"""Length-prefixed binary framing for the checker service.

The port's own copy of the JAX package's ``service/protocol.py``, byte
for byte on the wire: a client of either package talks to a server of
either.

One frame is the magic ``JTQ1``, a big-endian uint32 header length, a
JSON header, and the raw array payload.  The header names the op and
every array (name, dtype, shape, in order); the payload is the arrays'
little-endian bytes concatenated, so packed history columns cross the
wire as they sit in memory, with no per-op serialization.  Booleans
travel as uint8.

Streaming ops also carry a per-array ``crc32`` in the spec
(``send_frame(..., crc=True)``): a torn or bit-flipped block is then
detected by the receiver as :class:`TornPayloadError`, raised only after
the whole payload has been read, so the connection stays in frame sync
and the server quarantines exactly the poisoned stream while it goes on
serving every other.

The framing is symmetric: after a ``stream-subscribe`` request the
server sends :data:`PUSH_OPS` frames (``verdict-window`` deltas, then a
terminal ``subscribe-done`` or ``subscribe-timeout``) on that connection
until the stream's final window, each one an ordinary frame.
"""

from __future__ import annotations

import json
import socket
import struct
import zlib
from typing import Any, Mapping

import numpy as np

MAGIC = b"JTQ1"
_HDR = struct.Struct(">4sI")  # magic, header-json length

#: hard cap on a single frame's payload (1 GiB) — a corrupt length prefix
#: must not make the receiver try to allocate arbitrary memory
MAX_PAYLOAD = 1 << 30

#: the op that flips a connection into push mode (server → client frames)
SUBSCRIBE_OP = "stream-subscribe"

#: frames the SERVER originates on a subscribed connection; everything
#: else on the wire stays strict request → reply
PUSH_OPS = frozenset({
    "verdict-window", "subscribe-done", "subscribe-timeout",
})


class ProtocolError(RuntimeError):
    pass


class TornPayloadError(ProtocolError):
    """An array's bytes failed their declared crc32.

    The frame was fully consumed (the connection is still usable); the
    parsed ``header`` identifies which op/stream the torn bytes belonged
    to, so the receiver can quarantine that stream instead of dropping
    the connection."""

    def __init__(self, msg: str, header: dict[str, Any], torn: list[str]):
        super().__init__(msg)
        self.header = header
        self.torn = torn


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ProtocolError(f"connection closed mid-frame ({got}/{n})")
        got += r
    return bytes(buf)


def send_frame(
    sock: socket.socket,
    header: Mapping[str, Any],
    arrays: Mapping[str, np.ndarray] | None = None,
    crc: bool = False,
) -> None:
    arrays = arrays or {}
    specs = []
    chunks = []
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        if a.dtype == bool:
            a = a.astype(np.uint8)
        a = a.astype(a.dtype.newbyteorder("<"), copy=False)
        raw = a.tobytes()
        spec = {"name": name, "dtype": str(a.dtype), "shape": list(a.shape)}
        if crc:
            spec["crc32"] = zlib.crc32(raw)
        specs.append(spec)
        chunks.append(raw)
    hdr = dict(header)
    hdr["arrays"] = specs
    hdr_bytes = json.dumps(hdr).encode()
    # prefix and header in one write: two small writes in a row wait on
    # the peer's delayed ACK under Nagle's algorithm
    sock.sendall(_HDR.pack(MAGIC, len(hdr_bytes)) + hdr_bytes)
    for c in chunks:
        sock.sendall(c)


def no_delay(sock: socket.socket) -> socket.socket:
    """``sock`` with Nagle's algorithm off: a frame is several writes and
    a request waits for its reply, so a write held back for the peer's
    delayed ACK would add tens of milliseconds to every call."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def recv_frame(
    sock: socket.socket,
) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
    magic, hdr_len = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if magic != MAGIC:
        raise ProtocolError(f"bad magic {magic!r}")
    if hdr_len > MAX_PAYLOAD:
        raise ProtocolError(f"oversized header ({hdr_len} bytes)")
    header = json.loads(_recv_exact(sock, hdr_len))
    arrays: dict[str, np.ndarray] = {}
    torn: list[str] = []
    total = 0
    for spec in header.get("arrays", []):
        dtype = np.dtype(spec["dtype"])
        count = int(np.prod(spec["shape"], dtype=np.int64)) if spec["shape"] else 1
        nbytes = dtype.itemsize * count
        total += nbytes
        if total > MAX_PAYLOAD:
            raise ProtocolError(f"oversized payload (> {MAX_PAYLOAD} bytes)")
        buf = _recv_exact(sock, nbytes)
        # verify-but-keep-reading: the whole frame must be consumed
        # before raising, or the next recv would misparse payload bytes
        # as a frame header (losing the connection, not just the block)
        if "crc32" in spec and zlib.crc32(buf) != spec["crc32"]:
            torn.append(spec["name"])
            continue
        arrays[spec["name"]] = np.frombuffer(buf, dtype=dtype).reshape(
            spec["shape"]
        )
    if torn:
        raise TornPayloadError(
            f"torn payload: crc32 mismatch on array(s) {torn} "
            f"(op {header.get('op')!r})",
            header=header,
            torn=torn,
        )
    return header, arrays
