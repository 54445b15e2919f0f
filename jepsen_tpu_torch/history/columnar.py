"""The ``.jtc`` columnar history substrate: reading, checking, writing.

The port's own copy of the JAX package's ``history/columnar.py``, byte
for byte in its format, so that either package reads the files the
other wrote and the same sections give the same bytes.  A ``.jtc`` is
the already exploded int32 column blocks of one history, beside its
source (``history.jsonl`` -> ``history.jtc``), so that a re-check maps
the file and skips the JSONL parse:

    load = open + mmap + header check + CRC pass + ``np.frombuffer``

Layout (little-endian; payloads 64-byte aligned)::

    [header 96 B][section table n x 48 B][table crc32 u32][pad][payloads]
    [digest footer: "JTCD", count u32, one sha256 per section, crc32 u32]

    header:  magic "JTCF", version u32, workload i32, n_sections u32,
             src_name 32s, src_size u64, src_mtime_ns i64,
             src_sha256 32 B
    section: kind u32, dtype u32 (0=i32 1=i64), rows u64, cols u64,
             offset u64, length u64, crc32 u32, flags u32

Section kinds: 1 = queue/generic ``[n, 8]`` row matrix (the
``rows._rows_for`` schema), 2 = stream ``[n, 6]`` columns (flags bit 0:
full read observed), 3/4/5 = elle micro-op cells ``[M, 8]`` (flags bit
0: degenerate) + txn index (i64, true ``n_txns`` in flags) + dense key
table (i64), 6 = mutex WGL cells ``[n, 8]``.  The port checks only the
queue family so far, but it reads and rewrites every kind, so that a
file holding other families' sections keeps them.

Discipline: a write goes temp -> full checksum re-verify -> rename, and
every load re-verifies the CRCs; a flipped byte, a truncated tail or a
stale format version raises :class:`ColumnarFormatError`.  Staleness
(the source was rewritten) is not corruption: a stale ``.jtc`` loads as
None.  :func:`consult` logs a corrupt file and treats it as a miss
(``JEPSEN_TPU_JTC_STRICT=1`` makes it raise).  ``JEPSEN_TPU_NO_JTC=1``
disables the substrate; the native packer honors the same variable.
"""

from __future__ import annotations

import hashlib
import logging
import mmap
import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

MAGIC = b"JTCF"
VERSION = 1
JTC_SUFFIX = ".jtc"

#: header: magic, version, workload, n_sections, src_name, src_size,
#: src_mtime_ns, src_sha256
_HEADER = struct.Struct("<4sIiI32sQq32s")
#: section: kind, dtype, rows, cols, offset, length, crc32, flags
_SECTION = struct.Struct("<IIQQQQII")
_CRC = struct.Struct("<I")
_ALIGN = 64

#: trailing section-digest footer (one sha256 per section)
DIGEST_MAGIC = b"JTCD"
_DIGEST_HEAD = struct.Struct("<4sI")

SEC_QROWS = 1  # [n, 8] int32 — rows._rows_for schema (any workload)
SEC_STREAM = 2  # [n, 6] int32 — stream columns
SEC_EMOPS = 3  # [M, 8] int32 — elle micro-op cells
SEC_EMOPS_TXN = 4  # [n] int64 — elle txn index (true n_txns in flags)
SEC_EMOPS_KEYS = 5  # [k] int64 — elle dense key table
SEC_WGL = 6  # [n, 8] int32 — mutex WGL cells

FLAG_STREAM_FULL = 1
FLAG_EMOPS_DEGENERATE = 1

_DTYPES = {0: np.int32, 1: np.int64}
_DTYPE_CODES = {np.dtype(np.int32): 0, np.dtype(np.int64): 1}

#: workload codes shared with the native packer (``fastpack._WORKLOADS``)
_WORKLOADS = ("queue", "stream", "elle", "mutex")


class ColumnarFormatError(RuntimeError):
    """A ``.jtc`` file is corrupt, truncated, or format-incompatible."""


@dataclass
class ElleMopsMeta:
    """The side data of an elle cell section: what the elle checker's
    ``ElleMopsMeta`` holds, kept here so that the sections survive a
    rewrite before the elle family is ported."""

    n_txns: int
    txn_index: list
    keys: list
    degenerate: bool


def jtc_path_for(src_path: str | Path) -> Path:
    """Sibling ``.jtc`` of a history source file (``history.jsonl`` ->
    ``history.jtc``)."""
    return Path(src_path).with_suffix(JTC_SUFFIX)


def _disabled() -> bool:
    # "0" means enabled, as the native reader parses it
    return os.environ.get("JEPSEN_TPU_NO_JTC", "0") not in ("", "0")


def _strict() -> bool:
    return os.environ.get("JEPSEN_TPU_JTC_STRICT", "0") not in ("", "0")


def _src_digest(path: Path) -> bytes:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.digest()


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


@dataclass
class Jtc:
    """One loaded ``.jtc``: read-only numpy views over the mapped file."""

    path: Path
    workload: str | None
    src_name: str
    arrays: dict = field(default_factory=dict)  # kind -> np.ndarray view
    flags: dict = field(default_factory=dict)  # kind -> u32 flags

    def rows(self) -> np.ndarray | None:
        """The ``[n, 8]`` generic row matrix, or None if absent."""
        return self.arrays.get(SEC_QROWS)

    def stream(self):
        """``(cols, full_read)`` of a stream history, or None."""
        cols = self.arrays.get(SEC_STREAM)
        if cols is None:
            return None
        return cols, bool(self.flags.get(SEC_STREAM, 0) & FLAG_STREAM_FULL)

    def wgl_cells(self) -> np.ndarray | None:
        """The ``[n, 8]`` mutex WGL cell matrix, or None if absent."""
        return self.arrays.get(SEC_WGL)

    def emops(self):
        """``(cell matrix, ElleMopsMeta)`` of an elle history, or None."""
        mat = self.arrays.get(SEC_EMOPS)
        txn = self.arrays.get(SEC_EMOPS_TXN)
        keys = self.arrays.get(SEC_EMOPS_KEYS)
        if mat is None or txn is None or keys is None:
            return None
        meta = ElleMopsMeta(
            n_txns=int(self.flags.get(SEC_EMOPS_TXN, len(txn))),
            txn_index=[int(x) for x in txn],
            keys=[int(x) for x in keys],
            degenerate=bool(
                self.flags.get(SEC_EMOPS, 0) & FLAG_EMOPS_DEGENERATE
            ),
        )
        return mat, meta

    def content_key(self) -> str:
        """Content address of the payload: hex sha256 over the section
        bytes in kind order.  The stamp's mtime and size never enter, so
        re-packs of one history share it; for a queue history it equals
        the digest the service computes over the same rows streamed as
        contiguous block slices, and it keys the service's verdict
        cache."""
        h = hashlib.sha256()
        for kind in sorted(self.arrays):
            h.update(np.ascontiguousarray(self.arrays[kind]).tobytes())
        return h.hexdigest()


def read_jtc(path: str | Path) -> tuple[Jtc, dict]:
    """Read and CRC-verify one ``.jtc`` (no source-freshness check: that
    is :func:`load_jtc`'s).  Returns ``(Jtc, stamp)``, ``stamp`` holding
    the header's source identity fields.  Raises
    :class:`ColumnarFormatError` on any corruption, truncation or
    format-version mismatch."""
    path = Path(path)
    try:
        fh = open(path, "rb")
    except OSError as e:
        raise ColumnarFormatError(f"{path}: unreadable: {e}") from e
    with fh:
        try:
            mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError) as e:  # zero-length or map failure
            raise ColumnarFormatError(
                f"{path}: cannot map ({e}) — truncated?"
            ) from e
    size = len(mm)
    if size < _HEADER.size + _CRC.size:
        raise ColumnarFormatError(f"{path}: truncated header ({size} B)")
    (
        magic, version, workload_code, n_sections,
        src_name, src_size, src_mtime_ns, src_sha,
    ) = _HEADER.unpack_from(mm, 0)
    if magic != MAGIC:
        raise ColumnarFormatError(
            f"{path}: bad magic {magic!r} (not a .jtc file)"
        )
    if version != VERSION:
        raise ColumnarFormatError(
            f"{path}: stale format version {version} (this build reads "
            f"version {VERSION})"
        )
    table_end = _HEADER.size + n_sections * _SECTION.size
    if size < table_end + _CRC.size:
        raise ColumnarFormatError(
            f"{path}: truncated section table ({n_sections} sections "
            f"declared, {size} B on disk)"
        )
    (stored_crc,) = _CRC.unpack_from(mm, table_end)
    if zlib.crc32(mm[:table_end]) != stored_crc:
        raise ColumnarFormatError(f"{path}: header checksum mismatch")
    workload = (
        _WORKLOADS[workload_code]
        if 0 <= workload_code < len(_WORKLOADS)
        else None
    )
    out = Jtc(
        path=path,
        workload=workload,
        src_name=src_name.rstrip(b"\x00").decode("utf-8", "replace"),
    )
    data_end = table_end + _CRC.size
    for i in range(n_sections):
        kind, dtype_code, nrows, ncols, off, length, crc, flags = (
            _SECTION.unpack_from(mm, _HEADER.size + i * _SECTION.size)
        )
        if dtype_code not in _DTYPES:
            raise ColumnarFormatError(
                f"{path}: section {kind} has unknown dtype {dtype_code}"
            )
        if off + length > size:
            raise ColumnarFormatError(
                f"{path}: section {kind} extends past end of file "
                f"(offset {off} + {length} B > {size} B) — truncated tail"
            )
        dt = np.dtype(_DTYPES[dtype_code])
        if length != nrows * max(ncols, 1) * dt.itemsize:
            raise ColumnarFormatError(
                f"{path}: section {kind} length {length} does not match "
                f"its declared shape ({nrows} x {ncols})"
            )
        if zlib.crc32(mm[off : off + length]) != crc:
            raise ColumnarFormatError(
                f"{path}: section {kind} checksum mismatch (bit flip or "
                f"torn write)"
            )
        arr = np.frombuffer(mm, dtype=dt, count=length // dt.itemsize,
                            offset=off)
        if ncols > 1:
            arr = arr.reshape(int(nrows), int(ncols))
        out.arrays[kind] = arr
        out.flags[kind] = flags
        data_end = max(data_end, off + length)
    # the bytes after the last payload must be exactly the digest footer
    # (a file written before the footer existed ends at its last payload)
    if size > data_end:
        foot_len = _DIGEST_HEAD.size + 32 * n_sections + _CRC.size
        if size - data_end != foot_len:
            raise ColumnarFormatError(
                f"{path}: {size - data_end} trailing B after sections "
                f"(digest footer is {foot_len} B) — truncated tail"
            )
        foot = mm[data_end:size]
        magic_f, count = _DIGEST_HEAD.unpack_from(foot, 0)
        if magic_f != DIGEST_MAGIC or count != n_sections:
            raise ColumnarFormatError(
                f"{path}: digest footer checksum mismatch (bad magic or "
                f"section count)"
            )
        (foot_crc,) = _CRC.unpack_from(foot, foot_len - _CRC.size)
        if zlib.crc32(foot[: foot_len - _CRC.size]) != foot_crc:
            raise ColumnarFormatError(
                f"{path}: digest footer checksum mismatch (bit flip or "
                f"torn write)"
            )
    stamp = {
        "src_name": out.src_name,
        "src_size": src_size,
        "src_mtime_ns": src_mtime_ns,
        "src_sha256": src_sha,
    }
    return out, stamp


def load_jtc(src_path: str | Path) -> Jtc | None:
    """The fresh ``.jtc`` of a history source, or None when absent,
    disabled or stale (the source was rewritten).  Raises
    :class:`ColumnarFormatError` when the file exists but is corrupt.

    Freshness is two-tier: a stat fast path ((size, mtime_ns) match the
    stamp AND the ``.jtc`` is strictly newer than the source), else the
    source's sha256 against the stamp."""
    if _disabled():
        return None
    src = Path(src_path)
    target = jtc_path_for(src)
    try:
        jtc_mtime = os.stat(target).st_mtime_ns
    except OSError:
        return None  # absent
    jtc, stamp = read_jtc(target)
    if stamp["src_name"] != src.name:
        log.debug("%s: built from %r, not %r — treating as stale",
                  target, stamp["src_name"], src.name)
        return None
    try:
        st = os.stat(src)
    except OSError:
        return None
    if (
        st.st_size == stamp["src_size"]
        and st.st_mtime_ns == stamp["src_mtime_ns"]
        and jtc_mtime > st.st_mtime_ns
    ):
        return jtc
    if _src_digest(src) == stamp["src_sha256"]:
        return jtc
    return None


# one absent-substrate notice per directory, not one per file
_noted_dirs: set = set()
_noted_lock = threading.Lock()


def _note_once(key: Path, level: int, msg: str, *args) -> None:
    with _noted_lock:
        if key in _noted_dirs:
            return
        _noted_dirs.add(key)
    log.log(level, msg, *args)


def consult(src_path: str | Path) -> Jtc | None:
    """The fresh substrate or None, for the cache layers: a corrupt
    ``.jtc`` is logged as a warning (and raises under
    ``JEPSEN_TPU_JTC_STRICT=1``) before the caller parses the source; an
    absent one is noted once per directory.  Each outcome is counted in
    the global registry, as the JAX package counts it: ``jtc.hit``, or
    ``jtc.fallback`` with ``reason`` ``corrupt``, ``absent`` or
    ``stale``."""
    from jepsen_tpu_torch.obs.metrics import REGISTRY

    src = Path(src_path)
    try:
        got = load_jtc(src)
    except ColumnarFormatError as e:
        REGISTRY.counter("jtc.fallback", reason="corrupt").inc()
        if _strict():
            raise
        log.warning(
            "corrupt columnar substrate, falling back to the parse for "
            "%s: %s", src, e,
        )
        return None
    if got is not None:
        REGISTRY.counter("jtc.hit").inc()
        return got
    if not _disabled():
        if not jtc_path_for(src).exists():
            REGISTRY.counter("jtc.fallback", reason="absent").inc()
            _note_once(
                src.parent, logging.INFO,
                "no columnar substrate (.jtc) under %s; parsing",
                src.parent,
            )
        else:  # present, but stamped for other source bytes or name
            REGISTRY.counter("jtc.fallback", reason="stale").inc()
    return got


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def iter_row_blocks(rows: np.ndarray, block_rows: int):
    """Contiguous ``(slice, n_ops)`` blocks over a ``[n, 8]`` row matrix,
    the wire unit for streaming a queue substrate.  Slices are views;
    ``n_ops`` counts the distinct op indices (column 0) in the slice.
    Block boundaries do not matter for correctness (positions are
    global through column 0); ``block_rows`` sets the frame size."""
    if block_rows < 1:
        raise ValueError("block_rows must be >= 1")
    n = rows.shape[0]
    for lo in range(0, n, block_rows):
        blk = rows[lo : lo + block_rows]
        yield blk, int(len(np.unique(blk[:, 0])))


def _coerce_sections(rows, stream, emops, wgl=None) -> list | None:
    """``(kind, arr, flags)`` triples from the family substrates; None
    when a substrate cannot be represented (non-int elle keys)."""
    secs = []
    if rows is not None:
        secs.append((SEC_QROWS, np.ascontiguousarray(rows, np.int32), 0))
    if wgl is not None:
        secs.append((SEC_WGL, np.ascontiguousarray(wgl, np.int32), 0))
    if stream is not None:
        cols, full = stream
        secs.append((
            SEC_STREAM,
            np.ascontiguousarray(cols, np.int32),
            FLAG_STREAM_FULL if full else 0,
        ))
    if emops is not None:
        mat, meta = emops
        try:
            keys = np.ascontiguousarray(meta.keys, np.int64)
        except (OverflowError, TypeError, ValueError):
            return None
        if keys.dtype != np.int64 or keys.ndim != 1:
            return None
        secs.append((
            SEC_EMOPS,
            np.ascontiguousarray(mat, np.int32),
            FLAG_EMOPS_DEGENERATE if meta.degenerate else 0,
        ))
        secs.append((
            SEC_EMOPS_TXN,
            np.ascontiguousarray(meta.txn_index, np.int64),
            int(meta.n_txns),
        ))
        secs.append((SEC_EMOPS_KEYS, keys, 0))
    return secs


def build_jtc_bytes(
    secs: list,
    workload: str | None,
    name: bytes,
    src_size: int,
    src_mtime_ns: int,
    src_sha256: bytes,
) -> bytes:
    """The complete on-disk image of a ``.jtc``: a deterministic
    function of the sections and the source stamp, ending with the
    section digest footer."""
    wl_code = _WORKLOADS.index(workload) if workload in _WORKLOADS else -1
    table_end = _HEADER.size + len(secs) * _SECTION.size
    data_off = _align(table_end + _CRC.size)
    entries, payloads, digests = [], [], []
    for kind, arr, flags in secs:
        raw = arr.tobytes()
        nrows = arr.shape[0] if arr.ndim else 0
        ncols = arr.shape[1] if arr.ndim == 2 else 1
        entries.append(_SECTION.pack(
            kind, _DTYPE_CODES[arr.dtype], nrows, ncols,
            data_off, len(raw), zlib.crc32(raw), flags,
        ))
        payloads.append((data_off, raw))
        digests.append(hashlib.sha256(raw).digest())
        data_off = _align(data_off + len(raw))
    head = _HEADER.pack(
        MAGIC, VERSION, wl_code, len(secs), name,
        src_size, src_mtime_ns, src_sha256,
    ) + b"".join(entries)
    buf = bytearray(data_off if payloads else table_end + _CRC.size)
    buf[: len(head)] = head
    _CRC.pack_into(buf, table_end, zlib.crc32(head))
    end = table_end + _CRC.size
    for off, raw in payloads:
        buf[off : off + len(raw)] = raw
        end = off + len(raw)
    foot = _DIGEST_HEAD.pack(DIGEST_MAGIC, len(secs)) + b"".join(digests)
    foot += _CRC.pack(zlib.crc32(foot))
    return bytes(buf[:end]) + foot


def write_jtc(
    src_path: str | Path,
    workload: str | None,
    *,
    rows: np.ndarray | None = None,
    stream: tuple | None = None,
    emops: tuple | None = None,
    wgl: np.ndarray | None = None,
) -> Path:
    """Write (replace) the sibling ``.jtc`` of ``src_path`` holding the
    given sections, stamped with the source's current (size, mtime_ns,
    sha256): built in memory, written to a unique temp sibling, re-read
    and checksum-verified, then renamed into place.  Raises on any
    failure (:func:`update_jtc` is the best-effort path)."""
    src = Path(src_path)
    secs = _coerce_sections(rows, stream, emops, wgl)
    if secs is None:
        raise ValueError(f"{src}: substrate not representable as .jtc")
    if not secs:
        raise ValueError(f"{src}: refusing to write a section-less .jtc")
    st = os.stat(src)
    digest = _src_digest(src)
    name = src.name.encode()
    if len(name) > 32:
        # the loader compares the whole basename with this stamp: a
        # truncated one would never match
        raise ValueError(
            f"{src}: basename exceeds the 32-byte .jtc source-name "
            f"field; not representable"
        )
    buf = build_jtc_bytes(
        secs, workload, name, st.st_size, st.st_mtime_ns, digest
    )
    target = jtc_path_for(src)
    tmp = target.with_name(
        f"{target.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    )
    try:
        with open(tmp, "wb") as fh:
            fh.write(buf)
        read_jtc(tmp)  # checksum-verify what reached the disk
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return target


def update_jtc(
    src_path: str | Path,
    workload: str | None = None,
    *,
    rows: np.ndarray | None = None,
    stream: tuple | None = None,
    emops: tuple | None = None,
    wgl: np.ndarray | None = None,
) -> bool:
    """Best-effort merge of sections into the sibling ``.jtc``: the
    fresh file's other sections are kept, the given ones replace
    theirs, and the whole file is rewritten by :func:`write_jtc`.  Never
    raises: a cache that cannot be written must not fail the check that
    tried to leave it.  Returns True when installed."""
    if _disabled():
        return False
    src = Path(src_path)
    try:
        existing = load_jtc(src)
    except ColumnarFormatError as e:
        log.warning("replacing corrupt columnar substrate for %s: %s",
                    src, e)
        existing = None
    if existing is not None:
        if rows is None:
            rows = existing.rows()
        if stream is None:
            stream = existing.stream()
        if emops is None:
            emops = existing.emops()
        if wgl is None:
            wgl = existing.wgl_cells()
        if workload is None:
            workload = existing.workload
    try:
        write_jtc(
            src, workload, rows=rows, stream=stream, emops=emops, wgl=wgl
        )
        return True
    except (OSError, ValueError):
        return False
