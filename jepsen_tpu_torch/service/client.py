"""Client of the checker service: pack on the host, ship tensors.

The port's counterpart of the queue half of the JAX package's
``service/client.py``, speaking the same wire (``service/protocol.py``),
so it talks to a server of either package.  The stream and elle batch
ops (``check_stream_histories``, ``check_elle_histories``) wait for
those families (ROADMAP.md, Open items §1, items 6 and 7).

The streaming methods (``stream_open`` … ``submit_batch_rows``) speak
the ingestion surface.  With a :class:`RetryPolicy` transient faults are
the client's problem, not the caller's: a connection reset reconnects
and resends (block feeds are idempotent by sequence number, so the
server acks a duplicate), and a ``SATURATED`` reject backs off with
exponential delay and jitter and offers again.  When the budget runs out
the caller gets :class:`ServiceUnavailable`, whose ``.reason`` is
machine-readable: never a raw socket exception, never a block dropped
silently.
"""

from __future__ import annotations


import random
import socket
import time
from dataclasses import dataclass
from typing import Any, Sequence

import numpy as np

from jepsen_tpu_torch.history.encode import PackedHistories, pack_histories
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.service.protocol import (
    ProtocolError,
    no_delay,
    recv_frame,
    send_frame,
)


#: result-map keys that are value *sets* locally and travel as sorted lists
_SET_KEYS = frozenset(
    {
        "lost",
        "unexpected",
        "duplicated",
        "recovered",
        "duplicate",
        "phantom",
        "causality",
        # stream family
        "divergent",
        "reorder",
        # elle family
        "G0",
        "G1c",
        "G2",
        "G1a",
        "G1b",
        "incompatible-order",
    }
)


def _desetted(result: dict[str, Any]) -> dict[str, Any]:
    """Restore the local checkers' result shape (lists → value sets)."""
    out: dict[str, Any] = {}
    for k, v in result.items():
        if isinstance(v, dict):
            out[k] = _desetted(v)
        elif k in _SET_KEYS and isinstance(v, list):
            out[k] = set(v)
        else:
            out[k] = v
    return out


@dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff + full jitter.

    ``attempts`` bounds the TOTAL tries (first offer included); delays
    grow ``base_s * 2**k`` capped at ``cap_s``, each multiplied by a
    uniform jitter draw so a saturated server isn't re-hit by every
    client on the same beat.  ``seed`` pins the draw for tests."""

    attempts: int = 6
    base_s: float = 0.05
    cap_s: float = 2.0
    jitter: float = 0.5  # delay is scaled by uniform(jitter, 1.0)
    seed: int | None = None

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_s * (2.0 ** attempt), self.cap_s)
        return d * rng.uniform(min(self.jitter, 1.0), 1.0)


class ServiceUnavailable(RuntimeError):
    """The retry budget is spent.  ``reason`` is machine-readable:

    ``{"reason": "SATURATED"|"connection", "attempts": n,
    "last": <final reject dict or repr of the final exception>}``"""

    def __init__(self, msg: str, reason: dict[str, Any]):
        super().__init__(msg)
        self.reason = reason


class SubscriptionGap(RuntimeError):
    """A subscription cannot be made whole.  ``gap`` is machine-readable:
    either the server's retained window log no longer reaches back to
    the requested window (``{"requested": k, "floor": f,
    "missed_windows": n}``) or the push sequence itself skipped
    (``{"expected": k, "got": g}``).  The subscriber KNOWS exactly which
    windows it can never see — a silent resume would fabricate a
    contiguous verdict history around a hole."""

    def __init__(self, msg: str, gap: dict[str, Any]):
        super().__init__(msg)
        self.gap = gap


class CheckerClient:
    """One TCP connection to a checker service; reusable across calls."""

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 8640,
        timeout: float = 120.0,
        retry: RetryPolicy | None = None,
    ):
        self.host = host
        self.port = port
        self.timeout = timeout
        self.retry = retry
        self._rng = random.Random(retry.seed if retry else None)
        self.sock = no_delay(
            socket.create_connection((host, port), timeout=timeout))

    def close(self) -> None:
        self.sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _reconnect(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass
        self.sock = no_delay(socket.create_connection(
            (self.host, self.port), timeout=self.timeout
        ))

    def _call(
        self, header: dict[str, Any], arrays=None, crc: bool = False
    ) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
        send_frame(self.sock, header, arrays, crc=crc)
        reply, reply_arrays = recv_frame(self.sock)
        if reply.get("op") == "error":
            raise RuntimeError(f"sidecar error: {reply.get('error')}")
        return reply, reply_arrays

    def _call_robust(
        self, header: dict[str, Any], arrays=None, crc: bool = False
    ) -> dict[str, Any]:
        """One streaming-surface call under the retry policy: resend on
        connection faults (block feeds are seq-idempotent), back off and
        re-offer on ``SATURATED``.  Without a policy, single-shot."""
        attempts = self.retry.attempts if self.retry else 1
        last: Any = None
        saturated = False
        for attempt in range(attempts):
            if attempt:
                time.sleep(self.retry.delay_s(attempt - 1, self._rng))
            try:
                reply, _ = self._call(header, arrays, crc=crc)
            except (ConnectionError, ProtocolError, OSError) as e:
                last, saturated = repr(e), False
                if self.retry is None or attempt + 1 >= attempts:
                    break
                try:
                    self._reconnect()
                except OSError as e2:
                    last = repr(e2)
                continue
            if (
                reply.get("op") == "rejected"
                and reply.get("reason") == "SATURATED"
            ):
                last, saturated = reply, True
                continue
            return reply
        reason = {
            "reason": "SATURATED" if saturated else "connection",
            "attempts": attempts,
            "last": last,
        }
        raise ServiceUnavailable(
            f"service unavailable after {attempts} attempt(s): "
            f"{reason['reason']}",
            reason,
        )

    def ping(self) -> dict[str, Any]:
        reply, _ = self._call({"op": "ping"})
        return reply

    def check_packed(self, packed: PackedHistories) -> list[dict[str, Any]]:
        """The ``check`` op over a packed batch: its four columns cross
        the wire in their packed dtypes (int8 ``f``/``type``, int16 or
        int32 ``value``, bool ``mask``)."""
        arrays = {
            k: getattr(packed, k).cpu().numpy()
            for k in ("f", "type", "value", "mask")
        }
        reply, _ = self._call(
            {"op": "check", "value_space": packed.value_space}, arrays
        )
        return [_desetted(r) for r in reply["results"]]

    def check_histories(
        self,
        histories: Sequence[Sequence[Op]],
        length: int | None = None,
        value_space: int | None = None,
    ) -> list[dict[str, Any]]:
        packed = pack_histories(
            histories, length=length, value_space=value_space, device="cpu"
        )
        return self.check_packed(packed)

    # -- streaming surface ------------------------------------------------

    def stream_open(
        self,
        workload: str,
        opts: dict | None = None,
        content_key: str | None = None,
        deadline_s: float | None = None,
    ) -> dict[str, Any]:
        """Open a stream: ``{"op": "opened", "stream": sid}``, a cached
        verdict (when ``content_key`` hits), or raises
        :class:`ServiceUnavailable` after the retry budget."""
        header: dict[str, Any] = {
            "op": "stream-open", "workload": workload, "opts": opts or {},
        }
        if content_key is not None:
            header["content_key"] = content_key
        if deadline_s is not None:
            header["deadline_s"] = deadline_s
        return self._call_robust(header)

    def stream_feed_rows(
        self, sid: str, seq: int, rows: np.ndarray, n_ops: int
    ) -> dict[str, Any]:
        """Feed one ``[n, 8]`` row block (queue family), CRC-protected
        on the wire; seq-idempotent, so resend-after-reset is safe."""
        return self._call_robust(
            {"op": "stream-feed", "stream": sid, "seq": seq,
             "n_ops": n_ops},
            {"rows": np.ascontiguousarray(rows, np.int32)},
            crc=True,
        )

    def stream_feed_ops(
        self, sid: str, seq: int, ops_json: list, n_ops: int | None = None
    ) -> dict[str, Any]:
        """Feed one op-JSON block."""
        return self._call_robust({
            "op": "stream-feed", "stream": sid, "seq": seq,
            "ops_block": ops_json,
            "n_ops": len(ops_json) if n_ops is None else n_ops,
        })

    def stream_finish(
        self, sid: str, timeout: float | None = None
    ) -> dict[str, Any]:
        header: dict[str, Any] = {"op": "stream-finish", "stream": sid}
        if timeout is not None:
            header["timeout"] = timeout
        return _desetted(self._call_robust(header))

    def stream_abort(self, sid: str) -> dict[str, Any]:
        return self._call_robust({"op": "stream-abort", "stream": sid})

    def submit_batch_rows(
        self,
        workload: str,
        blocks: Sequence[np.ndarray],
        n_ops: Sequence[int],
        opts: dict | None = None,
        content_keys: Sequence[str] | None = None,
    ) -> dict[str, Any]:
        """One frame, many one-shot histories (the fleet path):
        concatenated rows + offsets; per-history admission replies in
        order (``accepted`` with an id, ``cached``, or ``rejected``)."""
        if not blocks:
            return {"op": "submitted", "replies": []}
        mats = [np.ascontiguousarray(b, np.int32) for b in blocks]
        offsets = np.zeros(len(mats) + 1, np.int64)
        np.cumsum([m.shape[0] for m in mats], out=offsets[1:])
        header: dict[str, Any] = {
            "op": "submit-batch", "workload": workload,
            "opts": opts or {}, "n_ops": [int(n) for n in n_ops],
        }
        if content_keys is not None:
            header["content_keys"] = list(content_keys)
        return self._call_robust(
            header,
            {"rows": np.concatenate(mats, axis=0), "offsets": offsets},
            crc=True,
        )

    def collect(
        self, ids: Sequence[str], timeout: float = 0.0
    ) -> dict[str, Any]:
        reply = self._call_robust(
            {"op": "collect", "ids": list(ids), "timeout": timeout}
        )
        if isinstance(reply.get("done"), dict):
            reply["done"] = {
                k: _desetted(v) if isinstance(v, dict) else v
                for k, v in reply["done"].items()
            }
        return reply

    def cache_get(
        self, content_key: str, workload: str, opts: dict | None = None
    ) -> dict[str, Any]:
        return self._call_robust({
            "op": "cache-get", "content_key": content_key,
            "workload": workload, "opts": opts or {},
        })

    def service_stats(self) -> dict[str, Any]:
        return self._call_robust({"op": "service-stats"})

    def subscribe_windows(
        self, sid: str, from_window: int = 0,
        timeout: float | None = None,
    ):
        """Generator over a stream's pushed verdict windows: yields
        contiguous ``verdict-window`` dicts from ``from_window`` until the
        terminal ``final`` window.

        Runs on a DEDICATED connection (push frames must not interleave
        with this client's request→reply calls).  A torn push connection
        reconnects under the retry policy and re-subscribes from the
        first window not yet yielded — the server replays the missed
        windows from its retained log, and duplicates below the resume
        point are dropped here, so the caller sees each window exactly
        once.  When the story cannot be made whole (the server's
        retained floor moved past the resume point, or the push sequence
        itself skipped), raises :class:`SubscriptionGap` with the
        machine-readable hole; when the budget is spent, raises
        :class:`ServiceUnavailable`."""
        next_window = from_window
        attempts = self.retry.attempts if self.retry else 1
        failures = 0
        last: Any = None
        sock: socket.socket | None = None

        def _drop(s):
            try:
                s.close()
            except OSError:
                pass

        try:
            while True:
                if sock is None:
                    if failures:
                        time.sleep(
                            self.retry.delay_s(failures - 1, self._rng)
                        )
                    try:
                        sock = no_delay(socket.create_connection(
                            (self.host, self.port),
                            timeout=(timeout if timeout is not None
                                     else self.timeout),
                        ))
                        send_frame(sock, {
                            "op": "stream-subscribe", "stream": sid,
                            "from_window": next_window,
                        })
                        ack, _ = recv_frame(sock)
                    except (ConnectionError, ProtocolError, OSError) as e:
                        if sock is not None:
                            _drop(sock)
                            sock = None
                        last = repr(e)
                        failures += 1
                        if failures >= attempts:
                            raise ServiceUnavailable(
                                f"subscription unavailable after "
                                f"{failures} attempt(s)",
                                {"reason": "connection",
                                 "attempts": failures, "last": last},
                            ) from e
                        continue
                    if ack.get("op") == "error":
                        raise RuntimeError(
                            f"sidecar error: {ack.get('error')}"
                        )
                    if "gap" in ack:
                        g = ack["gap"]
                        raise SubscriptionGap(
                            f"window(s) "
                            f"[{g['requested']}, {g['floor']}) fell off "
                            f"the server's retained log",
                            gap=g,
                        )
                try:
                    frame, _ = recv_frame(sock)
                except (ConnectionError, ProtocolError, OSError) as e:
                    _drop(sock)
                    sock = None
                    last = repr(e)
                    failures += 1
                    if failures >= attempts:
                        raise ServiceUnavailable(
                            f"subscription torn and not recoverable "
                            f"after {failures} attempt(s)",
                            {"reason": "connection",
                             "attempts": failures, "last": last},
                        ) from e
                    continue
                failures = 0  # progress renews the budget
                op = frame.get("op")
                if op in ("subscribe-done", "subscribe-timeout"):
                    return
                if op != "verdict-window":
                    raise ProtocolError(
                        f"unexpected push frame {op!r} on subscription"
                    )
                w = int(frame.get("window", -1))
                if w < next_window:
                    continue  # replayed duplicate: already yielded
                if w > next_window:
                    raise SubscriptionGap(
                        f"push sequence skipped: expected window "
                        f"{next_window}, got {w}",
                        gap={"expected": next_window, "got": w},
                    )
                next_window = w + 1
                if isinstance(frame.get("verdict"), dict):
                    frame["verdict"] = _desetted(frame["verdict"])
                yield frame
                if frame.get("final"):
                    return
        finally:
            if sock is not None:
                _drop(sock)

    def check_jtc(
        self,
        path,
        block_rows: int = 512,
        opts: dict | None = None,
        timeout: float | None = None,
    ) -> dict[str, Any]:
        """Stream one ``.jtc`` substrate end-to-end: content-key lookup
        first (a cached verdict costs a hash, not a device dispatch),
        else open + feed row blocks + finish.  Queue-family substrates
        only (the zero-parse wire path)."""
        from jepsen_tpu_torch.history.columnar import (
            iter_row_blocks,
            read_jtc,
        )

        jtc, _stamp = read_jtc(path)
        rows = jtc.rows()
        if rows is None:
            raise ValueError(f"{path}: no row section to stream")
        workload = jtc.workload or "queue"
        if workload != "queue":
            raise ValueError(
                f"{path}: {workload} histories stream as op blocks "
                f"(stream_feed_ops), not row blocks"
            )
        opened = self.stream_open(
            workload, opts=opts, content_key=jtc.content_key()
        )
        if opened["op"] == "cached":
            return opened
        if opened["op"] != "opened":
            return opened
        sid = opened["stream"]
        for seq, (blk, n) in enumerate(iter_row_blocks(rows, block_rows)):
            fed = self.stream_feed_rows(sid, seq, blk, n)
            if fed["op"] not in ("accepted",):
                return fed
        return self.stream_finish(sid, timeout=timeout)
