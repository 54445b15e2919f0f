"""Streaming ingestion: the checker service's core.

The port's counterpart of the JAX package's ``service/stream.py``, with
its admission, scheduling, recovery and accounting unchanged:

- **Streams, not requests.**  A client opens a stream, feeds ``.jtc``
  row blocks (the zero-parse ``[n, 8]`` row slices) or op-JSON blocks in
  sequence order, and finishes for a verdict.  Each stream owns a
  :class:`~jepsen_tpu_torch.checkers.segmented.SegmentedChecker` carry
  engine, so its verdict equals the batch ``check``'s by construction.
  Only the queue family is ported; another workload is refused at open
  with a machine-readable error naming its ROADMAP.md item.

- **Admission control and backpressure.**  More open streams than
  ``max_streams``, or more queued blocks than ``ingress_cap``, and the
  offer is rejected with a machine-readable ``SATURATED``: never a
  silent drop (the block stays with the client) and never a carry fed
  around a hole.

- **Degraded but honest under worker death.**  Checker workers claim
  streams off a shared token queue, preferring the shape bucket they
  just ran.  The carry is snapshotted after every fed block; a worker
  dying mid-feed loses nothing: the claim is requeued onto a survivor,
  the engine restored from the snapshot, the block fed again, and the
  verdict carries ``degraded`` provenance.  A block that kills workers
  past the retry budget quarantines its stream as unknown with
  evidence; with no worker left every open stream is quarantined rather
  than left hanging.

- **Sequencing is part of the contract.**  A duplicate seq is acked
  idempotently (a client retry after a reset); a gap quarantines the
  stream.

- **Content-addressed verdict cache.**  The service hashes every block
  it accepts; a clean finished verdict is cached under (digest,
  workload, contract) (``service/cache.py``).

- **A fault of the card or of K1 is not the data's.**  A K1 build or
  launch failure, a CUDA error or an exhausted card
  (:data:`~jepsen_tpu_torch.device.DEVICE_FAULTS`) is never quarantined,
  salvaged, cached or turned into a verdict: it fails every open stream
  with the fault's text (an ``error`` reply, not a verdict), the service
  stops admitting, and ``on_device_fault`` tells the server, which
  stops (``serve-checker`` exits 2).

``device`` is a torch device, ``"cuda"`` by default (raising
:class:`~jepsen_tpu_torch.device.NoDeviceError` without a card);
``"cpu"`` runs K1's plain version, as the tests do.  Everything here is
transport-free: ``service/server.py`` maps wire ops onto
:class:`IngestService`, and the tests drive it directly.
"""

from __future__ import annotations


import hashlib
import json
import logging
import os
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Sequence

import numpy as np

import torch

from jepsen_tpu_torch.checkers.protocol import UNKNOWN, VALID
from jepsen_tpu_torch.device import DEVICE_FAULTS, resolve_device

logger = logging.getLogger(__name__)

#: chaos hook: ``"<worker_idx>:<n_blocks>"`` makes that checker worker
#: raise :class:`WorkerDeath` in the middle of feeding its n-th block
#: (after the engine's mutation, before the snapshot and the ack), the
#: worst kill point
DIE_AFTER_ENV = "JEPSEN_TPU_SERVE_DIE_AFTER"

#: a block that sees this many worker deaths is poison: quarantine the
#: stream (never foldable into valid) and stop killing workers
MAX_BLOCK_RETRIES = 2

#: windows each stream keeps for its subscribers: a push connection that
#: drops and reconnects with ``from_window`` gets the missed windows
#: replayed from this log; asking below the retained floor is answered
#: with a machine-readable gap, never a silent skip
WINDOW_LOG_CAP = 64

SATURATED = "SATURATED"


class WorkerDeath(BaseException):
    """Chaos-injected checker-worker death (BaseException so ordinary
    ``except Exception`` recovery paths cannot swallow the kill)."""


def _parse_die_after(spec: str | None) -> tuple[int, int] | None:
    if not spec:
        return None
    try:
        idx, blocks = spec.split(":", 1)
        return int(idx), int(blocks)
    except ValueError:
        logger.error("%s=%r malformed (want idx:blocks); ignoring",
                     DIE_AFTER_ENV, spec)
        return None


class _Stream:
    """One admitted history stream and its carry engine."""

    __slots__ = (
        "sid", "workload", "opts", "engine", "kind", "shape",
        "pending", "next_seq", "blocks_fed", "ops_fed", "snapshot",
        "retries", "requeues", "quarantined", "finish_requested",
        "busy", "scheduled", "verdict", "done", "done_at",
        "created", "t0", "deadline", "digest", "content_key",
        "dead_workers", "carry_nbytes",
        "windows", "window_base", "subscribers",
        "batch_inflight", "batch_next_merge", "batch_results",
    )

    def __init__(self, sid, workload, opts, engine, kind, deadline_s):
        self.sid = sid
        self.workload = workload
        self.opts = opts
        self.engine = engine
        self.kind = kind  # "stream" (multi-block) | "submit" (one-shot)
        self.shape: tuple | None = None
        self.pending: deque = deque()  # (seq, block_kind, payload, n_ops)
        self.next_seq = 0
        self.blocks_fed = 0
        self.ops_fed = 0
        self.snapshot: dict | None = None
        self.retries = 0
        self.requeues: list[dict] = []
        self.dead_workers: list[str] = []
        self.quarantined = False
        self.finish_requested = False
        self.busy = False
        self.scheduled = False
        self.verdict: dict | None = None
        self.done = threading.Event()
        self.done_at: float | None = None
        self.created = time.monotonic()
        self.t0 = time.perf_counter()
        self.deadline = self.created + deadline_s
        self.digest = hashlib.sha256()
        self.content_key: str | None = None
        self.carry_nbytes = 0  # last snapshot's footprint (gauge share)
        # -- subscription push --
        self.windows: deque = deque()  # retained verdict windows (replay)
        self.window_base = 0  # window index of windows[0] (the floor)
        self.subscribers: list = []  # live SimpleQueue sinks
        # -- continuous batching --
        self.batch_inflight = 0  # accepted, not yet merged/evicted
        self.batch_next_merge = 0  # next seq the demux may fold in
        self.batch_results: dict = {}  # seq -> landed entry (reorder)


def _wire_safe(v):
    """Verdicts leave here over JSON (wire replies, the verdict cache):
    value sets become sorted lists (the batch ops' ``_jsonable``
    convention, deep), numpy scalars become Python ones."""
    if isinstance(v, dict):
        return {k: _wire_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_wire_safe(x) for x in v]
    if isinstance(v, (set, frozenset)):
        return sorted(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return v


def _block_shape(workload: str, block) -> tuple:
    from jepsen_tpu_torch.parallel.pipeline import _pow2_bucket

    _seq, bkind, payload, _n = block
    n = len(payload) if bkind == "ops" else int(payload.shape[0])
    return (workload, _pow2_bucket(max(n, 1)))


class IngestService:
    """The long-lived ingestion core: admission, bounded ingress,
    shape-coalescing checker workers, degraded-but-honest recovery.

    All limits are constructor-explicit so tests and the bench can pin
    tiny bounds; the CLI exposes them on ``serve-checker``."""

    def __init__(
        self,
        workers: int = 2,
        max_streams: int = 256,
        ingress_cap: int = 1024,
        stream_deadline_s: float = 120.0,
        cache=None,
        device: str | torch.device = "cuda",
        registry=None,
        block_delay_s: float = 0.0,
        die_after: tuple[int, int] | None = None,
        done_ttl_s: float = 300.0,
        batch: bool = False,
        target_batch: int = 32,
        max_batch_wait_ms: float = 25.0,
        dispatch_depth: int = 2,
        park_max_s: float = 5.0,
        warmup: bool = False,
        warmup_buckets: Sequence[tuple[int, int]] = (
            (128, 128), (256, 256),
        ),
    ):
        if workers < 1:
            raise ValueError("need at least one checker worker")
        if registry is None:
            from jepsen_tpu_torch.obs.metrics import REGISTRY as registry  # noqa: N813
        self.metrics = registry
        self.max_streams = max_streams
        self.ingress_cap = ingress_cap
        self.stream_deadline_s = stream_deadline_s
        self.cache = cache
        self.block_delay_s = block_delay_s
        self.done_ttl_s = done_ttl_s
        self.device = resolve_device(device)
        #: the fault of the card or of K1 that stopped the service, if any
        self.device_fault: BaseException | None = None
        #: called once with that fault (the server stops on it)
        self.on_device_fault = None
        self._die_after = (
            die_after
            if die_after is not None
            else _parse_die_after(os.environ.get(DIE_AFTER_ENV))
        )

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._streams: dict[str, _Stream] = {}
        self._tokens: deque[tuple[str, tuple]] = deque()
        self._active = 0  # undone streams (the admission bound)
        self._queued_blocks = 0  # blocks awaiting a worker (ingress bound)
        self._next_sid = 0
        self._running = True
        self._dead_workers: list[str] = []
        self._coalesced = 0

        self._g_depth = registry.gauge("service.ingress_depth")
        self._g_active = registry.gauge("service.streams_active")
        self._g_quar = registry.gauge("service.streams_quarantined")
        self._g_alive = registry.gauge("service.workers_alive")
        self._g_carry = registry.gauge("service.carry_bytes")
        self._carry_total = 0
        self._c_blocks = registry.counter("service.blocks")
        self._c_deaths = registry.counter("service.worker_deaths")
        self._c_requeues = registry.counter("service.block_requeues")
        self._c_windows = registry.counter("service.verdict_windows")
        self._g_subs = registry.gauge("service.subscribers")
        self._subs_total = 0
        self._s_verdict = registry.sketch("service.submit_to_verdict_s")
        self._s_block = registry.sketch("service.block_check_s")

        self._workers: list[threading.Thread] = []
        for i in range(workers):
            t = threading.Thread(
                target=self._worker, args=(i,),
                name=f"svcworker{i}", daemon=True,
            )
            self._workers.append(t)
            t.start()
        self._g_alive.set(workers)
        # continuous batching: opt-in cross-stream coalescing of queue
        # rows blocks into shape-bucketed super-batches, bounded by a
        # latency budget
        self._batcher = None
        if batch:
            from jepsen_tpu_torch.service.batcher import ContinuousBatcher

            self._batcher = ContinuousBatcher(
                self,
                target_batch=target_batch,
                max_wait_ms=max_batch_wait_ms,
                dispatch_depth=dispatch_depth,
                park_max_s=park_max_s,
                registry=registry,
            )
            if warmup:
                self._batcher.warmup(warmup_buckets)
        self._reaper = threading.Thread(
            target=self._reap, name="svc-reaper", daemon=True
        )
        self._reaper.start()

    # -- admission --------------------------------------------------------

    def _reject(self, reason: str, **detail) -> dict:
        self.metrics.counter(
            "service.admission_rejects", reason=reason
        ).inc()
        out = {"op": "rejected", "reason": SATURATED, "saturated": reason}
        out.update(detail)
        return out

    def _new_engine(self, workload: str, opts: dict):
        from jepsen_tpu_torch.checkers.segmented import SegmentedChecker

        return SegmentedChecker(workload, opts=opts, device=self.device)

    def _fault_reply(self) -> dict:
        e = self.device_fault
        return {"op": "error", "error": f"{type(e).__name__}: {e}",
                "reason": "device-fault"}

    def open(
        self,
        workload: str,
        opts: dict | None = None,
        content_key: str | None = None,
        deadline_s: float | None = None,
        kind: str = "stream",
    ) -> dict:
        """Admit one stream (or serve it straight off the verdict
        cache).  Returns ``{"op": "opened", "stream": sid}``, a cached
        verdict, or a loud ``SATURATED`` reject."""
        opts = dict(opts or {})
        if content_key is not None and self.cache is not None:
            from jepsen_tpu_torch.service.cache import cache_key

            entry = self.cache.get(cache_key(content_key, workload, opts))
            if entry is not None:
                out = {"op": "cached", "verdict": entry["verdict"]}
                if "report_ref" in entry:
                    out["report_ref"] = entry["report_ref"]
                return out
        with self._lock:
            if self.device_fault is not None:
                return self._fault_reply()
            if not self._running:
                return self._reject("shutdown")
            if len(self._dead_workers) >= len(self._workers):
                # a dead pool must refuse loudly, not enqueue forever
                return self._reject(
                    "no-live-workers",
                    dead_workers=list(self._dead_workers),
                )
            if self._active >= self.max_streams:
                return self._reject(
                    "streams", active=self._active,
                    max_streams=self.max_streams,
                )
            try:
                engine = self._new_engine(workload, opts)
            except (ValueError, NotImplementedError) as e:
                # an unknown workload, or a family not ported yet (the
                # error names its ROADMAP.md item)
                return {"op": "error", "error": str(e),
                        "reason": "bad-workload"}
            sid = f"s{self._next_sid}"
            self._next_sid += 1
            st = _Stream(
                sid, workload, opts, engine, kind,
                deadline_s if deadline_s is not None
                else self.stream_deadline_s,
            )
            st.content_key = content_key
            self._streams[sid] = st
            self._active += 1
            self._g_active.set(self._active)
        return {"op": "opened", "stream": sid}

    def feed(self, sid: str, seq: int, block_kind: str, payload,
             n_ops: int) -> dict:
        """Offer one block.  ``block_kind`` is ``"rows"`` (an ``[n, 8]``
        int32 matrix, queue family) or ``"ops"`` (a list of op-JSON
        dicts).  The reply is always machine-readable: ``accepted``
        (with the ingress depth), idempotent ``accepted dup`` for an
        already-fed seq, ``SATURATED`` (block NOT consumed — retry), or
        ``quarantined`` (gap / poisoned stream)."""
        with self._lock:
            if self.device_fault is not None:
                return self._fault_reply()
            st = self._streams.get(sid)
            if st is None:
                return {"op": "error", "error": f"unknown stream {sid!r}",
                        "reason": "unknown-stream"}
            if st.done.is_set() or st.quarantined:
                return {
                    "op": "quarantined", "stream": sid,
                    "error": "stream already closed or quarantined",
                }
            if seq < st.next_seq:
                # client retry after a reset: already consumed — ack,
                # never double-feed
                return {"op": "accepted", "stream": sid, "seq": seq,
                        "dup": True}
            if seq > st.next_seq:
                expected = st.next_seq
                self._quarantine_locked(
                    st,
                    f"gap in block sequence: expected seq {expected}, "
                    f"got {seq} — a carry fed around a hole would "
                    f"fabricate a verdict",
                )
                return {"op": "quarantined", "stream": sid,
                        "error": "sequence gap", "expected": expected,
                        "got": seq}
            if self._queued_blocks >= self.ingress_cap:
                return self._reject(
                    "ingress", queue_depth=self._queued_blocks,
                    ingress_cap=self.ingress_cap,
                )
            st.next_seq = seq + 1
            block = (seq, block_kind, payload, n_ops)
            if st.shape is None:
                st.shape = _block_shape(st.workload, block)
            batched = (
                self._batcher is not None and st.workload == "queue"
            )
            self._queued_blocks += 1
            self._g_depth.set(self._queued_blocks)
            if batched:
                # the coalescing path: parked entries stay counted in
                # the ingress bound above, so a full coalescing queue
                # counts against admission — never unbounded buffering
                st.batch_inflight += 1
            else:
                st.pending.append(block)
                self._schedule_locked(st)
            depth = self._queued_blocks
        if batched:
            # host prep and parking run on this connection's thread (the
            # lock is released), so prep parallelizes across clients
            self._batcher.offer(st, seq, block_kind, payload, n_ops)
        if self.cache is not None:
            # the content digest feeds only the verdict cache key: with no
            # cache it would be pure submit-path overhead
            if block_kind == "rows":
                st.digest.update(np.ascontiguousarray(payload).tobytes())
            else:
                st.digest.update(
                    json.dumps(payload, sort_keys=True,
                               separators=(",", ":")).encode()
                )
        return {"op": "accepted", "stream": sid, "seq": seq,
                "queue_depth": depth}

    def quarantine_stream(self, sid: str, error: str) -> dict:
        """External poison evidence (e.g. a torn block on the wire):
        quarantine THAT stream as unknown-with-evidence."""
        with self._lock:
            st = self._streams.get(sid)
            if st is None:
                return {"op": "error", "error": f"unknown stream {sid!r}"}
            self._quarantine_locked(st, error)
        return {"op": "quarantined", "stream": sid, "error": error}

    def abort(self, sid: str) -> dict:
        """Client abandons the stream: free its admission slot and any
        queued blocks without producing a verdict (nothing was promised
        — accounting-wise the stream never completed)."""
        with self._lock:
            st = self._streams.pop(sid, None)
            if st is None:
                return {"op": "error", "error": f"unknown stream {sid!r}"}
            if st.pending:
                self._queued_blocks -= len(st.pending)
                st.pending.clear()
                self._g_depth.set(self._queued_blocks)
            if self._batcher is not None:
                self._batcher.purge_stream_locked(st, "aborted")
            if not st.done.is_set():
                self._active -= 1
                self._g_active.set(self._active)
                self._carry_total -= st.carry_nbytes
                st.carry_nbytes = 0
                self._g_carry.set(self._carry_total)
                st.quarantined = True  # a racing worker drops the claim
                st.done.set()
                # subscribers must see a terminal window, never hang
                self._emit_window_locked(st, "aborted", final=True)
        return {"op": "aborted", "stream": sid}

    def finish(self, sid: str, timeout: float | None = None) -> dict:
        """Close the stream: drain its pending blocks, run the carry
        engine's ``finish()``, attach provenance, cache a clean
        verdict.  Returns the verdict dict (quarantined streams report
        ``unknown`` with the evidence attached, never an exception)."""
        with self._lock:
            st = self._streams.get(sid)
            if st is None:
                return {"op": "error", "error": f"unknown stream {sid!r}"}
            st.finish_requested = True
            self._schedule_locked(st)
            if self._batcher is not None:
                # drain: parked entries of a closing stream dispatch
                # now instead of riding out the coalescing deadline
                self._batcher.hurry_locked()
        limit = timeout if timeout is not None else max(
            0.0, st.deadline - time.monotonic()
        ) + 1.0
        if not st.done.wait(limit):
            with self._lock:
                if not st.done.is_set() and not st.busy:
                    self._quarantine_locked(
                        st,
                        f"finish deadline exceeded with "
                        f"{len(st.pending)} block(s) pending "
                        f"({limit:.1f}s)",
                        finalize_if_free=True,
                    )
            if not st.done.wait(1.0):
                # a worker is wedged holding the engine: answer without
                # it — unknown WITH evidence, never a hang
                return self._synthetic_verdict(
                    st, "checker worker wedged past the stream deadline"
                )
        assert st.verdict is not None
        return st.verdict

    def submit(
        self,
        workload: str,
        opts: dict | None,
        block_kind: str,
        payload,
        n_ops: int,
        content_key: str | None = None,
    ) -> dict:
        """One-shot admission: open + single block + finish-when-fed,
        without waiting for the verdict (fetch it with
        :meth:`collect`): the fleet path."""
        opened = self.open(
            workload, opts, content_key=content_key, kind="submit"
        )
        if opened["op"] != "opened":
            return opened
        sid = opened["stream"]
        fed = self.feed(sid, 0, block_kind, payload, n_ops)
        if fed["op"] != "accepted":
            # ingress refused the block: nothing was consumed, so the
            # admission slot must not leak — abort; the client retries
            # the whole submit (zero silent drops: this is counted as a
            # reject, not a verdict)
            self.abort(sid)
            return fed
        with self._lock:
            st = self._streams.get(sid)
            if st is not None:
                st.finish_requested = True
                self._schedule_locked(st)
                if self._batcher is not None:
                    self._batcher.hurry_locked()
        return {"op": "accepted", "id": sid}

    def collect(self, ids: Sequence[str], timeout: float = 0.0) -> dict:
        """Fetch finished submit verdicts; waits up to ``timeout`` for
        stragglers.  Collected verdicts are released from memory."""
        deadline = time.monotonic() + timeout
        done: dict[str, dict] = {}
        pending = list(ids)
        while True:
            still = []
            for sid in pending:
                with self._lock:
                    st = self._streams.get(sid)
                if st is None:
                    done[sid] = {"op": "error",
                                 "error": f"unknown stream {sid!r}"}
                elif st.done.is_set():
                    done[sid] = st.verdict
                    with self._lock:
                        self._streams.pop(sid, None)
                else:
                    still.append(sid)
            pending = still
            if not pending or time.monotonic() >= deadline:
                break
            time.sleep(0.002)
        return {"op": "collected", "done": done, "pending": pending}

    # -- subscription push --------------------------------------------------

    def subscribe(self, sid: str, from_window: int = 0):
        """Register a push subscriber on a stream's verdict windows.

        Returns ``(ack, replay, queue)``: the machine-readable ack (with
        a ``gap`` entry when the retained window floor has moved past
        ``from_window`` — the subscriber KNOWS which windows it can never
        see, instead of silently resuming), the retained windows at or
        above ``from_window`` to replay, and a live queue for windows
        emitted after this call (``None`` when the stream is already
        done — the replay then already ends in the terminal window)."""
        with self._lock:
            st = self._streams.get(sid)
            if st is None:
                return (
                    {"op": "error", "error": f"unknown stream {sid!r}",
                     "reason": "unknown-stream"},
                    [], None,
                )
            floor = st.window_base
            replay = [w for w in st.windows if w["window"] >= from_window]
            ack = {
                "op": "subscribed",
                "stream": sid,
                "from_window": from_window,
                "window_floor": floor,
                "next_window": st.window_base + len(st.windows),
                "replay": len(replay),
                "done": st.done.is_set(),
            }
            if from_window < floor:
                ack["gap"] = {
                    "requested": from_window,
                    "floor": floor,
                    "missed_windows": floor - from_window,
                }
            q = None
            if not st.done.is_set():
                q = queue_mod.SimpleQueue()
                st.subscribers.append(q)
                self._subs_total += 1
                self._g_subs.set(self._subs_total)
        return ack, replay, q

    def unsubscribe(self, sid: str, q) -> None:
        if q is None:
            return
        with self._lock:
            st = self._streams.get(sid)
            if st is not None and q in st.subscribers:
                st.subscribers.remove(q)
            self._subs_total = max(0, self._subs_total - 1)
            self._g_subs.set(self._subs_total)

    def _valid_so_far(self, st: _Stream):
        """Per-window partial verdict, O(carry): the queue carry answers
        per window (the other families, when ported, say ``"deferred"``
        where a partial verdict would re-run their whole analysis)."""
        if st.workload not in ("queue", "mutex"):
            return "deferred"
        try:
            return st.engine.verdict_so_far().get(VALID)
        except Exception as e:  # noqa: BLE001 — must not sink the drain
            return f"error: {type(e).__name__}: {e}"

    def _emit_window_locked(
        self, st: _Stream, valid_so_far, final: bool = False,
        verdict: dict | None = None,
    ) -> None:
        """Append one verdict window to the stream's bounded retained
        log and push it to live subscribers (caller holds the lock).
        The newest ``WINDOW_LOG_CAP`` windows are replayable; trimming
        advances ``window_base`` so a reconnect below the floor gets a
        machine-readable gap, never a silent skip."""
        w = {
            "op": "verdict-window",
            "stream": st.sid,
            "window": st.window_base + len(st.windows),
            "blocks": st.blocks_fed,
            "ops": st.ops_fed,
            "quarantined": st.quarantined,
            "final": final,
            "valid_so_far": _wire_safe(valid_so_far),
        }
        if verdict is not None:
            w["verdict"] = verdict  # already wire-safe on this path
        st.windows.append(w)
        while len(st.windows) > WINDOW_LOG_CAP:
            st.windows.popleft()
            st.window_base += 1
        self._c_windows.inc()
        for q in st.subscribers:
            q.put(w)

    def stats(self) -> dict:
        with self._lock:
            out = {
                "streams_active": self._active,
                "streams_held": len(self._streams),
                "queued_blocks": self._queued_blocks,
                "workers": len(self._workers),
                "workers_alive": len(self._workers)
                - len(self._dead_workers),
                "dead_workers": list(self._dead_workers),
                "coalesced_claims": self._coalesced,
                "carry_bytes": self._carry_total,
            }
            if self._batcher is not None:
                out["batcher"] = {
                    "parked": self._batcher.parked_locked(),
                    "target_batch": self._batcher.target,
                    "batch": self._batcher.batch,
                    "max_wait_ms": self._batcher.wait_s * 1000.0,
                    "warmed_buckets": sorted(self._batcher._warmed),
                }
        out["blocks"] = int(self._c_blocks.value)
        out["worker_deaths"] = int(self._c_deaths.value)
        out["block_requeues"] = int(self._c_requeues.value)
        out["verdict_windows"] = int(self._c_windows.value)
        out["subscribers"] = self._subs_total
        rejects = {}
        evictions = {}
        bucket_launches = {}
        for name, labels, metric in self.metrics.items():
            if name == "service.admission_rejects":
                rejects[dict(labels).get("reason", "")] = int(metric.value)
            elif name == "service.batcher_evictions":
                evictions[dict(labels).get("reason", "")] = int(
                    metric.value
                )
            elif name == "service.bucket_launches":
                bucket_launches[dict(labels)["bucket"]] = int(metric.value)
        out["admission_rejects"] = rejects
        if self._batcher is not None:
            out["batcher"]["launches"] = int(
                self._batcher._c_batches.value
            )
            out["batcher"]["batched_blocks"] = int(
                self._batcher._c_blocks.value
            )
            out["batcher"]["salvages"] = int(
                self._batcher._c_salvage.value
            )
            out["batcher"]["warmup_hits"] = int(
                self._batcher._c_whit.value
            )
            out["batcher"]["warmup_misses"] = int(
                self._batcher._c_wmiss.value
            )
            out["batcher"]["evictions"] = evictions
            # K1 launches of coalesced super-batches, by (L, V) bucket
            out["batcher"]["bucket_launches"] = bucket_launches
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    def close(self) -> None:
        with self._lock:
            self._running = False
            self._cond.notify_all()
            if self._batcher is not None:
                self._batcher.close_locked()
        for t in self._workers:
            t.join(timeout=2.0)
        if self._batcher is not None:
            self._batcher.join(timeout=2.0)

    # -- internals --------------------------------------------------------

    def _schedule_locked(self, st: _Stream) -> None:
        """Make the stream claimable (caller holds the lock): one token
        per idle stream with work — the ≤1-claimer discipline that
        keeps block order per stream while workers roam streams."""
        if st.scheduled or st.busy or st.done.is_set():
            return
        if not st.pending and not st.finish_requested:
            return
        if st.batch_inflight > 0:
            # batched blocks still in flight: the finish claim waits
            # until the demux drains them (it re-schedules at zero) —
            # a finish over unmerged blocks would fabricate a verdict
            return
        st.scheduled = True
        self._tokens.append((st.sid, st.shape or (st.workload, 0)))
        self._cond.notify()

    def _claim(self, pref_shape: tuple | None):
        """Pop a token, preferring one in the caller's last shape
        bucket (bounded scan) — same-shape streams coalesce onto the
        worker that just compiled/ran that shape."""
        with self._cond:
            while True:
                if not self._running:
                    return None
                if self._tokens:
                    idx = 0
                    if pref_shape is not None:
                        for i, (_sid, shape) in enumerate(self._tokens):
                            if i >= 32:
                                break
                            if shape == pref_shape:
                                idx = i
                                break
                    sid, _shape = self._tokens[idx]
                    del self._tokens[idx]
                    if idx > 0:
                        self._coalesced += 1
                    st = self._streams.get(sid)
                    if st is None:
                        continue
                    st.scheduled = False
                    if st.busy or st.done.is_set():
                        continue
                    st.busy = True
                    return st
                self._cond.wait(timeout=0.5)

    def _worker(self, idx: int) -> None:
        name = threading.current_thread().name
        fed_here = 0
        last_shape: tuple | None = None
        while True:
            st = self._claim(last_shape)
            if st is None:
                return
            last_shape = st.shape
            try:
                fed_here = self._drain(st, idx, fed_here)
            except WorkerDeath:
                self._on_worker_death(name, st)
                return
            except DEVICE_FAULTS as e:
                # the card's or K1's fault, not the stream's: never
                # quarantined, never a verdict
                with self._lock:
                    st.busy = False
                self.fail_device(e)
                return
            except Exception as e:  # noqa: BLE001 — honest, not fatal
                # a bug in the drain path must not wedge the stream or
                # kill the worker: quarantine with evidence, keep going
                logger.exception("service: drain of %s failed", st.sid)
                with self._lock:
                    if st.pending:
                        self._queued_blocks -= len(st.pending)
                        st.pending.clear()
                        self._g_depth.set(self._queued_blocks)
                    st.busy = False
                    self._quarantine_locked(
                        st,
                        f"checker worker error: {type(e).__name__}: {e}",
                        finalize_if_free=st.finish_requested,
                    )
                continue
            with self._lock:
                st.busy = False
                self._schedule_locked(st)

    def _drain(self, st: _Stream, idx: int, fed_here: int) -> int:
        while True:
            with self._lock:
                if st.quarantined and st.pending:
                    # poisoned: drop the backlog from accounting (the
                    # verdict already says unknown-with-evidence)
                    self._queued_blocks -= len(st.pending)
                    st.pending.clear()
                    self._g_depth.set(self._queued_blocks)
                block = st.pending[0] if st.pending else None
            if block is None:
                break
            seq, bkind, payload, n_ops = block
            if self.block_delay_s:
                time.sleep(self.block_delay_s)
            t0 = time.perf_counter()
            self._feed_engine(st, bkind, payload, n_ops)
            fed_here += 1
            if (
                self._die_after is not None
                and idx == self._die_after[0]
                and fed_here >= self._die_after[1]
            ):
                # mid-feed kill: the engine was mutated, the block not
                # yet acked — the worst case the snapshot protocol must
                # survive exactly
                raise WorkerDeath(
                    f"{DIE_AFTER_ENV} hook: worker {idx} dying mid-feed "
                    f"of {st.sid} seq {seq}"
                )
            nb = st.carry_nbytes
            if st.kind == "stream":
                st.snapshot = st.engine.state()
                nb = st.engine.state_nbytes(st.snapshot)
            st.blocks_fed += 1
            st.ops_fed += n_ops
            dt = time.perf_counter() - t0
            self._s_block.add(dt)
            self._c_blocks.inc()
            vsf = self._valid_so_far(st)
            with self._lock:
                if st.pending:  # a racing abort() may have cleared it
                    st.pending.popleft()
                    self._queued_blocks -= 1
                    self._g_depth.set(self._queued_blocks)
                if not st.done.is_set():
                    self._carry_total += nb - st.carry_nbytes
                    st.carry_nbytes = nb
                    self._g_carry.set(self._carry_total)
                    # one verdict window per closed segment, pushed to
                    # subscribers the moment the block lands
                    self._emit_window_locked(st, vsf)
        if st.finish_requested and not st.done.is_set():
            # the engine belongs to this worker (single-claimer): run
            # the heavy finish outside the service lock
            verdict = st.engine.finish()
            with self._lock:
                if not st.done.is_set():
                    self._complete_locked(st, verdict)
        return fed_here

    def _feed_engine(self, st: _Stream, bkind: str, payload,
                     n_ops: int) -> None:
        """Feed one block; engine-level failures (poison payloads)
        quarantine inside the engine itself; a fault of the card or of K1
        raises."""
        if bkind == "rows":
            rows = np.asarray(payload, np.int32)
            if rows.ndim != 2 or rows.shape[1] != 8:
                st.engine.quarantine(
                    st.engine.segments,
                    f"malformed rows block: shape {rows.shape}",
                )
                st.quarantined = True
                return
            st.engine.feed_rows(rows, n_ops)
        else:
            from jepsen_tpu_torch.history.ops import Op

            try:
                ops = [Op.from_json(d) for d in payload]
            except Exception as e:  # noqa: BLE001 — poison, not fatal
                st.engine.quarantine(
                    st.engine.segments,
                    f"undecodable ops block: {type(e).__name__}: {e}",
                )
                st.quarantined = True
                return
            st.engine.feed(ops, start_op=st.ops_fed)
        if st.engine.quarantines:
            st.quarantined = True

    def _quarantine_locked(
        self, st: _Stream, error: str, finalize_if_free: bool = False
    ) -> None:
        """Mark the stream poisoned (caller holds the lock).  The
        engine is only finalized when no worker holds it; a busy
        worker observes ``quarantined`` and finalizes after its
        current block."""
        st.quarantined = True
        if self._batcher is not None:
            # parked coalescing entries of a poisoned stream evict
            # (service.batcher_evictions) — batch-mates are untouched
            self._batcher.purge_stream_locked(st, "quarantined")
        if not st.engine.quarantines:
            # appending evidence is safe concurrently (list append);
            # the carry itself is never touched here
            st.engine.quarantine(st.engine.segments, error)
        if not st.busy and (finalize_if_free or st.finish_requested):
            self._finalize_locked(st)

    def _provenance(self, st: _Stream) -> dict:
        out = {
            "stream": st.sid,
            "workload": st.workload,
            "blocks": st.blocks_fed,
            "ops": st.ops_fed,
        }
        if self.cache is not None:
            # digests are only accumulated when a cache wants the key
            out["content_sha256"] = st.digest.hexdigest()
        return out

    def _degraded(self, st: _Stream) -> dict | None:
        if not (st.dead_workers or st.requeues):
            return None
        return {
            "dead_workers": list(st.dead_workers),
            "requeued_blocks": list(st.requeues),
            "worker_deaths": len(st.dead_workers),
        }

    def _finalize_locked(self, st: _Stream) -> None:
        """Finish the engine under the lock — only for the cold paths
        (quarantine, deadline, fail-all) where the engine is free."""
        if st.done.is_set():
            return
        self._complete_locked(st, st.engine.finish())

    def _complete_locked(self, st: _Stream, verdict: dict) -> None:
        from jepsen_tpu_torch.obs import trace as obs_trace

        verdict = _wire_safe(verdict)
        verdict["provenance"] = self._provenance(st)
        deg = self._degraded(st)
        if deg is not None:
            verdict["degraded"] = deg
        st.verdict = verdict
        st.done_at = time.monotonic()
        st.done.set()
        self._active -= 1
        self._g_active.set(self._active)
        self._carry_total -= st.carry_nbytes
        st.carry_nbytes = 0
        self._g_carry.set(self._carry_total)
        if st.quarantined:
            self._g_quar.inc()
        # terminal window: carries the FULL verdict so a subscriber
        # needs no follow-up poll to learn how the stream ended
        self._emit_window_locked(
            st, verdict.get(VALID), final=True, verdict=verdict
        )
        now = time.perf_counter()
        self._s_verdict.add(now - st.t0)
        obs_trace.complete(
            "service.stream", st.t0, now, track="service",
            args=(
                {"stream": st.sid, "blocks": st.blocks_fed,
                 "quarantined": st.quarantined}
                if obs_trace.is_enabled()
                else None
            ),
        )
        if (
            self.cache is not None
            and not st.quarantined
            and deg is None
            and st.blocks_fed > 0
        ):
            # clean verdicts only: a degraded or quarantined verdict
            # reflects this run's faults, not the history
            from jepsen_tpu_torch.service.cache import cache_key

            self.cache.put(
                cache_key(st.digest.hexdigest(), st.workload, st.opts),
                verdict,
            )

    def _synthetic_verdict(self, st: _Stream, error: str) -> dict:
        """A verdict without the engine (it is wedged under a worker):
        unknown WITH evidence — the degraded-but-honest floor."""
        out = {
            VALID: UNKNOWN,
            "quarantined": {"segments": [{"segment": st.blocks_fed,
                                          "error": error}]},
            "provenance": self._provenance(st),
        }
        deg = self._degraded(st) or {"dead_workers": [],
                                     "requeued_blocks": [],
                                     "worker_deaths": 0}
        deg["wedged"] = True
        out["degraded"] = deg
        return out

    def _on_worker_death(self, name: str, st: _Stream) -> None:
        """Requeue at block granularity: restore the stream's engine from
        its last snapshot, put the claim back for a survivor, name the
        dead worker in the provenance."""
        self._c_deaths.inc()
        logger.error(
            "service: checker worker %s died mid-feed of %s "
            "(block retries so far: %d)", name, st.sid, st.retries,
        )
        with self._lock:
            self._dead_workers.append(name)
            alive = len(self._workers) - len(self._dead_workers)
            self._g_alive.set(alive)
            st.dead_workers.append(name)
            st.retries += 1
            if st.snapshot is not None:
                from jepsen_tpu_torch.checkers.segmented import (
                    SegmentedChecker,
                )

                st.engine = SegmentedChecker.from_state(
                    st.snapshot, device=self.device
                )
            else:
                st.engine = self._new_engine(st.workload, st.opts)
            head_seq = st.pending[0][0] if st.pending else None
            st.busy = False
            if st.retries > MAX_BLOCK_RETRIES:
                if st.pending:
                    self._queued_blocks -= len(st.pending)
                    st.pending.clear()
                    self._g_depth.set(self._queued_blocks)
                self._quarantine_locked(
                    st,
                    f"block seq {head_seq} killed {st.retries} checker "
                    f"worker(s) — treating as poison (dead: "
                    f"{st.dead_workers})",
                    finalize_if_free=True,
                )
            else:
                self._c_requeues.inc()
                st.requeues.append({
                    "seq": head_seq,
                    "dead_worker": name,
                    "retries": st.retries,
                })
                self._schedule_locked(st)
            if alive <= 0:
                self._fail_all_locked(
                    f"no surviving checker workers (dead: "
                    f"{self._dead_workers})"
                )

    def _fail_all_locked(self, error: str) -> None:
        """Zero survivors: every undone stream quarantines loudly
        (unknown-with-evidence) instead of hanging its client."""
        for st in self._streams.values():
            if st.done.is_set():
                continue
            if st.pending:
                self._queued_blocks -= len(st.pending)
                st.pending.clear()
            if self._batcher is not None:
                self._batcher.purge_stream_locked(st, "failed")
            st.quarantined = True
            if not st.engine.quarantines:
                st.engine.quarantine(st.engine.segments, error)
            if st.busy and st.batch_inflight > 0:
                # the batch collector is mid-merge on this engine:
                # leave finalization to its pass (or the finish-path
                # wedge fallback) rather than racing the merge
                continue
            st.busy = False
            self._finalize_locked(st)
        self._g_depth.set(self._queued_blocks)

    def fail_device(self, err: BaseException) -> None:
        """A fault of the card or of K1: every open stream fails with the
        fault's text (an ``error`` reply in place of its verdict, never
        quarantined, never cached), the service stops admitting, and
        :attr:`on_device_fault` is told once."""
        with self._lock:
            if self.device_fault is not None:
                return
            self.device_fault = err
            logger.error("service: fault of the card or of K1, every open "
                         "stream fails: %s: %s", type(err).__name__, err)
            reply = self._fault_reply()
            for st in self._streams.values():
                if st.done.is_set():
                    continue
                if st.pending:
                    self._queued_blocks -= len(st.pending)
                    st.pending.clear()
                if self._batcher is not None:
                    self._batcher.purge_stream_locked(st, "device-fault")
                st.verdict = dict(reply, stream=st.sid)
                st.done_at = time.monotonic()
                st.done.set()
                self._active -= 1
                self._carry_total -= st.carry_nbytes
                st.carry_nbytes = 0
                w = {"op": "verdict-window", "stream": st.sid,
                     "window": st.window_base + len(st.windows),
                     "blocks": st.blocks_fed, "ops": st.ops_fed,
                     "quarantined": False, "final": True,
                     "valid_so_far": None, "error": reply["error"]}
                st.windows.append(w)
                for q in st.subscribers:
                    q.put(w)
            self._g_depth.set(self._queued_blocks)
            self._g_active.set(self._active)
            self._g_carry.set(self._carry_total)
            self._cond.notify_all()
        if self.on_device_fault is not None:
            self.on_device_fault(err)

    def _reap(self) -> None:
        """Deadline sweep: expire overdue idle streams as quarantined
        (freeing their admission slots), release stale done records."""
        while True:
            time.sleep(0.25)
            with self._lock:
                if not self._running:
                    return
                now = time.monotonic()
                for st in list(self._streams.values()):
                    if st.done.is_set():
                        if (
                            st.done_at is not None
                            and now - st.done_at > self.done_ttl_s
                        ):
                            self._streams.pop(st.sid, None)
                        continue
                    if now > st.deadline and not st.busy:
                        if st.pending:
                            self._queued_blocks -= len(st.pending)
                            st.pending.clear()
                            self._g_depth.set(self._queued_blocks)
                        self._quarantine_locked(
                            st,
                            f"stream deadline exceeded "
                            f"({self.stream_deadline_s:.1f}s) with "
                            f"pending work",
                            finalize_if_free=True,
                        )
