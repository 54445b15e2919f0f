"""Continuous batching for the checker service.

The port's counterpart of the JAX package's ``service/batcher.py``,
with its scheduling unchanged; its device half is K1 on ``[B, L]``
stacks.  Between stream ingestion
(:class:`~jepsen_tpu_torch.service.stream.IngestService`) and the
segmented carry engines:

- **Cross-stream coalescing.**  Every accepted queue rows block is
  prepared on the host (:func:`queue_prepare_rows`) on the feeding
  connection's thread and parked in a queue keyed by its bucket
  ``(L, V)``, the power-of-two size classes of a segment.  A bucket
  launches when it holds the target batch, or when its oldest entry
  passes the latency budget (``max_batch_wait_ms``): size or deadline,
  never starvation.

- **Carry isolation.**  Batching crosses streams only on the history
  axis: the batched launch
  (:func:`~jepsen_tpu_torch.parallel.pipeline.dispatch_coalesced`, K1
  through :func:`~jepsen_tpu_torch.checkers.segmented.seg_queue_batch_program`
  with each entry's own global positions as ``[B, L]`` pos) computes
  per-segment stats only, and no carry enters it.  Results go back to
  each stream through a reorder buffer and merge into its residue in seq
  order (``QueueCarry.merge_stats`` depends on order), so every verdict
  and every carry equals the per-stream serial one.

- **Staging ring.**  Each bucket owns a
  :class:`~jepsen_tpu_torch.parallel.pipeline.BucketStagingRing` of
  ``dispatch_depth`` recycled pinned slots at ``[batch, L]``, so steady
  state allocates no host memory.  The batcher has one CUDA stream for
  its copies and launches; the dispatcher never synchronizes the card,
  and the collector waits only on its launch's event, so the next
  super-batch is staged while the last one computes.

- **Backpressure.**  Parked entries stay counted in the service's
  ingress bound, so a full coalescing queue counts against admission.
  Entries whose stream dies (abort, quarantine, deadline) are evicted
  and counted as ``service.batcher_evictions{reason}``; a parked-age
  bound (``park_max_s``) dispatches whatever the size-or-deadline rule
  could not move.

- **Faults.**  A failed coalesced launch is retried entry by entry
  (``service.batch_salvages``) when the data caused it, so one poison
  segment quarantines one stream and not its batch-mates.  A fault of
  the card or of K1 (:data:`~jepsen_tpu_torch.device.DEVICE_FAULTS`) is
  not salvaged: it goes to :meth:`IngestService.fail_device`.

Locking: the batcher shares the service's lock, so the service's abort,
quarantine and reap paths purge parked entries with no lock-order
hazard.  An engine is touched only by the collector thread (under
``st.busy``, the workers' single-claimer rule), or by a worker running
``finish()`` once the stream's in-flight count is zero.
"""

from __future__ import annotations


import logging
import queue as queue_mod
import threading
import time
from collections import deque

import numpy as np
import torch

from jepsen_tpu_torch.device import DEVICE_FAULTS

logger = logging.getLogger(__name__)

#: bucket pseudo-keys for entries that never reach the device program
EMPTY_BUCKET = ("empty",)  # rows with no queue-relevant ops
PASS_BUCKET = ("pass",)  # ops-JSON blocks on a queue stream


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class ContinuousBatcher:
    """The admission-to-dispatch scheduler.  Constructed by
    :class:`IngestService` when batching is enabled; all knobs are
    constructor-explicit so tests and the bench pin tiny bounds."""

    def __init__(
        self,
        service,
        target_batch: int = 32,
        max_wait_ms: float = 25.0,
        dispatch_depth: int = 2,
        park_max_s: float = 5.0,
        registry=None,
    ):
        self.svc = service
        self.target = max(1, int(target_batch))
        self.batch = _pow2(self.target)  # the ONE compiled batch width
        self.wait_s = max(0.0, float(max_wait_ms) / 1000.0)
        self.depth = max(1, int(dispatch_depth))
        # the stranding backstop is ABSOLUTE: it must fire even when
        # the coalescing deadline is configured far beyond it
        self.park_max_s = max(0.05, float(park_max_s))
        self.device = service.device
        # one stream for every copy and launch of the batcher
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

        self._lock = service._lock  # ONE lock with the service
        self._cond = threading.Condition(self._lock)
        self._buckets: dict[tuple, deque] = {}
        self._rings: dict[tuple, object] = {}
        self._warmed: set[tuple] = set()
        self._seen: set[tuple] = set()  # buckets that already dispatched
        self._closing = False
        self._collect_q: queue_mod.Queue = queue_mod.Queue(
            maxsize=self.depth
        )
        self._idle_since = time.perf_counter()

        if registry is None:
            registry = service.metrics
        self.metrics = registry
        self._c_batches = registry.counter("service.batches")
        self._c_blocks = registry.counter("service.batched_blocks")
        self._c_salvage = registry.counter("service.batch_salvages")
        self._c_whit = registry.counter("service.warmup_hits")
        self._c_wmiss = registry.counter("service.warmup_misses")
        self._s_fill = registry.sketch("service.batch_fill")
        self._s_waste = registry.sketch("service.batch_pad_waste")
        self._s_coalesce = registry.sketch("service.batch_coalesce_s")
        self._s_dispatch = registry.sketch("service.batch_dispatch_s")
        self._s_occupancy = registry.sketch("service.batch_occupancy")

        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="svc-batcher", daemon=True
        )
        self._collector = threading.Thread(
            target=self._collect_loop, name="svc-batch-collect", daemon=True
        )
        self._dispatcher.start()
        self._collector.start()

    # -- warmup ------------------------------------------------------------

    def warmup(self, buckets) -> int:
        """``serve-checker --warmup``: allocate each ``(L, V)`` bucket's
        ring, then one K1 launch per bucket at this batcher's batch width
        (:func:`warmup_queue_buckets`), so the first super-batch of a
        warmed bucket finds K1 built and its ring pinned; it counts as
        ``service.warmup_hits`` when it lands."""
        from jepsen_tpu_torch.checkers.segmented import warmup_queue_buckets

        keys = [(int(L), int(V)) for L, V in buckets]
        for key in keys:
            self._ring(key)
        n = warmup_queue_buckets(keys, batch=self.batch, device=self.device)
        self._warmed.update(keys)
        logger.info(
            "batcher warmup: %d bucket(s) launched at batch %d", n,
            self.batch,
        )
        return n

    # -- ingestion side ----------------------------------------------------

    def offer(self, st, seq: int, block_kind: str, payload,
              n_ops: int) -> None:
        """Park one accepted block.  Called without the service lock, so
        the host prep runs on the feeding connection's thread, in
        parallel across clients.  The service has already counted the
        block against the ingress bound and the stream's in-flight
        count."""
        entry = {
            "sid": st.sid, "seq": int(seq), "n_ops": int(n_ops),
            "t_enq": time.monotonic(), "prep": None, "payload": None,
            "err": None, "stats": None,
        }
        if block_kind == "rows":
            from jepsen_tpu_torch.checkers.segmented import (
                EMPTY_QUEUE_STATS,
                queue_prepare_rows,
            )

            rows = np.asarray(payload, np.int32)
            key = EMPTY_BUCKET
            if rows.ndim != 2 or rows.shape[1] != 8:
                entry["err"] = f"malformed rows block: shape {rows.shape}"
            else:
                try:
                    prep = queue_prepare_rows(
                        rows, rows[:, 0].astype(np.int64)
                    )
                except ValueError as e:  # the data's fault: quarantined
                    entry["err"] = f"{type(e).__name__}: {e}"
                else:
                    if prep is None:
                        entry["stats"] = EMPTY_QUEUE_STATS
                    else:
                        entry["prep"] = prep
                        key = (prep["L"], prep["V"])
        else:
            entry["payload"] = (block_kind, payload)
            key = PASS_BUCKET
        with self._lock:
            cur = self.svc._streams.get(st.sid)
            if cur is not st or st.done.is_set() or st.quarantined:
                # the stream died between accept and park: the block
                # was counted — release it loudly, never strand it
                self._evict_locked(st, 1, "dead-stream")
                return
            self._buckets.setdefault(key, deque()).append(entry)
            self._cond.notify()

    def purge_stream_locked(self, st, reason: str) -> None:
        """Drop every parked entry and pending demux result of one
        stream (caller holds the lock) — the abort / quarantine /
        deadline-reap hook.  In-flight launches containing the stream
        are unaffected; the collector drops their rows on landing.
        Batch-mates are untouched either way."""
        dropped = 0
        for dq in self._buckets.values():
            if not dq:
                continue
            keep = [e for e in dq if e["sid"] != st.sid]
            if len(keep) != len(dq):
                dropped += len(dq) - len(keep)
                dq.clear()
                dq.extend(keep)
        dropped += len(st.batch_results)
        st.batch_results.clear()
        if dropped:
            self._evict_locked(st, dropped, reason)

    def _evict_locked(self, st, n: int, reason: str) -> None:
        svc = self.svc
        svc._queued_blocks = max(0, svc._queued_blocks - n)
        svc._g_depth.set(svc._queued_blocks)
        st.batch_inflight = max(0, st.batch_inflight - n)
        self.metrics.counter(
            "service.batcher_evictions", reason=reason
        ).inc(n)

    def parked_locked(self) -> int:
        return sum(len(dq) for dq in self._buckets.values())

    def close_locked(self) -> None:
        self._closing = True
        self._cond.notify_all()

    def join(self, timeout: float = 2.0) -> None:
        self._dispatcher.join(timeout=timeout)
        self._collector.join(timeout=timeout)

    # -- dispatch loop -----------------------------------------------------

    def _ready_key_locked(self, now: float):
        """Size-or-deadline: a bucket at target size dispatches NOW; a
        bucket whose oldest entry exceeded the budget dispatches
        partial (never starvation).  Overdue-past-park-bound buckets
        trump everything (the stranded-segment backstop).  A bucket
        holding a finish-requested stream's entries is drained
        immediately — close must not ride out the coalescing deadline."""
        best, best_age = None, -1.0
        streams = self.svc._streams
        for key, dq in self._buckets.items():
            if not dq:
                continue
            age = now - dq[0]["t_enq"]
            if age >= self.park_max_s:
                return key
            ready = len(dq) >= self.target or age >= self.wait_s
            if not ready:
                ready = any(
                    (s := streams.get(e["sid"])) is not None
                    and s.finish_requested
                    for e in dq
                )
            if ready and age > best_age:
                best, best_age = key, age
        return best

    def hurry_locked(self) -> None:
        """Wake the dispatcher out of its deadline sleep (caller holds
        the lock) — the finish() drain hook."""
        self._cond.notify()

    def _next_deadline_locked(self, now: float) -> float:
        dt = 0.25
        for dq in self._buckets.values():
            if dq:
                dt = min(dt, max(0.0, self.wait_s
                                 - (now - dq[0]["t_enq"])))
        return dt

    def _dispatch_loop(self) -> None:
        while True:
            key = entries = None
            with self._cond:
                while True:
                    if self._closing or not self.svc._running:
                        break
                    now = time.monotonic()
                    key = self._ready_key_locked(now)
                    if key is not None:
                        dq = self._buckets[key]
                        entries = []
                        while dq and len(entries) < self.target:
                            e = dq.popleft()
                            st = self.svc._streams.get(e["sid"])
                            if (st is None or st.done.is_set()
                                    or st.quarantined):
                                if st is not None:
                                    self._evict_locked(
                                        st, 1, "dead-stream"
                                    )
                                else:
                                    self.svc._queued_blocks = max(
                                        0, self.svc._queued_blocks - 1
                                    )
                                    self.svc._g_depth.set(
                                        self.svc._queued_blocks
                                    )
                                    self.metrics.counter(
                                        "service.batcher_evictions",
                                        reason="dead-stream",
                                    ).inc()
                                continue
                            entries.append(e)
                        if entries:
                            break
                        entries = None
                        continue  # bucket drained by evictions: rescan
                    self._cond.wait(
                        timeout=self._next_deadline_locked(now)
                    )
            if entries is None:
                # closing: sentinel goes out OUTSIDE the lock (the
                # bounded collect queue must never block a lock holder)
                self._collect_q.put(None)
                return
            t0 = time.perf_counter()
            try:
                self._launch(key, entries)
            except DEVICE_FAULTS as err:
                # the card's or K1's: never salvaged into verdicts
                self.svc.fail_device(err)
            except Exception:  # noqa: BLE001 — salvage already tried
                logger.exception("batcher: launch of %s failed", key)
                for e in entries:
                    e["err"] = e["err"] or "batched dispatch failed"
                self._collect_q.put((None, None, entries, t0))
            t1 = time.perf_counter()
            idle = max(0.0, t0 - self._idle_since)
            busy = t1 - t0
            if busy + idle > 0:
                self._s_occupancy.add(busy / (busy + idle))
            self._idle_since = t1

    def _ring(self, key):
        ring = self._rings.get(key)
        if ring is None:
            from jepsen_tpu_torch.parallel.pipeline import BucketStagingRing

            L, V = key
            ring = self._rings[key] = BucketStagingRing(
                self.batch, L, V, self.device, depth=self.depth
            )
        return ring

    def _launch(self, key, entries) -> None:
        now = time.monotonic()
        for e in entries:
            self._s_coalesce.add(now - e["t_enq"])
        self._c_batches.inc()
        self._c_blocks.inc(len(entries))
        if key in (EMPTY_BUCKET, PASS_BUCKET):
            # nothing for the device: straight to the demux, keeping
            # the per-stream seq order the reorder buffer enforces
            self._collect_q.put(
                (None, None, entries, time.perf_counter())
            )
            return
        L, V = key
        if key not in self._seen:
            self._seen.add(key)
            (self._c_whit if key in self._warmed
             else self._c_wmiss).inc()
        self._s_fill.add(len(entries) / self.batch)
        used = sum(e["prep"]["n_rel"] for e in entries)
        self._s_waste.add(1.0 - used / float(self.batch * L))
        ring = self._ring(key)
        while True:
            slot = ring.acquire(timeout=0.5)
            if slot is not None:
                break
            if self._closing or not self.svc._running:
                raise RuntimeError("batcher closing with ring busy")
        t0 = time.perf_counter()
        try:
            from jepsen_tpu_torch.parallel import pipeline

            ring.fill(slot, [e["prep"] for e in entries])
            pipeline.dispatch_coalesced(slot, V, self.stream)
            self.metrics.counter("service.bucket_launches",
                                 bucket=f"{L}x{V}").inc()
        except DEVICE_FAULTS:
            ring.release(slot)
            raise
        except Exception as err:  # noqa: BLE001 — salvage per entry
            ring.release(slot)
            logger.warning(
                "batcher: coalesced dispatch %s failed (%s); "
                "salvaging per entry", key, err,
            )
            self._salvage(entries)
            self._collect_q.put((None, None, entries, t0))
            return
        self._collect_q.put((key, slot, entries, t0))

    def _salvage(self, entries) -> None:
        """Entry-by-entry retry after a coalesced launch that failed for
        the data's sake, so one poison segment quarantines one stream,
        not its batch-mates.  A solo launch that fails is the card's or
        K1's fault (the data was checked when it was prepared) and
        raises."""
        from jepsen_tpu_torch.checkers.segmented import (
            queue_stats_from_prepared,
        )

        self._c_salvage.inc()
        for e in entries:
            e["stats"] = queue_stats_from_prepared(e["prep"], self.device)

    # -- collect / demux ---------------------------------------------------

    def _collect_loop(self) -> None:
        from jepsen_tpu_torch.checkers.segmented import _trim_queue_stats
        from jepsen_tpu_torch.obs import trace as obs_trace

        while True:
            item = self._collect_q.get()
            if item is None:
                return
            key, slot, entries, t0 = item
            if slot is not None:
                try:
                    if slot["event"] is not None:
                        slot["event"].synchronize()  # this launch only
                except DEVICE_FAULTS as err:
                    self._rings[key].release(slot)
                    self.svc.fail_device(err)
                    continue
                planes = slot["out"].numpy()  # [6, batch, V] on the host
                for i, e in enumerate(entries):
                    e["stats"] = _trim_queue_stats(
                        e["prep"]["u"], *(p[i] for p in planes)
                    )
                self._rings[key].release(slot)
            t1 = time.perf_counter()
            self._s_dispatch.add(t1 - t0)
            if obs_trace.is_enabled():
                obs_trace.complete(
                    "service.batch", t0, t1, track="service",
                    args={
                        "bucket": "x".join(str(k) for k in (key or ())),
                        "entries": len(entries),
                    },
                )
            try:
                self._demux(entries)
            except DEVICE_FAULTS as err:
                self.svc.fail_device(err)
            except Exception:  # noqa: BLE001 — must not kill the loop
                logger.exception("batcher: demux failed")

    def _demux(self, entries) -> None:
        """Hand every landed entry to its stream's reorder buffer and
        merge each stream's contiguous run IN SEQ ORDER — the other
        half of the carry-isolation invariant."""
        svc = self.svc
        runs: dict[str, tuple] = {}  # sid -> (st, [entry, ...])
        with self._lock:
            for e in entries:
                st = svc._streams.get(e["sid"])
                if st is None or st.done.is_set() or st.quarantined:
                    if st is not None:
                        self._evict_locked(st, 1, "dead-stream")
                    else:
                        svc._queued_blocks = max(
                            0, svc._queued_blocks - 1
                        )
                        svc._g_depth.set(svc._queued_blocks)
                        self.metrics.counter(
                            "service.batcher_evictions",
                            reason="dead-stream",
                        ).inc()
                    continue
                st.batch_results[e["seq"]] = e
                if e["sid"] not in runs:
                    runs[e["sid"]] = (st, [])
            for sid, (st, run) in list(runs.items()):
                while st.batch_next_merge in st.batch_results:
                    run.append(st.batch_results.pop(st.batch_next_merge))
                    st.batch_next_merge += 1
                if not run:
                    del runs[sid]
                else:
                    # single-claimer: workers cannot hold a stream with
                    # in-flight batched blocks (finish is gated), so
                    # busy is free to take here
                    st.busy = True
        for st, run in runs.values():
            try:
                self._merge_run(st, run)
            except DEVICE_FAULTS:
                with self._lock:
                    st.busy = False
                raise
            except Exception as err:  # noqa: BLE001 — that stream only
                logger.exception(
                    "batcher: merge into %s failed", st.sid
                )
                with self._lock:
                    self._evict_locked(st, len(run), "demux-error")
                    st.busy = False
                    svc._quarantine_locked(
                        st,
                        f"batched demux error: {type(err).__name__}: "
                        f"{err}",
                        finalize_if_free=st.finish_requested,
                    )

    def _merge_run(self, st, run) -> None:
        """Fold one stream's contiguous landed run into its engine
        (outside the lock — single-claimer via ``st.busy``), then book
        the blocks, emit verdict windows, and release the claim."""
        svc = self.svc
        merged = []
        error = None
        for e in run:
            if e["err"] is not None:
                st.engine.quarantine(st.engine.segments, e["err"])
                error = e["err"]
            elif e["payload"] is not None:
                bkind, payload = e["payload"]
                svc._feed_engine(st, bkind, payload, e["n_ops"])
            else:
                st.engine.merge_queue_stats(e["stats"], e["n_ops"])
            if st.engine.quarantines:
                st.quarantined = True
            merged.append((e, svc._valid_so_far(st)))
        nb = st.carry_nbytes
        if st.kind == "stream" and not st.quarantined:
            # one footprint refresh per landed run, not per block
            nb = st.engine.state_nbytes()
        with self._lock:
            for e, vsf in merged:
                st.blocks_fed += 1
                st.ops_fed += e["n_ops"]
                svc._queued_blocks = max(0, svc._queued_blocks - 1)
                st.batch_inflight = max(0, st.batch_inflight - 1)
                svc._c_blocks.inc()
                if not st.done.is_set():
                    svc._emit_window_locked(st, vsf)
            svc._g_depth.set(svc._queued_blocks)
            if not st.done.is_set():
                svc._carry_total += nb - st.carry_nbytes
                st.carry_nbytes = nb
                svc._g_carry.set(svc._carry_total)
            st.busy = False
            if st.quarantined:
                svc._quarantine_locked(
                    st,
                    error or "segment quarantined in batched merge",
                    finalize_if_free=st.finish_requested,
                )
            elif st.finish_requested and st.batch_inflight == 0:
                svc._schedule_locked(st)
