"""Pipelined bytes-to-verdict executor: overlap pack, staging and check.

The counterpart of the JAX package's ``parallel/pipeline.py`` for the
queue family.  Histories go from files to verdicts in chunks, through
three overlapped stages:

    producer thread                 caller thread
    ───────────────                 ─────────────
    chunk k+1: cache, then the      chunk k:   pinned host→device copy
               native thread-pool              on a side stream; K1 and
               parse (GIL released),           both classifiers enqueued
               host pack                       on the compute stream;
                                               block on chunk k-1's
                                               verdict tensors, convert

- **Host stage** (``produce``): substrates come cache-first (the
  ``.jtc`` or legacy npz, ``history/rows.py``), then from the native
  multi-file packer (``history/fastpack.py``), then from the Python
  packer, which raises the canonical error.  Each chunk is packed on
  the host with power-of-two ``L`` and ``V`` and padded to the chunk
  size with empty histories, so a bucket keeps one shape.
- **Staging stage** (``place``): the four check columns through the
  pinned ring of ``parallel/staging.py``; on the CPU, nothing to do.
- **Check stage** (``check``): ``combined_tensor_check(...,
  packed_out=True)``: the per-value stats kernel K1 and both
  classifiers, enqueued without a host sync.  At most ``depth``
  batches are in flight; the executor blocks only in ``collect`` (the
  verdict tensors' copy to the host), on the oldest batch.

Failure isolation is elastic by default: a chunk whose produce, place,
check or collect raises is retried once, then quarantined and re-run
history by history, so one poison history cannot condemn its
chunk-mates; a history that still fails reports ``unknown`` with the
captured exception as evidence, and every other verdict survives.
``fail_fast=True`` aborts the whole run with :class:`PipelineError` on
any stage failure, and no verdict escapes.  Either way a fault of the
card or of K1 (:data:`~jepsen_tpu_torch.device.DEVICE_FAULTS`: a build
or launch failure, a CUDA error) raises as it is: it is not the data's,
and is never quarantined into ``unknown``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.checkers.protocol import UNKNOWN, VALID
from jepsen_tpu_torch.device import DEVICE_FAULTS, DeviceFault
from jepsen_tpu_torch.obs import metrics as obs_metrics
from jepsen_tpu_torch.obs import trace as obs_trace

#: histories per pipeline chunk
DEFAULT_CHUNK = 64

#: where each family that is not ported yet stands in ROADMAP.md
NOT_PORTED = {
    "stream": "Open items §1, item 6 (stream family)",
    "elle": "Open items §1, item 7 (elle family)",
    "mutex": "Open items §1, item 8 (WGL / mutex family)",
}
MULTI_NOT_PORTED = "Open items §1, item 9 (multi-GPU and multi-process)"


class PipelineError(RuntimeError):
    """A pipeline stage crashed; no verdicts were emitted (the
    ``fail_fast=True`` contract; elastic runs quarantine instead)."""


def _scrub_exc(e):
    """Drop the frame locals of a kept exception's traceback chain: the
    stage frames hold whole packed batches, and the evidence only ever
    formats the exceptions."""
    seen: set[int] = set()
    cur = e if isinstance(e, BaseException) else None
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        try:
            traceback.clear_frames(cur.__traceback__)
        except RuntimeError:  # a frame still executing cannot be cleared
            pass
        cur = cur.__cause__ or cur.__context__
    return e


class Quarantined:
    """The collected result of a work unit (or one history) whose stage
    failures outlasted the retry: it carries the evidence in the unit's
    result slot, and ``check_sources`` turns it into ``unknown``
    verdicts with that evidence."""

    __slots__ = ("index", "stage", "attempts", "errors")

    def __init__(self, index: int, stage: str, attempts, errors):
        self.index = index
        self.stage = stage
        self.attempts = list(attempts)
        self.errors = [_scrub_exc(e) for e in errors]

    def evidence(self) -> dict:
        return {
            "stage": self.stage,
            "attempts": self.attempts,
            "errors": [f"{type(e).__name__}: {e}" for e in self.errors],
        }


def _counter_field(name: str, cast=int, **labels):
    """A :class:`PipelineStats` attribute backed by its run's registry:
    the stats object is a view, the registry is the storage."""

    def get(self):
        return cast(self.metrics.value(name, **labels))

    def set(self, v):
        self.metrics.counter(name, **labels).set(v)

    return property(get, set)


class PipelineStats:
    """The executor's timing evidence, a view over a run-scoped metrics
    registry (``self.metrics``, ``obs/metrics.py``), as in the JAX
    package.  Every field but the two derived fractions is a counter
    there; :meth:`add_busy` is the one accounting point of stage time,
    and mirrors it into the process-global ``REGISTRY`` with each batch's
    check time in the ``pipeline.check_batch_s`` sketch.

    ``*_busy_s``: seconds each stage was busy (the check stage counts
    from a batch's dispatch, or the previous batch's completion if
    later, to its collection).  ``stage_overlap_frac``: the share of
    the summed stage busy time that ran concurrently with another stage
    (0 for a serial run).  ``device_idle_frac``: the share of wall time
    with no batch in flight, that is dispatched and not yet collected (a
    batch whose device work has ended counts until it is collected).
    ``quarantined`` counts histories, ``unit_retries`` retried stages;
    ``lanes`` and ``dropped`` belong to the multi-lane executor, which is
    not ported (always 1 and 0)."""

    def __init__(self):
        self.metrics = obs_metrics.Registry()
        self.lanes = 1
        self.wall_s = 0.0
        self.stage_overlap_frac = 0.0
        self.device_idle_frac = 0.0

    batches = _counter_field("pipeline.batches")
    histories = _counter_field("pipeline.histories")
    dropped = _counter_field("pipeline.files_dropped")
    quarantined = _counter_field("pipeline.quarantined")
    unit_retries = _counter_field("pipeline.unit_retries")
    produce_busy_s = _counter_field(
        "pipeline.stage_busy_s", cast=float, stage="produce")
    place_busy_s = _counter_field(
        "pipeline.stage_busy_s", cast=float, stage="place")
    check_busy_s = _counter_field(
        "pipeline.stage_busy_s", cast=float, stage="check")

    def add_busy(self, stage: str, t0: float, t1: float) -> None:
        """Count ``t1 - t0`` seconds (``time.perf_counter()``) of
        ``stage`` (``produce``, ``place`` or ``check``) in this run and
        in the global registry, and record the stage as a trace span
        when the tracer is on."""
        dt = t1 - t0
        self.metrics.counter("pipeline.stage_busy_s", stage=stage).inc(dt)
        obs_metrics.REGISTRY.counter(
            "pipeline.stage_busy_s", stage=stage).inc(dt)
        if stage == "check":
            self.metrics.sketch("pipeline.check_batch_s").add(dt)
            obs_metrics.REGISTRY.sketch("pipeline.check_batch_s").add(dt)
        obs_trace.complete(f"pipeline.{stage}", t0, t1)

    def run_stage(self, stage: str, fn, arg):
        """``fn(arg)``, counted as busy time of ``stage``."""
        t0 = time.perf_counter()
        out = fn(arg)
        self.add_busy(stage, t0, time.perf_counter())
        return out

    def note_retry(self) -> None:
        self.metrics.counter("pipeline.unit_retries").inc()
        obs_metrics.REGISTRY.counter("pipeline.unit_retries").inc()

    def note_quarantine(self, evidence: dict, histories: int = 1) -> None:
        """``histories`` final quarantined verdicts, counted per history
        here and in the global registry, and a trace event with the
        evidence when the tracer is on."""
        self.metrics.counter("pipeline.quarantined").inc(histories)
        obs_metrics.REGISTRY.counter("pipeline.quarantined").inc(histories)
        if obs_trace.is_enabled():
            obs_trace.event("checker.quarantine",
                            args={"histories": histories, **evidence})

    def check_batch_quantile(self, q: float) -> float:
        return self.metrics.sketch("pipeline.check_batch_s").quantile(q)

    def finalize(self) -> "PipelineStats":
        busy = self.produce_busy_s + self.place_busy_s + self.check_busy_s
        self.stage_overlap_frac = (
            max(0.0, busy - self.wall_s) / busy if busy > 0 else 0.0
        )
        budget = self.wall_s * max(self.lanes, 1)
        self.device_idle_frac = (
            max(0.0, budget - self.check_busy_s) / budget
            if budget > 0
            else 0.0
        )
        return self


_STOP = object()
_UNSET = object()


class _Crash:
    def __init__(self, index: int, exc: BaseException):
        self.index = index
        self.exc = exc


class _Poison:
    """Producer → consumer marker (elastic mode): item ``index``'s
    produce stage failed past its retry."""

    def __init__(self, index: int, stage: str, errors):
        self.index = index
        self.stage = stage
        self.errors = list(errors)


def _to_host(raw):
    """A result tree with every tensor copied to the host (blocking on
    the device work that makes it)."""
    if isinstance(raw, torch.Tensor):
        return raw.cpu()
    if isinstance(raw, (tuple, list)):
        return type(raw)(_to_host(x) for x in raw)
    if dataclasses.is_dataclass(raw) and not isinstance(raw, type):
        return dataclasses.replace(raw, **{
            f.name: _to_host(getattr(raw, f.name))
            for f in dataclasses.fields(raw)
            if isinstance(getattr(raw, f.name), torch.Tensor)
        })
    return raw


def run_pipeline(
    items: Sequence[Any],
    produce: Callable[[Any], Any],
    check: Callable[[Any], Any],
    *,
    place: Callable[[Any], Any] | None = None,
    collect: Callable[[Any], Any] | None = None,
    depth: int = 2,
    fail_fast: bool = False,
) -> tuple[list[Any], PipelineStats]:
    """Run ``items`` through produce → place → check with overlap.

    ``produce(item)`` runs on the producer thread; ``place(host)``
    (default: as it is) and ``check(placed)`` on the caller's thread.
    ``check`` must only enqueue device work; the executor blocks on the
    oldest in-flight result in ``collect(raw)`` (default: every tensor
    copied to the host), keeping at most ``depth`` outstanding.

    Returns ``(results, stats)``, one collected result per item, in
    order.  By default a stage exception on item k is retried once, then
    item k's slot holds a :class:`Quarantined` and every other item
    completes; ``fail_fast=True`` raises :class:`PipelineError` on any
    stage exception, with no results.
    """
    if place is None:
        place = lambda host: host  # noqa: E731
    if collect is None:
        collect = _to_host
    stats = PipelineStats()
    n = len(items)
    if n == 0:
        return [], stats
    t_start = time.perf_counter()
    results: list[Any] = [None] * n
    run = _run_pipeline_failfast if fail_fast else _run_pipeline_elastic
    run(items, produce, check, place, collect, depth, stats, results, t_start)
    stats.batches = n
    stats.wall_s = time.perf_counter() - t_start
    return results, stats.finalize()


def _bounded_put(q: queue.Queue, abort: threading.Event, obj) -> None:
    """Put ``obj`` unless the run was aborted: a crashed consumer can
    never wedge the producer behind a full queue."""
    while not abort.is_set():
        try:
            q.put(obj, timeout=0.1)
            return
        except queue.Full:
            continue


def _run_pipeline_failfast(
    items, produce, check, place, collect, depth, stats, results, t_start
) -> None:
    """The abort-all executor: any stage exception raises
    :class:`PipelineError`, and no partial result escapes."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    abort = threading.Event()

    def producer() -> None:
        i = 0
        try:
            for i, item in enumerate(items):
                if abort.is_set():
                    return
                host = stats.run_stage("produce", produce, item)
                _bounded_put(q, abort, (i, host))
            _bounded_put(q, abort, _STOP)
        except BaseException as e:  # noqa: BLE001 - re-raised by consumer
            _bounded_put(q, abort, _Crash(i, e))

    prod = threading.Thread(
        target=producer, name="pipeline-producer", daemon=True
    )
    prod.start()

    in_flight: list[tuple[int, Any, float]] = []  # (index, raw, dispatch_t)
    last_ready = t_start

    def drain_one() -> None:
        nonlocal last_ready
        i, raw, t_disp = in_flight.pop(0)
        results[i] = collect(raw)
        t_ready = time.perf_counter()
        # the interval this batch had the device, after the previous one
        stats.add_busy("check", max(t_disp, last_ready), t_ready)
        last_ready = t_ready

    try:
        while True:
            got = q.get()
            if got is _STOP:
                break
            if isinstance(got, _Crash):
                raise PipelineError(
                    f"pipeline produce stage crashed on batch "
                    f"{got.index}: {type(got.exc).__name__}: {got.exc}"
                ) from got.exc
            i, host = got
            placed = stats.run_stage("place", place, host)
            t_disp = time.perf_counter()
            raw = check(placed)
            in_flight.append((i, raw, t_disp))
            del placed
            while len(in_flight) >= max(1, depth):
                drain_one()
        while in_flight:
            drain_one()
    except (PipelineError, *DEVICE_FAULTS):
        abort.set()
        raise
    except Exception as e:
        abort.set()
        raise PipelineError(
            f"pipeline check stage crashed: {type(e).__name__}: {e}"
        ) from e
    finally:
        abort.set()
        prod.join(timeout=10.0)


def _run_pipeline_elastic(
    items, produce, check, place, collect, depth, stats, results, t_start
) -> None:
    """Work-unit failure isolation: a failing stage is retried once in
    place, then the item quarantines and every other item's verdict
    survives."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    abort = threading.Event()

    def producer() -> None:
        i = 0
        try:
            for i, item in enumerate(items):
                if abort.is_set():
                    return
                errors: list[BaseException] = []
                host = _UNSET
                for attempt in range(2):
                    try:
                        host = stats.run_stage("produce", produce, item)
                        break
                    except Exception as e:
                        errors.append(e)
                        if attempt == 0:
                            stats.note_retry()
                if host is _UNSET:
                    _bounded_put(q, abort, _Poison(i, "produce", errors))
                else:
                    _bounded_put(q, abort, (i, host))
            _bounded_put(q, abort, _STOP)
        except BaseException as e:  # noqa: BLE001 - re-raised by consumer
            # interrupts and exits are not quarantined: crash loud
            _bounded_put(q, abort, _Crash(i, e))

    prod = threading.Thread(
        target=producer, name="pipeline-producer", daemon=True
    )
    prod.start()

    in_flight: list[tuple[int, Any, float]] = []
    last_ready = t_start

    def drain_one() -> None:
        nonlocal last_ready
        i, raw, t_disp = in_flight.pop(0)
        errors: list[BaseException] = []
        got = _UNSET
        for attempt in range(2):
            try:
                # a device error surfaces here, where the work is awaited
                got = collect(raw)
                break
            except DEVICE_FAULTS:
                raise
            except Exception as e:
                errors.append(e)
                if attempt == 0:
                    stats.note_retry()
                    # the failed result cannot be collected again: the one
                    # retry re-runs the whole chain from items[i]
                    try:
                        raw = check(
                            stats.run_stage(
                                "place",
                                place,
                                stats.run_stage("produce", produce, items[i]),
                            )
                        )
                    except DEVICE_FAULTS:
                        raise
                    except Exception as e2:
                        errors.append(e2)
                        break
        if got is _UNSET:
            results[i] = Quarantined(i, "collect", ["main"], errors)
            last_ready = time.perf_counter()
            return
        results[i] = got
        t_ready = time.perf_counter()
        stats.add_busy("check", max(t_disp, last_ready), t_ready)
        last_ready = t_ready

    try:
        while True:
            got = q.get()
            if got is _STOP:
                break
            if isinstance(got, _Crash):
                raise PipelineError(
                    f"pipeline produce stage crashed on batch "
                    f"{got.index}: {type(got.exc).__name__}: {got.exc}"
                ) from got.exc
            if isinstance(got, _Poison):
                results[got.index] = Quarantined(
                    got.index, got.stage, ["producer"], got.errors
                )
                continue
            i, host = got
            errors = []
            raw = _UNSET
            stage = "place"
            for attempt in range(2):
                try:
                    stage = "place"
                    placed = stats.run_stage("place", place, host)
                    stage = "check"
                    t_disp = time.perf_counter()
                    raw = check(placed)
                    break
                except DEVICE_FAULTS:
                    raise
                except Exception as e:
                    errors.append(e)
                    if attempt == 0:
                        stats.note_retry()
            if raw is _UNSET:
                results[i] = Quarantined(i, stage, ["main"], errors)
                continue
            in_flight.append((i, raw, t_disp))
            del placed
            while len(in_flight) >= max(1, depth):
                drain_one()
        while in_flight:
            drain_one()
    finally:
        abort.set()
        prod.join(timeout=10.0)


def _pow2_bucket(n: int, floor: int = 128) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


class BucketStagingRing:
    """The service batcher's staging for one coalescing bucket ``(L, V)``:
    ``depth`` recycled host slots at ``[batch, L]`` in K1's own dtypes
    (int8 ``f``/``typ``, int16 ``val`` or int32 where ``V`` exceeds
    32,767, int32 ``pos``, bool ``mask``) and a ``[6, batch, V]`` int32
    buffer for the stat planes, so that dispatch allocates no host memory
    in steady state.  The counterpart of the JAX package's
    ``parallel/pipeline.py::StagingRing`` (:class:`StagingRing` of
    ``parallel/staging.py`` is the executor's, another ring).

    The dispatcher acquires a slot, fills it and launches
    (:func:`dispatch_coalesced`); the collector waits on the slot's
    event, reads the stat planes and only then releases it, so a slot is never refilled while a launch could still read it,
    and the device tensors of the launch stay referenced by the slot
    until then.  On a CUDA device the slots are pinned, and a ring that
    cannot pin raises."""

    def __init__(self, batch: int, length: int, value_space: int,
                 device, depth: int = 2):
        from jepsen_tpu_torch.checkers.segmented import local_id_dtype

        self.batch, self.length = batch, length
        pin = torch.device(device).type == "cuda"
        val = torch.from_numpy(np.zeros(0, local_id_dtype(value_space))).dtype

        def host(shape, dtype, fill=0):
            t = torch.full(shape, fill, dtype=dtype, pin_memory=pin)
            if pin and not t.is_pinned():
                raise RuntimeError("could not allocate page-locked host "
                                   "memory for the batcher's staging ring")
            return t

        self._free: queue.Queue = queue.Queue()
        for _ in range(max(1, depth)):
            shape = (batch, length)
            self._free.put({
                "f": host(shape, torch.int8, -1),
                "typ": host(shape, torch.int8, -1),
                "val": host(shape, val),
                "pos": host(shape, torch.int32),
                "mask": host(shape, torch.bool),
                "out": host((6, batch, value_space), torch.int32),
                "event": torch.cuda.Event() if pin else None,
                "inflight": None,
            })

    def acquire(self, timeout: float | None = None):
        try:
            return self._free.get(timeout=timeout)
        except queue.Empty:
            return None

    def release(self, slot) -> None:
        slot["inflight"] = None  # the launch's device tensors may go now
        self._free.put(slot)

    def fill(self, slot, preps) -> None:
        """Copy ``len(preps)`` prepared segments of this bucket into the
        slot's rows; the rows past them are masked out, so every launch
        runs at the one ``[batch, L]`` shape."""
        cols = {k: slot[k].numpy() for k in ("f", "typ", "val", "pos",
                                              "mask")}
        n = len(preps)
        for i, p in enumerate(preps):
            for k, c in cols.items():
                c[i] = p[k]
        cols["mask"][n:] = False


#: the host columns of a ring slot, in the order K1's program takes them
_SLOT_COLUMNS = ("f", "typ", "val", "pos", "mask")


def dispatch_coalesced(slot, V: int, stream=None) -> None:
    """Launch one filled ring slot: each host plane copied to the ring's
    device with ``non_blocking=True`` on ``stream`` (the batcher's own
    CUDA stream), K1 on the ``[batch, L]`` stacks with ``[batch, L]`` pos
    (:func:`~jepsen_tpu_torch.checkers.segmented.seg_queue_batch_program`),
    the six ``[batch, V]`` stat planes copied back into the slot's pinned
    ``out``, and an event recorded after them.  Nothing waits: the
    collector waits on ``slot["event"]`` before it reads ``out``.  On the
    CPU the same calls run synchronously and there is no event."""
    from jepsen_tpu_torch.checkers.segmented import seg_queue_batch_program

    dev = slot["f"].device if stream is None else stream.device
    ctx = torch.cuda.stream(stream) if stream is not None else (
        contextlib.nullcontext())
    with ctx:
        cols = [slot[k].to(dev, non_blocking=True) for k in _SLOT_COLUMNS]
        planes = seg_queue_batch_program(*cols, V)
        for k, plane in enumerate(planes):
            slot["out"][k].copy_(plane, non_blocking=True)
        if slot["event"] is not None:
            slot["event"].record(stream)
    slot["inflight"] = (cols, planes)


def _chunks(seq: Sequence[Any], size: int) -> list[Sequence[Any]]:
    size = max(1, size)
    return [seq[i : i + size] for i in range(0, len(seq), size)]


def _pad_chunk(subs: list, n: int, sentinel) -> list:
    """Pad a short (tail) chunk up to ``n`` with sentinel substrates, so
    that every chunk of a bucket has one batch shape; ``convert`` trims
    the pad by the true chunk length."""
    if len(subs) < n:
        subs = list(subs) + [sentinel] * (n - len(subs))
    return subs


# ---------------------------------------------------------------------------
# The queue family: history files (or row matrices) -> verdict maps.
# ---------------------------------------------------------------------------


def _queue_substrates(
    paths: Sequence[Path], threads: int, use_cache: bool
) -> list[np.ndarray]:
    """``[n, 8]`` row matrices of ``paths``: cache, then the native
    packer, then the Python packer.  ``use_cache=False`` parses every
    file and writes no cache."""
    from jepsen_tpu_torch.history.fastpack import pack_files
    from jepsen_tpu_torch.history.rows import (
        _rows_for,
        load_rows_cache,
        rows_with_cache,
        save_rows_cache,
    )
    from jepsen_tpu_torch.history.store import read_history

    out: list = [None] * len(paths)
    misses = []
    for j, p in enumerate(paths):
        got = load_rows_cache(p) if use_cache else None
        if got is not None:
            out[j] = got[1]
        else:
            misses.append(j)
    if misses:
        native = pack_files([paths[j] for j in misses], threads,
                            use_jtc=use_cache)
        for j, got in zip(misses, native):
            if got is not None:
                if use_cache:
                    save_rows_cache(paths[j], got[0], got[1])
                out[j] = got[1]
            elif use_cache:
                # input the C parser flagged: the Python path raises the
                # canonical error, or packs what it accepts
                out[j] = rows_with_cache(paths[j])[1]
            else:
                out[j] = _rows_for(read_history(paths[j]))
    return out


@dataclass
class _Family:
    produce: Callable[[Any], Any]
    check: Callable[[Any], Any]
    place: Callable[[Any], Any]
    convert: Callable[[Any, Any], list[dict]]  # (chunk_item, collected)
    collect: Callable[[Any], Any]


def _queue_family(
    threads: int,
    use_cache: bool,
    delivery: str,
    chunk_pad: int = 0,
    device: str | torch.device = "cuda",
    depth: int = 2,
) -> _Family:
    from jepsen_tpu_torch.checkers.fused import (
        combined_tensor_check,
        queue_results,
    )
    from jepsen_tpu_torch.checkers.queue_lin import DELIVERIES
    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.history.encode import pack_row_matrices
    from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats
    from jepsen_tpu_torch.parallel.staging import StagingRing

    if delivery not in DELIVERIES:
        raise ValueError(f"unknown delivery contract {delivery!r}")
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        ring = StagingRing(dev, depth)
        # the caller's thread enqueues the check; name its stream
        compute = torch.cuda.current_stream(dev)

    def produce(chunk):
        if chunk and isinstance(chunk[0], (str, Path)):
            mats = _queue_substrates(chunk, threads, use_cache)
        else:
            mats = list(chunk)
        mats = _pad_chunk(mats, chunk_pad, np.zeros((0, 8), np.int32))
        n_max = max(m.shape[0] for m in mats)
        vmax = max(
            (int(m[:, 4].max(initial=0)) for m in mats if m.shape[0]),
            default=0,
        )
        return pack_row_matrices(
            mats,
            length=_pow2_bucket(max(n_max, 1)),
            value_space=_pow2_bucket(vmax + 1),
            device="cpu",
        )

    def place(packed):
        return ring.stage(packed, compute) if on_card else packed

    def check(packed):
        if not on_card:
            return combined_tensor_check(packed, delivery, packed_out=True)
        with torch.cuda.stream(compute):
            out = combined_tensor_check(packed, delivery, packed_out=True)
        # power-of-two L and V and fresh device columns: K1's vector path
        if fused_queue_stats.last_path != "vector":
            raise DeviceFault(
                f"K1 took its {fused_queue_stats.last_path} path on a "
                f"pipeline batch of shape {tuple(packed.f.shape)}")
        return out

    def collect(raw):
        if not on_card:
            return _to_host(raw)
        with torch.cuda.stream(compute):
            return _to_host(raw)

    def convert(item, collected):
        # the pad of a tail chunk is trimmed here
        return queue_results(*collected, delivery, len(item))

    return _Family(produce, check, place, convert, collect)


def family_for(workload: str, **opts) -> _Family:
    """The pipeline family of ``workload``.  Only ``queue`` is ported;
    the other families raise, naming their ROADMAP.md item."""
    if workload == "queue":
        return _queue_family(
            opts.get("threads", 0),
            opts.get("use_cache", True),
            opts.get("delivery", "exactly-once"),
            chunk_pad=opts.get("chunk_pad", 0),
            device=opts.get("device", "cuda"),
            depth=opts.get("depth", 2),
        )
    if workload in NOT_PORTED:
        raise NotImplementedError(
            f"the {workload} pipeline family is not ported yet "
            f"(ROADMAP.md {NOT_PORTED[workload]})")
    raise ValueError(f"no pipeline family for workload {workload!r}")


class _SalvagedUnit:
    """A quarantined unit after per-history isolation: one
    ``(single_item_unit, collected_or_Quarantined)`` pair per member, in
    unit order."""

    def __init__(self, members):
        self.members = members


def _salvage_unit(fam: _Family, unit, q: Quarantined) -> _SalvagedUnit:
    """Re-run each member of a quarantined unit alone through produce →
    place → check → collect (a chunk of one, padded to the bucket's
    batch shape); members that still fail quarantine with both the
    unit's and their own evidence."""
    members = []
    for j in range(len(unit)):
        sub = [unit[j]]
        stage = "produce"
        try:
            host = fam.produce(sub)
            stage = "place"
            placed = fam.place(host)
            stage = "check"
            raw = fam.check(placed)
            stage = "collect"
            col = fam.collect(raw)
        except DEVICE_FAULTS:
            raise
        except Exception as e:
            members.append((sub, Quarantined(
                q.index, stage, q.attempts + ["salvage"], q.errors + [e])))
            continue
        members.append((sub, col))
    return _SalvagedUnit(members)


def _resolve_quarantines(
    fam: _Family, items, collected, stats: PipelineStats
) -> list:
    """Elastic post-pass: isolate every quarantined unit per history
    and count the final per-history quarantines."""
    out = list(collected)
    for k, col in enumerate(out):
        if not isinstance(col, Quarantined):
            continue
        salvaged = _salvage_unit(fam, items[k], col)
        n_q = sum(
            1 for _s, c in salvaged.members if isinstance(c, Quarantined)
        )
        if n_q:
            stats.note_quarantine(col.evidence(), histories=n_q)
        out[k] = salvaged
    return out


def _quarantined_result(workload: str, evidence: dict) -> dict:
    """The ``unknown`` verdict, with evidence, of a quarantined history:
    one entry per source, which can never compose into valid."""
    errs = evidence.get("errors") or ["?"]
    row = {
        VALID: UNKNOWN,
        "error": f"quarantined at {evidence.get('stage')}: {errs[-1]}",
        "quarantined": dict(evidence),
    }
    if workload == "queue":
        return {"queue": dict(row), "linear": dict(row)}
    return {workload: dict(row)}


def _convert_unit(
    fam: _Family, workload: str, unit, col, stats: PipelineStats,
    fail_fast: bool,
) -> list[dict]:
    """One unit's collected result → per-history result maps.  A
    salvaged unit converts member by member; a crash of ``convert``
    quarantines the unit's histories unless ``fail_fast``."""
    if isinstance(col, _SalvagedUnit):
        out = []
        for sub, sub_col in col.members:
            if isinstance(sub_col, Quarantined):
                out.append(_quarantined_result(workload, sub_col.evidence()))
            else:
                out.extend(_convert_unit(
                    fam, workload, sub, sub_col, stats, fail_fast))
        return out
    if fail_fast:
        return fam.convert(unit, col)
    try:
        return fam.convert(unit, col)
    except Exception as e:
        q = Quarantined(-1, "convert", ["main"], [e])
        stats.note_quarantine(q.evidence(), histories=len(unit))
        return [_quarantined_result(workload, q.evidence()) for _ in unit]


def check_sources(
    workload: str,
    sources: Sequence[Any],
    *,
    chunk: int = DEFAULT_CHUNK,
    serial: bool = False,
    depth: int = 2,
    lanes: int | None = None,
    reduce: bool = False,
    fail_fast: bool = False,
    **opts,
) -> tuple[list[dict], PipelineStats]:
    """Bytes-to-verdict over ``sources`` (history file paths, or
    ``[n, 8]`` row matrices) through the pipeline executor.

    Returns ``(results, stats)``: one ``{"queue": …, "linear": …}``
    result map per source, in order, equal to the serial checkers'.
    ``serial=True`` runs the same stages one after another on the
    calling thread (the triage path; it always fails fast).  ``opts``:
    ``delivery``, ``device`` (default ``"cuda"``, which raises without a
    card), ``threads`` (native packer threads, 0: one per core) and
    ``use_cache``.  ``lanes``, ``reduce`` and ``mesh`` belong to the
    multi-device executor, which is not ported: they raise."""
    if lanes is not None or reduce or opts.get("mesh") is not None:
        raise NotImplementedError(
            "lanes, mesh and reduce are not ported yet "
            f"(ROADMAP.md {MULTI_NOT_PORTED})")
    opts.setdefault("chunk_pad", chunk)
    fam = family_for(workload, depth=depth, **opts)
    items = _chunks(list(sources), chunk)
    if serial:
        stats = PipelineStats()
        t0 = time.perf_counter()
        collected = []
        for it in items:
            host = stats.run_stage("produce", fam.produce, it)
            placed = stats.run_stage("place", fam.place, host)
            collected.append(stats.run_stage(
                "check", lambda p: fam.collect(fam.check(p)), placed))
        stats.batches = len(items)
        stats.wall_s = time.perf_counter() - t0
        stats.finalize()
    else:
        collected, stats = run_pipeline(
            items, fam.produce, fam.check, place=fam.place,
            collect=fam.collect, depth=depth, fail_fast=fail_fast,
        )
        if not fail_fast:
            collected = _resolve_quarantines(fam, items, collected, stats)
    results: list[dict] = []
    for it, col in zip(items, collected):
        results.extend(
            _convert_unit(fam, workload, it, col, stats, fail_fast or serial))
    stats.histories = len(results)
    return results, stats


class PipelinedChecker:
    """Checker-protocol adapter for ``check``: the family's verdict
    computed from the history file through the pipeline (cache-first
    substrate, device check), not from re-packed ``Op`` objects.  One
    run serves every sub-checker of the family through ``shared`` (the
    queue family answers as ``queue`` and ``linear``).

    With ``path=None`` (no stored history), :meth:`_from_ops` checks
    the in-memory ops through the same stages and conversion."""

    def __init__(self, workload: str, path, subkey: str, **opts):
        self.workload = workload
        self.path = path
        self.subkey = subkey
        self.name = subkey
        self._opts = dict(opts)
        self._shared = self._opts.pop("shared", None)

    def check(self, test, history, opts=None):
        if self._shared is not None and self.workload in self._shared:
            return self._shared[self.workload][0][self.subkey]
        if self.path is not None:
            results, _ = check_sources(
                self.workload, [self.path], chunk=1, **self._opts)
        else:
            results = self._from_ops(history)
        if self._shared is not None:
            self._shared[self.workload] = results
        return results[0][self.subkey]

    def _from_ops(self, history):
        if self.workload != "queue":
            family_for(self.workload)  # raises, naming its ROADMAP item
        from jepsen_tpu_torch.history.rows import _rows_for

        results, _ = check_sources(
            self.workload, [_rows_for(history)], chunk=1, serial=True,
            **self._opts)
        return results


# ---------------------------------------------------------------------------
# segment-producer mode
# ---------------------------------------------------------------------------


def check_source_segmented(
    workload: str | None,
    src,
    *,
    segment_ops: int,
    resume: bool = False,
    device: str | torch.device = "cuda",
    prefix_index=None,
    **opts,
) -> tuple[dict, PipelineStats]:
    """The pipeline's segment-producer mode: one history streamed through
    the segmented carry engine (``checkers/segmented.py``) in fixed-count
    segments, with bounded memory whatever the history's length, a
    durable checkpoint after each segment, and ``resume=True`` to go on
    from the last one, ``prefix_index`` to publish and resume from fleet
    prefix anchors.  Each segment's check time lands in the global
    registry's ``segmented.segment_check_s`` sketch, and the returned
    :class:`PipelineStats` counts the segments as checked batches."""
    from jepsen_tpu_torch.checkers.segmented import segmented_check_file

    stats = PipelineStats()
    t0 = time.perf_counter()
    before = obs_metrics.REGISTRY.value("segmented.segments")
    result = segmented_check_file(
        src,
        workload=workload,
        segment_ops=segment_ops,
        opts={k: v for k, v in opts.items() if v is not None},
        resume=resume,
        device=device,
        prefix_index=prefix_index,
    )
    t1 = time.perf_counter()
    stats.histories = 1
    stats.batches = int(
        obs_metrics.REGISTRY.value("segmented.segments") - before)
    stats.add_busy("check", t0, t1)
    return result, stats
