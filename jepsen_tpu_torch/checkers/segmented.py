"""Segmented checking of long queue histories: bounded memory, durable
checkpoints, verdicts equal to the monolithic check.

The port's counterpart of the queue family of the JAX package's
``checkers/segmented.py``.  A recorded history streams through the
checker one fixed-count segment at a time (``history/segments.py``, or
slices of the mmap'd ``.jtc`` rows), and only a compact residue crosses
a segment boundary:

- each segment's per-value stats ``(a, e, x, d, s, t)`` come off the
  stats kernel K1 (``ops/queue_stats.py``: ``csrc/queue_stats.cu`` on a
  CUDA device, its plain version on the CPU), with the segment's values
  renamed to dense local ids (so the value space is bounded by the
  segment, not the history) and the global op index as the position;
- they merge into a residue of open values (:class:`QueueCarry`).  A
  value with one attempted, acknowledged, read-once, never-failed life
  (``a=e=d=1, x=0, t>=s``) settles to one presence bit; a later op on it
  reopens it with exact deltas.  So verdicts equal the monolithic
  check's while the carry grows with the in-flight set, not the history.

Checkpoints make the carry durable: after each segment the checker
writes ``(segment_idx, carry, partial verdict, source sha256 + offset)``,
CRC'd, temp → fsync → rename, keeping the previous one as ``.prev``.  A
killed check resumes from the last checkpoint to the same verdict; a
torn or corrupt checkpoint is refused loudly and the previous one (or a
run from scratch) takes over.  The checkpoint format is the JAX
package's, byte for byte, so either package resumes the other's.

Precedence: invalid trumps all, but a poisoned segment (a line that does
not parse, a position int32 cannot hold) quarantines the verdicts as
unknown with evidence, which never folds into valid.  A fault of the
card or of K1 (a build failure, a launch failure, a CUDA error) is not a
fault of the data: it raises (:data:`~jepsen_tpu_torch.device.DEVICE_FAULTS`,
:class:`DeviceError`) and is never quarantined into an unknown verdict.

``device`` is a torch device: ``"cuda"`` by default, ``"cpu"`` runs K1's
plain version.  :func:`_queue_segment_stats_np` is the numpy twin of the
stats that the tests hold both against.  Only the queue family is
ported: the stream, elle and mutex carries come with those families.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.checkers.protocol import UNKNOWN, VALID, merge_valid
from jepsen_tpu_torch.device import DEVICE_FAULTS, DeviceFault
from jepsen_tpu_torch.history.ops import NO_VALUE, Op, OpF, OpType, workload_of
from jepsen_tpu_torch.history.segments import (
    SegmentPoisonError,
    iter_segments,
    prefix_sha256,
)
from jepsen_tpu_torch.obs import trace as obs_trace
from jepsen_tpu_torch.obs.metrics import REGISTRY

logger = logging.getLogger(__name__)

_INF = 2**31 - 1

#: default ops per segment
DEFAULT_SEGMENT_OPS = 65536

#: crash hook of the resume proofs: die (exit 137, the SIGKILL status)
#: right after checkpointing this segment index
DIE_AFTER_ENV = "JEPSEN_TPU_SEG_DIE_AFTER"

WORKLOADS = ("queue", "stream", "elle", "mutex")


class DeviceError(DeviceFault):
    """The stats stage failed on the device (K1's build or launch, a CUDA
    error): a fault of the checker, never quarantined as the data's."""


def _refuse_workload(workload: str) -> None:
    from jepsen_tpu_torch.parallel.pipeline import NOT_PORTED

    if workload == "queue":
        return
    if workload in NOT_PORTED:
        raise NotImplementedError(
            f"the segmented {workload} carry is not ported yet "
            f"(ROADMAP.md, {NOT_PORTED[workload]})")
    raise ValueError(f"unknown workload {workload!r}; one of {WORKLOADS}")


def _pow2ceil(n: int, floor: int = 128) -> int:
    out = floor
    while out < n:
        out *= 2
    return out


# ---------------------------------------------------------------------------
# queue family: set-reconciliation residue
# ---------------------------------------------------------------------------


class _Bitmap:
    """Growable packed presence bits over the dense value space: the
    one-bit-per-settled-value half of the queue residue."""

    def __init__(self, data: bytes = b"", nbits: int = 0):
        self._arr = np.frombuffer(data, dtype=np.uint8).copy() if data else (
            np.zeros(128, dtype=np.uint8)
        )
        self.nbits = nbits

    def _grow(self, v: int) -> None:
        need = v // 8 + 1
        if need > self._arr.shape[0]:
            arr = np.zeros(max(need, 2 * self._arr.shape[0]), np.uint8)
            arr[: self._arr.shape[0]] = self._arr
            self._arr = arr

    def test(self, v: int) -> bool:
        if v < 0 or v // 8 >= self._arr.shape[0]:
            return False
        return bool(self._arr[v // 8] & (1 << (v % 8)))

    def set(self, v: int) -> None:
        self._grow(v)
        self._arr[v // 8] |= np.uint8(1 << (v % 8))
        if v >= self.nbits:
            self.nbits = v + 1

    def nbytes(self) -> int:
        return int(self._arr.nbytes)

    def state(self) -> dict:
        used = (self.nbits + 7) // 8
        return {
            "bits": base64.b64encode(
                self._arr[:used].tobytes()
            ).decode("ascii"),
            "nbits": self.nbits,
        }

    @classmethod
    def from_state(cls, d: dict) -> "_Bitmap":
        return cls(base64.b64decode(d["bits"]), int(d["nbits"]))


def _queue_segment_stats_np(rows: np.ndarray, pos: np.ndarray):
    """The numpy host twin of the device stats: per unique value
    ``(vals, a, e, x, d, s, t)`` over one segment's exploded rows."""
    f = rows[:, 3]
    typ = rows[:, 2]
    val = rows[:, 4].astype(np.int64)
    has = val >= 0
    is_enq = (f == int(OpF.ENQUEUE)) & has
    is_read = (
        ((f == int(OpF.DEQUEUE)) | (f == int(OpF.DRAIN)))
        & has
        & (typ == int(OpType.OK))
    )
    rel = is_enq | is_read
    if not rel.any():
        z = np.zeros(0, np.int64)
        return z, z, z, z, z, z, z
    vals = val[rel]
    u, inv = np.unique(vals, return_inverse=True)
    n = len(u)

    def count(mask):
        m = mask[rel]
        return np.bincount(inv[m], minlength=n).astype(np.int64)

    def vmin(mask):
        out = np.full(n, _INF, np.int64)
        m = mask[rel]
        np.minimum.at(out, inv[m], pos[rel][m])
        return out

    enq_inv = is_enq & (typ == int(OpType.INVOKE))
    a = count(enq_inv)
    e = count(is_enq & (typ == int(OpType.OK)))
    x = count(is_enq & (typ == int(OpType.FAIL)))
    d = count(is_read)
    s = vmin(enq_inv)
    t = vmin(is_read)
    return u, a, e, x, d, s, t


def local_id_dtype(V: int):
    """The numpy dtype of a segment's dense local value ids below ``V``:
    int16 up to 32,768 values, int32 above."""
    return np.int16 if V <= 1 << 15 else np.int32


def queue_prepare_rows(rows: np.ndarray, pos: np.ndarray):
    """The host half of a segment's stats: the queue rows of one segment
    as K1's fixed-shape ``[L]`` columns, plus the local→global value map
    ``u``.  None when the segment has no queue row.

    ``f``/``typ`` are int8 (codes −1..2 and −1..3), ``val`` holds dense
    local ids in int16, or int32 where ``V`` exceeds 32,768, ``pos`` the
    global op index in int32, ``L`` and ``V`` powers of two (at least
    128).  ``(L, V)`` is the coalescing bucket of
    :func:`seg_queue_batch_program`.  A position int32 cannot hold raises
    ``ValueError``: a fault of the data, quarantined by the caller."""
    f = rows[:, 3]
    typ = rows[:, 2]
    val = rows[:, 4].astype(np.int64)
    has = val >= 0
    rel = has & (
        (f == int(OpF.ENQUEUE))
        | (f == int(OpF.DEQUEUE))
        | (f == int(OpF.DRAIN))
    )
    if not rel.any():
        return None
    u, local = np.unique(val[rel], return_inverse=True)
    n_rel = int(rel.sum())
    L = _pow2ceil(n_rel)
    V = _pow2ceil(len(u))
    p = np.asarray(pos)[rel].astype(np.int64)
    if int(p.min()) < -_INF - 1 or int(p.max()) > _INF:
        raise ValueError(
            f"op positions {int(p.min())}..{int(p.max())} do not fit int32")
    fb = np.full(L, -1, np.int8)
    tb = np.full(L, -1, np.int8)
    vb = np.full(L, NO_VALUE, local_id_dtype(V))
    pb = np.zeros(L, np.int32)
    mb = np.zeros(L, bool)
    fb[:n_rel] = f[rel]
    tb[:n_rel] = typ[rel]
    vb[:n_rel] = local
    pb[:n_rel] = p
    mb[:n_rel] = True
    return {
        "u": u, "f": fb, "typ": tb, "val": vb, "pos": pb, "mask": mb,
        "L": L, "V": V, "n_rel": n_rel,
    }


def _k1_input(f, typ, val, mask, V: int):
    """A :class:`PackedHistories` of the four columns K1 reads; the
    columns it does not read are left empty."""
    from jepsen_tpu_torch.history.encode import PackedHistories

    empty = torch.empty(0, dtype=torch.int32, device=f.device)
    return PackedHistories(
        index=empty, process=empty, type=typ, f=f, value=val,
        time_ms=empty, latency_ms=empty, mask=mask, first=empty,
        value_space=int(V),
    )


def _dispatch(packed, pos):
    """The stats pass: K1 on a CUDA device, its plain version on the
    CPU."""
    from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats

    return fused_queue_stats(packed, pos)


def _trim_queue_stats(u, a, e, x, d, s, t):
    k = len(u)
    return (
        u,
        *(np.asarray(c)[:k].astype(np.int64) for c in (a, e, x, d, s, t)),
    )


def queue_stats_from_prepared(prep: dict, device="cuda"):
    """One prepared segment's stats through K1 on ``device``, trimmed to
    its ``len(u)`` values.  Any failure here is the device's: a
    :class:`~jepsen_tpu_torch.device.DeviceFault` (K1's build or launch)
    raises as it is, anything else as :class:`DeviceError`."""
    t0 = time.perf_counter()
    try:
        dev = torch.device(device)
        cols = [
            torch.from_numpy(prep[k]).to(dev).unsqueeze(0)
            for k in ("f", "typ", "val", "mask")
        ]
        pos = torch.from_numpy(prep["pos"]).to(dev)
        st = _dispatch(_k1_input(*cols, prep["V"]), pos)
        host = [getattr(st, k)[0].cpu().numpy() for k in "aexdst"]
    except DeviceFault:
        raise
    except Exception as e:
        raise DeviceError(
            f"queue stats on {device} failed at L={prep['L']} "
            f"V={prep['V']}: {type(e).__name__}: {e}") from e
    REGISTRY.sketch("segmented.segment_device_s").add(
        time.perf_counter() - t0)
    return _trim_queue_stats(prep["u"], *host)


def _queue_segment_stats_device(rows: np.ndarray, pos: np.ndarray, device):
    """A segment's stats with its values renamed to dense local ids, so
    that K1 sees a value space bounded by the segment, at one bucketed
    ``(L, V)`` shape per size class."""
    t0 = time.perf_counter()
    prep = queue_prepare_rows(rows, pos)
    REGISTRY.sketch("segmented.segment_prepare_s").add(
        time.perf_counter() - t0)
    if prep is None:
        return EMPTY_QUEUE_STATS
    return queue_stats_from_prepared(prep, device)


EMPTY_QUEUE_STATS = tuple(np.zeros(0, np.int64) for _ in range(7))


def seg_queue_batch_program(f, typ, val, pos, mask, V):
    """One coalesced dispatch of same-bucket segments: ``[B, L]`` stacks
    (``f``/``typ`` int8, ``val`` int16 or int32 dense local ids below
    ``V``, ``pos`` int32, ``mask`` bool) on one device, through K1 with
    a ``[B, L]`` pos.  Returns the six ``[B, V]`` stat planes as tensors
    on that device; the caller trims row i to its entry's ``len(u)``."""
    st = _dispatch(_k1_input(f, typ, val, mask, V), pos)
    return st.a, st.e, st.x, st.d, st.s, st.t


def warmup_queue_buckets(buckets, batch: int, device="cuda") -> int:
    """``serve-checker --warmup``: for each ``(L, V)`` bucket, one K1
    launch at ``[batch, L]`` with ``[batch, L]`` pos on ``device``, then a
    synchronize, so that the first super-batch of a warmed bucket finds
    K1 built and loaded (there is no compile cache to fill).  On the CPU
    it runs the plain version once per bucket.  Returns the number of
    buckets warmed."""
    dev = torch.device(device)
    warmed = 0
    for L, V in buckets:
        val = torch.from_numpy(np.zeros(0, local_id_dtype(V))).dtype
        i8 = torch.full((batch, L), -1, dtype=torch.int8, device=dev)
        seg_queue_batch_program(
            i8, i8, torch.zeros((batch, L), dtype=val, device=dev),
            torch.zeros((batch, L), dtype=torch.int32, device=dev),
            torch.zeros((batch, L), dtype=torch.bool, device=dev), int(V))
        warmed += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return warmed


class QueueCarry:
    """The residue of both queue checkers (total-queue and queue
    linearizability): open values carry full ``(a,e,x,d,s,t)`` stats,
    settled values one presence bit, reopened values exact deltas off the
    strict settled base ``(1,1,0,1)``."""

    def __init__(self, delivery: str = "exactly-once", device="cuda"):
        if delivery not in ("exactly-once", "at-least-once"):
            raise ValueError(f"unknown delivery contract {delivery!r}")
        self.delivery = delivery
        self.device = device
        self.open: dict[int, list[int]] = {}  # v -> [a,e,x,d,s,t]
        self.reopened: dict[int, list[int]] = {}  # v -> [da,de,dx,dd]
        self.settled = _Bitmap()
        self.settled_count = 0
        self.attempt_count = 0
        self.ack_count = 0

    # -- feeding ----------------------------------------------------------
    def feed_rows(self, rows: np.ndarray, pos: np.ndarray) -> None:
        stats = _queue_segment_stats_device(rows, pos, self.device)
        t0 = time.perf_counter()
        self.merge_stats(*stats)
        REGISTRY.sketch("segmented.segment_merge_s").add(
        time.perf_counter() - t0)

    def merge_stats(self, u, a, e, x, d, s, t) -> None:
        """Fold one segment's per-value stats into the residue.  Not
        order-independent across segments of one history: settling
        forgets ``(s, t)``, so segments merge in order."""
        self.attempt_count += int(a.sum())
        self.ack_count += int(e.sum())
        open_, reopened, settled = self.open, self.reopened, self.settled
        for i in range(len(u)):
            v = int(u[i])
            ai, ei, xi, di = int(a[i]), int(e[i]), int(x[i]), int(d[i])
            si, ti = int(s[i]), int(t[i])
            ent = open_.get(v)
            if ent is not None:
                ent[0] += ai
                ent[1] += ei
                ent[2] += xi
                ent[3] += di
                if si < ent[4]:
                    ent[4] = si
                if ti < ent[5]:
                    ent[5] = ti
            elif v in reopened:
                r = reopened[v]
                r[0] += ai
                r[1] += ei
                r[2] += xi
                r[3] += di
            elif settled.test(v):
                # exact reopen: the settled base is pinned (1,1,0,1)
                # with t>=s, so deltas rebuild the full counts
                reopened[v] = [ai, ei, xi, di]
                self.settled_count -= 1
            else:
                open_[v] = [ai, ei, xi, di, si, ti]
                ent = open_[v]
            if ent is not None and (
                ent[0] == 1
                and ent[1] == 1
                and ent[2] == 0
                and ent[3] == 1
                and ent[5] >= ent[4]
            ):
                del open_[v]
                settled.set(v)
                self.settled_count += 1

    # -- verdicts ---------------------------------------------------------
    def _iter_full(self):
        """Final per-value counts of every value that is not clean:
        ``(v, a, e, x, d, t_lt_s)``; settled values never reopened are
        clean by construction and summarized by counters."""
        for v, (a, e, x, d, s, t) in self.open.items():
            yield v, a, e, x, d, (t < s and t != _INF and s != _INF
                                  and a > 0 and d > 0)
        for v, (da, de, dx, dd) in self.reopened.items():
            # base (1,1,0,1) with t >= s: never causal
            yield v, 1 + da, 1 + de, dx, 1 + dd, False

    def finish(self) -> dict[str, dict[str, Any]]:
        ok = self.settled_count
        lost_s, dup_s, unexp_s, recov_s = set(), set(), set(), set()
        lost = dup = unexp = recov = 0
        exactly_once = self.delivery == "exactly-once"
        l_dup, l_phantom, l_causal, l_recov = set(), set(), set(), set()
        read_values = self.settled_count
        for v, a, e, x, d, causal_rel in self._iter_full():
            ok += min(d, a)
            if a == 0 and d > 0:
                unexp += d
                unexp_s.add(v)
            if a > 0 and d > a:
                dup += d - a
                dup_s.add(v)
            if e > d:
                lost += e - d
                lost_s.add(v)
            if min(d, a) > e:
                recov += min(d, a) - e
                recov_s.add(v)
            # queue-linearizability: the CPU oracle's elif chain
            if d >= 1:
                read_values += 1
                if d > 1:
                    l_dup.add(v)
                if a == 0:
                    l_phantom.add(v)
                elif x >= a and exactly_once:
                    l_phantom.add(v)
                elif causal_rel:
                    l_causal.add(v)
                elif x >= a:
                    l_recov.add(v)
        total = {
            VALID: lost == 0 and unexp == 0,
            "attempt-count": self.attempt_count,
            "acknowledged-count": self.ack_count,
            "ok-count": ok,
            "lost-count": lost,
            "lost": lost_s,
            "unexpected-count": unexp,
            "unexpected": unexp_s,
            "duplicated-count": dup,
            "duplicated": dup_s,
            "recovered-count": recov,
            "recovered": recov_s,
        }
        linear = {
            VALID: not (
                (l_dup and exactly_once) or l_phantom or l_causal
            ),
            "delivery": self.delivery,
            "duplicate-count": len(l_dup),
            "duplicate": l_dup,
            "phantom-count": len(l_phantom),
            "phantom": l_phantom,
            "causality-count": len(l_causal),
            "causality": l_causal,
            "recovered-count": len(l_recov),
            "recovered": l_recov,
            "read-value-count": read_values,
        }
        return {"queue": total, "linear": linear}

    def carry_size(self) -> dict[str, int]:
        return {
            "open": len(self.open),
            "reopened": len(self.reopened),
            "settled": self.settled_count,
            "settled_bitmap_bytes": self.settled.nbytes(),
        }

    # -- checkpointing ----------------------------------------------------
    def state(self) -> dict:
        return {
            "delivery": self.delivery,
            "open": [[v, *ent] for v, ent in self.open.items()],
            "reopened": [[v, *ent] for v, ent in self.reopened.items()],
            "settled": self.settled.state(),
            "settled_count": self.settled_count,
            "attempt_count": self.attempt_count,
            "ack_count": self.ack_count,
        }

    @classmethod
    def from_state(cls, d: dict, device="cuda") -> "QueueCarry":
        c = cls(delivery=d["delivery"], device=device)
        c.open = {int(r[0]): [int(q) for q in r[1:]] for r in d["open"]}
        c.reopened = {
            int(r[0]): [int(q) for q in r[1:]] for r in d["reopened"]
        }
        c.settled = _Bitmap.from_state(d["settled"])
        c.settled_count = int(d["settled_count"])
        c.attempt_count = int(d["attempt_count"])
        c.ack_count = int(d["ack_count"])
        return c


# ---------------------------------------------------------------------------
# the segmented checker: orchestration, precedence, checkpoints
# ---------------------------------------------------------------------------


@dataclass
class Quarantine:
    """Evidence of a poisoned segment: unknown with evidence, never a
    silent drop, never folded into valid."""

    segment: int
    error: str
    line: int | None = None

    def as_dict(self) -> dict:
        d = {"segment": self.segment, "error": self.error}
        if self.line is not None:
            d["line"] = self.line
        return d


class SegmentedChecker:
    """Feed segments, carry compact state, give the monolithic verdicts.
    ``verdict_so_far()`` is pure; ``finish()`` closes the open classes.
    The queue family only: any other workload raises, naming its
    ROADMAP.md item."""

    def __init__(
        self,
        workload: str,
        opts: dict | None = None,
        device="cuda",
    ):
        _refuse_workload(workload)
        opts = dict(opts or {})
        self.workload = workload
        self.opts = opts
        self.carry = QueueCarry(
            delivery=opts.get("delivery") or "exactly-once", device=device
        )
        self.segments = 0
        self.ops_seen = 0
        self.quarantines: list[Quarantine] = []
        self.resumed_from: int | None = None

    # -- feeding ----------------------------------------------------------
    def _guarded(self, fn, *args) -> None:
        """``fn(*args)``; a fault of the data quarantines the segment, a
        fault of the device raises."""
        try:
            fn(*args)
        except DEVICE_FAULTS:
            raise
        except Exception as e:  # noqa: BLE001 - quarantined as evidence
            self.quarantine(self.segments, f"{type(e).__name__}: {e}")

    def feed_rows(self, rows: np.ndarray, n_ops: int) -> None:
        """One segment as pre-exploded ``[n, 8]`` rows (the ``.jtc``
        path: segments are slices of the mmap'd substrate, and no ``Op``
        is built).  Row column 0, the recorded op index, is the global
        position."""
        if self.quarantines:
            return
        self._guarded(self.carry.feed_rows, rows,
                      rows[:, 0].astype(np.int64))
        self.segments += 1
        self.ops_seen += n_ops

    def merge_queue_stats(self, stats, n_ops: int) -> None:
        """The demux half of the service's coalesced step: fold one
        segment's per-value stats (a row of a coalesced K1 launch) into
        the carry, equal to :meth:`feed_rows` on the rows they were
        prepared from, provided the caller merges one stream's segments
        in order."""
        if self.quarantines:
            return
        self._guarded(self.carry.merge_stats, *stats)
        self.segments += 1
        self.ops_seen += n_ops

    def feed(self, ops: Sequence[Op], start_op: int | None = None) -> None:
        """One segment of ops.  Positions are the global op index
        (``start_op`` defaults to the running count), the monolithic
        check's basis."""
        if self.quarantines:
            return  # poisoned: the carry is no longer trustworthy
        start = self.ops_seen if start_op is None else start_op
        for i, op in enumerate(ops):
            op.index = start + i

        def feed_ops():
            from jepsen_tpu_torch.history.rows import _rows_for

            rows = _rows_for(ops)
            self.carry.feed_rows(rows, rows[:, 0].astype(np.int64))

        self._guarded(feed_ops)
        self.segments += 1
        self.ops_seen = start + len(ops)

    def quarantine(
        self, segment: int, error: str, line: int | None = None
    ) -> None:
        logger.error(
            "segmented check: segment %d quarantined: %s", segment, error
        )
        self.quarantines.append(Quarantine(segment, error, line))

    # -- verdicts ---------------------------------------------------------
    def _apply_precedence(
        self, families: dict[str, dict[str, Any]]
    ) -> dict[str, Any]:
        if self.quarantines:
            # the queue's classes are end-state: none is final before the
            # end, so every verdict of a poisoned run is unknown
            ev = [q.as_dict() for q in self.quarantines]
            for r in families.values():
                r[VALID] = UNKNOWN
                r["quarantined"] = {"segments": ev}
        out: dict[str, Any] = dict(families)
        out[VALID] = merge_valid(
            r.get(VALID, False) for r in families.values()
        )
        return out

    def verdict_so_far(self) -> dict[str, Any]:
        return self._apply_precedence(self.carry.finish())

    def finish(self) -> dict[str, Any]:
        out = self._apply_precedence(self.carry.finish())
        out["segmented"] = {
            "segments": self.segments,
            "ops": self.ops_seen,
            "workload": self.workload,
            "resumed": self.resumed_from is not None,
            "carry": self.carry.carry_size(),
            "quarantined-segments": len(self.quarantines),
        }
        if self.resumed_from is not None:
            out["segmented"]["resumed_from"] = self.resumed_from
        return out

    # -- checkpointing ----------------------------------------------------
    def state(self) -> dict:
        return {
            "workload": self.workload,
            "opts": self.opts,
            "segments": self.segments,
            "ops_seen": self.ops_seen,
            "quarantines": [q.as_dict() for q in self.quarantines],
            "carry": self.carry.state(),
        }

    def state_nbytes(self, state: dict | None = None) -> int:
        """The carry's footprint in bytes: the compact-JSON size of
        :meth:`state` (pass a state already taken to reuse it).  The
        service sums it over live streams as ``service.carry_bytes``."""
        d = self.state() if state is None else state
        return len(json.dumps(d, separators=(",", ":")).encode())

    @classmethod
    def from_state(cls, d: dict, device="cuda") -> "SegmentedChecker":
        _refuse_workload(d["workload"])
        c = cls.__new__(cls)
        c.workload = d["workload"]
        c.opts = dict(d["opts"])
        c.carry = QueueCarry.from_state(d["carry"], device=device)
        c.segments = int(d["segments"])
        c.ops_seen = int(d["ops_seen"])
        c.quarantines = [
            Quarantine(q["segment"], q["error"], q.get("line"))
            for q in d["quarantines"]
        ]
        c.resumed_from = None
        return c


# ---------------------------------------------------------------------------
# durable checkpoints: temp -> fsync -> rename, CRC'd, rotated
# ---------------------------------------------------------------------------

CKPT_FORMAT = 1
CKPT_SUFFIX = ".segckpt.json"


class CheckpointError(Exception):
    """A checkpoint file is torn, corrupt, or from another source."""


def checkpoint_path_for(history_path: str | Path) -> Path:
    return Path(str(history_path) + CKPT_SUFFIX)


def _ckpt_crc(doc: dict) -> int:
    body = {k: v for k, v in doc.items() if k != "crc32"}
    return zlib.crc32(
        json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
    )


def write_checkpoint(path: Path, doc: dict) -> None:
    """Atomic, durable, rotated: the previous checkpoint survives as
    ``.prev``, so a torn write falls back one segment."""
    doc = dict(doc)
    doc["crc32"] = _ckpt_crc(doc)
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    with open(tmp, "w") as fh:
        json.dump(doc, fh, separators=(",", ":"))
        fh.flush()
        os.fsync(fh.fileno())
    if path.exists():
        os.replace(path, path.with_name(path.name + ".prev"))
    os.replace(tmp, path)


def read_checkpoint(path: Path) -> dict:
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except OSError as e:
        raise CheckpointError(f"{path}: unreadable: {e}") from e
    except ValueError as e:
        raise CheckpointError(f"{path}: torn/corrupt JSON: {e}") from e
    if not isinstance(doc, dict) or doc.get("format") != CKPT_FORMAT:
        raise CheckpointError(
            f"{path}: unknown checkpoint format "
            f"{doc.get('format') if isinstance(doc, dict) else type(doc)}"
        )
    if doc.get("crc32") != _ckpt_crc(doc):
        raise CheckpointError(
            f"{path}: CRC mismatch (torn or tampered checkpoint)"
        )
    return doc


def load_checkpoint_chain(path: Path) -> tuple[dict | None, list[str]]:
    """The newest valid checkpoint, refusing corrupt ones loudly:
    ``(doc | None, refusal notes)``.  A torn main checkpoint falls back
    to ``.prev``; both torn means a run from scratch."""
    notes: list[str] = []
    for p in (path, path.with_name(path.name + ".prev")):
        if not p.exists():
            continue
        try:
            return read_checkpoint(p), notes
        except CheckpointError as e:
            notes.append(str(e))
            logger.error("segmented resume: REFUSED checkpoint: %s", e)
    return None, notes


def clear_checkpoints(path: Path) -> None:
    """Remove a check's checkpoint, its ``.prev`` and any ``.tmp`` left
    by a crashed writer."""
    for p in (path, path.with_name(path.name + ".prev")):
        try:
            p.unlink()
        except OSError:
            pass
    try:
        for p in path.parent.glob(path.name + ".*.tmp"):
            p.unlink()
    except OSError:
        pass


# ---------------------------------------------------------------------------
# checking a file: stream -> feed -> checkpoint -> verdict
# ---------------------------------------------------------------------------


def _coerce_prefix_index(prefix_index: Any):
    """A path becomes a
    :class:`~jepsen_tpu_torch.history.prefix_index.PrefixCheckpointIndex`;
    an index object (anything with ``publish`` and ``lookup``) passes
    through."""
    if prefix_index is None:
        return None
    if hasattr(prefix_index, "lookup") and hasattr(prefix_index, "publish"):
        return prefix_index
    from jepsen_tpu_torch.history.prefix_index import PrefixCheckpointIndex

    return PrefixCheckpointIndex(prefix_index)


def _publish_quiet(pindex, doc: dict) -> None:
    """A failed publish costs later reuse, never this verdict: the local
    checkpoint is already durable."""
    try:
        pindex.publish(doc)
    except Exception as e:  # noqa: BLE001 - reuse is best-effort
        logger.warning("prefix index publish failed: %s", e)


def _prefix_resume(lookup, device):
    """The engine resumed from the deepest fleet anchor that ``lookup()``
    serves, and that hit; ``(None, None)`` on a miss."""
    t0 = time.perf_counter()
    hit = lookup()
    REGISTRY.sketch("prefix_index.lookup_s").add(time.perf_counter() - t0)
    if hit is None:
        return None, None
    engine = SegmentedChecker.from_state(hit.doc["state"], device=device)
    engine.resumed_from = int(hit.doc["segment_idx"])
    REGISTRY.counter("segmented.prefix_resumes").inc()
    return engine, hit


def _peek_workload(path: Path, n: int = 256) -> str:
    """The workload of the first ≤n ops, parsed leniently: lines that do
    not parse are skipped here, and the checking loop meets them again
    with full quarantine evidence."""
    ops: list[Op] = []
    with open(path, "rb") as fh:
        for line in fh:
            raw = line.strip()
            if not raw:
                continue
            try:
                ops.append(Op.from_json(json.loads(raw)))
            except Exception:  # noqa: BLE001 - lenient peek by design
                continue
            if len(ops) >= n:
                break
    return workload_of(ops)


def _die_after() -> int | None:
    raw = os.environ.get(DIE_AFTER_ENV)
    return int(raw) if raw else None


def _maybe_die(die_after: int | None, idx: int) -> None:
    if die_after is not None and idx >= die_after:
        logger.error(
            "segmented check: %s=%d hook firing after segment %d "
            "(simulated SIGKILL)", DIE_AFTER_ENV, die_after, idx,
        )
        os._exit(137)


def _finish_result(engine, src: Path, segment_ops: int, substrate: str,
                   refusals: list[str], cpath: Path,
                   hit=None) -> dict[str, Any]:
    result = engine.finish()
    result["segmented"]["segment_ops"] = segment_ops
    result["segmented"]["source"] = str(src)
    result["segmented"]["substrate"] = substrate
    if hit is not None:
        result["segmented"]["resumed_from_prefix"] = hit.provenance()
    if refusals:
        result["segmented"]["checkpoints_refused"] = refusals
        REGISTRY.counter("segmented.ckpt_refused").inc(len(refusals))
    if not engine.quarantines:
        clear_checkpoints(cpath)
    return result


def segmented_check_file(
    src: str | Path,
    workload: str | None = None,
    segment_ops: int = DEFAULT_SEGMENT_OPS,
    opts: dict | None = None,
    resume: bool = False,
    device="cuda",
    prefix_index: Any = None,
) -> dict[str, Any]:
    """Check one recorded history through the segmented engine: bounded
    memory, a durable checkpoint after each segment, resume.

    A queue history with a fresh ``.jtc`` is served as slices of its
    mmap'd rows (:func:`_segmented_check_rows`); otherwise the JSONL
    streams through :func:`~jepsen_tpu_torch.history.segments.iter_segments`
    and is never parsed whole.  ``resume=True`` goes on from the newest
    valid checkpoint (a refused one falls back to ``.prev``, then to a
    run from scratch, always loudly) to the same verdict.  A complete
    check that quarantined nothing removes its checkpoints.

    ``prefix_index`` (a directory or a
    :class:`~jepsen_tpu_torch.history.prefix_index.PrefixCheckpointIndex`)
    turns on fleet prefix resume: every full-segment checkpoint is also
    published under its content anchor, and a history sharing a verified
    prefix with one published before resumes from the deepest matching
    anchor, to the verdict of a check from scratch, with the anchor
    recorded in ``result["segmented"]["resumed_from_prefix"]``.  A valid
    local checkpoint (``resume=True``) wins over the index."""
    src = Path(src)
    cpath = checkpoint_path_for(src)
    if workload in (None, "auto"):
        workload = _peek_workload(src)
    _refuse_workload(workload)
    opts = dict(opts or {})
    pindex = _coerce_prefix_index(prefix_index)

    rows = _jtc_queue_rows(src)
    if rows is not None:
        return _segmented_check_rows(
            src, rows, segment_ops=segment_ops, opts=opts, resume=resume,
            cpath=cpath, device=device, pindex=pindex,
        )

    engine: SegmentedChecker | None = None
    start_segment = 0
    expect_sha = expect_bytes = None
    hit = None
    refusals: list[str] = []
    if resume:
        doc, refusals = load_checkpoint_chain(cpath)
        if doc is not None:
            if (
                doc["segment_ops"] != segment_ops
                or doc["workload"] != workload
                or doc["source"] != src.name
                or doc.get("substrate", "jsonl") != "jsonl"
                or doc.get("opts", {}) != opts
            ):
                refusals.append(
                    f"{cpath}: checkpoint is for "
                    f"({doc['workload']}, segment_ops="
                    f"{doc['segment_ops']}, {doc['source']}, "
                    f"opts={doc.get('opts')}), not "
                    f"({workload}, {segment_ops}, {src.name}, "
                    f"opts={opts}) — a resumed carry must be judged "
                    f"under the contract it was built with; "
                    f"recomputing from scratch"
                )
                logger.error("segmented resume: %s", refusals[-1])
            else:
                engine = SegmentedChecker.from_state(
                    doc["state"], device=device
                )
                engine.resumed_from = int(doc["segment_idx"])
                start_segment = engine.resumed_from + 1
                expect_sha = doc["source_sha256"]
                expect_bytes = int(doc["source_bytes"])
                REGISTRY.counter("segmented.resumes").inc()
    if engine is None and pindex is not None:
        # the deepest anchor whose (offset, sha256) matches this file's
        # own bytes: a divergent byte unmatches it, a shallower one serves
        engine, hit = _prefix_resume(lambda: pindex.lookup(
            src, workload=workload, segment_ops=segment_ops, opts=opts),
            device)
        if hit is not None:
            start_segment = engine.resumed_from + 1
            expect_sha, expect_bytes = hit.sha256, hit.offset
    if engine is None:
        engine = SegmentedChecker(workload, opts=opts, device=device)

    die_after = _die_after()
    sketch = REGISTRY.sketch("segmented.segment_check_s")
    seg_counter = REGISTRY.counter("segmented.segments")
    it = iter_segments(
        src,
        segment_ops,
        start_segment=start_segment,
        expect_sha256=expect_sha,
        expect_bytes=expect_bytes,
    )
    while True:
        t0 = time.perf_counter()
        try:
            seg = next(it)
        except StopIteration:
            break
        except SegmentPoisonError as e:
            engine.quarantine(e.segment_idx, e.error, line=e.line_no)
            break
        with obs_trace.span(
            "segmented.segment",
            track="segmented",
            args=(
                {"idx": seg.idx, "ops": len(seg.ops)}
                if obs_trace.is_enabled()
                else None
            ),
        ):
            if seg.ops:
                engine.feed(seg.ops, start_op=seg.start_op)
        sketch.add(time.perf_counter() - t0)
        seg_counter.inc()
        if seg.ops or not seg.final:
            doc = {
                "format": CKPT_FORMAT,
                "substrate": "jsonl",
                "workload": workload,
                "segment_ops": segment_ops,
                "segment_idx": seg.idx,
                "source": src.name,
                "source_bytes": seg.byte_end,
                "source_sha256": seg.sha256,
                "opts": opts,
                "partial": _partial_summary(engine),
                "state": engine.state(),
            }
            write_checkpoint(cpath, doc)
            # fleet anchors only at full segment boundaries: a final short
            # segment refills in an extended file
            if pindex is not None and len(seg.ops) == segment_ops:
                _publish_quiet(pindex, doc)
            _maybe_die(die_after, seg.idx)
        if seg.final:
            break

    return _finish_result(engine, src, segment_ops, "jsonl", refusals, cpath,
                          hit)


def _jtc_queue_rows(src: Path) -> np.ndarray | None:
    """A fresh ``.jtc`` rows section of a queue history, as a read-only
    mmap view; None when absent, stale, corrupt or of another family
    (the columnar layer logs why, and the JSONL stream takes over)."""
    try:
        from jepsen_tpu_torch.history import columnar

        jtc = columnar.consult(src)
    except Exception:  # noqa: BLE001 - strict mode raises upstream
        return None
    if jtc is None or jtc.workload != "queue":
        return None
    rows = jtc.rows()
    if rows is None or rows.ndim != 2 or rows.shape[1] != 8:
        return None
    return rows


def _segmented_check_rows(
    src: Path,
    rows: np.ndarray,
    *,
    segment_ops: int,
    opts: dict,
    resume: bool,
    cpath: Path,
    device,
    pindex: Any = None,
) -> dict[str, Any]:
    """The ``.jtc`` segment producer: fixed-count op segments are
    ``searchsorted`` slices of the mmap'd row matrix (column 0, the
    recorded op index, is monotone), fed to the queue carry with no parse
    and no ``Op``.  The checkpoint anchors on the whole source's digest
    (the substrate is stamped against the source bytes), and records the
    row prefix and its digest, as the JAX package's does; that row prefix
    is the fleet anchor."""
    import hashlib

    idx_col = rows[:, 0]
    n_total = int(idx_col[-1]) + 1 if len(rows) else 0
    n_segments = max(1, -(-n_total // segment_ops))
    digest = prefix_sha256(src, src.stat().st_size)

    engine: SegmentedChecker | None = None
    start_segment = 0
    hit = None
    refusals: list[str] = []
    if resume:
        doc, refusals = load_checkpoint_chain(cpath)
        if doc is not None:
            if (
                doc.get("substrate") != "jtc"
                or doc["segment_ops"] != segment_ops
                or doc["workload"] != "queue"
                or doc["source"] != src.name
                or doc["source_sha256"] != digest
                or doc.get("opts", {}) != opts
            ):
                refusals.append(
                    f"{cpath}: checkpoint does not match this "
                    f"(substrate=jtc, queue, segment_ops={segment_ops}, "
                    f"{src.name}, digest, opts={opts}) run — "
                    f"recomputing from scratch"
                )
                logger.error("segmented resume: %s", refusals[-1])
            else:
                engine = SegmentedChecker.from_state(
                    doc["state"], device=device
                )
                engine.resumed_from = int(doc["segment_idx"])
                start_segment = engine.resumed_from + 1
                REGISTRY.counter("segmented.resumes").inc()
    if engine is None and pindex is not None:
        engine, hit = _prefix_resume(lambda: pindex.lookup_rows(
            rows, workload="queue", segment_ops=segment_ops, opts=opts),
            device)
        if hit is not None:
            start_segment = engine.resumed_from + 1
    if engine is None:
        engine = SegmentedChecker("queue", opts=opts, device=device)

    die_after = _die_after()
    sketch = REGISTRY.sketch("segmented.segment_check_s")
    seg_counter = REGISTRY.counter("segmented.segments")
    # the row-prefix hash of the checkpoint, over the skipped prefix too
    row_hash = hashlib.sha256()
    if start_segment:
        hi0 = int(np.searchsorted(idx_col, start_segment * segment_ops))
        row_hash.update(np.ascontiguousarray(rows[:hi0]).tobytes())
    for k in range(start_segment, n_segments):
        t0 = time.perf_counter()
        lo = int(np.searchsorted(idx_col, k * segment_ops))
        hi = int(np.searchsorted(idx_col, (k + 1) * segment_ops))
        n_ops = min((k + 1) * segment_ops, n_total) - k * segment_ops
        with obs_trace.span(
            "segmented.segment",
            track="segmented",
            args=(
                {"idx": k, "rows": hi - lo, "substrate": "jtc"}
                if obs_trace.is_enabled()
                else None
            ),
        ):
            engine.feed_rows(rows[lo:hi], n_ops)
        sketch.add(time.perf_counter() - t0)
        seg_counter.inc()
        row_hash.update(np.ascontiguousarray(rows[lo:hi]).tobytes())
        doc = {
            "format": CKPT_FORMAT,
            "substrate": "jtc",
            "workload": "queue",
            "segment_ops": segment_ops,
            "segment_idx": k,
            "source": src.name,
            "source_bytes": src.stat().st_size,
            "source_sha256": digest,
            "prefix_rows": hi,
            "prefix_sha256": row_hash.hexdigest(),
            "opts": opts,
            "partial": _partial_summary(engine),
            "state": engine.state(),
        }
        write_checkpoint(cpath, doc)
        if pindex is not None and n_ops == segment_ops:
            _publish_quiet(pindex, doc)
        _maybe_die(die_after, k)

    return _finish_result(engine, src, segment_ops, "jtc", refusals, cpath,
                          hit)


def _partial_summary(engine: SegmentedChecker) -> dict:
    """The checkpoint's human-readable partial verdict (the carry is
    authoritative; this is for forensics)."""
    v: Any = "deferred"
    try:
        v = engine.verdict_so_far().get(VALID)
    except Exception as e:  # noqa: BLE001 - summary must not sink a ckpt
        v = f"error: {type(e).__name__}: {e}"
    return {
        "valid_so_far": v,
        "segments": engine.segments,
        "ops": engine.ops_seen,
        "quarantined": len(engine.quarantines),
    }
