"""Linearizability of unordered-queue histories, per-value decomposed.

A multiset over distinct values is a product of independent per-value
objects, so a history is linearizable iff each per-value subhistory is
(P-compositionality, Horn & Kroening, arXiv:1504.00204).  The check is a
per-value scatter/compare program, not a search.  Per value ``v`` — with
enqueue-invoke count ``a``, enqueue-fail count ``x``, earliest
enqueue-invoke position ``s``, ok-read count ``r``, earliest ok-read
position ``t``:

- **duplicate**: ``r > 1``.
- **phantom**: ``r ≥ 1`` and ``a == 0``; under ``exactly-once`` also
  ``x ≥ a`` (every attempt definitely failed).
- **recovered**: ``r ≥ 1``, ``a ≥ 1``, ``x ≥ a`` under ``at-least-once``:
  a client-side fail over a real connection is not the broker's verdict.
  Reported, never invalidating.
- **causality**: ``r ≥ 1``, ``a ≥ 1`` and ``t < s`` — the read completed
  before the enqueue was invoked.  Positions are history positions, so
  position order is real-time order.

Phantoms and causality violations always invalidate; duplicates only
under ``exactly-once``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.checkers.bitset import pack_bits, unpack_bits_np
from jepsen_tpu_torch.checkers.protocol import VALID, Checker
from jepsen_tpu_torch.history.encode import PackedHistories, pack_histories
from jepsen_tpu_torch.history.ops import Op, OpF, OpType
from jepsen_tpu_torch.ops.counts import INT32_MAX
from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats, queue_stats_plain

DELIVERIES = ("exactly-once", "at-least-once")


def check_queue_lin_cpu(
    history: Sequence[Op], delivery: str = "exactly-once"
) -> dict[str, Any]:
    """Reference implementation over raw ``Op`` lists.  ``delivery`` is
    the system's contract: ``"exactly-once"`` treats a duplicate read as
    a violation; ``"at-least-once"`` reports duplicates without
    invalidating and treats a read of an all-attempts-failed value as
    recovered, not phantom."""
    enq_invokes: dict[int, int] = {}
    enq_fails: dict[int, int] = {}
    enq_start: dict[int, int] = {}  # earliest history position of an invoke
    read_count: dict[int, int] = {}
    read_end: dict[int, int] = {}  # earliest history position of an ok read
    for pos, op in enumerate(history):
        if op.f == OpF.ENQUEUE and isinstance(op.value, int):
            v = op.value
            if op.type == OpType.INVOKE:
                enq_invokes[v] = enq_invokes.get(v, 0) + 1
                enq_start[v] = min(enq_start.get(v, pos), pos)
            elif op.type == OpType.FAIL:
                enq_fails[v] = enq_fails.get(v, 0) + 1
        elif op.f in (OpF.DEQUEUE, OpF.DRAIN) and op.type == OpType.OK:
            vals = op.value if isinstance(op.value, (list, tuple)) else [op.value]
            for v in vals:
                if isinstance(v, int):
                    read_count[v] = read_count.get(v, 0) + 1
                    read_end[v] = min(read_end.get(v, pos), pos)

    exactly_once = delivery == "exactly-once"
    dup, phantom, causal, recovered = set(), set(), set(), set()
    for v, r in read_count.items():
        a = enq_invokes.get(v, 0)
        x = enq_fails.get(v, 0)
        if r > 1:
            dup.add(v)
        if a == 0:
            phantom.add(v)
        elif x >= a and exactly_once:
            phantom.add(v)
        elif read_end[v] < enq_start[v]:
            causal.add(v)
        elif x >= a:
            recovered.add(v)

    return {
        VALID: not ((dup and exactly_once) or phantom or causal),
        "delivery": delivery,
        "duplicate-count": len(dup),
        "duplicate": dup,
        "phantom-count": len(phantom),
        "phantom": phantom,
        "causality-count": len(causal),
        "causality": causal,
        "recovered-count": len(recovered),
        "recovered": recovered,
        "read-value-count": len(read_count),
    }


@dataclass
class QueueLinTensors:
    valid: torch.Tensor  # [B] bool
    duplicate: torch.Tensor  # [B, V] bool
    phantom: torch.Tensor  # [B, V] bool
    causality: torch.Tensor  # [B, V] bool
    recovered: torch.Tensor  # [B, V] bool (at-least-once: fail-read values)
    read_value_count: torch.Tensor  # [B] int32


@dataclass
class QueueLinTensorsPacked:
    """:class:`QueueLinTensors` with the four class masks as presence
    bits ``[B, ceil(V/32)]`` (int32 words, ``checkers/bitset.py``
    layout); ``value_space`` is the unpack width."""

    valid: torch.Tensor  # [B] bool
    duplicate: torch.Tensor  # [B, ceil(V/32)] int32
    phantom: torch.Tensor  # [B, ceil(V/32)] int32
    causality: torch.Tensor  # [B, ceil(V/32)] int32
    recovered: torch.Tensor  # [B, ceil(V/32)] int32
    read_value_count: torch.Tensor  # [B] int32
    value_space: int = 0


def queue_lin_count_vectors(f, type_, value, pos, mask, value_space: int):
    """Per-history ``(a, x, s, r, t)`` vectors ``[B, V]`` over ``[B, L]``
    rows: enqueue-invoke count, enqueue-fail count, earliest
    enqueue-invoke position, ok-read count, earliest ok-read position.
    ``pos`` is each row's history position (``[L]`` or ``[B, L]``).  A
    view of the plain stats pass."""
    st = queue_stats_plain(f, type_, value, mask, value_space, pos)
    return st.a, st.x, st.s, st.d, st.t


def queue_lin_classify(
    a, x, s, r, t, exactly_once: bool = True, packed_out: bool = False
) -> QueueLinTensors | QueueLinTensorsPacked:
    """Vectors ``[B, V]`` → results.  ``exactly_once=False`` is the
    at-least-once contract.  ``packed_out=True`` returns the class masks
    as presence bits."""
    read = r >= 1
    dup = r > 1
    never_attempted = read & (a == 0)
    all_failed = read & (a > 0) & (x >= a)
    causal_base = (
        read & ~never_attempted & (s != INT32_MAX) & (t != INT32_MAX) & (t < s)
    )
    if exactly_once:
        phantom = never_attempted | all_failed
        causal = causal_base & ~all_failed
        recovered = torch.zeros_like(phantom)
    else:
        phantom = never_attempted
        causal = causal_base
        recovered = all_failed & ~causal_base
    valid = ~(phantom.any(-1) | causal.any(-1))
    if exactly_once:
        valid &= ~dup.any(-1)
    rvc = read.sum(-1, dtype=torch.int32)
    if packed_out:
        return QueueLinTensorsPacked(
            valid=valid,
            duplicate=pack_bits(dup),
            phantom=pack_bits(phantom),
            causality=pack_bits(causal),
            recovered=pack_bits(recovered),
            read_value_count=rvc,
            value_space=int(r.shape[-1]),
        )
    return QueueLinTensors(
        valid=valid,
        duplicate=dup,
        phantom=phantom,
        causality=causal,
        recovered=recovered,
        read_value_count=rvc,
    )


def queue_lin_tensor_check(
    packed: PackedHistories,
    delivery: str = "exactly-once",
    packed_out: bool = False,
) -> QueueLinTensors | QueueLinTensorsPacked:
    """Batched check over packed histories by the plain scatters."""
    pos = torch.arange(packed.length, dtype=torch.int32, device=packed.device)
    a, x, s, r, t = queue_lin_count_vectors(
        packed.f, packed.type, packed.value, pos, packed.mask,
        packed.value_space,
    )
    return queue_lin_classify(
        a, x, s, r, t, exactly_once=delivery == "exactly-once",
        packed_out=packed_out,
    )


def queue_lin_tensors_to_results(
    t: QueueLinTensors | QueueLinTensorsPacked,
) -> list[dict[str, Any]]:
    """Result tensors → result maps (one per history).  Packed and dense
    tensors render identical maps."""
    packed = isinstance(t, QueueLinTensorsPacked)
    valid = t.valid.cpu().numpy()

    def mask_of(x):
        arr = x.cpu().numpy()
        return unpack_bits_np(arr, t.value_space) if packed else arr

    masks = {
        "duplicate": mask_of(t.duplicate),
        "phantom": mask_of(t.phantom),
        "causality": mask_of(t.causality),
        "recovered": mask_of(t.recovered),
    }
    rvc = t.read_value_count.cpu().numpy()
    out = []
    for b in range(valid.shape[0]):
        r: dict[str, Any] = {VALID: bool(valid[b])}
        for k, arr in masks.items():
            vals = set(np.nonzero(arr[b])[0].tolist())
            r[k] = vals
            r[f"{k}-count"] = len(vals)
        r["read-value-count"] = int(rvc[b])
        out.append(r)
    return out


class QueueLinearizability(Checker):
    """Knossos ``checker/queue`` + ``model/unordered-queue``: the ``cpu``
    oracle, or the ``tensor`` path on ``device`` through the fused stats
    kernel."""

    name = "queue-linearizability"

    def __init__(
        self,
        backend: str = "tensor",
        delivery: str = "exactly-once",
        device: str = "cuda",
    ):
        if backend not in ("cpu", "tensor"):
            raise ValueError(f"unknown backend {backend!r}")
        if delivery not in DELIVERIES:
            raise ValueError(f"unknown delivery contract {delivery!r}")
        self.backend = backend
        self.delivery = delivery
        self.device = device

    def check(
        self,
        test: Mapping[str, Any],
        history: Sequence[Op],
        opts: Mapping[str, Any] | None = None,
    ) -> dict[str, Any]:
        if self.backend == "cpu":
            return check_queue_lin_cpu(history, delivery=self.delivery)
        st = fused_queue_stats(pack_histories([history], device=self.device))
        r = queue_lin_tensors_to_results(
            queue_lin_classify(
                st.a, st.x, st.s, st.d, st.t,
                exactly_once=self.delivery == "exactly-once",
                packed_out=True,
            )
        )[0]
        r["delivery"] = self.delivery
        return r
