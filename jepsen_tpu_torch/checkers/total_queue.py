"""``total-queue``: what goes in must come out.

It reconciles three multisets over the op history:

- **attempts**  — values of ``invoke``-type enqueues
- **acknowledged** — values of ``ok``-type enqueues (publish confirmed)
- **reads**     — values of ``ok``-type dequeues and drains

Values are dense unique ints, so the multisets are count vectors over the
value space and the reconciliation is per-value arithmetic.  Per value
``v`` with ``a`` attempts, ``e`` acks, ``d`` reads:

- ``ok[v]         = min(d, a)``
- ``unexpected[v] = d`` if ``a == 0`` — reads of values never attempted
- ``duplicated[v] = max(d - a, 0)`` if ``a > 0``
- ``lost[v]       = max(e - d, 0)``   — acknowledged but never read
- ``recovered[v]  = max(min(d, a) - e, 0)`` — read, attempted, but the
  enqueue was indeterminate or failed

``valid? = (no lost) and (no unexpected)``.

The tensor path packs histories to ``[B, L]`` tensors and computes the
count vectors with masked scatters (or, through :class:`TotalQueue`, the
fused stats kernel); :func:`check_total_queue_cpu` is the single-threaded
oracle the tensor path is tested against.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, fields
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.checkers.bitset import pack_bits, unpack_bits_np
from jepsen_tpu_torch.checkers.protocol import VALID, Checker
from jepsen_tpu_torch.history.encode import PackedHistories, pack_histories
from jepsen_tpu_torch.history.ops import Op, OpF, OpType
from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats, queue_stats_plain


def check_total_queue_cpu(history: Sequence[Op]) -> dict[str, Any]:
    """Reference implementation over raw ``Op`` lists."""
    attempts: Counter = Counter()
    acked: Counter = Counter()
    reads: Counter = Counter()
    for op in history:
        if op.f == OpF.ENQUEUE and isinstance(op.value, int):
            if op.type == OpType.INVOKE:
                attempts[op.value] += 1
            elif op.type == OpType.OK:
                acked[op.value] += 1
        elif op.f in (OpF.DEQUEUE, OpF.DRAIN) and op.type == OpType.OK:
            vals = op.value if isinstance(op.value, (list, tuple)) else [op.value]
            for v in vals:
                if isinstance(v, int):
                    reads[v] += 1

    values = set(attempts) | set(acked) | set(reads)
    ok = lost = dup = unexp = recov = 0
    lost_s, dup_s, unexp_s, recov_s = set(), set(), set(), set()
    for v in values:
        a, e, d = attempts[v], acked[v], reads[v]
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

    return {
        VALID: lost == 0 and unexp == 0,
        "attempt-count": sum(attempts.values()),
        "acknowledged-count": sum(acked.values()),
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


@dataclass
class TotalQueueTensors:
    """Per-history totals ``[B]`` + per-value class counts ``[B, V]``."""

    valid: torch.Tensor  # [B] bool
    attempt_count: torch.Tensor  # [B] int32
    acknowledged_count: torch.Tensor  # [B] int32
    ok_count: torch.Tensor  # [B] int32
    lost: torch.Tensor  # [B, V] int32
    unexpected: torch.Tensor  # [B, V] int32
    duplicated: torch.Tensor  # [B, V] int32
    recovered: torch.Tensor  # [B, V] int32


@dataclass
class TotalQueueTensorsPacked:
    """:class:`TotalQueueTensors` with the class totals reduced on the
    device and the per-value anomaly sets as presence bits
    ``[B, ceil(V/32)]`` (int32 words, ``checkers/bitset.py`` layout)."""

    valid: torch.Tensor  # [B] bool
    attempt_count: torch.Tensor  # [B] int32
    acknowledged_count: torch.Tensor  # [B] int32
    ok_count: torch.Tensor  # [B] int32
    lost_count: torch.Tensor  # [B] int32
    unexpected_count: torch.Tensor  # [B] int32
    duplicated_count: torch.Tensor  # [B] int32
    recovered_count: torch.Tensor  # [B] int32
    lost: torch.Tensor  # [B, ceil(V/32)] int32 — presence bits
    unexpected: torch.Tensor  # [B, ceil(V/32)] int32
    duplicated: torch.Tensor  # [B, ceil(V/32)] int32
    recovered: torch.Tensor  # [B, ceil(V/32)] int32
    value_space: int = 0


def total_queue_count_vectors(
    f: torch.Tensor,
    type_: torch.Tensor,
    value: torch.Tensor,
    mask: torch.Tensor,
    value_space: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-history ``(attempts, acks, reads)`` count vectors ``[B, V]``
    over ``[B, L]`` rows: a view of the plain stats pass."""
    st = queue_stats_plain(f, type_, value, mask, value_space)
    return st.a, st.e, st.d


def _total(x: torch.Tensor) -> torch.Tensor:
    return x.sum(-1, dtype=torch.int32)


def total_queue_classify(
    a: torch.Tensor, e: torch.Tensor, d: torch.Tensor, packed_out: bool = False
) -> TotalQueueTensors | TotalQueueTensorsPacked:
    """Count vectors ``[B, V]`` → results.  ``packed_out=True`` reduces
    the class totals on the device and returns presence bits instead of
    the count vectors."""
    ok = torch.minimum(d, a)
    unexpected = torch.where(a == 0, d, 0)
    duplicated = torch.where(a > 0, torch.clamp(d - a, min=0), 0)
    lost = torch.clamp(e - d, min=0)
    recovered = torch.clamp(ok - e, min=0)
    valid = (_total(lost) == 0) & (_total(unexpected) == 0)
    if packed_out:
        return TotalQueueTensorsPacked(
            valid=valid,
            attempt_count=_total(a),
            acknowledged_count=_total(e),
            ok_count=_total(ok),
            lost_count=_total(lost),
            unexpected_count=_total(unexpected),
            duplicated_count=_total(duplicated),
            recovered_count=_total(recovered),
            lost=pack_bits(lost > 0),
            unexpected=pack_bits(unexpected > 0),
            duplicated=pack_bits(duplicated > 0),
            recovered=pack_bits(recovered > 0),
            value_space=int(a.shape[-1]),
        )
    return TotalQueueTensors(
        valid=valid,
        attempt_count=_total(a),
        acknowledged_count=_total(e),
        ok_count=_total(ok),
        lost=lost,
        unexpected=unexpected,
        duplicated=duplicated,
        recovered=recovered,
    )


def total_queue_tensor_check(
    packed: PackedHistories, packed_out: bool = False
) -> TotalQueueTensors | TotalQueueTensorsPacked:
    """Batched check over packed histories by the plain scatters."""
    a, e, d = total_queue_count_vectors(
        packed.f, packed.type, packed.value, packed.mask, packed.value_space
    )
    return total_queue_classify(a, e, d, packed_out=packed_out)


def _tensors_to_results(
    t: TotalQueueTensors | TotalQueueTensorsPacked,
) -> list[dict[str, Any]]:
    """Result tensors → reference-shaped result maps (one per history).
    Packed and dense tensors render identical maps."""
    packed = isinstance(t, TotalQueueTensorsPacked)
    h = {
        f.name: getattr(t, f.name).cpu().numpy()
        for f in fields(t)
        if isinstance(getattr(t, f.name), torch.Tensor)
    }
    valid = h["valid"]
    per_value = {k: h[k] for k in ("lost", "unexpected", "duplicated", "recovered")}
    if packed:
        per_value = {k: unpack_bits_np(v, t.value_space) for k, v in per_value.items()}
    out = []
    for b in range(valid.shape[0]):
        r: dict[str, Any] = {VALID: bool(valid[b])}
        r["attempt-count"] = int(h["attempt_count"][b])
        r["acknowledged-count"] = int(h["acknowledged_count"][b])
        r["ok-count"] = int(h["ok_count"][b])
        for k, arr in per_value.items():
            row = arr[b]
            r[f"{k}-count"] = int(h[f"{k}_count"][b]) if packed else int(row.sum())
            r[k] = set(np.nonzero(row)[0].tolist())
        out.append(r)
    return out


class TotalQueue(Checker):
    """``checker/total-queue``: the ``cpu`` oracle, or the ``tensor``
    path on ``device`` through the fused stats kernel."""

    name = "total-queue"

    def __init__(self, backend: str = "tensor", device: str = "cuda"):
        if backend not in ("cpu", "tensor"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.device = device

    def check(
        self,
        test: Mapping[str, Any],
        history: Sequence[Op],
        opts: Mapping[str, Any] | None = None,
    ) -> dict[str, Any]:
        if self.backend == "cpu":
            return check_total_queue_cpu(history)
        st = fused_queue_stats(pack_histories([history], device=self.device))
        return _tensors_to_results(
            total_queue_classify(st.a, st.e, st.d, packed_out=True)
        )[0]
