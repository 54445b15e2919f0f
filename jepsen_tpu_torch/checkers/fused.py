"""Both quorum-queue verdicts from one pass of the fused stats kernel.

One pass over the packed rows (``ops/queue_stats.py``) yields every
per-value stat that total-queue and queue linearizability classify from.
On CUDA tensors that pass is the hand-written kernel; on CPU tensors it is
the plain version.  This is the port's main path: the counterpart of the
JAX package's ``checkers/fused.py`` (``_combined_batch`` and
``fused_tensor_check``).
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from jepsen_tpu_torch.checkers.queue_lin import (
    DELIVERIES,
    QueueLinTensors,
    QueueLinTensorsPacked,
    queue_lin_classify,
    queue_lin_tensors_to_results,
)
from jepsen_tpu_torch.checkers.total_queue import (
    TotalQueueTensors,
    TotalQueueTensorsPacked,
    _tensors_to_results,
    total_queue_classify,
)
from jepsen_tpu_torch.history.encode import PackedHistories, pack_histories
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats


def combined_tensor_check(
    packed: PackedHistories,
    delivery: str = "exactly-once",
    packed_out: bool = False,
) -> tuple[
    TotalQueueTensors | TotalQueueTensorsPacked,
    QueueLinTensors | QueueLinTensorsPacked,
]:
    """Batched total-queue + queue-linearizability results: the stats
    pass (the kernel on CUDA, the plain version on the CPU), then both
    classifiers.  ``packed_out=True`` returns the per-value class masks
    as presence bits."""
    if delivery not in DELIVERIES:
        raise ValueError(f"unknown delivery contract {delivery!r}")
    st = fused_queue_stats(packed)
    tq = total_queue_classify(st.a, st.e, st.d, packed_out=packed_out)
    ql = queue_lin_classify(
        st.a, st.x, st.s, st.d, st.t,
        exactly_once=delivery == "exactly-once",
        packed_out=packed_out,
    )
    return tq, ql


#: The JAX package's name for the stats → classify path.
fused_tensor_check = combined_tensor_check


def queue_results(tq, ql, delivery: str | None = None,
                  n: int | None = None) -> list[dict[str, Any]]:
    """The verdict tensors of :func:`combined_tensor_check` → one
    ``{"queue": …, "linear": …}`` pair of result maps for each of the
    first ``n`` histories (all by default).  Each ``linear`` map records
    its delivery contract, which a re-check inherits; with ``delivery``
    None it has no such key, as the service's ``check`` reply."""
    out = []
    for q, lin in zip(_tensors_to_results(tq)[:n],
                      queue_lin_tensors_to_results(ql)[:n]):
        if delivery is not None:
            lin["delivery"] = delivery
        out.append({"queue": q, "linear": lin})
    return out


def check_queue_batch(
    histories: Sequence[Sequence[Op]],
    delivery: str = "exactly-once",
    device: str | torch.device = "cuda",
) -> list[dict[str, Any]]:
    """Pack and check a batch of histories on ``device``; one
    ``{"queue": …, "linear": …}`` pair of result maps per history."""
    tq, ql = combined_tensor_check(
        pack_histories(histories, device=device), delivery, packed_out=True
    )
    return queue_results(tq, ql, delivery)
