"""Per-value queue statistics: the CUDA kernel and its plain version.

The counterpart of the JAX package's ``ops/pallas_stats.py``.  Both queue
checkers classify from six per-value vectors over the live rows
(``mask`` set, ``value ≥ 0``) of each history:

    a[v] — enqueue-invoke count        (total-queue + queue-lin)
    e[v] — enqueue-ok count            (total-queue)
    x[v] — enqueue-fail count          (queue-lin)
    d[v] — ok dequeue/drain read count (total-queue + queue-lin)
    s[v] — least position of an enqueue invoke   (queue-lin)
    t[v] — least position of an ok read          (queue-lin)

``s``/``t`` are ``INT32_MAX`` where no row matched.  A row's position is
its row index unless a ``pos`` tensor gives global positions.

:func:`fused_queue_stats` dispatches on the tensors' device: the plain
version (:func:`queue_stats_plain`, masked scatters) for CPU tensors, the
hand-written kernel ``csrc/queue_stats.cu`` for CUDA tensors.  A CUDA
call launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from jepsen_tpu_torch.history.encode import PackedHistories
from jepsen_tpu_torch.history.ops import OpF, OpType
from jepsen_tpu_torch.ops import _build
from jepsen_tpu_torch.ops.counts import masked_value_counts, masked_value_reduce_min

N_STATS = 6


@dataclass
class QueueStats:
    """Per-value stats, each ``[B, V]`` int32."""

    a: torch.Tensor  # enqueue invokes
    e: torch.Tensor  # enqueue oks
    x: torch.Tensor  # enqueue fails
    d: torch.Tensor  # ok reads
    s: torch.Tensor  # least enqueue-invoke position (INT32_MAX if none)
    t: torch.Tensor  # least ok-read position (INT32_MAX if none)


def queue_stats_plain(
    f: torch.Tensor,
    type_: torch.Tensor,
    value: torch.Tensor,
    mask: torch.Tensor,
    value_space: int,
    pos: torch.Tensor | None = None,
) -> QueueStats:
    """The six stats by masked scatters over ``[B, L]`` columns, on any
    device."""
    live = (value >= 0) & mask.bool()
    is_enq = (f == int(OpF.ENQUEUE)) & live
    is_read = (
        ((f == int(OpF.DEQUEUE)) | (f == int(OpF.DRAIN)))
        & live
        & (type_ == int(OpType.OK))
    )
    enq_inv = is_enq & (type_ == int(OpType.INVOKE))
    if pos is None:
        pos = torch.arange(value.shape[-1], dtype=torch.int32, device=value.device)
    V = value_space
    return QueueStats(
        a=masked_value_counts(value, enq_inv, V),
        e=masked_value_counts(value, is_enq & (type_ == int(OpType.OK)), V),
        x=masked_value_counts(value, is_enq & (type_ == int(OpType.FAIL)), V),
        d=masked_value_counts(value, is_read, V),
        s=masked_value_reduce_min(value, enq_inv, pos, V),
        t=masked_value_reduce_min(value, is_read, pos, V),
    )


@functools.cache
def _kernel():
    fn = _build.load("queue_stats").queue_stats_launch
    vp = ctypes.c_void_p
    fn.argtypes = [
        vp, vp, vp, ctypes.c_int, vp, vp, vp,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_column(name: str, t: torch.Tensor, dtypes, shape) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(packed: PackedHistories, pos: torch.Tensor | None) -> QueueStats:
    value = packed.value
    shape = tuple(value.shape)
    if len(shape) != 2 or shape[0] == 0:
        raise ValueError(f"expected a non-empty [B, L] batch, got {shape}")
    B, L = shape
    V = packed.value_space
    if V <= 0:
        raise ValueError(f"value_space must be positive, got {V}")
    _check_column("value", value, (torch.int16, torch.int32), shape)
    _check_column("f", packed.f, (torch.int8,), shape)
    _check_column("type", packed.type, (torch.int8,), shape)
    _check_column("mask", packed.mask, (torch.bool,), shape)
    if pos is not None:
        _check_column("pos", pos, (torch.int32,), shape)
    dev = value.device
    out = torch.empty((B, N_STATS, V), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _kernel()(
            packed.f.data_ptr(),
            packed.type.data_ptr(),
            value.data_ptr(),
            value.element_size(),
            packed.mask.data_ptr(),
            None if pos is None else pos.data_ptr(),
            out.data_ptr(),
            B, L, V,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc:
        raise RuntimeError(f"queue_stats kernel launch failed: CUDA error {rc}")
    fused_queue_stats.launches += 1
    return QueueStats(*(out[:, k] for k in range(N_STATS)))


def fused_queue_stats(
    packed: PackedHistories, pos: torch.Tensor | None = None
) -> QueueStats:
    """The six stats of a packed batch in one pass: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  ``pos`` (``[B, L]``
    int32) overrides the row positions."""
    cols = (packed.f, packed.type, packed.value, packed.mask)
    dev = packed.value.device
    if any(c.device != dev for c in cols) or (
        pos is not None and pos.device != dev
    ):
        raise ValueError("packed columns and pos must lie on one device")
    if dev.type == "cuda":
        return _launch(packed, pos)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return queue_stats_plain(
        packed.f, packed.type, packed.value, packed.mask,
        packed.value_space, pos,
    )


fused_queue_stats.launches = 0  # kernel launches, for run accounting
