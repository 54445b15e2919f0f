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
import threading
from dataclasses import dataclass

import torch

from jepsen_tpu_torch.history.encode import PackedHistories
from jepsen_tpu_torch.history.ops import OpF, OpType
from jepsen_tpu_torch.ops import _build
from jepsen_tpu_torch.ops.counts import masked_value_counts, masked_value_reduce_min

N_STATS = 6
_COUNT_LOCK = threading.Lock()


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
        vp, vp, vp, ctypes.c_int, vp, vp, ctypes.c_longlong, vp,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, vp,
    ]
    fn.restype = ctypes.c_int
    return fn


_DTYPES = {  # f, type, value, mask
    (torch.int8, torch.int8, value, torch.bool)
    for value in (torch.int16, torch.int32)
}
_INT32 = torch.iinfo(torch.int32)


def _validated(
    packed: PackedHistories, pos: torch.Tensor | None
) -> torch.Tensor | None:
    """The one input contract of :func:`fused_queue_stats`, the same on
    every device; returns ``pos`` as int32 (``None``, ``[L]`` or
    ``[B, L]``).

    Columns are ``[B, L]`` with ``B > 0``: ``f``/``type`` int8, ``value``
    int16 or int32, ``mask`` bool (``TypeError`` otherwise), of any
    strides (the CUDA path copies a non-contiguous one).  ``pos`` is
    ``[L]``, shared by the batch, or ``[B, L]``, of any integer dtype; a
    dtype other than int32 is converted after a range check, so that a
    position int32 cannot hold raises ``ValueError`` instead of wrapping.
    An int32 ``pos`` is taken as it is, with no check and no host sync."""
    f, type_, value, mask = packed.f, packed.type, packed.value, packed.mask
    shape = value.shape
    if len(shape) != 2 or shape[0] == 0:
        raise ValueError(f"expected a non-empty [B, L] batch, got {tuple(shape)}")
    if packed.value_space <= 0:
        raise ValueError(f"value_space must be positive, got {packed.value_space}")
    dtypes = (f.dtype, type_.dtype, value.dtype, mask.dtype)
    if dtypes not in _DTYPES:
        raise TypeError("f, type, value, mask must be int8, int8, int16 or "
                        f"int32, bool; got {dtypes}")
    if not f.shape == type_.shape == shape == mask.shape:
        raise ValueError("f, type, value, mask must share one shape, got "
                         f"{[tuple(c.shape) for c in (f, type_, value, mask)]}")
    if pos is None:
        return None
    if pos.shape != shape and pos.shape != shape[1:]:
        raise ValueError(f"pos must have shape {tuple(shape[1:])} or "
                         f"{tuple(shape)}, got {tuple(pos.shape)}")
    if pos.dtype == torch.int32:
        return pos
    if pos.dtype.is_floating_point or pos.dtype.is_complex or pos.dtype == torch.bool:
        raise TypeError(f"pos must be an integer tensor, got {pos.dtype}")
    if pos.numel():
        lo, hi = (int(x) for x in torch.aminmax(pos))
        if lo < _INT32.min or hi > _INT32.max:
            raise ValueError(
                f"pos holds {lo}..{hi}, outside the int32 range of positions")
    return pos.to(torch.int32)


_PATHS = ("scalar", "vector")  # the load path the launcher reports


def _launch(packed: PackedHistories, pos: torch.Tensor | None) -> QueueStats:
    f, type_ = packed.f.contiguous(), packed.type.contiguous()
    value, mask = packed.value.contiguous(), packed.mask.contiguous()
    if pos is not None:
        pos = pos.contiguous()
    B, L = value.shape
    V = packed.value_space
    dev = value.device.index
    out = torch.empty((B, N_STATS, V), dtype=torch.int32, device=value.device)
    path = ctypes.c_int()
    rc = _kernel()(
        f.data_ptr(),
        type_.data_ptr(),
        value.data_ptr(),
        value.element_size(),
        mask.data_ptr(),
        None if pos is None else pos.data_ptr(),
        0 if pos is None or pos.dim() == 1 else L,  # pos's batch stride
        out.data_ptr(),
        B, L, V,
        ctypes.byref(path),
        dev,
        # the current stream's handle, without building a Stream object
        torch._C._cuda_getCurrentRawStream(dev),
    )
    if rc:
        raise _build.KernelLaunchError(
            f"queue_stats kernel launch failed: CUDA error {rc}")
    with _COUNT_LOCK:  # handler, worker and batcher threads launch at once
        fused_queue_stats.launches += 1
    fused_queue_stats.last_path = _PATHS[path.value]
    return QueueStats(*out.unbind(1))


def fused_queue_stats(
    packed: PackedHistories, pos: torch.Tensor | None = None
) -> QueueStats:
    """The six stats of a packed batch in one pass: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.  ``pos`` (``[L]`` or
    ``[B, L]``, any integer dtype) overrides the row positions.  Both
    devices take and refuse the same inputs (:func:`_validated`)."""
    cols = (packed.f, packed.type, packed.value, packed.mask)
    dev = packed.value.device
    if any(c.device != dev for c in cols) or (
        pos is not None and pos.device != dev
    ):
        raise ValueError("packed columns and pos must lie on one device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    pos = _validated(packed, pos)
    if dev.type == "cuda":
        return _launch(packed, pos)
    return queue_stats_plain(
        packed.f, packed.type, packed.value, packed.mask,
        packed.value_space, pos,
    )


fused_queue_stats.launches = 0  # kernel launches, for run accounting
fused_queue_stats.last_path = None  # load path the last launch took
