"""Pinned host staging for the pipeline's host→device copies.

The counterpart of the JAX package's staging (``donated``,
``_device_put_on`` and ``StagingRing`` in ``parallel/pipeline.py``).  A
:class:`StagingRing` keeps ``depth`` page-locked host slots per shape
bucket for the four columns the check reads (``f``, ``type``, ``value``,
``mask``).  Staging a batch copies its columns into the next slot of
its bucket, copies the slot to the card on a side CUDA stream with
``non_blocking=True``, and records an event there that the compute
stream waits on; the host-analysis columns stay on the host.

A slot is handed out again only once the event of its last copy has
completed, so a copy still in flight never reads host memory that has
been refilled.  The device tensors are made on the side stream and read
on the compute stream, so each is marked with ``record_stream``: the
caching allocator then keeps its memory until the compute stream's work
on it is done.  Pinning is not optional: a ring that cannot pin its
slots raises; it never copies from pageable memory.
"""

from __future__ import annotations

import dataclasses

import torch

from jepsen_tpu_torch.history.encode import PackedHistories

#: the packed columns the check stage reads, the only ones staged
CHECK_COLUMNS = ("f", "type", "value", "mask")


class _Slot:
    """One pinned host buffer per check column, and the event of the
    last copy out of it."""

    def __init__(self, batch: int, length: int, dtypes: dict):
        self.host = {}
        for k in CHECK_COLUMNS:
            t = torch.empty((batch, length), dtype=dtypes[k], pin_memory=True)
            if not t.is_pinned():
                raise RuntimeError(
                    "could not allocate page-locked host memory for the "
                    "staging ring")
            self.host[k] = t
        self.event = torch.cuda.Event()


class StagingRing:
    """``depth`` pinned host slots per ``[batch, length]`` bucket (and
    column dtypes), a side stream for the host→device copies, and their
    events.  :meth:`stage` is called from one thread (the pipeline's
    caller thread)."""

    def __init__(self, device: torch.device, depth: int = 2):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a staging ring stages to a CUDA device, "
                             f"not {device}")
        self.device = device
        self.depth = max(1, depth)
        self.copy_stream = torch.cuda.Stream(device)
        self._rings: dict[tuple, list[_Slot]] = {}
        self._next: dict[tuple, int] = {}

    def _slot(self, packed: PackedHistories) -> _Slot:
        dtypes = {k: getattr(packed, k).dtype for k in CHECK_COLUMNS}
        key = (packed.batch, packed.length, *dtypes.values())
        ring = self._rings.setdefault(key, [])
        if len(ring) < self.depth:
            ring.append(_Slot(packed.batch, packed.length, dtypes))
            return ring[-1]
        i = self._next.get(key, 0)
        self._next[key] = (i + 1) % self.depth
        slot = ring[i]
        slot.event.synchronize()  # its last copy has left the host buffer
        return slot

    def stage(
        self, packed: PackedHistories, compute_stream: torch.cuda.Stream
    ) -> PackedHistories:
        """``packed`` (on the CPU) with its four check columns on the
        card, ready for work enqueued on ``compute_stream``; the other
        columns stay where they are."""
        slot = self._slot(packed)
        for k in CHECK_COLUMNS:
            slot.host[k].copy_(getattr(packed, k))
        with torch.cuda.stream(self.copy_stream):
            cols = {
                k: t.to(self.device, non_blocking=True)
                for k, t in slot.host.items()
            }
            slot.event.record(self.copy_stream)
        compute_stream.wait_event(slot.event)
        for t in cols.values():
            t.record_stream(compute_stream)
        return dataclasses.replace(packed, **cols)
