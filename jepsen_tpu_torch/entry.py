"""Entry point: the combined quorum-queue check on a packed example batch.

The counterpart of ``__graft_entry__.entry()`` in the JAX package: the
same synthetic example (8 histories at L=256), the same host arrays, and
a step function that runs total-queue + queue linearizability.
"""

from __future__ import annotations

import numpy as np
import torch

from jepsen_tpu_torch.checkers.fused import combined_tensor_check
from jepsen_tpu_torch.device import resolve_device
from jepsen_tpu_torch.history.encode import PackedHistories, pack_histories
from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch


def _example_packed(batch: int, length: int) -> PackedHistories:
    shs = synth_batch(batch, SynthSpec(n_ops=max(length // 4, 16)))
    return pack_histories(
        [s.ops for s in shs], length=length, value_space=length, device="cpu"
    )


def entry(device: str | torch.device = "cuda"):
    """Return ``(fn, example_args)``.  The example args are host numpy
    arrays ``(f, type, value, mask)``; ``fn`` places them on ``device``
    and returns the dense ``(TotalQueueTensors, QueueLinTensors)``.
    ``entry()`` itself touches no device."""
    packed = _example_packed(batch=8, length=256)
    V = packed.value_space

    def check_step(f: np.ndarray, type_: np.ndarray, value: np.ndarray,
                   mask: np.ndarray):
        dev = resolve_device(device)
        cols = {
            k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for k, a in (("f", f), ("type", type_), ("value", value),
                         ("mask", mask))
        }
        # the check reads no host-analysis column: those stay blank
        shape = cols["f"].shape
        blank = torch.full(shape, -1, dtype=torch.int32, device=dev)
        step = PackedHistories(
            index=blank, process=blank, time_ms=blank, latency_ms=blank,
            first=torch.zeros(shape, dtype=torch.bool, device=dev),
            value_space=V, **cols,
        )
        return combined_tensor_check(step)

    example_args = tuple(
        getattr(packed, k).numpy() for k in ("f", "type", "value", "mask")
    )
    return check_step, example_args
