"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


class DeviceFault(RuntimeError):
    """A fault of the card or of a kernel (no card, a build or launch
    failure, a CUDA error): never a fault of the data, so it raises and
    is never quarantined into an ``unknown`` verdict."""


class NoDeviceError(DeviceFault):
    """CUDA was asked for and no card is present."""


#: the exceptions that are faults of the card or of a kernel: the port's
#: own, and torch's for a CUDA error or an exhausted card
DEVICE_FAULTS: tuple[type[BaseException], ...] = (
    DeviceFault,
    torch.cuda.OutOfMemoryError,
    *((torch.AcceleratorError,) if hasattr(torch, "AcceleratorError")
      else ()),
)


def resolve_device(device: str | torch.device) -> torch.device:
    """``device`` as a ``torch.device``; raises :class:`NoDeviceError`
    when CUDA is asked for and no card is present, so that nothing
    quietly runs on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoDeviceError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch version on the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
