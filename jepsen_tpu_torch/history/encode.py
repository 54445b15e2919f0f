"""Packing histories into fixed-shape ``[B, L]`` torch tensors.

The counterpart of the JAX package's ``history/encode.py``, with the same
rules, so that both packages pack a batch to the same bytes:

1. **Drain explosion.**  A drain completion's list of values becomes one
   row per value (``history/rows.py``); an empty drain becomes a single
   ``NO_VALUE`` row.
2. **Padding.**  Histories are padded to a fixed length ``L`` (rounded up
   to a multiple of 128 by default); padded rows have ``mask=False`` and
   ``value=NO_VALUE`` and are no-ops in every kernel.
3. **Value space.**  ``V`` is the largest value + 1 rounded up to 128
   (at least 128); a value ``≥ V`` is refused, because the per-value
   kernels would drop exactly the values an "unexpected" anomaly makes.
4. **Narrow columns.**  ``type``/``f`` are int8, ``value`` int16 when
   ``V ≤ 32767`` and int32 above, ``mask``/``first`` bool; the host
   columns (index, process, times) stay int32.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.device import resolve_device
from jepsen_tpu_torch.history.ops import NO_VALUE, Op
from jepsen_tpu_torch.history.rows import _COLUMNS, _rows_for

LANE = 128  # default padding granule of L and V


def _round_up(n: int, k: int) -> int:
    return ((max(n, 1) + k - 1) // k) * k


@dataclass
class PackedHistories:
    """A batch of histories as ``[B, L]`` tensors on one device.
    ``value_space`` is the width V of the per-value statistics; every
    value is in ``[0, V)`` or ``NO_VALUE``."""

    index: torch.Tensor  # [B, L] int32 — original history index of the row
    process: torch.Tensor  # [B, L] int32
    type: torch.Tensor  # [B, L] int8 — OpType codes
    f: torch.Tensor  # [B, L] int8 — OpF codes
    value: torch.Tensor  # [B, L] int16 (int32 when V > 32767) or NO_VALUE
    time_ms: torch.Tensor  # [B, L] int32 — ms since history start
    latency_ms: torch.Tensor  # [B, L] int32 — completion latency or -1
    mask: torch.Tensor  # [B, L] bool
    first: torch.Tensor  # [B, L] bool — first exploded row of its op
    value_space: int = 0

    @property
    def batch(self) -> int:
        return self.type.shape[0]

    @property
    def length(self) -> int:
        return self.type.shape[1]

    @property
    def device(self) -> torch.device:
        return self.type.device


TENSOR_FIELDS = tuple(
    f.name for f in fields(PackedHistories) if f.name != "value_space"
)


def from_reference_arrays(
    cols: Mapping[str, np.ndarray],
    value_space: int,
    device: str | torch.device = "cuda",
) -> PackedHistories:
    """A ``PackedHistories`` from packed columns handed over as numpy
    arrays (for example the JAX package's packer output), byte for byte.
    ``cols`` holds every tensor field of :class:`PackedHistories`."""
    dev = resolve_device(device)
    missing = [k for k in TENSOR_FIELDS if k not in cols]
    if missing:
        raise ValueError(f"missing packed columns: {missing}")
    shapes = {np.shape(cols[k]) for k in TENSOR_FIELDS}
    if len(shapes) != 1 or len(next(iter(shapes))) != 2:
        raise ValueError(f"packed columns must share one [B, L] shape: {shapes}")
    return PackedHistories(
        **{
            k: torch.from_numpy(np.ascontiguousarray(cols[k])).to(dev)
            for k in TENSOR_FIELDS
        },
        value_space=int(value_space),
    )


def pack_histories(
    histories: Sequence[Sequence[Op]],
    length: int | None = None,
    value_space: int | None = None,
    device: str | torch.device = "cuda",
) -> PackedHistories:
    """Pack a batch of histories into one ``PackedHistories`` on
    ``device``.  ``length``: L, by default the longest exploded history
    rounded up to 128.  ``value_space``: V, by default the largest value
    + 1 rounded up to 128."""
    if not histories:
        raise ValueError("cannot pack an empty batch of histories")
    return pack_row_matrices(
        [_rows_for(h) for h in histories],
        length=length,
        value_space=value_space,
        device=device,
    )


def pack_row_matrices(
    mats: Sequence[np.ndarray],
    length: int | None = None,
    value_space: int | None = None,
    device: str | torch.device = "cuda",
) -> PackedHistories:
    """Assemble pre-exploded ``[n, 8]`` row matrices (``_rows_for``) into
    a :class:`PackedHistories` on ``device``."""
    dev = resolve_device(device)
    if not mats:
        raise ValueError("cannot pack an empty batch of histories")
    n_max = max(m.shape[0] for m in mats)
    L = length if length is not None else _round_up(n_max, LANE)
    if n_max > L:
        raise ValueError(f"history of exploded length {n_max} exceeds L={L}")
    B = len(mats)

    vmax = max(
        (int(m[:, 4].max(initial=0)) for m in mats if m.shape[0]), default=0
    )
    V = value_space if value_space is not None else _round_up(vmax + 1, LANE)
    if vmax >= V:
        raise ValueError(
            f"history contains value {vmax} >= value_space {V}; "
            "raise value_space (or omit it to size automatically)"
        )

    val_dt = np.int16 if V <= np.iinfo(np.int16).max else np.int32
    dtypes = {
        "index": np.int32,
        "process": np.int32,
        "type": np.int8,
        "f": np.int8,
        "value": val_dt,
        "time_ms": np.int32,
        "latency_ms": np.int32,
        "first": bool,
    }
    cols = {
        c: np.full((B, L), -1, dtype=dt)
        if c != "first"
        else np.zeros((B, L), dtype=bool)
        for c, dt in dtypes.items()
    }
    cols["value"][:] = NO_VALUE
    cols["mask"] = np.zeros((B, L), dtype=bool)
    for b, m in enumerate(mats):
        n = m.shape[0]
        for ci, c in enumerate(_COLUMNS):
            cols[c][b, :n] = m[:, ci]
        cols["mask"][b, :n] = True
    return PackedHistories(
        **{k: torch.from_numpy(cols[k]).to(dev) for k in TENSOR_FIELDS},
        value_space=V,
    )


def pack_history(
    history: Sequence[Op],
    length: int | None = None,
    value_space: int | None = None,
    device: str | torch.device = "cuda",
) -> PackedHistories:
    """Pack a single history (batch dim of 1)."""
    return pack_histories(
        [history], length=length, value_space=value_space, device=device
    )
