"""Masked per-value scatters, batched over ``[B, L]``.

The queue checkers reduce each history to per-value statistics over a
dense value space of width ``V``: a masked scatter-add or scatter-min of
each row into its value's slot.  PyTorch has no dropping scatter, and
``index_add_`` raises at index ``V``; so unselected rows (and values
outside ``[0, V)``) are routed to a sink slot ``V`` of a ``[B, V + 1]``
buffer that is sliced off afterwards.  Routing to ``-1`` would wrap
onto ``V - 1``.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1


def _routed(values: torch.Tensor, select: torch.Tensor, value_space: int):
    """int64 scatter indices: the value where selected and in ``[0, V)``,
    else the sink slot ``V``.  Narrow values widen here, per call."""
    v = values.long()
    return torch.where(select & (v >= 0) & (v < value_space), v, value_space)


def masked_value_counts(
    values: torch.Tensor,  # [B, L] int16/int32
    select: torch.Tensor,  # [B, L] bool
    value_space: int,
) -> torch.Tensor:
    """``out[b, v] = #{i : select[b, i] and values[b, i] == v}``, int32."""
    B = values.shape[0]
    out = torch.zeros((B, value_space + 1), dtype=torch.int32, device=values.device)
    out.scatter_add_(
        1,
        _routed(values, select, value_space),
        torch.ones(values.shape, dtype=torch.int32, device=values.device),
    )
    return out[:, :value_space]


def masked_value_reduce_min(
    values: torch.Tensor,  # [B, L] int16/int32
    select: torch.Tensor,  # [B, L] bool
    payload: torch.Tensor,  # [B, L] — quantity to min-reduce per value
    value_space: int,
) -> torch.Tensor:
    """``out[b, v] = min(payload[b, i] : select[b, i] and values[b, i] ==
    v)``, ``INT32_MAX`` where no row matched, int32."""
    B = values.shape[0]
    out = torch.full(
        (B, value_space + 1), INT32_MAX, dtype=torch.int32, device=values.device
    )
    out.scatter_reduce_(
        1,
        _routed(values, select, value_space),
        payload.to(torch.int32).expand(values.shape).contiguous(),
        "amin",
        include_self=True,
    )
    return out[:, :value_space]
