"""Row explosion: histories -> ``[n, 8]`` int32 row matrices.

The per-op half of packing (``encode.pack_histories`` = explosion +
assembly).  A copy of the JAX package's ``_rows_for``, so that both
packages explode a history into the same rows.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from jepsen_tpu_torch.history.ops import NO_VALUE, Op, OpType

_COLUMNS = (
    "index", "process", "type", "f", "value", "time_ms", "latency_ms",
    "first",
)


def _rows_for(history: Sequence[Op]) -> np.ndarray:
    """Explode one history into an ``[n, 8]`` int32 row matrix (the last
    column is the 0/1 first-row flag).

    Completion latencies come from a stable sort on process: a
    completion's latency is against the immediately preceding row of its
    process iff that row is its open INVOKE (a process has at most one
    open op).  Drain completions explode by ``np.repeat`` into one row per
    drained value; an empty drain becomes one ``NO_VALUE`` row.
    """
    n = len(history)
    if n == 0:
        return np.zeros((0, len(_COLUMNS)), np.int32)
    idx_l, proc_l, typ_l, f_l, time_l, val_l = zip(
        *[
            (op.index, op.process, op.type, op.f, op.time, op.value)
            for op in history
        ]
    )
    idx = np.asarray(idx_l, np.int32)
    proc = np.asarray(proc_l, np.int32)
    typ = np.asarray(typ_l, np.int32)
    f = np.asarray(f_l, np.int32)
    times = np.asarray(time_l, np.int64)  # ns: exceeds int32
    t_ms = np.where(times >= 0, times // 1_000_000, -1)

    order = np.argsort(proc, kind="stable")
    sp, st, s_inv = proc[order], times[order], typ[order] == int(OpType.INVOKE)
    ok = np.zeros(n, bool)
    ok[1:] = (
        ~s_inv[1:]
        & (sp[1:] == sp[:-1])
        & s_inv[:-1]
        & (st[:-1] >= 0)
        & (st[1:] >= 0)
    )
    lat_sorted = np.full(n, -1, np.int64)
    lat_sorted[1:][ok[1:]] = (st[1:] - st[:-1])[ok[1:]] // 1_000_000
    lat = np.empty(n, np.int64)
    lat[order] = lat_sorted

    # scalars resolve inline; lists leave a sentinel and are exploded
    # below only when present
    _LIST = NO_VALUE - 1  # impossible as a real value (values ≥ 0 or NO_VALUE)
    scalar_vals = [
        v
        if type(v) is int  # exact-type fast path; subclasses fall through
        else (
            _LIST
            if isinstance(v, (list, tuple))
            else (int(v) if isinstance(v, int) else NO_VALUE)  # e.g. bool
        )
        for v in val_l
    ]
    plain = _LIST not in scalar_vals
    if plain:
        flat_vals = scalar_vals
    else:
        counts = np.ones(n, np.int64)
        flat_vals = []
        for r, v in enumerate(scalar_vals):
            seq = val_l[r]
            if v != _LIST or not isinstance(seq, (list, tuple)):
                # scalar — including a real value equal to the sentinel,
                # which the type check disambiguates
                flat_vals.append(v)
                continue
            if seq:
                counts[r] = len(seq)
                flat_vals.extend(
                    x if isinstance(x, int) else NO_VALUE for x in seq
                )
            else:
                flat_vals.append(NO_VALUE)

    out = np.empty((len(flat_vals), len(_COLUMNS)), np.int32)
    if plain:
        rep = slice(None)
        first = np.ones(n, np.int32)
    else:
        rep = np.repeat(np.arange(n), counts)
        first = np.zeros(len(rep), np.int32)
        first[np.cumsum(counts) - counts] = 1
    v64 = np.asarray(flat_vals, np.int64)
    i32 = np.iinfo(np.int32)
    if v64.size and (
        int(v64.max()) > i32.max
        or int(v64.min()) < min(i32.min, _LIST)
        or int(t_ms.max(initial=0)) > i32.max
    ):
        # a silently int32-wrapped value would alias onto a legitimate one
        # and evade the packer's value_space guard
        raise OverflowError(
            "op value or timestamp exceeds the int32 packing range "
            f"(value range [{v64.min()}, {v64.max()}], "
            f"max time_ms {t_ms.max(initial=0)})"
        )
    out[:, 0] = idx[rep]
    out[:, 1] = proc[rep]
    out[:, 2] = typ[rep]
    out[:, 3] = f[rep]
    out[:, 4] = v64.astype(np.int32)
    out[:, 5] = t_ms[rep].astype(np.int32)
    out[:, 6] = np.where(first == 1, lat[rep], -1).astype(np.int32)
    out[:, 7] = first
    return out
