"""``perf``: windowed completion rates, latency histograms and quantiles.

The counterpart of the JAX package's ``checkers/perf.py`` (jepsen's
``checker/perf``: always ``{:valid? true}``; it draws graphs rather than
judging).  The statistics are torch ops over ``[B, L]`` packed columns
on any device; only the drawing is host-side matplotlib, imported when
an output directory is given.

Per history: completion time is cut into ``N_WINDOWS`` windows; each
window counts completions per op function and outcome (``rates``) and
histograms ok latencies into ``N_BUCKETS`` log-spaced buckets per op
function (``lat_hist``); p50/p95/p99 are the upper edges of the buckets
where the bucket CDF first reaches each quantile (``quantiles``).  The
arithmetic is the JAX package's to the bit: float32 bucket edges and
``searchsorted`` on the left, floor division of times, and the quantile
target ``ceil(total * q)`` in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from jepsen_tpu_torch.checkers.protocol import VALID, Checker
from jepsen_tpu_torch.history.encode import PackedHistories, pack_histories
from jepsen_tpu_torch.history.ops import Op, OpF, OpType

N_WINDOWS = 64
N_BUCKETS = 48
# log-spaced latency bucket edges: 0.1 ms … 100 s
_EDGES_MS = np.logspace(-1, 5, N_BUCKETS - 1)
_QUANTILES = (0.5, 0.95, 0.99)

_FS = (OpF.ENQUEUE, OpF.DEQUEUE, OpF.DRAIN)
_TYPES = (OpType.OK, OpType.FAIL, OpType.INFO)

#: stream, transactional and mutex ops ride the producer/consumer slots
#: of the grid, so that every family gets latency and rate graphs
_REMAP = {
    OpF.APPEND: OpF.ENQUEUE,
    OpF.READ: OpF.DEQUEUE,
    OpF.TXN: OpF.ENQUEUE,
    OpF.ACQUIRE: OpF.ENQUEUE,
    OpF.RELEASE: OpF.DEQUEUE,
}

MATPLOTLIB_MISSING = "matplotlib is not installed"


@dataclass
class PerfTensors:
    """Windowed stats per history.

    ``rates``:     [B, W, |F|, |T|] int32 completions per window
    ``lat_hist``:  [B, W, |F|, NB]  int32 ok-latency histogram
    ``quantiles``: [B, W, |F|, 3]   float32 p50/p95/p99 ok latency (ms,
                   bucket upper edge; -1 where the window has none)
    ``window_ms``: [B]              int32 window width
    """

    rates: torch.Tensor
    lat_hist: torch.Tensor
    quantiles: torch.Tensor
    window_ms: torch.Tensor


def _grid_add(flat: torch.Tensor, select: torch.Tensor, size: int):
    """Count selected rows of ``[B, L]`` into a ``[B, size]`` grid by
    their flat index; unselected rows go to a sink slot past the end
    (the JAX package's ``mode="drop"``)."""
    B = flat.shape[0]
    idx = torch.where(select, flat, size).long()
    out = torch.zeros((B, size + 1), dtype=torch.int32, device=flat.device)
    out.scatter_add_(1, idx, select.to(torch.int32))
    return out[:, :size]


def perf_tensor_check(packed: PackedHistories) -> PerfTensors:
    """The windowed stats of a packed batch, on the batch's device."""
    f, type_ = packed.f.long(), packed.type.long()
    time_ms, latency_ms = packed.time_ms, packed.latency_ms
    mask, first = packed.mask, packed.first
    dev = time_ms.device
    B = time_ms.shape[0]
    nf, nt = len(_FS), len(_TYPES)

    is_completion = mask & (type_ != int(OpType.INVOKE)) & (time_ms >= 0)
    t_max = torch.where(is_completion, time_ms, 0).amax(-1)  # [B] int32
    window_ms = torch.clamp(
        torch.div(t_max, N_WINDOWS, rounding_mode="floor") + 1, min=1)
    # padded rows carry time_ms = -1, which floors to window -1, then 0
    win = torch.clamp(
        torch.div(time_ms, window_ms[:, None], rounding_mode="floor"),
        0, N_WINDOWS - 1).long()

    edges = torch.from_numpy(_EDGES_MS.astype(np.float32)).to(dev)
    bucket = torch.searchsorted(edges, latency_ms.to(torch.float32),
                                side="left")

    sel = (
        is_completion
        & first  # one count per op, not per drain-exploded row
        & (f >= int(OpF.ENQUEUE))
        & (f <= int(OpF.DRAIN))
        & (type_ >= int(OpType.OK))
        & (type_ <= int(OpType.INFO))
    )
    ti = type_ - int(OpType.OK)  # OK/FAIL/INFO -> 0..2
    rates = _grid_add((win * nf + f) * nt + ti, sel, N_WINDOWS * nf * nt)
    rates = rates.view(B, N_WINDOWS, nf, nt)

    ok_lat = sel & (type_ == int(OpType.OK)) & (latency_ms >= 0)
    lat_hist = _grid_add((win * nf + f) * N_BUCKETS + bucket, ok_lat,
                         N_WINDOWS * nf * N_BUCKETS)
    lat_hist = lat_hist.view(B, N_WINDOWS, nf, N_BUCKETS)

    # quantiles from the bucket CDF (upper edge of the quantile bucket)
    cdf = torch.cumsum(lat_hist, -1, dtype=torch.int32)
    total = cdf[..., -1:]
    total_f = total.to(torch.float32)
    uppers = torch.from_numpy(np.concatenate(
        [_EDGES_MS, [_EDGES_MS[-1] * 10]]).astype(np.float32)).to(dev)
    qs = []
    for q in _QUANTILES:
        # float32, as the JAX package's int32 x weakly typed float
        need = torch.ceil(total_f * torch.tensor(q, dtype=torch.float32))
        reached = cdf.to(torch.float32) >= torch.clamp(need, min=1.0)
        idx = reached.to(torch.uint8).argmax(-1)  # first bucket reached
        qs.append(torch.where(total[..., 0] > 0, uppers[idx],
                              torch.tensor(-1.0, device=dev)))
    quantiles = torch.stack(qs, -1)
    return PerfTensors(rates=rates, lat_hist=lat_hist, quantiles=quantiles,
                       window_ms=window_ms)


# ---------------------------------------------------------------------------
# host-side rendering
# ---------------------------------------------------------------------------


def render_perf_plots(
    t: PerfTensors, out_dir: str | Path, history_idx: int = 0
) -> dict[str, str]:
    """Write ``latency-raw.png`` and ``rate.png`` for one history;
    returns ``{plot-name: path}``.  Raises ``ImportError`` where
    matplotlib is not installed."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    b = history_idx
    window_s = float(t.window_ms[b].cpu()) / 1e3
    xs = np.arange(N_WINDOWS) * window_s
    rates = t.rates[b].cpu().numpy()  # [W, F, T]
    quant = t.quantiles[b].cpu().numpy()  # [W, F, 3]

    paths = {}
    fig, ax = plt.subplots(figsize=(9, 4.5))
    for fi, fname in enumerate(("enqueue", "dequeue")):
        for qi, qname in enumerate(("p50", "p95", "p99")):
            ys = quant[:, fi, qi]
            ok = ys > 0
            ax.plot(xs[ok], ys[ok], marker=".", lw=1, label=f"{fname} {qname}")
    ax.set_yscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("latency (ms)")
    ax.set_title("completion latency quantiles")
    if ax.get_legend_handles_labels()[0]:
        ax.legend(loc="upper right", fontsize=7)
    p = out_dir / "latency-raw.png"
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    paths["latency-graph"] = str(p)

    fig, ax = plt.subplots(figsize=(9, 4.5))
    for fi, fname in enumerate(("enqueue", "dequeue")):
        for ti, tname in enumerate(("ok", "fail", "info")):
            ys = rates[:, fi, ti] / max(window_s, 1e-9)
            if ys.sum() == 0:
                continue
            ax.plot(xs, ys, lw=1, marker=".", label=f"{fname} {tname}")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("ops/s")
    ax.set_title("completion rate")
    if ax.get_legend_handles_labels()[0]:
        ax.legend(loc="upper right", fontsize=7)
    p = out_dir / "rate.png"
    fig.savefig(p, dpi=110, bbox_inches="tight")
    plt.close(fig)
    paths["rate-graph"] = str(p)
    return paths


class Perf(Checker):
    """``checker/perf``: windowed stats on ``device`` and, given an
    output directory, the two graphs; always valid.  Where matplotlib is
    not installed, each graph's map says so under ``"error"`` and
    carries no ``"file"``."""

    name = "perf"

    def __init__(self, out_dir: str | Path | None = None,
                 device: str | torch.device = "cuda"):
        self.out_dir = out_dir
        self.device = device

    def check(
        self,
        test: Mapping[str, Any],
        history: Sequence[Op],
        opts: Mapping[str, Any] | None = None,
    ) -> dict[str, Any]:
        history = [
            Op(op.type, _REMAP[op.f], op.process, op.value, op.time,
               op.index, op.error)
            if op.f in _REMAP
            else op
            for op in history
        ]
        t = perf_tensor_check(pack_histories([history], device=self.device))
        result: dict[str, Any] = {
            VALID: True,
            "latency-graph": {VALID: True},
            "rate-graph": {VALID: True},
        }
        if self.out_dir is not None:
            try:
                paths = render_perf_plots(t, self.out_dir)
            except ModuleNotFoundError as e:
                if e.name != "matplotlib":
                    raise
                for k in ("latency-graph", "rate-graph"):
                    result[k]["error"] = MATPLOTLIB_MISSING
                return result
            for k, p in paths.items():
                result[k] = {VALID: True, "file": p}
        return result
