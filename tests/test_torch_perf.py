"""The port's ``perf`` ≡ the JAX package's: the same packed bytes through
both ``perf_tensor_check`` functions, field by field (``rates``,
``lat_hist`` and ``window_ms`` exact, ``quantiles`` bit for bit as
float32), and the ``Perf`` result map with its graphs."""

from pathlib import Path

import numpy as np
import pytest

from jepsen_tpu.checkers.perf import Perf as JaxPerf
from jepsen_tpu.checkers.perf import perf_tensor_check as jax_perf
from jepsen_tpu.history.ops import Op as JaxOp
from jepsen_tpu_torch.checkers.perf import _EDGES_MS, Perf, perf_tensor_check
from jepsen_tpu_torch.history.encode import pack_histories
from jepsen_tpu_torch.history.ops import Op, OpF, OpType

from _torch_ref import corpus_histories, reference_pair

FIELDS = ("rates", "lat_hist", "quantiles", "window_ms")

#: integer latencies (ms) on and around every bucket edge; the edges at
#: 0.1, 100 and 100,000 ms are the ones an integer can sit on exactly
EDGE_LATENCIES = sorted({int(x) for e in _EDGES_MS
                         for x in (np.floor(e), np.ceil(e))} | {100, 100_000})


def _ops(rng, n_ops: int, latencies, fs=(OpF.ENQUEUE, OpF.DEQUEUE,
                                         OpF.DRAIN)):
    """``n_ops`` invoke/complete pairs over 4 processes, each completion
    ``ok``, ``fail`` or ``info`` after a latency drawn from
    ``latencies`` (negative: the completion is stamped before its
    invoke)."""
    t = [1_000_000 * int(x) for x in rng.integers(0, 50, 4)]
    ops = []
    for i in range(n_ops):
        p = int(rng.integers(0, 4))
        f = fs[int(rng.integers(0, len(fs)))]
        v = i if f == OpF.ENQUEUE else None
        ops.append(Op.invoke(f, p, v, time=t[p]))
        lat = int(latencies[int(rng.integers(0, len(latencies)))])
        typ = (OpType.OK, OpType.OK, OpType.FAIL, OpType.INFO)[
            int(rng.integers(0, 4))]
        val = v
        if f == OpF.DRAIN and typ == OpType.OK:
            val = [int(x) for x in rng.integers(0, 50, int(rng.integers(0, 3)))]
        elif f == OpF.DEQUEUE and typ == OpType.OK:
            val = int(rng.integers(0, 50))
        ops.append(Op(typ, f, p, val, time=t[p] + lat * 1_000_000))
        t[p] += max(lat, 0) * 1_000_000 + int(rng.integers(1, 5)) * 1_000_000
    for i, op in enumerate(ops):
        op.index = i
    return ops


def _to_jax(history):
    return [JaxOp.from_json(op.to_json()) for op in history]


def _cases():
    rng = np.random.default_rng(20261017)
    return {
        "synth corpus with drains": corpus_histories(6, 150, lost=1,
                                                     duplicated=1),
        "fail and info completions": [
            _to_jax(_ops(rng, 60, [1, 3, 17, 250])) for _ in range(4)],
        "negative latencies": [
            _to_jax(_ops(rng, 50, [-40, -1, 0, 2, 900])) for _ in range(4)],
        "latencies on bucket edges": [
            _to_jax(_ops(rng, 120, EDGE_LATENCIES)) for _ in range(6)],
        "empty histories beside others": [
            [], _to_jax(_ops(rng, 30, [5, 60])), [],
            _to_jax(_ops(rng, 10, [100]))],
        "all empty": [[], []],
    }


CASES = _cases()


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", list(CASES))
def test_perf_tensor_check_equals_reference(name):
    ref, port = reference_pair(CASES[name])
    want, got = jax_perf(ref), perf_tensor_check(port)
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f)


def test_the_cases_reach_what_they_name():
    _, port = reference_pair(CASES["latencies on bucket edges"])
    got = perf_tensor_check(port)
    lat = port.latency_ms[port.first & port.mask]
    assert {100, 100_000} <= set(lat.tolist())
    assert int(got.lat_hist.sum()) > 0
    _, neg = reference_pair(CASES["negative latencies"])
    assert int(neg.latency_ms.min()) < -1
    _, mixed = reference_pair(CASES["fail and info completions"])
    rates = perf_tensor_check(mixed).rates.sum((0, 1, 2))
    assert (rates > 0).all()  # ok, fail and info each counted
    empty = perf_tensor_check(reference_pair(CASES["all empty"])[1])
    assert (empty.quantiles == -1).all() and (empty.window_ms == 1).all()


def test_port_packer_gives_the_same_perf():
    hs = CASES["fail and info completions"]
    got = perf_tensor_check(pack_histories(
        [[Op.from_json(o.to_json()) for o in h] for h in hs], device="cpu"))
    want = jax_perf(reference_pair(hs)[0])
    for f in FIELDS:
        np.testing.assert_array_equal(
            _bits(getattr(got, f).numpy()), _bits(np.asarray(getattr(want, f))))


def _plot_names(result):
    return {k: Path(v["file"]).name for k, v in result.items()
            if isinstance(v, dict) and "file" in v}


@pytest.mark.parametrize("fs", [
    (OpF.ENQUEUE, OpF.DEQUEUE, OpF.DRAIN),
    (OpF.APPEND, OpF.READ),  # remapped onto the producer/consumer slots
], ids=["queue", "stream"])
def test_perf_result_map_and_plots_equal_reference(tmp_path, fs):
    h = _ops(np.random.default_rng(7), 80, [2, 30, 400], fs=fs)
    got = Perf(out_dir=tmp_path / "port", device="cpu").check({}, h)
    want = JaxPerf(out_dir=tmp_path / "jax").check({}, _to_jax(h))
    assert _plot_names(got) == _plot_names(want) == {
        "latency-graph": "latency-raw.png", "rate-graph": "rate.png"}
    for k in ("latency-graph", "rate-graph"):
        assert Path(got[k]["file"]).is_file()
        assert Path(got[k]["file"]).parent == tmp_path / "port"
    strip = lambda r: {k: {kk: vv for kk, vv in v.items() if kk != "file"}
                       if isinstance(v, dict) else v for k, v in r.items()}
    assert strip(got) == strip(want)
    assert Perf(device="cpu").check({}, h) == JaxPerf().check({}, _to_jax(h))


def test_perf_reports_missing_matplotlib(tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "matplotlib", None)  # import fails
    h = _ops(np.random.default_rng(8), 20, [5])
    got = Perf(out_dir=tmp_path, device="cpu").check({}, h)
    for k in ("latency-graph", "rate-graph"):
        assert got[k] == {"valid?": True,
                          "error": "matplotlib is not installed"}
    assert got["valid?"] is True and not list(tmp_path.iterdir())
