"""The port's obs registry and span ring ≡ the JAX package's: the same
samples into both registries give the same quantiles, counters, states
and Prometheus text; the same records into both rings give the same
health; and the port counts and traces where the JAX package does
(``PipelineStats``, the ``.jtc`` hit/fallback counters, the native
pack span)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from jepsen_tpu.obs import metrics as jax_metrics
from jepsen_tpu.obs import trace as jax_trace
from jepsen_tpu.parallel.pipeline import PipelineStats as JaxPipelineStats
from jepsen_tpu_torch.obs import metrics as port_metrics
from jepsen_tpu_torch.obs import trace as port_trace
from jepsen_tpu_torch.parallel.pipeline import PipelineStats

PACKAGES = ((port_metrics, port_trace), (jax_metrics, jax_trace))
REPO = Path(__file__).resolve().parent.parent


def _samples(dist: str, n: int = 5000) -> np.ndarray:
    rng = np.random.default_rng(7)
    return {
        "lognormal": rng.lognormal(0.0, 1.0, n),
        "uniform": rng.uniform(0.001, 5.0, n),
        "exp": rng.exponential(0.05, n),
        "with zeros": np.concatenate([rng.exponential(1.0, n - 50),
                                      np.zeros(40), -np.ones(10)]),
    }[dist]


def _fill(metrics, xs) -> object:
    """One registry of each kind of metric, fed ``xs``; sketches merged
    from five shards, as per-lane sketches are."""
    reg = metrics.Registry()
    shards = [metrics.QuantileSketch() for _ in range(5)]
    for i, x in enumerate(xs):
        shards[i % 5].add(float(x))
    merged = reg.sketch("segmented.segment_check_s")
    for s in shards:
        merged.merge(s)
    reg.sketch("service.check_latency_s", op="check").merge_state(
        shards[0].state())
    reg.counter("pipeline.files_dropped", reason="zero-length").inc(2)
    reg.counter("jtc.hit").inc(len(xs))
    reg.gauge("service.carry_bytes").set(float(xs.max()))
    return reg


@pytest.mark.parametrize("dist", ["lognormal", "uniform", "exp",
                                  "with zeros"])
def test_same_samples_same_quantiles_counters_and_text(dist):
    xs = _samples(dist)
    port, ref = (_fill(m, xs) for m, _t in PACKAGES)
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        a = port.sketch("segmented.segment_check_s").quantile(q)
        b = ref.sketch("segmented.segment_check_s").quantile(q)
        assert a == b, q
    assert port.snapshot() == ref.snapshot()
    assert (port.sketch("segmented.segment_check_s").state()
            == ref.sketch("segmented.segment_check_s").state())
    # the same ring health on both sides, so that the texts compare whole
    for _m, trace in PACKAGES:
        trace.enable(capacity=256)
        for i in range(300):
            with trace.span("segmented.segment", track=f"t{i % 2}"):
                pass
        trace.event("checker.unit_retry")
        trace.disable()
    assert (port_metrics.render_prometheus(port)
            == jax_metrics.render_prometheus(ref))
    assert "jepsen_tpu_trace_spans_dropped_total 45" in (
        port_metrics.render_prometheus(port))


def test_sketch_state_delta_and_refusals_equal_reference():
    xs = _samples("lognormal", 400)
    states = []
    for metrics, _t in PACKAGES:
        sk = metrics.QuantileSketch()
        for x in xs[:200]:
            sk.add(float(x))
        prev = sk.state()
        for x in xs[200:]:
            sk.add(float(x))
        delta = metrics.sketch_state_delta(prev, sk.state())
        states.append((prev, delta, metrics.sketch_state_delta(
            sk.state(), prev)))
        with pytest.raises(ValueError, match="alpha"):
            sk.merge(metrics.QuantileSketch(alpha=0.05))
        reg = metrics.Registry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.sketch("x")
        empty = metrics.QuantileSketch()
        assert empty.quantile(0.5) != empty.quantile(0.5)  # NaN
    assert states[0] == states[1]


def test_trace_ring_equals_reference():
    out = []
    for _m, trace in PACKAGES:
        trace.enable(capacity=256)
        with trace.span("outer", track="lane0", args={"k": 1}):
            with trace.span("inner", track="lane0"):
                pass
        trace.event("mark", track="nemesis", args={"x": 2})
        trace.complete("pipeline.check", 1.0, 1.5, track="lane0")
        for _ in range(300):
            trace.event("fill")
        trace.disable()
        recs = trace.snapshot()
        out.append((
            [(r[0], r[1], r[2], r[5]) for r in recs],
            trace.spans_recorded(), trace.dropped(), trace.ring_capacity(),
            trace.track_span_counts(),
        ))
    assert out[0] == out[1]
    assert out[0][2] == 48  # 304 records in 256 slots


def test_disabled_span_is_a_shared_noop_with_no_allocation():
    """Off, a span is one shared no-op and costs no allocation: 10,000
    spans leave the block count where it was.  Counted in a process of
    its own, where no other thread (a test runner's, another test's)
    allocates meanwhile."""
    port_trace.disable()
    assert port_trace.span("x") is port_trace.span("y")
    code = (
        "import gc, sys\n"
        "from jepsen_tpu_torch.obs import trace\n"
        "def loop(n):\n"
        "    for _ in range(n):\n"
        "        with trace.span('pipeline.check'):\n"
        "            pass\n"
        "loop(100)\n"
        "gc.disable()\n"
        "before = sys.getallocatedblocks()\n"
        "loop(10_000)\n"
        "print(sys.getallocatedblocks() - before)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert int(out.stdout.strip()) < 50


def test_pipeline_stats_are_registry_views_as_in_the_reference():
    got, want = PipelineStats(), JaxPipelineStats()
    for stats in (got, want):
        stats.histories = 5
        stats.batches = 2
        stats.add_busy("produce", 0.0, 0.5)
        stats.add_busy("check", 0.0, 0.25)
        stats.add_busy("check", 0.0, 0.75)
        stats.note_quarantine({"stage": "check"}, histories=3)
        stats.wall_s = 1.0
        stats.finalize()
    assert got.metrics.snapshot() == want.metrics.snapshot()
    for f in ("histories", "batches", "quarantined", "produce_busy_s",
              "check_busy_s", "stage_overlap_frac", "device_idle_frac"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.check_batch_quantile(0.5) == want.check_batch_quantile(0.5)
    before = port_metrics.REGISTRY.value("pipeline.stage_busy_s",
                                         stage="place")
    PipelineStats().add_busy("place", 0.0, 0.125)
    assert port_metrics.REGISTRY.value(
        "pipeline.stage_busy_s", stage="place") == before + 0.125


def test_jtc_counters_and_native_pack_span(tmp_path):
    from jepsen_tpu_torch.history import columnar
    from jepsen_tpu_torch.history.fastpack import pack_files
    from jepsen_tpu_torch.history.rows import _rows_for
    from jepsen_tpu_torch.history.store import write_history_jsonl
    from jepsen_tpu_torch.history.synth import SynthSpec, synth_history

    reg = port_metrics.REGISTRY
    h = synth_history(SynthSpec(n_ops=30)).ops
    src = tmp_path / "history.jsonl"
    write_history_jsonl(src, h)

    def counts():
        return (reg.value("jtc.hit"),
                *(reg.value("jtc.fallback", reason=r)
                  for r in ("absent", "stale", "corrupt")))

    c0 = counts()
    assert columnar.consult(src) is None
    columnar.write_jtc(src, "queue", rows=_rows_for(h))
    assert columnar.consult(src) is not None
    with open(src, "a") as fh:
        fh.write("\n")  # the source changed: the substrate is stale
    assert columnar.consult(src) is None
    jtc = columnar.jtc_path_for(src)
    jtc.write_bytes(jtc.read_bytes()[:100])  # torn
    assert columnar.consult(src) is None
    assert [b - a for a, b in zip(c0, counts())] == [1, 1, 1, 1]

    port_trace.enable()
    pack_files([src, src])
    port_trace.disable()
    spans = [r for r in port_trace.snapshot()
             if r[1] == "fastpack.jt_pack_files"]
    assert len(spans) == 1 and spans[0][5]["files"] == 2
