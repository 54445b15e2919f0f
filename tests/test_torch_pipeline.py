"""The port's pipeline executor ≡ the JAX package's: ``check_sources`` on
queue history files, serial and overlapped, against the JAX package's
``check_sources`` and the CPU oracles; the elastic and fail-fast
contracts; ``bench-check --pipeline`` and ``check`` against the JAX
commands; and no path that runs on the CPU when CUDA was asked for."""

import contextlib
import io
import json
import shutil
from pathlib import Path

import pytest
import torch

from jepsen_tpu.cli.main import main as jax_main
from jepsen_tpu.history.store import write_history_jsonl
from jepsen_tpu.history.synth import SynthSpec, synth_batch
from jepsen_tpu.parallel.pipeline import check_sources as jax_check_sources
from jepsen_tpu_torch.__main__ import main as port_main
from jepsen_tpu_torch.checkers.protocol import merge_valid
from jepsen_tpu_torch.checkers.queue_lin import check_queue_lin_cpu
from jepsen_tpu_torch.checkers.total_queue import check_total_queue_cpu
from jepsen_tpu_torch.history.rows import _rows_for
from jepsen_tpu_torch.history.store import read_history
from jepsen_tpu_torch.parallel.pipeline import (
    PipelineError,
    PipelineStats,
    PipelinedChecker,
    check_sources,
    family_for,
    run_pipeline,
)

from _torch_ref import ANOMALIES, DELIVERIES

REPO = Path(__file__).resolve().parent.parent
STORES = [
    "store/rabbitmq-simple-partition/20260730T165911",
    "store/cluster_r12_nemesis_queue",
]
N = 22  # 3 full chunks of 6 and a tail of 4, padded


def _write_store(root: Path, n: int = N) -> list[Path]:
    """``n`` queue histories, one run directory each, in sorted order."""
    paths = []
    for i in range(n):
        sh = synth_batch(1, SynthSpec(n_ops=40 + 7 * i, seed=i),
                         **ANOMALIES[i % len(ANOMALIES)])[0]
        d = root / f"run{i:03d}"
        d.mkdir(parents=True)
        write_history_jsonl(d / "history.jsonl", sh.ops)
        paths.append(d / "history.jsonl")
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _write_store(tmp_path_factory.mktemp("store"))


def _oracle(paths, delivery):
    out = []
    for p in paths:
        h = read_history(p)
        out.append({"queue": check_total_queue_cpu(h),
                    "linear": check_queue_lin_cpu(h, delivery)})
    return out


@pytest.mark.parametrize("delivery", DELIVERIES)
def test_check_sources_equals_reference_and_oracle(corpus, delivery):
    got, stats = check_sources("queue", corpus, chunk=6, delivery=delivery,
                               device="cpu")
    serial, _ = check_sources("queue", corpus, chunk=6, delivery=delivery,
                              device="cpu", serial=True)
    want, _ = jax_check_sources("queue", corpus, chunk=6, delivery=delivery)
    assert got == serial == want == _oracle(corpus, delivery)
    assert stats.batches == 4 and stats.histories == N
    assert {r["linear"]["delivery"] for r in got} == {delivery}


def test_cold_and_uncached_runs_equal_warm(tmp_path, corpus):
    paths = _write_store(tmp_path, 7)
    cold, _ = check_sources("queue", paths, chunk=3, device="cpu")
    assert all(p.with_suffix(".jtc").is_file() for p in paths)
    warm, _ = check_sources("queue", paths, chunk=3, device="cpu")
    parse, _ = check_sources("queue", paths, chunk=3, device="cpu",
                             use_cache=False)
    assert cold == warm == parse == _oracle(paths, "exactly-once")


def test_tail_chunk_is_padded_to_the_chunk_shape(corpus):
    fam = family_for("queue", device="cpu", chunk_pad=6)
    packed = fam.produce(corpus[-4:])
    assert packed.batch == 6 and not packed.mask[4:].any()
    n_max = max(len(_rows_for(read_history(q))) for q in corpus[-4:])
    for width in (packed.length, packed.value_space):
        assert width >= 128 and width & (width - 1) == 0  # a power of two
    assert packed.length // 2 < n_max <= packed.length
    assert len(fam.convert(corpus[-4:], fam.collect(fam.check(packed)))) == 4


def test_corrupt_file_mid_corpus_quarantines_only_itself(tmp_path, corpus):
    bad = tmp_path / "bad" / "history.jsonl"
    bad.parent.mkdir()
    bad.write_text('{"type": "not a real op"\n')  # torn JSON line
    files = corpus[:6]
    mix = files[:2] + [bad] + files[2:]
    res, stats = check_sources("queue", mix, chunk=4, device="cpu")
    assert len(res) == 7
    for fam in ("queue", "linear"):
        assert res[2][fam]["valid?"] == "unknown"
        assert res[2][fam]["quarantined"]["errors"]
    serial, _ = check_sources("queue", files, chunk=4, device="cpu",
                              serial=True)
    assert [r for i, r in enumerate(res) if i != 2] == serial
    assert stats.quarantined == 1 and stats.unit_retries >= 1
    want, _ = jax_check_sources("queue", mix, chunk=4)
    assert [r["queue"]["valid?"] for r in want] == [
        r["queue"]["valid?"] for r in res]
    # unknown never folds into valid; an invalid history still trumps it
    assert merge_valid(r["queue"]["valid?"] for r in res) is False
    assert merge_valid(r["queue"]["valid?"] for r in res
                       if r["queue"]["valid?"] is not False) == "unknown"


def test_fail_fast_raises_with_no_results(tmp_path, corpus):
    bad = tmp_path / "history.jsonl"
    bad.write_text('{"type": "not a real op"\n')
    with pytest.raises(PipelineError, match="produce stage crashed"):
        check_sources("queue", corpus[:3] + [bad], chunk=2, device="cpu",
                      fail_fast=True)

    def check(x):
        if x == 3:
            raise RuntimeError("device exploded")
        return torch.tensor([x])

    with pytest.raises(PipelineError, match="device exploded"):
        run_pipeline(list(range(6)), lambda x: x, check, fail_fast=True)


def test_elastic_run_pipeline_quarantines_a_failing_item():
    def produce(i):
        if i == 2:
            raise RuntimeError("packer exploded")
        return i

    res, stats = run_pipeline(list(range(5)), produce,
                              lambda x: torch.tensor([x + 1]))
    assert res[2].stage == "produce"
    assert "packer exploded" in res[2].evidence()["errors"][-1]
    assert [int(res[i][0]) for i in (0, 1, 3, 4)] == [1, 2, 4, 5]
    assert stats.unit_retries == 1


def test_pipeline_stats_schema(corpus):
    _, stats = check_sources("queue", corpus, chunk=4, device="cpu")
    assert isinstance(stats, PipelineStats)
    assert stats.histories == N and stats.batches == 6
    assert stats.lanes == 1 and stats.dropped == 0
    assert stats.quarantined == 0 and stats.unit_retries == 0
    assert stats.wall_s > 0
    for f in ("produce_busy_s", "place_busy_s", "check_busy_s"):
        assert getattr(stats, f) >= 0
    assert 0.0 <= stats.stage_overlap_frac <= 1.0
    assert 0.0 <= stats.device_idle_frac <= 1.0
    _, serial = check_sources("queue", corpus, chunk=4, device="cpu",
                              serial=True)
    assert serial.stage_overlap_frac == 0.0


def test_pipelined_checker_from_a_file_and_from_ops(corpus):
    h = read_history(corpus[5])
    shared: dict = {}
    via_file = {sub: PipelinedChecker("queue", corpus[5], sub, shared=shared,
                                      device="cpu").check({}, h)
                for sub in ("queue", "linear")}
    from_ops = {sub: PipelinedChecker("queue", None, sub, device="cpu")
                .check({}, h) for sub in ("queue", "linear")}
    assert via_file == from_ops == _oracle(corpus[5:6], "exactly-once")[0]


def test_families_and_modes_not_ported_raise(corpus):
    for workload, item in (("stream", "item 6"), ("elle", "item 7"),
                           ("mutex", "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            check_sources(workload, corpus, device="cpu")
    for kw in ({"lanes": 0}, {"reduce": True}, {"mesh": object()}):
        with pytest.raises(NotImplementedError, match="item 9"):
            check_sources("queue", corpus, device="cpu", **kw)


def test_edn_sources_are_refused_by_name(tmp_path, corpus):
    """EDN sources were refused by name before the EDN reader was
    ported; now an EDN run without a JSONL twin is walked and checked
    as its JSONL copy is, and an exported twin beside a JSONL history
    is skipped."""
    from jepsen_tpu_torch.__main__ import bench_check_pipeline
    from jepsen_tpu_torch.history.edn import write_history_edn
    from jepsen_tpu_torch.history.store import history_paths

    run = tmp_path / "edn-run"
    run.mkdir()
    write_history_edn(run / "history.edn", read_history(corpus[1]))
    shutil.copytree(corpus[0].parent, tmp_path / "jsonl-run")
    write_history_edn(tmp_path / "jsonl-run" / "history.edn",
                      read_history(corpus[0]))  # a twin
    paths = history_paths(tmp_path)
    assert paths == [tmp_path / "jsonl-run" / "history.jsonl",
                     run / "history.edn"]
    assert [op.to_json() for op in read_history(run / "history.edn")] == [
        op.to_json() for op in read_history(corpus[1])]
    _, results, _ = bench_check_pipeline(tmp_path, chunk=4, device="cpu")
    assert results == _oracle(corpus[:2], "exactly-once")


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue()


def test_bench_check_pipeline_equals_reference(tmp_path):
    _write_store(tmp_path / "port", 9)
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    rc, out = _stdout(port_main, ["bench-check", "--pipeline", "--chunk", "4",
                                  "--device", "cpu", str(tmp_path / "port")])
    got = json.loads(out.strip().splitlines()[-1])
    jrc, jout = _stdout(jax_main, ["bench-check", "--pipeline", "--chunk", "4",
                                   "--histories", str(tmp_path / "jax")])
    want = json.loads(jout.strip().splitlines()[-1])
    assert rc == jrc == 0
    for k in ("histories", "batches", "invalid", "quarantined", "mode",
              "lanes", "dropped"):
        assert got[k] == want[k], k
    assert got["device"] == "cpu" and got["invalid"] > 0
    assert set(want) - {"backend"} <= set(got)
    rc, out = _stdout(port_main, ["bench-check", "--pipeline", "--serial",
                                  "--device", "cpu", str(tmp_path / "port")])
    serial = json.loads(out.strip().splitlines()[-1])
    assert (serial["mode"], serial["invalid"]) == ("serial", got["invalid"])


def _write_streams(root: Path, n: int) -> None:
    from jepsen_tpu.history.synth import StreamSynthSpec, synth_stream_batch

    for i, sh in enumerate(synth_stream_batch(n, StreamSynthSpec(n_ops=30))):
        d = root / f"stream{i:03d}"
        d.mkdir(parents=True)
        write_history_jsonl(d / "history.jsonl", sh.ops)


def test_bench_check_parses_each_file_once_and_caches_it(tmp_path,
                                                         monkeypatch):
    """A cold bench-check parses each file once, in its classification,
    and keeps the rows as the file's cache, which the check then reads;
    a warm one parses none."""
    from jepsen_tpu_torch.__main__ import bench_check_pipeline
    from jepsen_tpu_torch.history import fastpack

    paths = _write_store(tmp_path, 9)
    parsed = []
    real = fastpack.pack_files

    def counting(ps, *a, **kw):
        parsed.extend(ps)
        return real(ps, *a, **kw)

    monkeypatch.setattr(fastpack, "pack_files", counting)
    cold, results, _ = bench_check_pipeline(tmp_path, chunk=4, device="cpu")
    assert sorted(map(str, parsed)) == sorted(map(str, paths))
    assert all(p.with_suffix(".jtc").is_file() for p in paths)
    assert results == _oracle(paths, "exactly-once")
    parsed.clear()
    warm, again, _ = bench_check_pipeline(tmp_path, chunk=4, device="cpu")
    assert parsed == [] and again == results
    assert cold["classify_s"] > 0 and warm["invalid"] == cold["invalid"]


def test_bench_check_benches_the_majority_family(tmp_path):
    """As the JAX command: the majority family of a mixed store is
    benched and the rest skipped; a majority family that is not ported
    raises, naming its ROADMAP.md item."""
    from jepsen_tpu_torch.__main__ import bench_check_pipeline

    paths = _write_store(tmp_path / "mostly-queue", 5)
    _write_streams(tmp_path / "mostly-queue", 2)
    summary, results, _ = bench_check_pipeline(
        tmp_path / "mostly-queue", chunk=4, device="cpu")
    assert summary["histories"] == 5
    assert results == _oracle(paths, "exactly-once")
    _write_store(tmp_path / "mostly-stream", 2)
    _write_streams(tmp_path / "mostly-stream", 3)
    with pytest.raises(NotImplementedError, match="item 6"):
        bench_check_pipeline(tmp_path / "mostly-stream", device="cpu")


def _check_copy(fn, argv, run: Path):
    rc, out = _stdout(fn, [*argv, str(run)])
    return rc, json.loads((run / "results.json").read_text())


@pytest.mark.parametrize("store", STORES)
def test_check_on_copies_equals_reference(tmp_path, store):
    port_run, jax_run = tmp_path / "port", tmp_path / "jax"
    for run in (port_run, jax_run):
        shutil.copytree(REPO / store, run)
    rc, got = _check_copy(port_main, ["check", "--device", "cpu"], port_run)
    jrc, want = _check_copy(jax_main, ["check", "--checker", "tpu"], jax_run)
    assert rc == jrc == 0
    assert set(got) == set(want) == {"perf", "queue", "linear", "valid?"}
    assert got["queue"] == want["queue"] and got["linear"] == want["linear"]
    for k, v in want["perf"].items():
        if isinstance(v, dict):
            assert Path(got["perf"][k]["file"]).name == Path(v["file"]).name
            assert Path(got["perf"][k]["file"]).parent == port_run
        else:
            assert got["perf"][k] == v
    for name in ("latency-raw.png", "rate.png", "history.jtc"):
        assert (port_run / name).is_file()
    # the serial path gives the same map
    rc, serial = _check_copy(port_main, ["check", "--device", "cpu",
                                         "--serial"], port_run)
    assert serial == got


def test_default_device_raises_without_a_card(tmp_path, corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_sources("queue", corpus)
    # the command line says so in one line and exits 2
    assert port_main(["bench-check", "--pipeline",
                      str(corpus[0].parent)]) == 2
    run = tmp_path / "run"
    shutil.copytree(corpus[0].parent, run)
    assert port_main(["check", str(run)]) == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from jepsen_tpu_torch.__main__ import check_run

        check_run(run, None, "cuda")
    with pytest.raises(RuntimeError):  # pinned host memory needs a card
        from jepsen_tpu_torch.parallel.staging import _Slot

        _Slot(2, 128, {k: torch.int8 for k in ("f", "type", "value", "mask")})
    assert not (run / "results.json").exists()
