"""The port's command line exits as the JAX package's does: 2, with a
one-line ``error:``, for a usage or environment error (every refusal the
port makes), ``check STORE_ROOT`` checks the store's latest run, and
``bench-check`` reads ``--delivery`` only with ``--pipeline``."""

import json
import os
import shutil
import stat
from pathlib import Path

import pytest
import torch

from jepsen_tpu.cli.main import main as jax_main
from jepsen_tpu.history.store import write_history_jsonl
from jepsen_tpu.history.synth import StreamSynthSpec, SynthSpec
from jepsen_tpu.history.synth import synth_batch, synth_stream_batch
from jepsen_tpu_torch.__main__ import main as port_main

from test_torch_pipeline import _stdout

REPO = Path(__file__).resolve().parent.parent
RECORDED = REPO / "store" / "cluster_r12_nemesis_queue" / "history.jsonl"


def _queue_run(root: Path, name: str = "run0") -> Path:
    d = root / name
    d.mkdir(parents=True)
    write_history_jsonl(d / "history.jsonl",
                        synth_batch(1, SynthSpec(n_ops=30))[0].ops)
    return d


def _stream_run(root: Path, name: str) -> Path:
    d = root / name
    d.mkdir(parents=True)
    write_history_jsonl(d / "history.jsonl",
                        synth_stream_batch(1, StreamSynthSpec(n_ops=30))[0].ops)
    return d


def _log_pattern_run(root: Path) -> Path:
    d = _queue_run(root, "logged")
    (d / "results.json").write_text(json.dumps(
        {"log-file-pattern": {"valid?": True, "pattern": "panic"}}))
    return d


#: name -> (argv made in a scratch dir, a word the error names)
REFUSALS = {
    "check, missing history": (
        lambda t: ["check", "--device", "cpu", str(t / "nope")], "no "),
    "bench-check --pipeline, missing store": (
        lambda t: ["bench-check", "--pipeline", "--device", "cpu",
                   str(t / "nope")], "no histories"),
    "bench-check --histories, missing store": (
        lambda t: ["bench-check", "--device", "cpu", "--histories",
                   str(t / "nope")], "no histories"),
    "check, a stream history": (
        lambda t: ["check", "--device", "cpu", str(_stream_run(t, "s"))],
        "item 6"),
    "check --segment-ops, a stream history": (
        lambda t: ["check", "--device", "cpu", "--segment-ops", "8",
                   str(_stream_run(t, "s"))], "item 6"),
    "bench-check, a stream majority": (
        lambda t: ["bench-check", "--device", "cpu", "--histories",
                   str(_stream_run(t, "s").parent)], "item 6"),
    "bench-check --workload elle": (
        lambda t: ["bench-check", "--device", "cpu", "--workload", "elle"],
        "item 7"),
    "synth --workload stream": (
        lambda t: ["synth", "--workload", "stream", "--store", str(t)],
        "item 6"),
    "synth --workload elle": (
        lambda t: ["synth", "--workload", "elle", "--store", str(t)],
        "item 7"),
    "synth --workload mutex": (
        lambda t: ["synth", "--workload", "mutex", "--store", str(t)],
        "item 8"),
    "bench-check --engine": (
        lambda t: ["bench-check", "--device", "cpu", "--engine", "classic"],
        "item 8"),
    "bench-check --lanes": (
        lambda t: ["bench-check", "--device", "cpu", "--lanes", "2"],
        "item 9"),
    "bench-check --mesh": (
        lambda t: ["bench-check", "--device", "cpu", "--mesh"], "item 9"),
    "bench-check --pipeline --reduce": (
        lambda t: ["bench-check", "--pipeline", "--reduce", "--device", "cpu",
                   str(_queue_run(t).parent)], "item 9"),
    "check --prefix-index": (
        lambda t: ["check", "--device", "cpu", "--segment-ops", "8",
                   "--prefix-index", str(t / "idx"), str(_stream_run(t, "s"))],
        "item 6"),
    "check --segment-ops --carry-cap": (
        lambda t: ["check", "--device", "cpu", "--segment-ops", "8",
                   "--carry-cap", "10", str(_queue_run(t))], "item 8"),
    "check, a log-file-pattern run": (
        lambda t: ["check", "--device", "cpu", str(_log_pattern_run(t))],
        "log-file-pattern"),
    "bench-check --workers -1": (
        lambda t: ["bench-check", "--device", "cpu", "--workers", "-1"],
        "--workers"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_every_refusal_exits_2_with_an_error_line(tmp_path, capsys, name):
    argv, word = REFUSALS[name]
    rc = port_main(argv(tmp_path))
    err = capsys.readouterr().err.strip().splitlines()
    assert rc == 2
    assert len(err) >= 1 and err[-1].startswith("error: "), err
    assert word in err[-1]


@pytest.mark.parametrize("argv", [
    ["check", "RUN"],
    ["check", "--segment-ops", "8", "RUN"],
    ["bench-check", "--count", "2", "--ops", "20"],
    ["bench-check", "--pipeline", "STORE"],
])
def test_no_card_exits_2(tmp_path, capsys, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    run = _queue_run(tmp_path)
    argv = [str(run) if a == "RUN" else str(tmp_path) if a == "STORE" else a
            for a in argv]
    assert port_main(argv) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert err == ["error: no CUDA device is available; pass device='cpu' "
                   "to run the plain PyTorch version on the CPU"]
    assert not (run / "results.json").exists()


#: every command whose stats stage is K1, over the run or store "RUN"
K1_COMMANDS = {
    "bench-check": ["bench-check", "--count", "2", "--ops", "20"],
    "bench-check --histories": ["bench-check", "--histories", "STORE"],
    "bench-check --pipeline": ["bench-check", "--pipeline", "STORE"],
    "bench-check --pipeline --fail-fast": ["bench-check", "--pipeline",
                                           "--fail-fast", "STORE"],
    "check": ["check", "RUN"],
    "check --serial": ["check", "--serial", "RUN"],
    "check --segment-ops": ["check", "--segment-ops", "8", "RUN"],
}


def _patch_k1(monkeypatch, fn):
    """``fn`` in place of K1's wrapper, in every module of the port that
    calls it."""
    from jepsen_tpu_torch.checkers import fused, queue_lin, total_queue
    from jepsen_tpu_torch.ops import queue_stats

    for mod in (fused, queue_lin, total_queue, queue_stats):
        monkeypatch.setattr(mod, "fused_queue_stats", fn)


def _k1_argv(tmp_path, name):
    run = _queue_run(tmp_path / "store")
    argv = [str(run) if a == "RUN" else str(run.parent) if a == "STORE"
            else a for a in K1_COMMANDS[name]]
    return argv[:1] + ["--device", "cpu"] + argv[1:], run


@pytest.mark.parametrize("name", list(K1_COMMANDS))
def test_a_kernel_build_failure_exits_2_and_stays_loud(tmp_path, capsys,
                                                       monkeypatch, name):
    """K1 that does not build: one ``error:`` line naming the kernel, then
    the compiler's own text on stderr, from every command whose stats
    stage is K1 (never a quarantined ``unknown``, never a traceback)."""
    from jepsen_tpu_torch.ops import _build, queue_stats

    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'queue_stats.cu(1): error: the "
                    "compiler says no'\nexit 1\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    def building_stats(packed, pos=None):
        queue_stats._kernel()  # what the first launch on a card does
        raise AssertionError("unreachable: the build fails")

    _patch_k1(monkeypatch, building_stats)
    argv, run = _k1_argv(tmp_path, name)
    rc = port_main(argv)
    out, err = capsys.readouterr()
    err = err.strip().splitlines()
    assert rc == 2
    i = next(k for k, line in enumerate(err) if line.startswith("error: "))
    assert err[i] == "error: nvcc failed for queue_stats.cu (exit 1):"
    assert err[i + 1] == "queue_stats.cu(1): error: the compiler says no"
    assert "Traceback" not in "\n".join(err)
    assert not list((tmp_path / "build").glob("*.so"))
    assert not (run / "results.json").exists()
    assert "unknown" not in out


@pytest.mark.parametrize("name", list(K1_COMMANDS))
def test_a_cuda_error_in_the_stats_stage_exits_2(tmp_path, capsys,
                                                 monkeypatch, name):
    """An error of the card while K1 runs (here torch's own CUDA error, or
    a launcher's) raises to one ``error:`` line and exit 2: it is not
    retried into a quarantined ``unknown``."""
    from jepsen_tpu_torch.device import DEVICE_FAULTS
    from jepsen_tpu_torch.ops import queue_stats

    cuda_error = next((t for t in DEVICE_FAULTS
                       if t.__name__ == "AcceleratorError"),
                      queue_stats._build.KernelLaunchError)
    calls = []

    def faulting_stats(packed, pos=None):
        calls.append(1)
        raise cuda_error("CUDA error: an illegal memory access was "
                         "encountered")

    _patch_k1(monkeypatch, faulting_stats)
    argv, run = _k1_argv(tmp_path, name)
    rc = port_main(argv)
    out, err = capsys.readouterr()
    assert rc == 2
    last = err.strip().splitlines()[-1]
    assert last.startswith("error: ") and "illegal memory access" in last
    assert len(calls) == 1  # no retry, no salvage
    assert not (run / "results.json").exists()
    assert "unknown" not in out


def test_verdict_codes_stay_0_1_3(tmp_path):
    clean = tmp_path / "clean"
    clean.mkdir()
    write_history_jsonl(clean / "history.jsonl",
                        synth_batch(1, SynthSpec(n_ops=40, seed=3))[0].ops)
    lossy = tmp_path / "lossy"
    lossy.mkdir()
    write_history_jsonl(lossy / "history.jsonl",
                        synth_batch(1, SynthSpec(n_ops=40, seed=3),
                                    lost=1)[0].ops)
    for run, want in ((clean, 0), (lossy, 1)):
        rc, _ = _stdout(port_main, ["check", "--device", "cpu", str(run)])
        jrc, _ = _stdout(jax_main, ["check", str(run)])
        assert rc == jrc == want
    poisoned = tmp_path / "poisoned"
    shutil.copytree(clean, poisoned)
    with open(poisoned / "history.jsonl", "a") as fh:
        fh.write('{"type": "torn mid-rec\n')
    rc, _ = _stdout(port_main, ["check", "--device", "cpu", "--segment-ops",
                                "16", str(poisoned)])
    jrc, _ = _stdout(jax_main, ["check", "--segment-ops", "16",
                                str(poisoned)])
    assert rc == jrc == 3


def test_check_store_root_resolves_the_latest_run(tmp_path):
    """A store whose ``run1/`` holds a copy of a recorded queue history,
    with ``latest -> run1``: both packages check that run, to the same
    map and exit code."""
    results = {}
    for pkg, fn in (("port", port_main), ("jax", jax_main)):
        store = tmp_path / pkg
        (store / "run1").mkdir(parents=True)
        shutil.copy(RECORDED, store / "run1" / "history.jsonl")
        os.symlink(store / "run1", store / "latest")
        argv = ["check", str(store)]
        rc, _ = _stdout(fn, argv[:1] + (["--device", "cpu"] if pkg == "port"
                                        else []) + argv[1:])
        saved = json.loads((store / "run1" / "results.json").read_text())
        results[pkg] = (rc, saved["queue"], saved["linear"])
    assert results["port"] == results["jax"]
    assert results["port"][0] == 1  # re-checked as exactly-once: invalid


def test_bench_check_reads_delivery_only_with_pipeline(tmp_path):
    """Over a store whose histories hold only duplicated values,
    ``bench-check --histories STORE --delivery at-least-once`` checks the
    batch exactly-once in both packages (the JAX command reads
    ``--delivery`` only with ``--pipeline``), so both count every history
    invalid; with ``--pipeline`` both honour it and count none."""
    src = tmp_path / "src"
    rc, _ = _stdout(port_main, ["synth", "--store", str(src), "--count", "6",
                                "--ops", "60", "--duplicated", "1"])
    assert rc == 0
    counts = {}
    for pipeline in (False, True):
        for pkg, fn, dev in (("port", port_main, ["--device", "cpu"]),
                             ("jax", jax_main, [])):
            store = tmp_path / f"{pkg}-{pipeline}"
            shutil.copytree(src, store)
            argv = ["bench-check", *dev, "--histories", str(store),
                    "--delivery", "at-least-once"]
            if pipeline:
                argv.append("--pipeline")
            rc, out = _stdout(fn, argv)
            assert rc == 0
            summary = json.loads(out.strip().splitlines()[-1])
            counts[pkg, pipeline] = summary["invalid"], summary["histories"]
    n = counts["port", False][1]
    assert n >= 6
    assert counts["port", False] == counts["jax", False] == (n, n)
    assert counts["port", True] == counts["jax", True] == (0, n)
