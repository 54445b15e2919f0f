"""The port's ``bench-check`` (without ``--pipeline``) and ``synth`` ≡ the
JAX package's: the counterparts of ``tests/test_cli.py``'s synthetic,
synth-then-store and mixed-store cases, with ``histories``,
``ops_per_history`` and ``invalid`` equal on the same seeds; ``--workers``
equal to the serial path; the store-level packed cache written by each
package and hit by the other; and ``--profile``."""

import json
from pathlib import Path

import numpy as np
import pytest

from jepsen_tpu.cli.main import main as jax_main
from jepsen_tpu.history.storecache import STORE_CACHE
from jepsen_tpu.history.storecache import (
    load_packed_store_cache as jax_load_store_cache,
)
from jepsen_tpu_torch.__main__ import PROFILE_TRACE
from jepsen_tpu_torch.__main__ import main as port_main
from jepsen_tpu_torch.history.encode import TENSOR_FIELDS
from jepsen_tpu_torch.history.parpack import (
    WORKER_MODULE,
    _worker_argv,
    _worker_env,
)
from jepsen_tpu_torch.history.store import history_paths
from jepsen_tpu_torch.history.storecache import load_packed_store_cache

from test_torch_pipeline import _stdout

COUNTS = ("histories", "ops_per_history", "invalid")


def _bench(fn, argv):
    if fn is port_main:
        argv = [*argv, "--device", "cpu"]
    rc, out = _stdout(fn, ["bench-check", *argv])
    return rc, json.loads(out.strip().splitlines()[-1])


def _synth(fn, store: Path, *argv):
    rc, out = _stdout(fn, ["synth", "--store", str(store), *argv])
    assert rc == 0, out
    return out


def _same_counts(argv_port, argv_jax=None):
    rc, got = _bench(port_main, argv_port)
    jrc, want = _bench(jax_main, argv_jax or argv_port)
    assert rc == jrc == 0
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert set(want) - {"backend"} <= set(got) and got["device"] == "cpu"
    return got


@pytest.mark.parametrize("count, ops", [(8, 60), (5, 200)])
def test_bench_check_synthetic(count, ops):
    got = _same_counts(["--count", str(count), "--ops", str(ops)])
    assert got["histories"] == count and got["invalid"] >= 1
    assert got["histories_per_sec"] > 0 and got["check_s"] > 0


def test_synth_then_bench_on_store(tmp_path):
    for pkg, fn in (("port", port_main), ("jax", jax_main)):
        out = _synth(fn, tmp_path / pkg, "--count", "4", "--ops", "50",
                     "--lost", "1", "--duplicated", "1")
        assert out.strip() == f"wrote 4 histories under {tmp_path / pkg}"
    ports = sorted(history_paths(tmp_path / "port"))
    jaxes = sorted(history_paths(tmp_path / "jax"))
    assert [p.read_text() for p in ports] == [p.read_text() for p in jaxes]
    got = _same_counts(["--histories", str(tmp_path / "port")],
                       ["--histories", str(tmp_path / "jax")])
    assert got["histories"] == 4


def test_bench_check_mixed_store_filters_majority(tmp_path, capsys):
    for pkg, fn in (("port", port_main), ("jax", jax_main)):
        _synth(fn, tmp_path / pkg, "--count", "3", "--ops", "40")
        # the stream family from the JAX package's synth, in both stores
        _synth(jax_main, tmp_path / pkg, "--workload", "stream",
               "--count", "1", "--ops", "40")
    capsys.readouterr()
    got = _same_counts(["--histories", str(tmp_path / "port")],
                       ["--histories", str(tmp_path / "jax")])
    assert got["histories"] == 3  # the queue majority wins
    assert "mixed store" in capsys.readouterr().err
    assert not (tmp_path / "port" / STORE_CACHE).exists()  # a mixed store


@pytest.mark.parametrize("source", ["synthetic", "stored"])
def test_workers_equal_the_serial_path(tmp_path, source):
    if source == "stored":
        _synth(port_main, tmp_path, "--count", "6", "--ops", "50",
               "--lost", "1")
        argv = ["--histories", str(tmp_path)]
    else:
        argv = ["--count", "6", "--ops", "50"]
    rc, par = _bench(port_main, [*argv, "--workers", "2"])
    if source == "stored":
        (tmp_path / STORE_CACHE).unlink()
    rc2, ser = _bench(port_main, argv)
    assert rc == rc2 == 0
    assert {k: par[k] for k in COUNTS} == {k: ser[k] for k in COUNTS}
    assert "produce_s" in par and "produce_s" not in ser
    jrc, want = _bench(jax_main, [*argv, "--workers", "2"])
    assert {k: par[k] for k in COUNTS} == {k: want[k] for k in COUNTS}


def test_workers_run_the_port_module_with_no_card():
    env = _worker_env()
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    argv = _worker_argv("in.pkl", "out.pkl")
    assert argv[1:] == ["-m", WORKER_MODULE, "in.pkl", "out.pkl"]
    assert WORKER_MODULE == "jepsen_tpu_torch.history.parpack"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_cache_written_by_one_package_is_hit_by_the_other(
        tmp_path, capsys, writer):
    _synth(port_main, tmp_path, "--count", "5", "--ops", "60", "--lost", "1")
    paths = history_paths(tmp_path)
    capsys.readouterr()
    fn, other = ((port_main, jax_main) if writer == "port"
                 else (jax_main, port_main))
    rc, first = _bench(fn, ["--histories", str(tmp_path)])
    assert rc == 0 and (tmp_path / STORE_CACHE).is_file()
    assert "store cache hit" not in capsys.readouterr().err
    rc, second = _bench(other, ["--histories", str(tmp_path)])
    assert rc == 0 and "store cache hit" in capsys.readouterr().err
    assert {k: first[k] for k in COUNTS} == {k: second[k] for k in COUNTS}
    jax_packed = jax_load_store_cache(tmp_path, paths)
    port_packed = load_packed_store_cache(tmp_path, paths)
    assert port_packed.value_space == jax_packed.value_space
    for k in TENSOR_FIELDS:
        a, b = getattr(port_packed, k).numpy(), np.asarray(getattr(
            jax_packed, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    # a member rewritten after the cache: the cache is refused
    paths[0].write_text(paths[0].read_text())
    assert load_packed_store_cache(tmp_path, paths) is None


def test_profile_writes_a_chrome_trace(tmp_path):
    rc, got = _bench(port_main, ["--count", "3", "--ops", "40", "--profile",
                                 str(tmp_path / "prof")])
    assert rc == 0 and got["histories"] == 3
    trace = json.loads((tmp_path / "prof" / PROFILE_TRACE).read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("scatter" in n or "index_put" in n or "aten::" in n
               for n in names)
