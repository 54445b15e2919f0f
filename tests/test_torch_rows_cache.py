"""The port's history substrate ≡ the JAX package's: ``.jtc`` and npz row
caches written by either package are read by the other, the same input
gives the same ``.jtc`` bytes, the freshness and corruption rules hold,
a port rewrite keeps other families' sections, and the port's native
packer equals the Python row explosion."""

import json
import logging
from pathlib import Path

import numpy as np
import pytest

from jepsen_tpu.checkers.elle import ElleMopsMeta as JaxElleMopsMeta
from jepsen_tpu.history import columnar as jax_columnar
from jepsen_tpu.history import rows as jax_rows
from jepsen_tpu.history.synth import SynthSpec as JaxSynthSpec
from jepsen_tpu.history.synth import synth_batch as jax_synth_batch
from jepsen_tpu_torch.history import columnar, fastpack, rows
from jepsen_tpu_torch.history.rows import _rows_for
from jepsen_tpu_torch.history.store import read_history, write_history_jsonl
from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch

REPO = Path(__file__).resolve().parent.parent
RECORDED = [REPO / "store/rabbitmq-simple-partition/20260730T165911/history.jsonl",
            REPO / "store/cluster_r12_nemesis_queue/history.jsonl"]


def _history(tmp_path: Path, seed: int = 0, name: str = "history.jsonl",
             **anomalies) -> tuple[Path, np.ndarray]:
    sh = synth_batch(1, SynthSpec(n_ops=150, seed=seed), **anomalies)[0]
    d = tmp_path / f"run{seed}"
    d.mkdir(exist_ok=True)
    p = d / name
    write_history_jsonl(p, sh.ops)
    return p, _rows_for(sh.ops)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["jtc", "npz"])
def test_caches_are_read_across_packages(tmp_path, monkeypatch, writer, fmt):
    if fmt == "npz":
        monkeypatch.setenv("JEPSEN_TPU_NO_JTC", "1")
    p, want = _history(tmp_path, lost=1)
    save, load = ((jax_rows.save_rows_cache, rows.load_rows_cache)
                  if writer == "jax" else
                  (rows.save_rows_cache, jax_rows.load_rows_cache))
    save(p, "queue", want)
    written = {"jtc": columnar.jtc_path_for(p), "npz": rows.cache_path_for(p)}
    assert written[fmt].is_file()
    assert not written["jtc" if fmt == "npz" else "npz"].exists()
    workload, got = load(p)
    assert workload == "queue"
    np.testing.assert_array_equal(np.asarray(got), want)


def test_same_input_gives_the_same_jtc_bytes(tmp_path):
    p, r = _history(tmp_path)
    jax_columnar.write_jtc(p, "queue", rows=r)
    want = columnar.jtc_path_for(p).read_bytes()
    columnar.write_jtc(p, "queue", rows=r)
    assert columnar.jtc_path_for(p).read_bytes() == want
    # every section kind, through both builders
    rng = np.random.default_rng(3)
    cells = rng.integers(0, 99, (7, 8)).astype(np.int32)
    stream = (rng.integers(0, 9, (5, 6)).astype(np.int32), True)
    txn, keys = [0, 2, 5], [11, -4, 2**40]

    def secs(mod, meta_cls):
        return mod._coerce_sections(
            r, stream, (cells, meta_cls(n_txns=3, txn_index=txn, keys=keys,
                                        degenerate=True)), wgl=cells)

    args = ("elle", b"history.jsonl", 1234, 5678, bytes(range(32)))
    assert (columnar.build_jtc_bytes(secs(columnar, columnar.ElleMopsMeta),
                                     *args)
            == jax_columnar.build_jtc_bytes(secs(jax_columnar,
                                                 JaxElleMopsMeta), *args))


def test_a_rewritten_source_makes_the_cache_stale(tmp_path):
    p, r = _history(tmp_path, seed=1)
    rows.save_rows_cache(p, "queue", r)
    assert rows.load_rows_cache(p) is not None
    q, _ = _history(tmp_path, seed=2)
    p.write_bytes(q.read_bytes())  # another history in the same file
    assert rows.load_rows_cache(p) is None
    assert jax_rows.load_rows_cache(p) is None
    workload, got, hit = rows.rows_with_cache(p)
    assert not hit and workload == "queue"
    np.testing.assert_array_equal(got, _rows_for(read_history(p)))
    assert rows.rows_with_cache(p)[2]  # the miss left a fresh cache


def test_a_corrupt_jtc_is_a_logged_miss(tmp_path, monkeypatch, caplog):
    p, r = _history(tmp_path, seed=3)
    columnar.write_jtc(p, "queue", rows=r)
    t = columnar.jtc_path_for(p)
    raw = bytearray(t.read_bytes())
    raw[-60] ^= 0xFF  # a flipped bit in the last payload or the footer
    t.write_bytes(bytes(raw))
    with pytest.raises(columnar.ColumnarFormatError):
        columnar.read_jtc(t)
    with caplog.at_level(logging.WARNING):
        assert rows.load_rows_cache(p) is None
    assert "corrupt columnar substrate" in caplog.text
    monkeypatch.setenv("JEPSEN_TPU_JTC_STRICT", "1")
    with pytest.raises(columnar.ColumnarFormatError):
        rows.load_rows_cache(p)
    t.write_bytes(bytes(raw[:100]))  # truncated
    with pytest.raises(columnar.ColumnarFormatError, match="truncated"):
        columnar.read_jtc(t)


def test_port_rewrite_keeps_other_families_sections(tmp_path):
    p, r = _history(tmp_path, seed=4)
    rng = np.random.default_rng(5)
    stream = (rng.integers(0, 9, (6, 6)).astype(np.int32), True)
    wgl = rng.integers(0, 9, (4, 8)).astype(np.int32)
    emops = (rng.integers(0, 9, (3, 8)).astype(np.int32),
             JaxElleMopsMeta(n_txns=2, txn_index=[0, 1], keys=[7, 9]))
    jax_columnar.write_jtc(p, "queue", rows=r[:5], stream=stream,
                           emops=emops, wgl=wgl)
    assert columnar.update_jtc(p, "queue", rows=r)
    got = jax_columnar.load_jtc(p)
    np.testing.assert_array_equal(got.rows(), r)
    np.testing.assert_array_equal(got.stream()[0], stream[0])
    assert got.stream()[1] is True
    np.testing.assert_array_equal(got.wgl_cells(), wgl)
    mat, meta = got.emops()
    np.testing.assert_array_equal(mat, emops[0])
    assert (meta.n_txns, meta.txn_index, meta.keys) == (2, [0, 1], [7, 9])
    port = columnar.load_jtc(p)
    assert port.emops()[1] == columnar.ElleMopsMeta(2, [0, 1], [7, 9], False)


def test_the_store_jtc_written_by_the_jax_package_is_served():
    p = RECORDED[1]
    jtc, _stamp = columnar.read_jtc(columnar.jtc_path_for(p))
    assert jtc.workload == "queue"
    np.testing.assert_array_equal(jtc.rows(), _rows_for(read_history(p)))


def test_native_packer_equals_row_explosion(tmp_path):
    paths = [_history(tmp_path, seed=s, **a)[0] for s, a in enumerate(
        [{}, {"lost": 1}, {"duplicated": 2}, {"unexpected": 1},
         {"causality": 1}])] + RECORDED
    for p in paths:
        workload, got = fastpack.pack_file(p)
        assert workload == "queue"
        np.testing.assert_array_equal(got, _rows_for(read_history(p)))
    many = fastpack.pack_files(paths, threads=3, use_jtc=False)
    for p, (workload, got) in zip(paths, many):
        np.testing.assert_array_equal(got, _rows_for(read_history(p)))
    # the same rows as the JAX package's own explosion
    hs = [sh.ops for sh in jax_synth_batch(2, JaxSynthSpec(n_ops=60))]
    for i, h in enumerate(hs):
        q = tmp_path / f"jax{i}.jsonl"
        q.write_text("".join(json.dumps(op.to_json()) + "\n" for op in h))
        np.testing.assert_array_equal(fastpack.pack_file(q)[1],
                                      jax_rows._rows_for(h))


def test_native_packer_flags_what_python_refuses(tmp_path):
    bad = tmp_path / "history.jsonl"
    bad.write_text('{"type": "not a real op"\n')
    assert fastpack.pack_file(bad) is None
    assert fastpack.pack_files([bad]) == [None]
    with pytest.raises(ValueError):
        rows.rows_with_cache(bad)  # the Python path's canonical error
    assert fastpack.pack_file(tmp_path / "history.edn") is None


def test_a_packer_that_does_not_build_raises_with_the_compiler_text(
        tmp_path, monkeypatch):
    src = tmp_path / "rows_packer.cpp"
    src.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(fastpack, "SOURCE", src)
    monkeypatch.setattr(fastpack, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="failed for rows_packer.cpp") as e:
        fastpack.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "build").iterdir())
