"""The port's EDN sources ≡ the JAX package's: the cases of
``tests/test_edn.py`` through both readers, ``synth --format edn`` read
back by both packages, the EDN-twin store walk, and a ``.jtc`` of an EDN
run written by one package and served by the other."""

import json
import shutil

import pytest

from jepsen_tpu.cli.main import _history_paths as jax_history_paths
from jepsen_tpu.cli.main import main as jax_main
from jepsen_tpu.history import columnar as jax_columnar
from jepsen_tpu.history import edn as jax_edn
from jepsen_tpu.history.store import Store as JaxStore
from jepsen_tpu.history.synth import SynthSpec as JaxSpec
from jepsen_tpu.history.synth import synth_history as jax_synth_history
from jepsen_tpu_torch.__main__ import main as port_main
from jepsen_tpu_torch.checkers.queue_lin import check_queue_lin_cpu
from jepsen_tpu_torch.checkers.total_queue import check_total_queue_cpu
from jepsen_tpu_torch.history import columnar as port_columnar
from jepsen_tpu_torch.history import edn as port_edn
from jepsen_tpu_torch.history.rows import _rows_for, load_rows_cache
from jepsen_tpu_torch.history.store import Store, history_paths, read_history

from test_torch_pipeline import _stdout

#: the parser inputs of tests/test_edn.py
FORMS = [
    r'"café A"',
    '[1 -2 3.5 "hi\\n" :kw :ns/kw nil true false sym 42N]',
    "; a comment\n{:a 1, :b [2 3]} #{4 5} (6 7)",
    '#jepsen.history.Op{:type :ok, :f :enqueue, :value 1, :process 0} '
    '#_ {:dropped true} 9',
    "{:type :invoke, :f :enqueue, :value 3, :process 2, :time 100, "
    ":index 7}",
    '{:type :info, :f :start, :process :nemesis, :value "partitioned"}',
    "{:type :fail, :f :dequeue, :process 1, :error :exhausted}",
]

#: inputs each reader refuses
BAD_FORMS = ["[1 2", '"open', "{:odd}"]
BAD_OPS = [
    "{:type :ok, :f :frobnicate, :process 0}",
    "{:type :ok, :f :enqueue, :value 1, :process :writer}",
    '{:type :ok, :f :enqueue, :value 1, :process "w3"}',
    "{:type :ok, :f :enqueue, :value 1, :process 1.5}",
]

JEPSEN_STYLE_HISTORY = """[
 {:type :invoke, :f :enqueue, :value 0, :process 0, :time 10, :index 0}
 {:type :ok,     :f :enqueue, :value 0, :process 0, :time 20, :index 1}
 {:type :invoke, :f :enqueue, :value 1, :process 1, :time 30, :index 2}
 #jepsen.history.Op{:type :info, :f :enqueue, :value 1, :process 1,
                    :time 40, :index 3}
 {:type :info, :f :start, :process :nemesis, :time 45, :index 4}
 {:type :invoke, :f :dequeue, :process 2, :time 50, :index 5}
 {:type :ok,     :f :dequeue, :value 0, :process 2, :time 60, :index 6}
 {:type :info, :f :stop, :process :nemesis, :time 65, :index 7}
 {:type :invoke, :f :drain, :process 3, :time 70, :index 8}
 {:type :ok,     :f :drain, :value [1], :process 3, :time 80, :index 9}
]
"""

RICH_NEMESIS = (
    '{:type :info, :f :start-partition, :process :nemesis, '
    ':value "majority"}\n'
    "{:type :info, :f :kill, :process :nemesis}\n"
    "{:type :invoke, :f :enqueue, :value 1, :process 0}\n"
    "{:type :ok, :f :enqueue, :value 1, :process 0}\n"
    "{:type :invoke, :f :drain, :process 1}\n"
    "{:type :ok, :f :drain, :value [1], :process 1}\n"
)

HISTORIES = {
    "vector layout": JEPSEN_STYLE_HISTORY,
    "line layout": JEPSEN_STYLE_HISTORY.strip()[1:-1].strip(),
    "lossy": JEPSEN_STYLE_HISTORY.replace(
        ":value [1], :process 3", ":value [], :process 3").replace(
        ":type :ok,     :f :dequeue, :value 0",
        ":type :fail,   :f :dequeue, :value nil"),
    "rich nemesis": RICH_NEMESIS,
}


def _ops_json(ops):
    return [op.to_json() for op in ops]


@pytest.mark.parametrize("text", FORMS)
def test_parser_equals_reference(text):
    got = port_edn.parse_edn_forms(text)
    assert got == jax_edn.parse_edn_forms(text)
    if text.startswith("{:type"):
        port_op = port_edn.op_from_edn(got[0])
        jax_op = jax_edn.op_from_edn(jax_edn.parse_edn_forms(text)[0])
        assert port_op.to_json() == jax_op.to_json()
    kws = [x for f in got if isinstance(f, list) for x in f
           if isinstance(x, port_edn.Keyword)]
    assert all(type(k) is port_edn.Keyword for k in kws)


@pytest.mark.parametrize("text", BAD_FORMS + BAD_OPS)
def test_refusals_equal_reference(text):
    with pytest.raises(port_edn.EdnError) as got:
        port_edn.op_from_edn(port_edn.parse_edn_forms(text)[0])
    with pytest.raises(jax_edn.EdnError) as want:
        jax_edn.op_from_edn(jax_edn.parse_edn_forms(text)[0])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", list(HISTORIES))
def test_history_import_equals_reference(tmp_path, name):
    p = tmp_path / "history.edn"
    p.write_text(HISTORIES[name])
    got = read_history(p)
    assert _ops_json(got) == _ops_json(jax_edn.read_history_edn(p))
    from jepsen_tpu.checkers.total_queue import (
        check_total_queue_cpu as jax_total_queue,
    )

    assert check_total_queue_cpu(got) == jax_total_queue(
        jax_edn.read_history_edn(p))


def test_export_roundtrip_and_escapes_equal_reference(tmp_path):
    from jepsen_tpu.history.ops import Op as JaxOp
    from jepsen_tpu_torch.history.ops import Op, OpF, OpType
    from jepsen_tpu_torch.history.synth import SynthSpec, synth_history

    h = synth_history(SynthSpec(n_ops=60, seed=4, lost=1)).ops
    crash = Op(type=OpType.FAIL, f=OpF.ENQUEUE, process=0, value=1, time=5,
               index=0, error="client-crash: boom\n  at line 1\ttab")
    port_edn.write_history_edn(tmp_path / "port.edn", [*h, crash])
    jax_ops = [JaxOp.from_json(op.to_json()) for op in [*h, crash]]
    jax_edn.write_history_edn(tmp_path / "jax.edn", jax_ops)
    text = (tmp_path / "port.edn").read_text()
    assert text == (tmp_path / "jax.edn").read_text()
    assert len(text.splitlines()) == len(h) + 1  # one op a line
    assert _ops_json(read_history(tmp_path / "port.edn")) == _ops_json(
        [*h, crash])


def test_synth_format_edn_read_back_by_both(tmp_path):
    rc, out = _stdout(port_main, ["synth", "--count", "3", "--ops", "60",
                                  "--lost", "2", "--format", "edn",
                                  "--store", str(tmp_path / "port")])
    assert rc == 0 and "wrote 3 histories" in out
    assert jax_main(["synth", "--count", "3", "--ops", "60", "--lost", "2",
                     "--format", "edn", "--store", str(tmp_path / "jax")]) == 0
    ports, jaxes = (
        sorted(p for p in (tmp_path / pkg).glob("synth/*/history.edn")
               if not p.parent.is_symlink())  # not the `current` link
        for pkg in ("port", "jax"))
    assert len(ports) == len(jaxes) == 3
    for p, j in zip(ports, jaxes):
        assert p.read_text() == j.read_text()
        assert _ops_json(read_history(p)) == _ops_json(
            jax_edn.read_history_edn(p))
        assert p.with_suffix(".jtc").is_file()  # cut at record time
    # the store root resolves to its latest run in both packages
    lost = [check_total_queue_cpu(read_history(p))["lost-count"]
            for p in ports]
    assert max(lost) >= 1
    rc, _ = _stdout(port_main, ["check", "--device", "cpu",
                                str(tmp_path / "port")])
    jrc, _ = _stdout(jax_main, ["check", str(tmp_path / "jax")])
    assert rc == jrc
    got = json.loads((ports[-1].parent / "results.json").read_text())
    want = json.loads((jaxes[-1].parent / "results.json").read_text())
    assert got["queue"] == want["queue"] and got["linear"] == want["linear"]


def test_edn_twin_walk_equals_reference(tmp_path):
    h = jax_synth_history(JaxSpec(n_ops=40, seed=1)).ops
    jax_store = JaxStore(tmp_path)
    twin = jax_store.run_dir("t", "a")
    jax_store.save_history(twin, h)
    jax_store.save_history_edn(twin, h)  # an exported twin: skipped
    alone = jax_store.run_dir("t", "b")
    jax_store.save_history_edn(alone, h)  # EDN only: walked
    got = history_paths(tmp_path)
    assert got == jax_history_paths(str(tmp_path))
    assert got == [twin / "history.jsonl", alone / "history.edn"]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_jtc_of_an_edn_run_serves_both_packages(tmp_path, writer):
    """The ``.jtc`` of an EDN run keys the EDN file's basename; the one
    either package writes is served by the other, with the same rows."""
    h = jax_synth_history(JaxSpec(n_ops=50, seed=2, lost=1)).ops
    d = tmp_path / "run"
    d.mkdir()
    if writer == "jax":
        JaxStore(tmp_path).save_history_edn(d, h)
    else:
        from jepsen_tpu_torch.history.ops import Op

        Store(tmp_path).save_history_edn(
            d, [Op.from_json(op.to_json()) for op in h])
    src = d / "history.edn"
    port_jtc = port_columnar.load_jtc(src)
    jax_jtc = jax_columnar.load_jtc(src)
    assert port_jtc is not None and jax_jtc is not None
    assert port_jtc.src_name == jax_jtc.src_name == "history.edn"
    rows = _rows_for(read_history(src))
    assert (port_jtc.rows() == rows).all() and (jax_jtc.rows() == rows).all()
    assert load_rows_cache(src)[0] == "queue"
    # a JSONL copy beside it is not served the EDN file's substrate
    shutil.copy(src, d / "history.jsonl")
    assert port_columnar.load_jtc(d / "history.jsonl") is None
    assert check_queue_lin_cpu(read_history(src))["valid?"] is True
