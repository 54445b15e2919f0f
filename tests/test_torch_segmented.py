"""The port's segmented queue engine ≡ the JAX package's ≡ the port's
monolithic check: the queue cases of ``tests/test_segmented.py``
(anomalies × deliveries × segment sizes, violations across segment
boundaries including settled → reopened, the ``.jtc`` producer, poison
quarantine, torn and mismatched checkpoints, kill and resume), plus
checkpoints handed from one package to the other, K1's segment shapes
(int16 and int32 local ids), and the rule that a fault of the device
raises instead of being quarantined."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu.checkers.segmented import SegmentedChecker as JaxSegmented
from jepsen_tpu.checkers.segmented import (
    segmented_check_file as jax_check_file,
)
from jepsen_tpu.cli.main import main as jax_main
from jepsen_tpu.history.store import Store as JaxStore
from jepsen_tpu_torch.__main__ import main as port_main
from jepsen_tpu_torch.checkers import segmented
from jepsen_tpu_torch.checkers.fused import check_queue_batch
from jepsen_tpu_torch.checkers.segmented import (
    DeviceError,
    SegmentedChecker,
    checkpoint_path_for,
    queue_prepare_rows,
    queue_stats_from_prepared,
    read_checkpoint,
    seg_queue_batch_program,
    segmented_check_file,
)
from jepsen_tpu_torch.history.ops import Op, OpF, OpType
from jepsen_tpu_torch.history.rows import _rows_for
from jepsen_tpu_torch.history.segments import (
    SegmentPoisonError,
    SourceMismatchError,
    iter_segments,
    prefix_sha256,
)
from jepsen_tpu_torch.history.store import json_default, write_history_jsonl
from jepsen_tpu_torch.history.synth import SynthSpec, synth_history

from test_torch_pipeline import _stdout

REPO = Path(__file__).resolve().parent.parent
FAMILIES = ("queue", "linear", "valid?")

QUEUE_ANOMALIES = (
    {},
    {"lost": 2},
    {"duplicated": 2},
    {"unexpected": 1},
    {"phantom_fail": 1},
    {"causality": 1},
    {"lost": 1, "duplicated": 1, "unexpected": 1, "causality": 1},
)


def norm(x):
    return json.loads(json.dumps(x, default=json_default))


def _jax_ops(ops):
    from jepsen_tpu.history.ops import Op as JaxOp

    return [JaxOp.from_json(op.to_json()) for op in ops]


def run_port(ops, segment_ops, opts=None, device="cpu"):
    eng = SegmentedChecker("queue", opts=opts or {}, device=device)
    for i in range(0, len(ops), segment_ops):
        eng.feed([Op.from_json(op.to_json())
                  for op in ops[i:i + segment_ops]])
    return norm(eng.finish())


def twin_carry(ops, segment_ops, delivery):
    """The carry fed by :func:`segmented._queue_segment_stats_np`, the
    numpy twin of K1's segment stats, segment by segment."""
    carry = segmented.QueueCarry(delivery, device="cpu")
    for i in range(0, len(ops), segment_ops):
        seg = [Op.from_json(op.to_json()) for op in ops[i:i + segment_ops]]
        for j, op in enumerate(seg):
            op.index = i + j
        rows = _rows_for(seg)
        carry.merge_stats(*segmented._queue_segment_stats_np(
            rows, rows[:, 0].astype(np.int64)))
    return norm(carry.finish())


def run_jax(ops, segment_ops, opts=None):
    eng = JaxSegmented("queue", opts=opts or {}, device=False)
    ops = _jax_ops(ops)
    for i in range(0, len(ops), segment_ops):
        eng.feed(ops[i:i + segment_ops])
    return norm(eng.finish())


def monolithic(ops, delivery="exactly-once"):
    r = check_queue_batch([ops], delivery, device="cpu")[0]
    out = norm(r)
    out["valid?"] = r["queue"]["valid?"] and r["linear"]["valid?"]
    return out


def assert_same(port, jax, mono=None):
    for fam in FAMILIES:
        assert port[fam] == jax[fam], fam
        if mono is not None:
            assert port[fam] == mono[fam], fam
    assert port["segmented"]["segments"] == jax["segmented"]["segments"]
    assert port["segmented"]["carry"] == jax["segmented"]["carry"]


@pytest.mark.parametrize("kw", QUEUE_ANOMALIES,
                         ids=lambda kw: "+".join(kw) or "clean")
@pytest.mark.parametrize("delivery", ["exactly-once", "at-least-once"])
def test_matches_reference_and_monolithic(kw, delivery):
    ops = synth_history(SynthSpec(n_ops=173, seed=5, **kw)).ops
    mono = monolithic(ops, delivery)
    for seg in (7, 64):
        port = run_port(ops, seg, {"delivery": delivery})
        assert_same(port, run_jax(ops, seg, {"delivery": delivery}), mono)
    # the numpy host twin of the stats gives the same carry
    twin = twin_carry(ops, 64, delivery)
    for fam in ("queue", "linear"):
        assert twin[fam] == port[fam], fam


def _op(type_, f, process, value, t):
    return Op(OpType[type_], OpF[f], process, value, time=t)


def _base():
    ops, t = [], 0
    for v in range(6):  # six clean lives that settle
        t += 2
        ops.append(_op("INVOKE", "ENQUEUE", v % 3, v, t))
        ops.append(_op("OK", "ENQUEUE", v % 3, v, t + 1))
        ops.append(_op("INVOKE", "DEQUEUE", v % 3, None, t + 2))
        ops.append(_op("OK", "DEQUEUE", v % 3, v, t + 3))
    return ops, t


def _duplicate_read_of_long_settled_value():
    ops, t = _base()
    ops.append(_op("INVOKE", "DEQUEUE", 0, None, t + 10))
    ops.append(_op("OK", "DEQUEUE", 0, 0, t + 11))
    return ops, (4, 5), lambda r: r["queue"]["duplicated"] == [0]


def _late_ack_turns_settled_value_lost():
    ops, t = _base()
    ops.append(_op("OK", "ENQUEUE", 1, 1, t + 10))
    return ops, (4, 100), lambda r: r["queue"]["lost"] == [1]


def _loss_across_the_whole_history():
    ops, t = _base()
    ops.insert(0, _op("OK", "ENQUEUE", 4, 99, 1))
    ops.insert(0, _op("INVOKE", "ENQUEUE", 4, 99, 0))
    return ops, (4, 6), lambda r: r["queue"]["lost"] == [99]


def _causality_pair_spanning_boundary():
    ops, t = _base()
    ops.append(_op("INVOKE", "DEQUEUE", 4, None, t + 10))
    ops.append(_op("OK", "DEQUEUE", 4, 777, t + 11))
    for v in range(700, 706):
        ops.append(_op("INVOKE", "ENQUEUE", 3, v, t + 12))
        ops.append(_op("OK", "ENQUEUE", 3, v, t + 13))
        ops.append(_op("INVOKE", "DEQUEUE", 3, None, t + 14))
        ops.append(_op("OK", "DEQUEUE", 3, v, t + 15))
    ops.append(_op("INVOKE", "ENQUEUE", 4, 777, t + 20))
    ops.append(_op("OK", "ENQUEUE", 4, 777, t + 21))
    return ops, (5, 9), lambda r: r["linear"]["causality"] == [777]


@pytest.mark.parametrize("case", [
    _duplicate_read_of_long_settled_value,
    _late_ack_turns_settled_value_lost,
    _loss_across_the_whole_history,
    _causality_pair_spanning_boundary,
], ids=lambda f: f.__name__.strip("_"))
def test_violations_across_segment_boundaries(case):
    ops, segs, flagged = case()
    for i, op in enumerate(ops):
        op.index = i
    mono = monolithic(ops)
    for seg in segs:
        port = run_port(ops, seg)
        assert_same(port, run_jax(ops, seg), mono)
        assert flagged(port) and port["valid?"] is False


def test_carry_is_residual_not_linear():
    ops = synth_history(SynthSpec(n_ops=2000, seed=3)).ops
    eng = SegmentedChecker("queue", device="cpu")
    for i in range(0, len(ops), 200):
        eng.feed(ops[i:i + 200])
    carry = eng.carry.carry_size()
    assert carry["settled"] > 300
    assert carry["open"] + carry["reopened"] < carry["settled"] / 4


# ---------------------------------------------------------------------------
# K1 at segment shapes
# ---------------------------------------------------------------------------


def _wide_segment_rows(n_values: int, seed: int = 0) -> np.ndarray:
    """One segment whose queue rows hold ``n_values`` distinct values,
    each enqueued and read, some twice, at global positions."""
    rng = np.random.default_rng(seed)
    vals = rng.permutation(10 * n_values)[:n_values]
    ops = []
    for v in vals:
        v = int(v)
        ops += [_op("INVOKE", "ENQUEUE", 0, v, 1), _op("OK", "ENQUEUE", 0, v,
                                                       2)]
        ops += [_op("INVOKE", "DEQUEUE", 1, None, 3),
                _op("OK", "DEQUEUE", 1, v, 4)]
    for k in rng.integers(0, len(ops), 50):
        ops.append(ops[int(k)])
    for i, op in enumerate(ops):
        op.index = 1_000_000 + i
    return _rows_for(ops)


@pytest.mark.parametrize("n_values, dtype, V", [
    (300, np.int16, 512),
    (32_768, np.int16, 32_768),
    (32_769, np.int32, 65_536),
])
def test_k1_segment_shapes_equal_the_host_twin(n_values, dtype, V):
    rows = _wide_segment_rows(n_values)
    prep = queue_prepare_rows(rows, rows[:, 0].astype(np.int64))
    assert prep["val"].dtype == dtype and prep["V"] == V
    assert prep["f"].dtype == prep["typ"].dtype == np.int8
    assert prep["pos"].dtype == np.int32 and prep["pos"].shape == (
        prep["L"],)
    got = queue_stats_from_prepared(prep, "cpu")
    want = segmented._queue_segment_stats_np(rows, rows[:, 0].astype(
        np.int64))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_batched_segments_equal_one_by_one():
    """The service's coalesced dispatch: same-bucket segments stacked on a
    ``[B, L]`` axis with ``[B, L]`` positions, one K1 call."""
    ops = synth_history(SynthSpec(n_ops=400, seed=2, lost=1)).ops
    rows = _rows_for(ops)
    preps = [queue_prepare_rows(r, r[:, 0].astype(np.int64))
             for r in np.array_split(rows, 4)]
    L = max(p["L"] for p in preps)
    V = max(p["V"] for p in preps)

    def stack(k, fill, dtype):
        out = np.full((len(preps), L), fill, dtype)
        for i, p in enumerate(preps):
            out[i, :len(p[k])] = p[k]
        return torch.from_numpy(out)

    planes = seg_queue_batch_program(
        stack("f", -1, np.int8), stack("typ", -1, np.int8),
        stack("val", -1, np.int16), stack("pos", 0, np.int32),
        stack("mask", False, bool), V)
    for i, p in enumerate(preps):
        k = len(p["u"])
        want = queue_stats_from_prepared(p, "cpu")
        for plane, w in zip(planes, want[1:]):
            np.testing.assert_array_equal(plane[i, :k].numpy(), w)


def test_a_device_fault_raises_and_a_data_fault_quarantines(tmp_path,
                                                            monkeypatch):
    ops = synth_history(SynthSpec(n_ops=200, seed=9)).ops
    hp = tmp_path / "history.jsonl"
    write_history_jsonl(hp, ops)

    def broken(packed, pos):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(segmented, "_dispatch", broken)
    with pytest.raises(DeviceError, match="illegal memory access"):
        segmented_check_file(hp, segment_ops=64, device="cpu")
    eng = SegmentedChecker("queue", device="cpu")
    with pytest.raises(DeviceError):
        eng.feed(ops[:64])
    assert eng.quarantines == []
    # with the stats stage whole again, a torn line is the data's fault
    monkeypatch.undo()
    lines = hp.read_bytes().splitlines(keepends=True)
    hp.write_bytes(b"".join(lines[:150]) + b'{"type": "torn mid-rec\n'
                   + b"".join(lines[150:]))
    r = segmented_check_file(hp, segment_ops=64, device="cpu")
    assert r["valid?"] == "unknown"
    # a position int32 cannot hold is the data's fault too
    rows = _rows_for(ops[:20])
    with pytest.raises(ValueError, match="int32"):
        queue_prepare_rows(rows, rows[:, 0].astype(np.int64) + 2**31)
    eng = SegmentedChecker("queue", device="cpu")
    eng.feed_rows(rows + np.array([2**31 - 5] + [0] * 7, np.int64), 20)
    assert eng.quarantines and "int32" in eng.quarantines[0].error


# ---------------------------------------------------------------------------
# whole-file checks: JSONL and .jtc producers, poison, checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture()
def queue_history_file(tmp_path):
    sh = synth_history(SynthSpec(n_ops=400, seed=9, lost=1, duplicated=1))
    hp = tmp_path / "history.jsonl"
    write_history_jsonl(hp, sh.ops)
    return hp, sh


def _die_child(pkg, hpath, seg_ops, die_after, opts=None):
    """A check in a child process that dies (exit 137) right after
    checkpointing segment ``die_after``."""
    if pkg == "port":
        call = ("from jepsen_tpu_torch.checkers.segmented import "
                "segmented_check_file as f\n"
                f"f(sys.argv[2], segment_ops={seg_ops}, device='cpu', "
                f"opts={opts or {}!r})\n")
    else:
        call = ("from jepsen_tpu.checkers.segmented import "
                "segmented_check_file as f\n"
                f"f(sys.argv[2], segment_ops={seg_ops}, device=False, "
                f"opts={opts or {}!r})\n")
    code = "import sys; sys.path.insert(0, sys.argv[1])\n" + call
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JEPSEN_TPU_SEG_DIE_AFTER=str(die_after))
    p = subprocess.run([sys.executable, "-c", code, str(REPO), str(hpath)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode == 137, p.stderr[-800:]
    return read_checkpoint(checkpoint_path_for(hpath))


def test_segments_and_anchors_equal_reference(queue_history_file):
    from jepsen_tpu.history.segments import iter_segments as jax_iter

    hp, _ = queue_history_file
    got = list(iter_segments(hp, 40))
    want = list(jax_iter(hp, 40))
    assert [(s.idx, s.start_op, s.byte_end, s.sha256, s.final, s.line_end,
             [o.to_json() for o in s.ops]) for s in got] == [
        (s.idx, s.start_op, s.byte_end, s.sha256, s.final, s.line_end,
         [o.to_json() for o in s.ops]) for s in want]
    assert got[-1].sha256 == prefix_sha256(hp, hp.stat().st_size)
    with pytest.raises(SourceMismatchError):
        list(iter_segments(hp, 40, start_segment=1, expect_sha256="0" * 64,
                           expect_bytes=got[0].byte_end))


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_kill_and_resume_identical(queue_history_file, pkg):
    """Killed after segment 2 by either package, resumed by the port: the
    same verdict as an uninterrupted run of each package."""
    hp, sh = queue_history_file
    r0 = norm(segmented_check_file(hp, segment_ops=100, device="cpu"))
    assert not checkpoint_path_for(hp).exists()
    assert r0["segmented"]["resumed"] is False
    doc = _die_child(pkg, hp, 100, die_after=2)
    assert doc["segment_idx"] == 2 and doc["substrate"] == "jsonl"
    assert doc["source_sha256"] == prefix_sha256(hp, doc["source_bytes"])
    r1 = norm(segmented_check_file(hp, segment_ops=100, device="cpu",
                                   resume=True))
    assert r1["segmented"]["resumed"] is True
    assert r1["segmented"]["resumed_from"] == 2
    want = norm(jax_check_file(hp, segment_ops=100, device=False))
    for fam in FAMILIES:
        assert r1[fam] == r0[fam] == want[fam] == monolithic(sh.ops)[fam]


def test_a_port_checkpoint_resumes_in_the_reference(queue_history_file):
    hp, _ = queue_history_file
    doc = _die_child("port", hp, 100, die_after=1)
    assert doc["segment_idx"] == 1
    r = norm(jax_check_file(hp, segment_ops=100, device=False, resume=True))
    assert r["segmented"]["resumed_from"] == 1
    want = norm(segmented_check_file(hp, segment_ops=100, device="cpu"))
    for fam in FAMILIES:
        assert r[fam] == want[fam]


def test_a_reference_prefix_checkpoint_resumes_over_the_whole_file(
        tmp_path, queue_history_file):
    """The JAX engine checks a prefix copy (three full segments) and keeps
    its checkpoint; the port's run over the whole file resumes from it."""
    hp, sh = queue_history_file
    lines = hp.read_bytes().splitlines(keepends=True)
    pre = tmp_path / "prefix" / "history.jsonl"
    pre.parent.mkdir()
    pre.write_bytes(b"".join(lines[:300]))
    jax_check_file(pre, segment_ops=100, device=False, keep_checkpoint=True)
    shutil.copy(checkpoint_path_for(pre), checkpoint_path_for(hp))
    r = norm(segmented_check_file(hp, segment_ops=100, device="cpu",
                                  resume=True))
    assert r["segmented"]["resumed_from"] == 2
    for fam in FAMILIES:
        assert r[fam] == monolithic(sh.ops)[fam]


def test_resume_from_final_short_segment_checkpoint(tmp_path):
    sh = synth_history(SynthSpec(n_ops=200, seed=4, lost=1))
    hp = tmp_path / "history.jsonl"
    write_history_jsonl(hp, sh.ops)
    n_lines = sum(1 for line in hp.read_bytes().splitlines() if line)
    last = (n_lines - 1) // 100
    assert n_lines % 100 != 0
    r0 = norm(segmented_check_file(hp, segment_ops=100, device="cpu"))
    _die_child("port", hp, 100, die_after=last)
    r1 = norm(segmented_check_file(hp, segment_ops=100, device="cpu",
                                   resume=True))
    assert r1["segmented"]["resumed_from"] == last
    for fam in FAMILIES:
        assert r1[fam] == r0[fam]


@pytest.mark.parametrize("change", ["segment size", "contract", "source"])
def test_mismatched_checkpoints_are_refused(queue_history_file, change):
    hp, _ = queue_history_file
    _die_child("port", hp, 100, die_after=2)
    if change == "source":
        raw = hp.read_bytes()
        hp.write_bytes(raw[:50] + b"X" + raw[51:])
        with pytest.raises(SourceMismatchError):
            segmented_check_file(hp, segment_ops=100, device="cpu",
                                 resume=True)
        with pytest.raises(Exception, match="diverged"):
            jax_check_file(hp, segment_ops=100, device=False, resume=True)
        return
    kw = ({"segment_ops": 64} if change == "segment size" else
          {"segment_ops": 100, "opts": {"delivery": "at-least-once"}})
    r = segmented_check_file(hp, device="cpu", resume=True, **kw)
    assert r["segmented"]["resumed"] is False
    assert r["segmented"]["checkpoints_refused"]
    if change == "contract":
        assert r["linear"]["delivery"] == "at-least-once"


@pytest.mark.parametrize("torn", ["main", "both"])
def test_torn_checkpoints_are_refused_loudly(queue_history_file, torn,
                                             caplog):
    import logging

    hp, sh = queue_history_file
    _die_child("port", hp, 100, die_after=3)
    cp = checkpoint_path_for(hp)
    if torn == "main":
        raw = cp.read_bytes()
        cp.write_bytes(raw[: len(raw) // 2])
    else:
        cp.write_bytes(b"garbage")
        cp.with_name(cp.name + ".prev").write_bytes(b"worse")
    with caplog.at_level(logging.ERROR):
        r = norm(segmented_check_file(hp, segment_ops=100, device="cpu",
                                      resume=True))
    refusals = r["segmented"]["checkpoints_refused"]
    assert any("REFUSED checkpoint" in rec.message for rec in caplog.records)
    if torn == "main":
        assert "torn/corrupt" in refusals[0]
        assert r["segmented"]["resumed_from"] == 2  # fell back to .prev
    else:
        assert len(refusals) == 2 and r["segmented"]["resumed"] is False
    for fam in FAMILIES:
        assert r[fam] == monolithic(sh.ops)[fam]


def test_torn_line_quarantines_as_unknown_with_evidence(tmp_path):
    sh = synth_history(SynthSpec(n_ops=200, seed=9))
    hp = tmp_path / "history.jsonl"
    write_history_jsonl(hp, sh.ops)
    lines = hp.read_bytes().splitlines(keepends=True)
    hp.write_bytes(b"".join(lines[:150]) + b'{"type": "torn mid-rec'
                   + b"".join(lines[150:]))
    r = norm(segmented_check_file(hp, segment_ops=64, device="cpu"))
    want = norm(jax_check_file(hp, segment_ops=64, device=False))
    assert r["valid?"] == "unknown"
    for fam in ("queue", "linear"):
        ev = r[fam]["quarantined"]["segments"]
        assert ev and ev[0]["line"] == 151
        assert "JSONDecodeError" in ev[0]["error"]
        assert r[fam] == want[fam]
    assert checkpoint_path_for(hp).exists()  # a poisoned run keeps them
    with pytest.raises(SegmentPoisonError):
        list(iter_segments(hp, 64))


@pytest.fixture()
def recorded_run(tmp_path):
    st = JaxStore(tmp_path)
    rd = st.run_dir("t")
    sh = synth_history(SynthSpec(n_ops=400, seed=9, lost=1, duplicated=1))
    hp = st.save_history(rd, _jax_ops(sh.ops))  # leaves the .jtc beside it
    assert hp.with_suffix(".jtc").exists()
    return hp, sh


def test_jtc_slices_equal_the_jsonl_stream(recorded_run, monkeypatch):
    from jepsen_tpu_torch.obs.metrics import REGISTRY

    hp, sh = recorded_run
    hits = REGISTRY.value("jtc.hit")
    r_jtc = norm(segmented_check_file(hp, segment_ops=100, device="cpu"))
    assert REGISTRY.value("jtc.hit") > hits
    assert r_jtc["segmented"]["substrate"] == "jtc"
    want = norm(jax_check_file(hp, segment_ops=100, device=False))
    monkeypatch.setenv("JEPSEN_TPU_NO_JTC", "1")
    r_jsonl = norm(segmented_check_file(hp, segment_ops=100, device="cpu"))
    assert r_jsonl["segmented"]["substrate"] == "jsonl"
    for fam in FAMILIES:
        assert r_jtc[fam] == r_jsonl[fam] == want[fam] == monolithic(
            sh.ops)[fam]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_jtc_kill_and_resume_across_packages(recorded_run, pkg):
    hp, sh = recorded_run
    doc = _die_child(pkg, hp, 100, die_after=2)
    assert doc["substrate"] == "jtc"
    r = norm(segmented_check_file(hp, segment_ops=100, device="cpu",
                                  resume=True))
    assert r["segmented"]["resumed_from"] == 2
    for fam in FAMILIES:
        assert r[fam] == monolithic(sh.ops)[fam]


def test_substrate_mismatch_refused(recorded_run, monkeypatch):
    hp, _ = recorded_run
    _die_child("port", hp, 100, die_after=2)  # a .jtc checkpoint
    monkeypatch.setenv("JEPSEN_TPU_NO_JTC", "1")  # resume through JSONL
    r = segmented_check_file(hp, segment_ops=100, device="cpu", resume=True)
    assert r["segmented"]["resumed"] is False
    assert r["segmented"]["checkpoints_refused"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_cli_check_segment_ops_and_resume(queue_history_file, pkg):
    """``check --segment-ops N [--resume]`` through each command line:
    the same ``results.json`` maps, with ``resumed`` set only on the
    resumed run."""
    hp, sh = queue_history_file
    fn, dev = ((port_main, ["--device", "cpu"]) if pkg == "port"
               else (jax_main, ["--checker", "cpu"]))
    rc, _ = _stdout(fn, ["check", *dev, "--segment-ops", "100", str(hp)])
    first = json.loads((hp.parent / "results.json").read_text())
    # the re-check inherits the delivery results.json now records, and a
    # checkpoint resumes only under the contract it was built with
    _die_child(pkg, hp, 100, die_after=1, opts={"delivery": "exactly-once"})
    rc2, _ = _stdout(fn, ["check", *dev, "--segment-ops", "100",
                          "--resume", str(hp.parent)])
    second = json.loads((hp.parent / "results.json").read_text())
    assert rc == rc2 == 1
    assert first["segmented"]["resumed"] is False
    assert second["segmented"]["resumed_from"] == 1
    for fam in FAMILIES:
        assert first[fam] == second[fam] == monolithic(sh.ops)[fam]


def test_other_workloads_name_their_roadmap_items():
    for workload, item in (("stream", "item 6"), ("elle", "item 7"),
                           ("mutex", "item 8")):
        with pytest.raises(NotImplementedError, match=item):
            SegmentedChecker(workload, device="cpu")
    with pytest.raises(ValueError):
        SegmentedChecker("nope", device="cpu")
