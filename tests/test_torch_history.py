"""PyTorch port ≡ JAX package: op schema, synthesis, row explosion, store
and packing give the same histories and the same bytes."""

import json

import numpy as np
import pytest
import torch

from jepsen_tpu.history import encode as jax_encode
from jepsen_tpu.history import ops as jax_ops
from jepsen_tpu.history import rows as jax_rows
from jepsen_tpu.history import store as jax_store
from jepsen_tpu.history import synth as jax_synth
from jepsen_tpu_torch.history import encode, ops, rows, store, synth

from _torch_ref import ANOMALIES, ANOMALY_IDS, reference_pair

SPECS = [
    dict(n_ops=60),
    dict(n_ops=200, seed=7, lost=2, duplicated=1),
    dict(n_ops=150, unexpected=2, phantom_fail=1),
    dict(n_ops=120, causality=2, n_processes=3),
    dict(n_ops=80, drain=False),
    dict(n_ops=470, n_processes=5, lost=1, duplicated=1, seed=3),
]


def _port_ops(history):
    return [ops.Op.from_json(op.to_json()) for op in history]


@pytest.mark.parametrize("spec", SPECS)
def test_synth_history_equals_reference(spec):
    mine = synth.synth_history(synth.SynthSpec(**spec))
    ref = jax_synth.synth_history(jax_synth.SynthSpec(**spec))
    assert [op.to_json() for op in mine.ops] == [op.to_json() for op in ref.ops]
    for k in ("lost", "duplicated", "unexpected", "phantom_fail", "causality"):
        assert getattr(mine, k) == getattr(ref, k), k
    assert mine.clean == ref.clean


def test_synth_batch_equals_reference():
    mine = synth.synth_batch(5, synth.SynthSpec(n_ops=50, seed=11), lost=1)
    ref = jax_synth.synth_batch(5, jax_synth.SynthSpec(n_ops=50, seed=11), lost=1)
    assert [[o.to_json() for o in s.ops] for s in mine] == [
        [o.to_json() for o in s.ops] for s in ref
    ]


def test_synth_refuses_injection_without_drain():
    with pytest.raises(ValueError, match="drain"):
        synth.synth_history(synth.SynthSpec(drain=False, lost=1))


def test_op_codes_and_json_equal_reference():
    assert {t.name: int(t) for t in ops.OpType} == {
        t.name: int(t) for t in jax_ops.OpType
    }
    assert {f.name: int(f) for f in ops.OpF} == {f.name: int(f) for f in jax_ops.OpF}
    assert ops.NO_VALUE == jax_ops.NO_VALUE
    hist = jax_synth.synth_history(jax_synth.SynthSpec(n_ops=40)).ops
    for op in hist:
        d = op.to_json()
        assert ops.Op.from_json(d).to_json() == d
    assert ops.workload_of(_port_ops(hist)) == jax_ops.workload_of(hist)
    for f, want in ((ops.OpF.APPEND, "stream"), (ops.OpF.TXN, "elle"),
                    (ops.OpF.ACQUIRE, "mutex")):
        assert ops.workload_of([ops.Op.invoke(f, 0)]) == want


def _edge_history():
    """Empty and non-int drains, bools, unmatched completions, nemesis."""
    O, T, F = jax_ops.Op, jax_ops.OpType, jax_ops.OpF
    h = [
        O(T.INVOKE, F.ENQUEUE, 0, 3, time=1_000_000),
        O(T.INVOKE, F.DRAIN, 1, time=2_000_000),
        O(T.OK, F.ENQUEUE, 0, 3, time=5_000_000),
        O(T.OK, F.DRAIN, 1, [], time=6_000_000),
        O(T.INVOKE, F.DRAIN, 2, time=7_000_000),
        O(T.OK, F.DRAIN, 2, [3, "x", 4], time=9_500_000),
        O(T.INFO, F.START, -1, "partition", time=10_000_000),
        O(T.OK, F.DEQUEUE, 3, True, time=-1),
        O(T.INVOKE, F.DEQUEUE, 4, time=11_000_000),
    ]
    return jax_ops.reindex(h)


@pytest.mark.parametrize("which", ["edge", "synth", "empty"])
def test_rows_for_equals_reference(which):
    hist = {
        "edge": _edge_history(),
        "synth": jax_synth.synth_history(
            jax_synth.SynthSpec(n_ops=300, lost=1, duplicated=2)).ops,
        "empty": [],
    }[which]
    mine = rows._rows_for(_port_ops(hist))
    ref = jax_rows._rows_for(hist)
    assert rows._COLUMNS == jax_rows._COLUMNS
    assert mine.dtype == ref.dtype and mine.shape == ref.shape
    np.testing.assert_array_equal(mine, ref)


def test_rows_for_refuses_out_of_int32_value():
    h = [ops.Op.invoke(ops.OpF.ENQUEUE, 0, 2**31, time=0)]
    with pytest.raises(OverflowError):
        rows._rows_for(h)


PACK_CASES = {
    "default": ({}, dict(n=4, n_ops=200)),
    "length": (dict(length=1024), dict(n=3, n_ops=100)),
    "value_space": (dict(value_space=300), dict(n=2, n_ops=120)),
    "int32_values": (dict(value_space=40_000), dict(n=2, n_ops=60)),
    "single": ({}, dict(n=1, n_ops=30)),
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_histories_equals_reference(case):
    kw, sk = PACK_CASES[case]
    hs = [s.ops for s in jax_synth.synth_batch(
        sk["n"], jax_synth.SynthSpec(n_ops=sk["n_ops"]), lost=1)]
    ref = jax_encode.pack_histories(hs, to_device=False, **kw)
    mine = encode.pack_histories([_port_ops(h) for h in hs], device="cpu", **kw)
    assert mine.value_space == ref.value_space
    assert (mine.batch, mine.length) == (ref.batch, ref.length)
    assert mine.device == torch.device("cpu")
    for k in encode.TENSOR_FIELDS:
        a, b = getattr(mine, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    if case == "int32_values":
        assert mine.value.dtype == torch.int32


@pytest.mark.parametrize("mk", ["port", "reference"])
def test_value_at_or_above_value_space_raises(mk):
    O, T, F = ops.Op, ops.OpType, ops.OpF
    h = ops.reindex([O(T.INVOKE, F.ENQUEUE, 0, 200, time=0)])
    if mk == "port":
        with pytest.raises(ValueError, match="value_space"):
            encode.pack_histories([h], value_space=128, device="cpu")
    else:
        href = jax_ops.reindex([jax_ops.Op(jax_ops.OpType.INVOKE,
                                           jax_ops.OpF.ENQUEUE, 0, 200, time=0)])
        with pytest.raises(ValueError, match="value_space"):
            jax_encode.pack_histories([href], value_space=128, to_device=False)


def test_pack_refusals():
    with pytest.raises(ValueError, match="empty batch"):
        encode.pack_histories([], device="cpu")
    h = synth.synth_history(synth.SynthSpec(n_ops=100)).ops
    with pytest.raises(ValueError, match="exceeds L"):
        encode.pack_histories([h], length=16, device="cpu")


@pytest.mark.parametrize("anomalies", ANOMALIES, ids=ANOMALY_IDS)
def test_from_reference_arrays_keeps_the_bytes(anomalies):
    hs = [s.ops for s in jax_synth.synth_batch(
        3, jax_synth.SynthSpec(n_ops=100), **anomalies)]
    ref, mine = reference_pair(hs)
    own = encode.pack_histories([_port_ops(h) for h in hs], device="cpu")
    for k in encode.TENSOR_FIELDS:
        assert torch.equal(getattr(mine, k), getattr(own, k)), k
    assert mine.value_space == own.value_space == ref.value_space


def test_from_reference_arrays_refuses_bad_columns():
    ref = jax_encode.pack_histories(
        [jax_synth.synth_history(jax_synth.SynthSpec(n_ops=20)).ops],
        to_device=False)
    cols = {k: np.asarray(getattr(ref, k)) for k in encode.TENSOR_FIELDS}
    with pytest.raises(ValueError, match="missing"):
        encode.from_reference_arrays(
            {k: v for k, v in cols.items() if k != "mask"}, 128, "cpu")
    cols["mask"] = cols["mask"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        encode.from_reference_arrays(cols, 128, "cpu")


def test_store_roundtrip_equals_reference(tmp_path):
    hist = jax_synth.synth_history(jax_synth.SynthSpec(n_ops=80, lost=1)).ops
    p = tmp_path / "history.jsonl"
    store.write_history_jsonl(p, _port_ops(hist))
    assert p.read_text() == "".join(
        json.dumps(op.to_json()) + "\n" for op in hist
    )
    mine = store.read_history_jsonl(p)
    ref = jax_store.read_history_jsonl(p)
    assert [o.to_json() for o in mine] == [o.to_json() for o in ref]
