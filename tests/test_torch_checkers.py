"""PyTorch port ≡ JAX package for the queue checkers: presence bits,
total-queue, queue linearizability and the fused check, field for field
and result map for result map, under both delivery contracts and both
output layouts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jepsen_tpu.checkers import bitset as jax_bitset
from jepsen_tpu.checkers import fused as jax_fused
from jepsen_tpu.checkers import protocol as jax_protocol
from jepsen_tpu.checkers import queue_lin as jax_ql
from jepsen_tpu.checkers import total_queue as jax_tq
from jepsen_tpu.history.ops import Op as JaxOp
from jepsen_tpu.history.ops import OpF as JaxOpF
from jepsen_tpu.history.ops import OpType as JaxOpType
from jepsen_tpu.history.ops import reindex as jax_reindex
from jepsen_tpu.history.synth import SynthSpec as JaxSynthSpec
from jepsen_tpu.history.synth import synth_batch as jax_synth_batch
from jepsen_tpu_torch.checkers import bitset, fused, protocol, queue_lin, total_queue
from jepsen_tpu_torch.history.ops import Op

from _torch_ref import (
    ANOMALIES,
    ANOMALY_IDS,
    DELIVERIES,
    assert_fields_equal,
    corpus_histories,
    reference_pair,
)

PACKED_OUT = [False, True]


def _port_ops(history):
    return [Op.from_json(op.to_json()) for op in history]


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 384])
def test_bitset_equals_reference(n):
    rng = np.random.default_rng(n)
    bits = rng.random((3, n)) < 0.4
    bits[:, -1] = True  # the top bit of a full word sets the sign bit
    mine = bitset.pack_bits(torch.from_numpy(bits))
    ref = np.asarray(jax_bitset.pack_bits(jnp.asarray(bits)))
    assert mine.dtype == torch.int32 and bitset.n_words(n) == jax_bitset.n_words(n)
    np.testing.assert_array_equal(mine.numpy().view(np.uint32), ref)
    np.testing.assert_array_equal(bitset.pack_bits_np(bits), ref)
    assert torch.equal(bitset.unpack_bits(mine, n), torch.from_numpy(bits))
    np.testing.assert_array_equal(bitset.unpack_bits_np(mine.numpy(), n), bits)
    np.testing.assert_array_equal(bitset.unpack_bits_np(ref, n), bits)


@pytest.mark.parametrize("packed_out", PACKED_OUT)
@pytest.mark.parametrize("anomalies", ANOMALIES, ids=ANOMALY_IDS)
def test_total_queue_equals_reference(anomalies, packed_out):
    hs = corpus_histories(**anomalies)
    ref, mine = reference_pair(hs)
    t_mine = total_queue.total_queue_tensor_check(mine, packed_out=packed_out)
    t_ref = jax_tq.total_queue_tensor_check(ref, packed_out=packed_out)
    assert_fields_equal(t_mine, t_ref)
    maps = total_queue._tensors_to_results(t_mine)
    assert maps == jax_tq._tensors_to_results(t_ref)
    assert maps == [total_queue.check_total_queue_cpu(_port_ops(h)) for h in hs]
    assert maps == [jax_tq.check_total_queue_cpu(h) for h in hs]


@pytest.mark.parametrize("packed_out", PACKED_OUT)
@pytest.mark.parametrize("delivery", DELIVERIES)
@pytest.mark.parametrize("anomalies", ANOMALIES, ids=ANOMALY_IDS)
def test_queue_lin_equals_reference(anomalies, delivery, packed_out):
    hs = corpus_histories(**anomalies)
    ref, mine = reference_pair(hs)
    t_mine = queue_lin.queue_lin_tensor_check(mine, delivery, packed_out)
    t_ref = jax_ql.queue_lin_tensor_check(ref, delivery, packed_out)
    assert_fields_equal(t_mine, t_ref)
    maps = queue_lin.queue_lin_tensors_to_results(t_mine)
    assert maps == jax_ql.queue_lin_tensors_to_results(t_ref)
    for m, h in zip(maps, hs):
        want = jax_ql.check_queue_lin_cpu(h, delivery)
        assert queue_lin.check_queue_lin_cpu(_port_ops(h), delivery) == want
        assert {**m, "delivery": delivery} == want


@pytest.mark.parametrize("packed_out", PACKED_OUT)
@pytest.mark.parametrize("delivery", DELIVERIES)
@pytest.mark.parametrize("anomalies", ANOMALIES, ids=ANOMALY_IDS)
def test_combined_check_equals_reference(anomalies, delivery, packed_out):
    ref, mine = reference_pair(corpus_histories(**anomalies))
    tq, ql = fused.combined_tensor_check(mine, delivery, packed_out)
    tq_ref, ql_ref = jax_fused.combined_tensor_check(ref, delivery, packed_out)
    assert_fields_equal(tq, tq_ref)
    assert_fields_equal(ql, ql_ref)


@pytest.mark.parametrize("delivery", DELIVERIES)
def test_fused_check_equals_reference_pallas_path(delivery):
    ref, mine = reference_pair(corpus_histories(lost=1, causality=1))
    tq, ql = fused.fused_tensor_check(mine, delivery)
    tq_ref, ql_ref = jax_fused.fused_tensor_check(
        ref, interpret=True, delivery=delivery)
    assert_fields_equal(tq, tq_ref)
    assert_fields_equal(ql, ql_ref)


def test_combined_check_refuses_unknown_delivery():
    _, mine = reference_pair(corpus_histories(n=1, n_ops=20))
    with pytest.raises(ValueError, match="delivery"):
        fused.combined_tensor_check(mine, "at-most-once")


def _hand_histories():
    """The hand-made anomaly shapes of the JAX package's checker tests."""
    O, T, F = JaxOp, JaxOpType, JaxOpF
    fail_read = [  # a failed enqueue whose value is read anyway
        O(T.INVOKE, F.ENQUEUE, 0, 0), O(T.FAIL, F.ENQUEUE, 0, 0),
        O(T.INVOKE, F.DEQUEUE, 1), O(T.OK, F.DEQUEUE, 1, 0),
    ]
    read_first = [  # a read completing before any enqueue of its value
        O(T.INVOKE, F.DEQUEUE, 1), O(T.OK, F.DEQUEUE, 1, 0),
        O(T.INVOKE, F.ENQUEUE, 0, 0), O(T.FAIL, F.ENQUEUE, 0, 0),
    ]
    overlap = [  # dequeue overlapping its enqueue: linearizable
        O(T.INVOKE, F.ENQUEUE, 0, 0), O(T.INVOKE, F.DEQUEUE, 1),
        O(T.OK, F.DEQUEUE, 1, 0), O(T.OK, F.ENQUEUE, 0, 0),
    ]
    info_read = [  # an indeterminate enqueue surfacing later: recovered
        O(T.INVOKE, F.ENQUEUE, 0, 0), O(T.INFO, F.ENQUEUE, 0, 0),
        O(T.INVOKE, F.DRAIN, 1), O(T.OK, F.DRAIN, 1, [0, 0, 7]),
    ]
    return [jax_reindex(h) for h in (fail_read, read_first, overlap, info_read)]


@pytest.mark.parametrize("delivery", DELIVERIES)
@pytest.mark.parametrize("which", ["random_mixed", "hand_made"])
def test_checker_classes_equal_reference(which, delivery):
    if which == "random_mixed":
        hs = [sh.ops for seed in range(3) for sh in jax_synth_batch(
            2, JaxSynthSpec(n_ops=150, seed=10 * seed, lost=seed,
                            duplicated=1, causality=seed % 2))]
    else:
        hs = _hand_histories()
    mine = protocol.compose({
        "queue": total_queue.TotalQueue(device="cpu"),
        "linear": queue_lin.QueueLinearizability(delivery=delivery, device="cpu"),
    })
    ref = jax_protocol.compose({
        "queue": jax_tq.TotalQueue(backend="tpu"),
        "linear": jax_ql.QueueLinearizability(backend="tpu", delivery=delivery),
    })
    oracle = protocol.compose({
        "queue": total_queue.TotalQueue(backend="cpu"),
        "linear": queue_lin.QueueLinearizability(backend="cpu", delivery=delivery),
    })
    for h in hs:
        want = ref.check({}, h)
        assert mine.check({}, _port_ops(h)) == want
        assert oracle.check({}, _port_ops(h)) == want


def test_protocol_merge_and_refusals():
    for vals in ([True, True], [True, "unknown"], [True, False, "unknown"],
                 [None], []):
        assert protocol.merge_valid(vals) == jax_protocol.merge_valid(vals)
    with pytest.raises(ValueError, match="backend"):
        total_queue.TotalQueue(backend="tpu")
    with pytest.raises(ValueError, match="delivery"):
        queue_lin.QueueLinearizability(delivery="at-most-once")
