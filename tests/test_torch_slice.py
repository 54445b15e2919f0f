"""The port's slice as a whole ≡ the JAX package: a batch of histories
to both queue verdicts, the entry point, and the ``check`` command on
recorded runs."""

import contextlib
import io
import json
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest

import __graft_entry__
from jepsen_tpu.checkers.queue_lin import check_queue_lin_batch
from jepsen_tpu.checkers.queue_lin import QueueLinearizability as JaxQueueLin
from jepsen_tpu.checkers.total_queue import check_total_queue_batch
from jepsen_tpu.checkers.total_queue import TotalQueue as JaxTotalQueue
from jepsen_tpu.history.store import read_history_jsonl as jax_read_history
from jepsen_tpu.history.synth import SynthSpec as JaxSynthSpec
from jepsen_tpu.history.synth import synth_batch as jax_synth_batch
from jepsen_tpu_torch.__main__ import INVALID_BANNER, main as port_main
from jepsen_tpu_torch.checkers.fused import check_queue_batch
from jepsen_tpu_torch.entry import entry
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.history.store import write_history_jsonl
from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch

from _torch_ref import DELIVERIES, assert_fields_equal

REPO = Path(__file__).resolve().parent.parent
STORES = [
    "store/rabbitmq-simple-partition/20260730T165911",
    "store/cluster_r12_nemesis_queue",
]


@pytest.mark.parametrize("delivery", DELIVERIES)
def test_check_queue_batch_equals_reference(delivery):
    hs = [sh.ops for seed in range(4) for sh in jax_synth_batch(
        2, JaxSynthSpec(n_ops=120, seed=seed * 50, lost=seed % 2,
                        duplicated=1, unexpected=seed // 3,
                        phantom_fail=seed % 3 == 1, causality=seed == 2))]
    got = check_queue_batch(
        [[Op.from_json(o.to_json()) for o in h] for h in hs],
        delivery=delivery, device="cpu",
    )
    want_q = check_total_queue_batch(hs)
    want_l = check_queue_lin_batch(hs, delivery=delivery)
    assert got == [{"queue": q, "linear": lin} for q, lin in zip(want_q, want_l)]


def test_entry_equals_graft_entry():
    fn, args = entry(device="cpu")
    ref_fn, ref_args = __graft_entry__.entry()
    assert len(args) == len(ref_args)
    for a, b in zip(args, ref_args):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tq, ql = fn(*args)
    tq_ref, ql_ref = jax.jit(ref_fn)(*ref_args)
    assert_fields_equal(tq, tq_ref)
    assert_fields_equal(ql, ql_ref)


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = port_main(argv)
    *body, banner = buf.getvalue().rstrip("\n").split("\n")
    return rc, json.loads("\n".join(body)), banner


@pytest.mark.parametrize("store", STORES)
def test_cli_check_equals_reference_on_recorded_run(store, tmp_path):
    # on a copy: check writes results, graphs and caches into the run
    run = tmp_path / "run"
    shutil.copytree(REPO / store, run)
    recorded = json.loads((run / "results.json").read_text())
    delivery = recorded["linear"].get("delivery", "exactly-once")
    rc, got, banner = _cli(["check", "--device", "cpu", str(run)])
    history = jax_read_history(run / "history.jsonl")
    want = {
        "queue": JaxTotalQueue(backend="tpu").check({}, history),
        "linear": JaxQueueLin(backend="tpu", delivery=delivery).check({}, history),
    }
    for fam in ("queue", "linear"):
        assert set(got[fam]) == set(want[fam])
        for key, val in want[fam].items():
            assert got[fam][key] == (sorted(val) if isinstance(val, set) else val)
        for key, val in recorded[fam].items():
            assert got[fam][key] == val, (fam, key)
    assert got["valid?"] is True and rc == 0 and banner.startswith("Everything")


def test_cli_flags_an_invalid_run(tmp_path):
    sh = synth_batch(1, SynthSpec(n_ops=80, lost=1, duplicated=1))[0]
    write_history_jsonl(tmp_path / "history.jsonl", sh.ops)
    rc, got, banner = _cli(["check", "--device", "cpu", str(tmp_path)])
    assert rc == 1 and banner == INVALID_BANNER
    assert got["queue"]["lost"] == sorted(sh.lost)
    assert got["linear"]["duplicate"] == sorted(sh.duplicated)
    assert got["linear"]["delivery"] == "exactly-once"
    rc, got, _ = _cli(["check", "--device", "cpu", "--delivery",
                       "at-least-once", str(tmp_path / "history.jsonl")])
    assert rc == 1 and got["linear"]["valid?"] is True
    assert got["queue"]["valid?"] is False
