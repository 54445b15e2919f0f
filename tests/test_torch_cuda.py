"""The port's CUDA kernel against its plain PyTorch version on the card.

This file imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Where no card is present the test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.checkers.fused import combined_tensor_check
from jepsen_tpu_torch.checkers.queue_lin import queue_lin_tensor_check
from jepsen_tpu_torch.checkers.total_queue import total_queue_tensor_check
from jepsen_tpu_torch.history.encode import TENSOR_FIELDS, pack_histories
from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch
from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats, queue_stats_plain


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _to(packed, dev):
    return dataclasses.replace(
        packed, **{k: getattr(packed, k).to(dev) for k in TENSOR_FIELDS}
    )


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card(cuda_device):
    cases = []
    for kw in ({}, {"lost": 2, "duplicated": 1}, {"unexpected": 1},
               {"phantom_fail": 1, "causality": 1}):
        hs = [s.ops for s in synth_batch(4, SynthSpec(n_ops=200), **kw)]
        cases.append(pack_histories(hs, device="cpu"))
    hs = [s.ops for s in synth_batch(3, SynthSpec(n_ops=90), lost=1)]
    cases.append(pack_histories(hs, length=301, value_space=40_000, device="cpu"))
    for packed in cases:
        g = _to(packed, cuda_device)
        before = fused_queue_stats.launches
        k = fused_queue_stats(g)
        assert fused_queue_stats.launches == before + 1
        pl = queue_stats_plain(g.f, g.type, g.value, g.mask, g.value_space)
        pos = torch.from_numpy(np.random.default_rng(0).integers(
            0, 2**31 - 1, tuple(g.f.shape)).astype(np.int32)).to(cuda_device)
        kp = fused_queue_stats(g, pos)
        plp = queue_stats_plain(g.f, g.type, g.value, g.mask, g.value_space, pos)
        torch.cuda.synchronize()
        for f in "aexdst":
            assert torch.equal(getattr(k, f), getattr(pl, f)), f
            assert torch.equal(getattr(kp, f), getattr(plp, f)), f
        for delivery in ("exactly-once", "at-least-once"):
            tq, ql = combined_tensor_check(g, delivery)
            tq_p = total_queue_tensor_check(g)
            ql_p = queue_lin_tensor_check(g, delivery)
            for x, y in ((tq, tq_p), (ql, ql_p)):
                for fl in dataclasses.fields(x):
                    assert torch.equal(getattr(x, fl.name), getattr(y, fl.name))
