"""Shared helpers of the PyTorch-port differential tests.

The same packed bytes go through both packages: the JAX package packs a
batch on the host (``to_device=False``) and the port takes those arrays
unchanged through ``from_reference_arrays``.  All comparisons are exact,
because every stat and verdict is integer or boolean.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from jepsen_tpu.history.encode import pack_histories as jax_pack_histories
from jepsen_tpu.history.synth import SynthSpec as JaxSynthSpec
from jepsen_tpu.history.synth import synth_batch as jax_synth_batch
from jepsen_tpu_torch.history.encode import TENSOR_FIELDS, from_reference_arrays

#: the anomaly corpus of tests/test_pallas_stats.py
ANOMALIES = [
    {},
    {"lost": 2},
    {"duplicated": 1},
    {"unexpected": 1},
    {"phantom_fail": 1},
    {"causality": 1},
]
ANOMALY_IDS = ["clean", "lost", "duplicated", "unexpected", "phantom_fail",
               "causality"]
DELIVERIES = ["exactly-once", "at-least-once"]


def corpus_histories(n: int = 4, n_ops: int = 200, **anomalies):
    return [sh.ops for sh in jax_synth_batch(n, JaxSynthSpec(n_ops=n_ops),
                                             **anomalies)]


def reference_pair(histories, **pack_kw):
    """``(jax_packed_on_host, port_packed_on_cpu)`` of the same bytes."""
    ref = jax_pack_histories(histories, to_device=False, **pack_kw)
    cols = {k: np.asarray(getattr(ref, k)) for k in TENSOR_FIELDS}
    return ref, from_reference_arrays(cols, ref.value_space, "cpu")


def assert_fields_equal(port, ref):
    """Every field of a port result dataclass equals the JAX package's
    field of the same name, values and dtype.  The port holds presence
    bits as int32 words; the JAX package's uint32 words compare with
    their bits."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if not isinstance(a, torch.Tensor):
            assert a == b, f.name
            continue
        a, b = a.numpy(), np.asarray(b)
        if b.dtype == np.uint32:
            a = a.view(np.uint32)
        assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f.name)
