"""PyTorch port ≡ JAX package for the per-value stats: the port's plain
scatters and its fused-stats dispatcher on CPU tensors against the JAX
Pallas kernel (interpret mode) and the JAX scatter count vectors, exactly."""

import jax
import numpy as np
import pytest
import torch

from jepsen_tpu.checkers.queue_lin import queue_lin_count_vectors
from jepsen_tpu.checkers.total_queue import total_queue_count_vectors
from jepsen_tpu.ops.pallas_stats import fused_queue_stats as jax_fused_queue_stats
from jepsen_tpu_torch.history.encode import from_reference_arrays
from jepsen_tpu_torch.ops.counts import (
    INT32_MAX,
    masked_value_counts,
    masked_value_reduce_min,
)
from jepsen_tpu_torch.ops.queue_stats import (
    _validated,
    fused_queue_stats,
    queue_stats_plain,
)

from _torch_ref import ANOMALIES, ANOMALY_IDS, corpus_histories, reference_pair
from test_torch_cuda import LOAD_PATHS, REFUSALS, load_path_input, refusal_base


def _jax_scatter_stats(ref):
    """The JAX scatter path's ``(a, e, x, d, s, t)`` on a host batch."""
    V = ref.value_space
    a, e, d = jax.vmap(
        lambda f, t, v, m: total_queue_count_vectors(f, t, v, m, V)
    )(ref.f, ref.type, ref.value, ref.mask)
    pos = np.broadcast_to(np.arange(ref.length, dtype=np.int32), ref.f.shape)
    a2, x, s, r, t = jax.vmap(
        lambda f, ty, v, p, m: queue_lin_count_vectors(f, ty, v, p, m, V)
    )(ref.f, ref.type, ref.value, pos, ref.mask)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(a2))
    np.testing.assert_array_equal(np.asarray(d), np.asarray(r))
    return dict(a=a, e=e, x=x, d=d, s=s, t=t)


def _assert_stats(st, want):
    for k in "aexdst":
        got = getattr(st, k).numpy()
        ref = np.asarray(want[k] if isinstance(want, dict) else getattr(want, k))
        assert got.dtype == np.int32, k
        np.testing.assert_array_equal(got, ref, err_msg=k)


@pytest.mark.parametrize("anomalies", ANOMALIES, ids=ANOMALY_IDS)
def test_plain_stats_equal_pallas_kernel_and_scatters(anomalies):
    ref, mine = reference_pair(corpus_histories(**anomalies))
    st = queue_stats_plain(mine.f, mine.type, mine.value, mine.mask,
                           mine.value_space)
    _assert_stats(st, jax_fused_queue_stats(ref, interpret=True))
    _assert_stats(st, _jax_scatter_stats(ref))
    _assert_stats(fused_queue_stats(mine), _jax_scatter_stats(ref))


def test_non_default_length_equals_pallas_kernel():
    ref, mine = reference_pair(corpus_histories(n=2, n_ops=40), length=128)
    _assert_stats(fused_queue_stats(mine), jax_fused_queue_stats(ref, interpret=True))


@pytest.mark.parametrize("case", ["int32_values", "odd_value_space"])
def test_wide_and_odd_value_spaces_equal_scatters(case):
    kw = (dict(value_space=40_000) if case == "int32_values"
          else dict(value_space=250, length=300))
    ref, mine = reference_pair(corpus_histories(n=2, n_ops=80, lost=1), **kw)
    assert mine.value.dtype == (torch.int32 if case == "int32_values"
                                else torch.int16)
    _assert_stats(fused_queue_stats(mine), _jax_scatter_stats(ref))


def _loop_stats(f, ty, v, m, V, pos):
    """Row-by-row reference of the six stats (numpy)."""
    B, L = v.shape
    out = {k: np.zeros((B, V), np.int64) for k in "aexd"}
    out["s"] = np.full((B, V), INT32_MAX, np.int64)
    out["t"] = np.full((B, V), INT32_MAX, np.int64)
    for b in range(B):
        for i in range(L):
            val = int(v[b, i])
            if not m[b, i] or val < 0 or val >= V:
                continue
            p = int(pos[b, i])
            if f[b, i] == 0:
                if ty[b, i] == 0:
                    out["a"][b, val] += 1
                    out["s"][b, val] = min(out["s"][b, val], p)
                elif ty[b, i] == 1:
                    out["e"][b, val] += 1
                elif ty[b, i] == 2:
                    out["x"][b, val] += 1
            elif f[b, i] in (1, 2) and ty[b, i] == 1:
                out["d"][b, val] += 1
                out["t"][b, val] = min(out["t"][b, val], p)
    return out


@pytest.mark.parametrize("seed", range(3))
def test_explicit_positions_equal_row_loop(seed):
    rng = np.random.default_rng(seed)
    B, L, V = 3, 200, 70
    f = rng.integers(0, 6, (B, L)).astype(np.int8)
    ty = rng.integers(0, 4, (B, L)).astype(np.int8)
    # values past V are dropped, as the JAX scatters' mode="drop" does
    v = rng.integers(-2, V + 5, (B, L)).astype(np.int16)
    m = rng.random((B, L)) < 0.8
    pos = rng.integers(0, 2**31 - 1, (B, L)).astype(np.int32)
    cols = dict(f=f, type=ty, value=v, mask=m, first=m.copy(),
                **{k: np.full((B, L), -1, np.int32)
                   for k in ("index", "process", "time_ms", "latency_ms")})
    packed = from_reference_arrays(cols, V, "cpu")
    st = fused_queue_stats(packed, torch.from_numpy(pos))
    _assert_stats(st, _loop_stats(f, ty, v, m, V, pos))


def test_masked_scatters_route_to_the_sink():
    values = torch.tensor([[0, 3, 3, 4, -1, 2]], dtype=torch.int16)
    select = torch.tensor([[True, True, True, True, True, False]])
    # 4 is past V=4 and -1 is no value: both land in the sink, never in V-1
    assert masked_value_counts(values, select, 4).tolist() == [[1, 0, 0, 2]]
    pos = torch.tensor([9, 7, 5, 1, 0, 0], dtype=torch.int32)
    assert masked_value_reduce_min(values, select, pos, 4).tolist() == [
        [9, INT32_MAX, INT32_MAX, 5]
    ]


def test_cpu_dispatch_launches_no_kernel():
    _, mine = reference_pair(corpus_histories(n=2, n_ops=30))
    before = fused_queue_stats.launches
    fused_queue_stats(mine)
    assert fused_queue_stats.launches == before


def test_unsupported_device_raises_instead_of_falling_back():
    _, mine = reference_pair(corpus_histories(n=1, n_ops=20))
    meta = type(mine)(**{
        k: getattr(mine, k).to("meta") if isinstance(getattr(mine, k), torch.Tensor)
        else getattr(mine, k)
        for k in mine.__dataclass_fields__
    })
    with pytest.raises(ValueError, match="unsupported device"):
        fused_queue_stats(meta)
    with pytest.raises(ValueError, match="one device"):
        fused_queue_stats(mine, torch.zeros(mine.f.shape, dtype=torch.int32,
                                            device="meta"))


def _jax_queue_lin_stats(ref, pos):
    """The JAX package's ``(a, x, s, d, t)`` with one ``[L]`` row of
    positions for every history."""
    V = ref.value_space
    a, x, s, r, t = jax.vmap(
        lambda f, ty, v, m: queue_lin_count_vectors(f, ty, v, pos, m, V)
    )(ref.f, ref.type, ref.value, ref.mask)
    return dict(a=a, x=x, s=s, d=r, t=t)


def test_row_pos_equals_broadcast_rows_and_jax_count_vectors():
    ref, mine = reference_pair(corpus_histories(n=3, n_ops=120, lost=1,
                                                causality=1))
    rng = np.random.default_rng(7)
    pos = rng.permutation(2**20)[:mine.length].astype(np.int32)
    row = fused_queue_stats(mine, torch.from_numpy(pos))
    rows = fused_queue_stats(mine, torch.from_numpy(
        np.broadcast_to(pos, mine.f.shape).copy()))
    _assert_stats(row, rows)
    want = _jax_queue_lin_stats(ref, pos)
    for k in "axsdt":
        np.testing.assert_array_equal(getattr(row, k).numpy(),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("shape", ["row", "batch"])
def test_int64_pos_in_range_equals_int32(shape):
    _, mine = reference_pair(corpus_histories(n=2, n_ops=80, duplicated=1))
    rng = np.random.default_rng(11)
    dims = (mine.length,) if shape == "row" else tuple(mine.f.shape)
    pos = rng.integers(-2**31, 2**31 - 1, dims, endpoint=True)
    p32 = torch.from_numpy(pos.astype(np.int32))
    p64 = torch.from_numpy(pos.astype(np.int64))
    _assert_stats(fused_queue_stats(mine, p64), fused_queue_stats(mine, p32))
    # int32 is taken as it is: no range check, no copy
    assert _validated(mine, p32) is p32


@pytest.mark.parametrize("name", list(REFUSALS))
def test_contract_refuses_on_the_cpu_what_it_refuses_on_the_card(name):
    spoil, error = REFUSALS[name]
    packed, pos = spoil(refusal_base("cpu"))
    with pytest.raises(error):
        fused_queue_stats(packed, pos)


@pytest.mark.parametrize("L, V, shift, path", LOAD_PATHS)
def test_inputs_of_both_load_paths_equal_row_loop_on_the_cpu(L, V, shift, path):
    # the card takes these on its vector or scalar path; the CPU takes
    # the same inputs, misaligned ones included, and gives the same stats
    cols, packed, pos = load_path_input(L, V, shift, "cpu")
    st = fused_queue_stats(packed, pos)
    _assert_stats(st, _loop_stats(
        cols["f"], cols["type"], cols["value"], cols["mask"], V,
        np.broadcast_to(cols["pos"], cols["f"].shape)))
