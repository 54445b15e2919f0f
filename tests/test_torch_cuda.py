"""The port on the card against its plain PyTorch version: the CUDA
kernel, the pipeline executor with its pinned staging ring, and
``perf``.

This file imports no JAX, so that it runs where the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Where no card is present the tests skip.  :data:`REFUSALS`, the inputs
the stats dispatcher refuses on every device, and :data:`LOAD_PATHS`,
inputs of both of K1's load paths, are shared with the CPU tests of
``test_torch_queue_stats.py``.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.checkers.fused import combined_tensor_check
from jepsen_tpu_torch.checkers.perf import perf_tensor_check
from jepsen_tpu_torch.checkers.queue_lin import queue_lin_tensor_check
from jepsen_tpu_torch.checkers.total_queue import total_queue_tensor_check
from jepsen_tpu_torch.history.encode import (
    TENSOR_FIELDS,
    from_reference_arrays,
    pack_histories,
)
from jepsen_tpu_torch.history.store import write_history_jsonl
from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch
from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats, queue_stats_plain
from jepsen_tpu_torch.parallel.pipeline import check_sources


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def refusal_base(dev):
    """A small valid batch on ``dev`` that :data:`REFUSALS` spoils."""
    hs = [s.ops for s in synth_batch(2, SynthSpec(n_ops=30))]
    return _to(pack_histories(hs, device="cpu"), dev)


def _columns(**fns):
    return lambda p: (dataclasses.replace(
        p, **{k: fn(getattr(p, k)) for k, fn in fns.items()}), None)


def _pos(make):
    return lambda p: (p, make(p))


#: name -> (spoil: packed -> (packed, pos), the error every device raises)
REFUSALS = {
    "int64 pos above int32": (_pos(lambda p: torch.full(
        p.f.shape, 2**31, dtype=torch.int64, device=p.device)), ValueError),
    "int64 [L] pos below int32": (_pos(lambda p: torch.full(
        p.f.shape[1:], -2**31 - 1, dtype=torch.int64, device=p.device)),
        ValueError),
    "float pos": (_pos(lambda p: torch.zeros(
        p.f.shape, device=p.device)), TypeError),
    "bool pos": (_pos(lambda p: torch.zeros(
        p.f.shape, dtype=torch.bool, device=p.device)), TypeError),
    "pos of shape [B, L+1]": (_pos(lambda p: torch.zeros(
        (p.batch, p.length + 1), dtype=torch.int32, device=p.device)),
        ValueError),
    "pos of shape [1, L]": (_pos(lambda p: torch.zeros(
        (1, p.length), dtype=torch.int32, device=p.device)), ValueError),
    "int32 f": (_columns(f=lambda t: t.int()), TypeError),
    "int16 type": (_columns(type=lambda t: t.short()), TypeError),
    "uint8 mask": (_columns(mask=lambda t: t.to(torch.uint8)), TypeError),
    "int64 value": (_columns(value=lambda t: t.long()), TypeError),
    "int8 value": (_columns(value=lambda t: t.to(torch.int8)), TypeError),
    "mask of another shape": (_columns(mask=lambda t: t[:, :-1]), ValueError),
    "1-D columns": (_columns(**{k: (lambda t: t[0]) for k in
                                ("f", "type", "value", "mask")}), ValueError),
    "value_space 0": (lambda p: (dataclasses.replace(p, value_space=0), None),
                      ValueError),
}


def _to(packed, dev):
    return dataclasses.replace(
        packed, **{k: getattr(packed, k).to(dev) for k in TENSOR_FIELDS}
    )


#: (L, V, input placed off a 16-byte boundary, the load path K1 takes):
#: the vector path needs L % 16 == 0, V % 4 == 0 and aligned arrays
LOAD_PATHS = [
    (1024, 384, None, "vector"), (128, 4, None, "vector"),
    (1000, 384, None, "scalar"), (1024, 382, None, "scalar"),
    (1024, 1, None, "scalar"), (1024, 384, "f", "scalar"),
    (1024, 384, "value", "scalar"), (1024, 384, "pos", "scalar"),
]


def shifted(t):
    """``t`` copied to start one element past an aligned address."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def load_path_input(L, V, shift, dev):
    """Three random histories of ``L`` rows over ``V`` value ids and an
    ``[L]`` pos, on ``dev``, with input ``shift`` placed off a 16-byte
    boundary; returns ``(columns as numpy, packed, pos)``."""
    rng = np.random.default_rng(L * 1000 + V)
    B = 3
    cols = {
        "f": rng.integers(0, 6, (B, L)).astype(np.int8),
        "type": rng.integers(0, 4, (B, L)).astype(np.int8),
        "value": rng.integers(-1, V + 2, (B, L)).astype(np.int16),
        "mask": rng.random((B, L)) < 0.9,
        "pos": rng.integers(-2**31, 2**31 - 1, L, endpoint=True).astype(
            np.int32),
    }
    cols["first"] = cols["mask"].copy()
    for k in ("index", "process", "time_ms", "latency_ms"):
        cols[k] = np.full((B, L), -1, np.int32)
    packed = from_reference_arrays(cols, V, dev)
    pos = torch.from_numpy(cols["pos"]).to(dev)
    if shift == "pos":
        pos = shifted(pos)
    elif shift:
        packed = dataclasses.replace(
            packed, **{shift: shifted(getattr(packed, shift))})
    return cols, packed, pos


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


@pytest.mark.cuda
def test_kernel_equals_plain_on_every_load_path(cuda_device):
    from chip_smoke import check_exact_case, exact_cases

    paths = set()
    for case in exact_cases():
        before = fused_queue_stats.launches
        path, err = check_exact_case(case, cuda_device)
        assert err == 0, case.name
        assert fused_queue_stats.launches == before + 1, case.name
        paths.add(path)
    assert paths == {"vector", "scalar"}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(REFUSALS))
def test_card_refuses_what_the_cpu_refuses(cuda_device, name):
    spoil, error = REFUSALS[name]
    for dev in (torch.device("cpu"), cuda_device):
        packed, pos = spoil(refusal_base(dev))
        before = fused_queue_stats.launches
        with pytest.raises(error):
            fused_queue_stats(packed, pos)
        assert fused_queue_stats.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("L, V, shift, path", LOAD_PATHS)
def test_launcher_chooses_the_load_path(cuda_device, L, V, shift, path):
    _, packed, pos = load_path_input(L, V, shift, cuda_device)
    k = fused_queue_stats(packed, pos)
    assert fused_queue_stats.last_path == path
    pl = queue_stats_plain(packed.f, packed.type, packed.value, packed.mask,
                           V, pos)
    for f in "aexdst":
        assert torch.equal(getattr(k, f), getattr(pl, f)), f


def queue_store(root, n: int):
    """``n`` synthetic queue histories with assorted anomalies, one run
    directory each, in sorted order."""
    kinds = ({}, {"lost": 1}, {"duplicated": 1}, {"unexpected": 1},
             {"phantom_fail": 1}, {"causality": 1})
    paths = []
    for i in range(n):
        sh = synth_batch(1, SynthSpec(n_ops=30 + 5 * (i % 9), seed=i),
                         **kinds[i % len(kinds)])[0]
        d = root / f"run{i:03d}"
        d.mkdir(parents=True)
        write_history_jsonl(d / "history.jsonl", sh.ops)
        paths.append(d / "history.jsonl")
    return paths


@pytest.mark.cuda
@pytest.mark.parametrize("delivery", ["exactly-once", "at-least-once"])
def test_pipeline_on_the_card_equals_the_cpu_path(cuda_device, tmp_path,
                                                  delivery):
    paths = queue_store(tmp_path, 20)
    want, _ = check_sources("queue", paths, chunk=8, delivery=delivery,
                            device="cpu")
    fused_queue_stats.launches = 0
    got, stats = check_sources("queue", paths, chunk=8, delivery=delivery,
                               device=cuda_device)
    assert fused_queue_stats.launches == 3  # ceil(20 / 8), one per batch
    assert fused_queue_stats.last_path == "vector"
    assert got == want and stats.quarantined == 0
    serial, _ = check_sources("queue", paths, chunk=8, delivery=delivery,
                              device=cuda_device, serial=True)
    assert serial == want


@pytest.mark.cuda
def test_pinned_ring_under_stress(cuda_device, tmp_path):
    """Depth 2 and chunks of 4: a slot refilled while its copy is still
    in flight would change some batch's verdicts."""
    paths = queue_store(tmp_path, 64)
    want, _ = check_sources("queue", paths, chunk=4, device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for _ in range(3):
            got, stats = check_sources("queue", paths, chunk=4, depth=2,
                                       device=cuda_device)
            assert got == want and stats.quarantined == 0
    finally:
        sys.setswitchinterval(interval)
    serial, _ = check_sources("queue", paths, chunk=4, depth=2,
                              device=cuda_device, serial=True)
    assert serial == want


@pytest.mark.cuda
def test_perf_on_the_card_equals_the_cpu(cuda_device):
    hs = [s.ops for s in synth_batch(8, SynthSpec(n_ops=150), lost=1)]
    hs.append([])
    packed = pack_histories(hs, device="cpu")
    want = perf_tensor_check(packed)
    got = perf_tensor_check(_to(packed, cuda_device))
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name).cpu()
        assert g.dtype == w.dtype, f.name
        if w.dtype == torch.float32:
            w, g = w.view(torch.int32), g.view(torch.int32)  # bit for bit
        assert torch.equal(g, w), f.name


def segment_rows(n_values: int, seed: int = 0) -> np.ndarray:
    """The exploded rows of one segment whose queue rows hold
    ``n_values`` distinct values at global positions past 2**20: each
    value enqueued (some failed or indeterminate) and read, some twice."""
    from jepsen_tpu_torch.history.ops import Op, OpF, OpType
    from jepsen_tpu_torch.history.rows import _rows_for

    rng = np.random.default_rng(seed)
    ops = []
    for v in rng.permutation(4 * n_values)[:n_values].tolist():
        done = OpType.FAIL if v % 97 == 0 else OpType.OK
        ops += [Op.invoke(OpF.ENQUEUE, v % 5, v, time=1),
                Op(done, OpF.ENQUEUE, v % 5, v, time=2),
                Op.invoke(OpF.DEQUEUE, 7, None, time=3),
                Op(OpType.OK, OpF.DEQUEUE, 7, v, time=4)]
    ops += [ops[int(k)] for k in rng.integers(0, len(ops), 64)]
    for i, op in enumerate(ops):
        op.index = (1 << 20) + i
    return _rows_for(ops)


@pytest.mark.cuda
@pytest.mark.parametrize("n_values, dtype", [(20_000, torch.int16),
                                             (40_000, torch.int32)])
def test_kernel_at_segment_shapes_equals_plain(cuda_device, n_values, dtype):
    """K1 as the segmented engine drives it: B=1, an ``[L]`` pos of global
    op indexes, dense local value ids in int16 (V=32,768) and int32
    (V=65,536)."""
    from jepsen_tpu_torch.checkers.segmented import (
        _k1_input,
        queue_prepare_rows,
    )

    rows = segment_rows(n_values)
    prep = queue_prepare_rows(rows, rows[:, 0].astype(np.int64))
    cols = [torch.from_numpy(prep[k]).unsqueeze(0).to(cuda_device)
            for k in ("f", "typ", "val", "mask")]
    assert cols[2].dtype == dtype
    assert prep["L"] == (65_536 if dtype == torch.int16 else 131_072)
    packed = _k1_input(*cols, prep["V"])
    pos = torch.from_numpy(prep["pos"]).to(cuda_device)
    fused_queue_stats.launches = 0
    got = fused_queue_stats(packed, pos)
    assert fused_queue_stats.launches == 1
    want = queue_stats_plain(packed.f, packed.type, packed.value,
                             packed.mask, packed.value_space, pos)
    for k in "aexdst":
        assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.cuda
def test_segmented_check_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    from jepsen_tpu_torch.checkers.segmented import segmented_check_file

    sh = synth_batch(1, SynthSpec(n_ops=3000, seed=11), lost=1,
                     duplicated=1)[0]
    hp = tmp_path / "history.jsonl"
    write_history_jsonl(hp, sh.ops)
    want = segmented_check_file(hp, segment_ops=1000, device="cpu")
    fused_queue_stats.launches = 0
    got = segmented_check_file(hp, segment_ops=1000, device=cuda_device)
    segments = got["segmented"]["segments"]
    assert fused_queue_stats.launches == segments == want["segmented"][
        "segments"] > 1
    for fam in ("queue", "linear", "valid?"):
        assert got[fam] == want[fam], fam
    assert got["queue"]["valid?"] is False


def bucket_preps(B: int, L: int, V: int, seed: int = 0) -> list:
    """``B`` prepared segments of one batcher bucket ``(L, V)``: random
    codes, dense local ids below ``V`` in K1's dtype for ``V``, each
    with its own global op indices as positions, and a random fill."""
    from jepsen_tpu_torch.checkers.segmented import local_id_dtype

    rng = np.random.default_rng(seed)
    preps = []
    for i in range(B):
        n = int(rng.integers(1, L + 1))
        mask = np.zeros(L, bool)
        mask[:n] = True
        preps.append({
            "f": rng.integers(-1, 3, L).astype(np.int8),
            "typ": rng.integers(-1, 4, L).astype(np.int8),
            "val": rng.integers(-1, V, L).astype(local_id_dtype(V)),
            "pos": np.sort(rng.integers(0, 2**31 - 1, L)).astype(np.int32),
            "mask": mask,
        })
    return preps


@pytest.mark.cuda
@pytest.mark.parametrize("B, L, V", [(32, 128, 128), (32, 256, 256),
                                     (2, 65_536, 65_536)])
def test_kernel_at_batcher_buckets_equals_plain(cuda_device, B, L, V):
    """K1 as the service batcher drives it: a pinned ring slot filled with
    ``B`` segments, copied and launched on the batcher's own stream with a
    ``[B, L]`` pos, the planes copied back behind an event; each row
    equals the plain version on the same stacks, at the two default
    buckets and an int32 one."""
    from jepsen_tpu_torch.parallel.pipeline import (
        BucketStagingRing,
        dispatch_coalesced,
    )

    preps = bucket_preps(B, L, V, seed=L)
    ring = BucketStagingRing(B, L, V, cuda_device, depth=2)
    slot = ring.acquire(timeout=5)
    assert slot["f"].is_pinned() and slot["out"].is_pinned()
    ring.fill(slot, preps)
    stream = torch.cuda.Stream(cuda_device)
    fused_queue_stats.launches = 0
    dispatch_coalesced(slot, V, stream)
    slot["event"].synchronize()
    assert fused_queue_stats.launches == 1
    cols = {k: torch.from_numpy(np.stack([p[k] for p in preps]))
            for k in ("f", "typ", "val", "pos", "mask")}
    want = queue_stats_plain(cols["f"], cols["typ"], cols["val"],
                             cols["mask"], V, cols["pos"])
    for i, k in enumerate("aexdst"):
        assert torch.equal(slot["out"][i], getattr(want, k)), k
    ring.release(slot)


@pytest.mark.cuda
def test_batching_service_on_the_card_equals_the_cpu(cuda_device):
    """16 streams through ``IngestService(batch=True)`` on the card and on
    the CPU: equal verdicts, and K1 launched on the card."""
    from jepsen_tpu_torch.history.columnar import iter_row_blocks
    from jepsen_tpu_torch.history.rows import _rows_for
    from jepsen_tpu_torch.obs.metrics import Registry
    from jepsen_tpu_torch.service.stream import IngestService, _wire_safe

    corpus = [_rows_for(sh.ops) for sh in synth_batch(
        16, SynthSpec(n_ops=300, seed=21), lost=1, duplicated=1)]
    out = {}
    for dev in ("cpu", cuda_device):
        svc = IngestService(device=dev, batch=True, target_batch=8,
                            registry=Registry())
        fused_queue_stats.launches = 0
        try:
            sids = []
            for rows in corpus:
                sid = svc.open("queue", None, kind="stream")["stream"]
                for seq, (blk, n) in enumerate(iter_row_blocks(rows, 96)):
                    assert svc.feed(sid, seq, "rows", blk, n)["op"] == (
                        "accepted")
                sids.append(sid)
            verdicts = [svc.finish(s, timeout=60) for s in sids]
            stats = svc.stats()
        finally:
            svc.close()
        assert stats["batcher"]["salvages"] == 0
        out[str(dev)] = ([{k: _wire_safe(v[k]) for k in
                           ("queue", "linear", "valid?")} for v in verdicts],
                         fused_queue_stats.launches)
    (cpu, _), (card, launches) = out["cpu"], out[str(cuda_device)]
    assert card == cpu and launches > 0
    assert all(v["valid?"] is False for v in card)
