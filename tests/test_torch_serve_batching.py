"""Continuous batching in the port's service ≡ the per-stream serial
oracle ≡ the JAX package's batching service: the cases of
``tests/test_serve_batching.py`` (coalesced streams, mixed buckets
merged in seq order, ops-JSON pass-through, abort and gap while parked,
the park-age bound, parked entries against admission, warm-up hits and
misses), the coalesced launch bit-exact per entry at ``[B, L]`` pos and
at an int32 bucket, the two sides of a failed launch (the data's fault
salvaged entry by entry, the card's or K1's failing every stream and
stopping the service, never a verdict), and ``serve-checker`` as a
process.  Every wait has a timeout; no test asserts a wall-clock time."""

import json
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from jepsen_tpu.history.synth import SynthSpec, synth_history
from jepsen_tpu.obs.metrics import Registry as JaxRegistry
from jepsen_tpu.service.stream import IngestService as JaxIngest
from jepsen_tpu_torch.__main__ import main as port_main
from jepsen_tpu_torch.checkers import segmented
from jepsen_tpu_torch.checkers.segmented import (
    SegmentedChecker,
    queue_prepare_rows,
    queue_stats_from_prepared,
)
from jepsen_tpu_torch.history.columnar import iter_row_blocks
from jepsen_tpu_torch.history.ops import Op, OpF, OpType
from jepsen_tpu_torch.history.rows import _rows_for
from jepsen_tpu_torch.obs.metrics import Registry
from jepsen_tpu_torch.ops._build import KernelLaunchError
from jepsen_tpu_torch.parallel import pipeline
from jepsen_tpu_torch.service import CheckerClient, CheckerServer
from jepsen_tpu_torch.service.cache import VerdictCache
from jepsen_tpu_torch.service.stream import IngestService, _wire_safe

REPO = Path(__file__).resolve().parent.parent
FAMILIES = ("queue", "linear", "valid?")


def history(n_ops=400, seed=3, **anoms):
    ops = synth_history(SynthSpec(n_ops=n_ops, seed=seed, **anoms)).ops
    ops = [Op.from_json(op.to_json()) for op in ops]
    return _rows_for(ops), len(ops), ops


def families(v):
    return {k: _wire_safe(v.get(k)) for k in FAMILIES}


def oracle(rows, n_ops):
    eng = SegmentedChecker("queue", device="cpu")
    eng.feed_rows(rows, n_ops)
    return families(eng.finish())


def svc(**kw):
    kw.setdefault("workers", 2)
    kw.setdefault("registry", Registry())
    kw.setdefault("batch", True)
    kw.setdefault("target_batch", 8)
    kw.setdefault("max_batch_wait_ms", 25.0)
    return IngestService(device="cpu", **kw)


def jax_svc(**kw):
    kw.setdefault("workers", 2)
    kw.setdefault("registry", JaxRegistry())
    kw.setdefault("batch", True)
    kw.setdefault("target_batch", 8)
    kw.setdefault("max_batch_wait_ms", 25.0)
    return JaxIngest(device=False, **kw)


def open_stream(s, deadline_s=60.0):
    r = s.open("queue", None, kind="stream", deadline_s=deadline_s)
    assert r["op"] == "opened", r
    return r["stream"]


def feed_interleaved(s, streams, block_rows=96):
    """Round-robin blocks across streams, so every bucket coalesces
    material of several streams."""
    plans = [(sid, list(iter_row_blocks(rows, block_rows)), [0])
             for sid, (rows, _n) in streams]
    fed = True
    while fed:
        fed = False
        for sid, blocks, cur in plans:
            if cur[0] >= len(blocks):
                continue
            rep = s.feed(sid, cur[0], "rows", *blocks[cur[0]])
            assert rep["op"] == "accepted", rep
            cur[0] += 1
            fed = True


def test_cross_stream_batching_equals_the_serial_oracle_and_the_jax_service():
    corpus = [history(n_ops=160 + 40 * i, seed=i, lost=i % 2,
                      duplicated=(i + 1) % 2)[:2] for i in range(6)]
    out = []
    for make in (svc, jax_svc):
        s = make()
        try:
            streams = [(open_stream(s), hv) for hv in corpus]
            feed_interleaved(s, streams)
            out.append(([s.finish(sid, timeout=30) for sid, _ in streams],
                        s.stats()))
        finally:
            s.close()
    (verdicts, stats), (jverdicts, _jstats) = out
    for v, jv, (rows, n_ops) in zip(verdicts, jverdicts, corpus):
        assert families(v) == families(jv) == oracle(rows, n_ops)
        assert "degraded" not in v
    bat = stats["batcher"]
    assert bat["batched_blocks"] > 0 and bat["salvages"] == 0
    assert 0 < bat["launches"] < bat["batched_blocks"]


def test_mixed_buckets_of_one_stream_merge_in_seq_order():
    rows, n_ops, _ = history(n_ops=900, seed=11, lost=2, duplicated=2)
    small = list(iter_row_blocks(rows, 64))
    blocks, i = [], 0
    while i < len(small):
        if i % 3 == 2 or i + 1 >= len(small):
            blocks.append(small[i])
            i += 1
        else:  # a double-width block: another (L, V) bucket
            (b1, n1), (b2, n2) = small[i], small[i + 1]
            blocks.append((np.concatenate([b1, b2]), n1 + n2))
            i += 2
    s = svc(target_batch=4, max_batch_wait_ms=10.0)
    try:
        sid = open_stream(s)
        for seq, (blk, b_ops) in enumerate(blocks):
            assert s.feed(sid, seq, "rows", blk, b_ops)["op"] == "accepted"
        v = s.finish(sid, timeout=30)
    finally:
        s.close()
    assert families(v) == oracle(rows, n_ops)


def test_ops_json_blocks_interleave_with_coalesced_rows():
    rows, n_ops, ops = history(n_ops=240, seed=7, lost=1)
    mid = len(ops) // 2
    s = svc(target_batch=4)
    try:
        sid = open_stream(s)
        rep = s.feed(sid, 0, "ops", [op.to_json() for op in ops[:mid]], mid)
        assert rep["op"] == "accepted", rep
        rest = _rows_for(ops[mid:])
        assert s.feed(sid, 1, "rows", rest, n_ops - mid)["op"] == "accepted"
        sid_b = open_stream(s)
        for seq, b in enumerate(iter_row_blocks(rows, 96)):
            s.feed(sid_b, seq, "rows", *b)
        v, v_b = s.finish(sid, timeout=30), s.finish(sid_b, timeout=30)
    finally:
        s.close()
    want = oracle(rows, n_ops)
    assert families(v) == families(v_b) == want


def test_abort_while_parked_leaves_batch_mates_unaffected():
    corpus = [history(n_ops=200, seed=20 + i)[:2] for i in range(3)]
    reg = Registry()
    s = svc(registry=reg, target_batch=64, max_batch_wait_ms=30_000.0,
            park_max_s=60.0)
    try:
        streams = [(open_stream(s), hv) for hv in corpus]
        feed_interleaved(s, streams)
        victim = streams[1][0]
        assert s.abort(victim)["op"] == "aborted"
        evicted = reg.value("service.batcher_evictions", reason="aborted")
        survivors = [(s.finish(sid, timeout=30), hv)
                     for sid, hv in streams if sid != victim]
    finally:
        s.close()
    assert evicted > 0
    for v, (rows, n_ops) in survivors:
        assert families(v) == oracle(rows, n_ops)


def test_a_gap_while_parked_keeps_its_evidence():
    rows, _n, _ = history(n_ops=300, seed=31)
    mate_rows, mate_ops, _ = history(n_ops=300, seed=32, lost=1)
    reg = Registry()
    s = svc(registry=reg, target_batch=64, max_batch_wait_ms=30_000.0,
            park_max_s=60.0)
    try:
        sid, mate = open_stream(s), open_stream(s)
        blocks = list(iter_row_blocks(rows, 96))
        for seq, b in enumerate(iter_row_blocks(mate_rows, 96)):
            s.feed(mate, seq, "rows", *b)
        s.feed(sid, 0, "rows", *blocks[0])
        assert s.feed(sid, 2, "rows", *blocks[2])["op"] == "quarantined"
        v, v_mate = s.finish(sid, timeout=30), s.finish(mate, timeout=30)
        evicted = reg.value("service.batcher_evictions", reason="quarantined")
    finally:
        s.close()
    assert v["valid?"] == "unknown"
    assert "gap in block sequence" in json.dumps(v)
    assert evicted > 0
    assert families(v_mate) == oracle(mate_rows, mate_ops)


def test_the_park_age_bound_dispatches_an_undersized_bucket():
    rows, n_ops, _ = history(n_ops=160, seed=40)
    s = svc(target_batch=64, max_batch_wait_ms=600_000.0, park_max_s=0.3)
    try:
        sid = open_stream(s)
        for seq, b in enumerate(iter_row_blocks(rows, 96)):
            s.feed(sid, seq, "rows", *b)
        bat = {}
        for _ in range(400):  # bounded poll, about 10 s at most
            bat = s.stats()["batcher"]
            if bat["parked"] == 0 and bat["launches"] >= 1:
                break
            time.sleep(0.025)
        v = s.finish(sid, timeout=30)
    finally:
        s.close()
    assert bat["parked"] == 0 and bat["launches"] >= 1, bat
    assert families(v) == oracle(rows, n_ops)


def test_parked_entries_count_against_admission():
    rows, _n, _ = history(n_ops=400, seed=41)
    s = svc(ingress_cap=4, target_batch=64, max_batch_wait_ms=30_000.0,
            park_max_s=60.0)
    try:
        sid = open_stream(s)
        blocks = list(iter_row_blocks(rows, 64))
        rejected, fed = None, 0
        for seq, b in enumerate(blocks):
            rep = s.feed(sid, seq, "rows", *b)
            if rep["op"] == "rejected":
                rejected = rep
                break
            fed += 1
        v = s.finish(sid, timeout=30)
    finally:
        s.close()
    assert rejected is not None and rejected["saturated"] == "ingress"
    part = np.concatenate([b for b, _ in blocks[:fed]])
    assert families(v) == oracle(part, sum(n for _, n in blocks[:fed]))


def test_warmup_hit_and_cold_miss_counters():
    rows, n_ops, _ = history(n_ops=200, seed=50)
    blk, _ = next(iter_row_blocks(rows, 96))
    prep = queue_prepare_rows(blk, blk[:, 0].astype(np.int64))
    bucket = (int(prep["L"]), int(prep["V"]))

    def run(**kw):
        s = svc(target_batch=4, **kw)
        try:
            sid = open_stream(s)
            for seq, b in enumerate(iter_row_blocks(rows, 96)):
                s.feed(sid, seq, "rows", *b)
            v = s.finish(sid, timeout=30)
            stats = s.stats()
        finally:
            s.close()
        assert families(v) == oracle(rows, n_ops)
        return stats["batcher"]

    warm = run(warmup=True, warmup_buckets=(bucket,))
    assert warm["warmup_hits"] >= 1 and warm["warmup_misses"] == 0
    assert bucket in [tuple(b) for b in warm["warmed_buckets"]]
    cold = run(warmup=False)
    assert cold["warmup_hits"] == 0 and cold["warmup_misses"] >= 1


def _wide_rows(n_values: int, base: int) -> np.ndarray:
    """A segment of ``n_values`` distinct values (every other one
    enqueued and acknowledged, the rest only read) at global positions
    from ``base``."""
    rng = np.random.default_rng(n_values)
    ops = []
    for i, v in enumerate(rng.permutation(4 * n_values)[:n_values].tolist()):
        if i % 2:
            ops.append(Op(OpType.OK, OpF.DEQUEUE, 7, v, time=4))
        else:
            ops += [Op.invoke(OpF.ENQUEUE, v % 5, v, time=1),
                    Op(OpType.OK, OpF.ENQUEUE, v % 5, v, time=2)]
    for i, op in enumerate(ops):
        op.index = base + i
    return _rows_for(ops)


@pytest.mark.parametrize("bucket_kind", ["int16", "int32"])
def test_a_coalesced_launch_gives_each_entry_its_solo_stats(bucket_kind):
    """Several streams' segments through one ring slot and one launch at
    ``[B, L]`` pos (each stream's own global op indices): each row of the
    planes equals that segment checked alone, at an int16 and an int32
    bucket."""
    if bucket_kind == "int16":
        segs = [history(n_ops=300, seed=60 + i, lost=i % 2)[0][:120]
                for i in range(5)]
        for i, r in enumerate(segs):  # far apart global positions
            r[:, 0] += i * 1_000_000
    else:
        segs = [_wide_rows(40_000, base=(1 << 20) * (i + 1))
                for i in range(2)]
    preps = [queue_prepare_rows(r, r[:, 0].astype(np.int64)) for r in segs]
    keys = {(p["L"], p["V"]) for p in preps}
    assert len(keys) == 1
    (L, V), = keys
    assert preps[0]["val"].dtype == (np.int16 if bucket_kind == "int16"
                                     else np.int32)
    ring = pipeline.BucketStagingRing(8, L, V, "cpu", depth=1)
    slot = ring.acquire(timeout=5)
    ring.fill(slot, preps)
    pipeline.dispatch_coalesced(slot, V)
    planes = slot["out"].numpy()
    for i, p in enumerate(preps):
        got = segmented._trim_queue_stats(p["u"], *(q[i] for q in planes))
        solo = queue_stats_from_prepared(p, "cpu")
        for a, b in zip(got, solo):
            np.testing.assert_array_equal(a, b)
    assert not planes[:4, len(preps):].any()  # masked rows count nothing
    ring.release(slot)
    assert slot["inflight"] is None


# ---------------------------------------------------------------------------
# faults: the data's are salvaged, the card's or K1's fail loud
# ---------------------------------------------------------------------------


def _streams(s, corpus):
    streams = [(open_stream(s), hv) for hv in corpus]
    feed_interleaved(s, streams)
    return streams


def test_a_data_fault_in_a_coalesced_launch_is_salvaged(monkeypatch):
    corpus = [history(n_ops=200, seed=70 + i, lost=i % 2)[:2]
              for i in range(3)]

    def refuse(slot, V, stream=None):
        raise ValueError("a stand-in launch refused the batch")

    monkeypatch.setattr(pipeline, "dispatch_coalesced", refuse)
    s = svc(target_batch=4)
    try:
        streams = _streams(s, corpus)
        verdicts = [s.finish(sid, timeout=30) for sid, _ in streams]
        stats = s.stats()
    finally:
        s.close()
    assert stats["batcher"]["salvages"] >= 1
    assert s.device_fault is None
    for v, (rows, n_ops) in zip(verdicts, corpus):
        assert families(v) == oracle(rows, n_ops)
        assert "degraded" not in v
        assert v["segmented"]["quarantined-segments"] == 0


@pytest.mark.parametrize("path", ["batcher", "worker"])
def test_a_device_fault_fails_every_stream_and_is_never_a_verdict(
        monkeypatch, path):
    corpus = [history(n_ops=200, seed=80 + i)[:2] for i in range(3)]
    fault = KernelLaunchError("queue_stats kernel launch failed: CUDA "
                              "error 700")

    def broken(*a, **kw):
        raise fault

    if path == "batcher":
        monkeypatch.setattr(pipeline, "dispatch_coalesced", broken)
    else:
        monkeypatch.setattr(segmented, "_dispatch", broken)
    reg = Registry()
    seen = []
    s = svc(registry=reg, batch=path == "batcher", target_batch=4,
            cache=VerdictCache(8, registry=reg))
    s.on_device_fault = seen.append
    try:
        streams = []
        for rows, n_ops in corpus:
            sid = open_stream(s)
            for seq, b in enumerate(iter_row_blocks(rows, 96)):
                rep = s.feed(sid, seq, "rows", *b)
                assert rep["op"] in ("accepted", "error"), rep
            streams.append(sid)
        verdicts = [s.finish(sid, timeout=30) for sid in streams]
        refused = s.open("queue", None)
        stats = s.stats()
    finally:
        s.close()
    assert s.device_fault is fault and seen == [fault]
    for v in verdicts:
        assert (v["op"], v["reason"]) == ("error", "device-fault")
        assert "CUDA error 700" in v["error"] and "valid?" not in v
    assert (refused["op"], refused["reason"]) == ("error", "device-fault")
    assert stats["cache"]["entries"] == 0
    assert reg.value("service.streams_quarantined") == 0
    if path == "batcher":
        assert stats["batcher"]["salvages"] == 0


def test_a_device_fault_in_the_check_op_stops_the_server(monkeypatch):
    from jepsen_tpu_torch.checkers import fused

    fault = KernelLaunchError("queue_stats kernel launch failed: CUDA "
                              "error 719")

    def broken(*a, **kw):
        raise fault

    srv = CheckerServer(host="127.0.0.1", port=0, device="cpu",
                        metrics_registry=Registry())
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        _rows, _n, ops = history(n_ops=80, seed=90)
        with CheckerClient(port=srv.port, timeout=30) as c:
            sid = c.stream_open("queue")["stream"]
            monkeypatch.setattr(fused, "fused_queue_stats", broken)
            with pytest.raises(RuntimeError, match="CUDA error 719"):
                c.check_histories([ops])
            t.join(timeout=30)
            assert not t.is_alive()
        assert srv.device_fault is fault
        assert srv.ingest_service().finish(sid)["reason"] == "device-fault"
    finally:
        srv.server_close()


# ---------------------------------------------------------------------------
# serve-checker as a process
# ---------------------------------------------------------------------------


def test_serve_checker_runs_answers_and_stops_on_sigint(tmp_path):
    errlog = tmp_path / "stderr.txt"
    with open(errlog, "w") as err_fh:
        proc = subprocess.Popen(
            [sys.executable, "-m", "jepsen_tpu_torch", "serve-checker",
             "--device", "cpu", "--host", "127.0.0.1", "--port", "0",
             "--metrics-port", "-1", "--store", str(tmp_path), "--batch",
             "--warmup", "--target-batch", "4"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=err_fh, text=True)
    watchdog = threading.Timer(120, proc.kill)  # a hung start fails, late
    watchdog.start()
    try:
        banner = proc.stdout.readline()
        m = re.match(r"checker sidecar on 127\.0\.0\.1:(\d+) \(backend=cpu, "
                     r"mesh=None, metrics=off\)", banner)
        assert m, (banner, errlog.read_text()[-2000:])
        rows, n_ops, ops = history(n_ops=150, seed=5, lost=1)
        with CheckerClient(port=int(m[1]), timeout=30) as c:
            assert c.ping()["backend"] == "cpu"
            (r,) = c.check_histories([ops])
            assert r["valid?"] is False and r["queue"]["lost-count"] == 1
            sid = c.stream_open("queue")["stream"]
            for seq, b in enumerate(iter_row_blocks(rows, 64)):
                assert c.stream_feed_rows(sid, seq, *b)["op"] == "accepted"
            v = c.stream_finish(sid, timeout=30)
        assert families(v) == oracle(rows, n_ops)
        proc.send_signal(signal.SIGINT)
        proc.communicate(timeout=60)
        assert proc.returncode == 0, errlog.read_text()[-2000:]
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)


@pytest.mark.parametrize("argv,match", [
    (["serve-checker", "--port", "0"], "no CUDA device"),
    (["serve-checker", "--seq", "2", "--device", "cpu"], "item 9"),
    (["serve-checker", "--device", "cpu", "--warmup-buckets", "128"],
     "not L:V"),
])
def test_serve_checker_refusals_exit_2(capsys, argv, match):
    if "--device" not in argv and torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    assert port_main(argv) == 2
    err = capsys.readouterr().err.strip().splitlines()
    assert err[0].startswith("error: ") and re.search(match, err[0])
