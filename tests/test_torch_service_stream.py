"""The port's streaming ingestion ≡ the JAX package's ≡ the port's
monolithic check: the cases of ``tests/test_service_stream.py``
(``TestIngestCore``, ``TestAdmissionControl``, ``TestChaosRecovery``
through the worker-death hook, ``TestVerdictCache``,
``TestWireStreaming``, ``TestClientRetry``), each run through both
packages' ``IngestService`` on the CPU, plus verdict-window
subscriptions and the content key a stream and a ``.jtc`` share.

Every wait has a timeout; no test asserts a wall-clock time."""

import hashlib
import json
import random
import struct
import time
import zlib

import numpy as np
import pytest

from jepsen_tpu.history.synth import SynthSpec, synth_history
from jepsen_tpu.obs.metrics import Registry as JaxRegistry
from jepsen_tpu.service.cache import VerdictCache as JaxCache
from jepsen_tpu.service.cache import cache_key as jax_cache_key
from jepsen_tpu.service.client import RetryPolicy as JaxRetry
from jepsen_tpu.service.stream import IngestService as JaxIngest
from jepsen_tpu_torch.checkers.fused import check_queue_batch
from jepsen_tpu_torch.checkers.segmented import SegmentedChecker
from jepsen_tpu_torch.history.columnar import iter_row_blocks
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.history.rows import _rows_for
from jepsen_tpu_torch.obs.metrics import Registry
from jepsen_tpu_torch.service import (
    CheckerClient,
    CheckerServer,
    RetryPolicy,
    ServiceUnavailable,
)
from jepsen_tpu_torch.service.cache import VerdictCache, cache_key, contract_key
from jepsen_tpu_torch.service.protocol import MAGIC, recv_frame
from jepsen_tpu_torch.service.stream import SATURATED, IngestService, _wire_safe

FAMILIES = ("queue", "linear", "valid?")


class History:
    def __init__(self, n_ops=400, seed=3, **anoms):
        sh = synth_history(SynthSpec(n_ops=n_ops, seed=seed, **anoms))
        self.ops = [Op.from_json(op.to_json()) for op in sh.ops]
        self.rows = _rows_for(self.ops)
        self.n_ops = len(self.ops)

    def blocks(self, block_rows=128):
        return list(iter_row_blocks(self.rows, block_rows))

    def monolithic(self):
        """The port's monolithic check of the same history, as the wire
        carries it."""
        return _wire_safe(check_queue_batch([self.ops], device="cpu")[0])


def families(v):
    return {k: _wire_safe(v.get(k)) for k in FAMILIES}


def oracle(h):
    eng = SegmentedChecker("queue", device="cpu")
    eng.feed_rows(h.rows, h.n_ops)
    out = families(eng.finish())
    mono = h.monolithic()
    assert {k: out[k] for k in ("queue", "linear")} == mono
    return out


def port_svc(**kw):
    kw.setdefault("workers", 2)
    kw.setdefault("registry", Registry())
    return IngestService(device="cpu", **kw)


def jax_svc(**kw):
    kw.setdefault("workers", 2)
    kw.setdefault("registry", JaxRegistry())
    if "cache" in kw:
        kw["cache"] = JaxCache(kw["cache"].capacity, registry=kw["registry"])
    return JaxIngest(device=False, **kw)


def both(scenario, **kw):
    """``scenario(svc)`` through the port's service and the JAX
    package's, each closed after; returns ``(port, jax)``."""
    out = []
    for make in (port_svc, jax_svc):
        svc = make(**kw)
        try:
            out.append(scenario(svc))
        finally:
            svc.close()
    return out


def feed_stream(svc, h, block_rows=128, deadline_s=60.0, dying=False):
    """Open a stream and feed all of ``h``; with ``dying`` (the last
    worker is set to die) a block may meet a stream already failed."""
    r = svc.open("queue", None, kind="stream", deadline_s=deadline_s)
    assert r["op"] == "opened", r
    for seq, (blk, n) in enumerate(h.blocks(block_rows)):
        rep = svc.feed(r["stream"], seq, "rows", blk, n)
        want = ("accepted", "quarantined") if dying else ("accepted",)
        assert rep["op"] in want, rep
    return r["stream"]


# ---------------------------------------------------------------------------
# the ingestion core
# ---------------------------------------------------------------------------


def test_stream_verdict_equals_the_jax_service_and_the_monolithic_check():
    h = History(lost=1, duplicated=1)

    def scenario(svc):
        return svc.finish(feed_stream(svc, h), timeout=30)

    port, jax = both(scenario)
    assert _wire_safe(port) == _wire_safe(jax)  # provenance included
    assert families(port) == oracle(h)
    assert port["provenance"]["ops"] >= h.n_ops
    assert "degraded" not in port


def test_submit_collect_verdicts_equal():
    corpus = [History(n_ops=120, seed=s, lost=s % 2) for s in range(5)]

    def scenario(svc):
        ids = []
        for h in corpus:
            rep = svc.submit("queue", None, "rows", h.rows, h.n_ops)
            assert rep["op"] == "accepted"
            ids.append(rep["id"])
        got = svc.collect(ids, timeout=30)
        assert not got["pending"]
        return [got["done"][i] for i in ids]

    port, jax = both(scenario)
    assert _wire_safe(port) == _wire_safe(jax)
    for v, h in zip(port, corpus):
        assert families(v) == oracle(h)


def test_a_sequence_gap_quarantines_never_a_gapped_carry():
    h = History()

    def scenario(svc):
        sid = svc.open("queue", None, kind="stream")["stream"]
        blocks = h.blocks()
        svc.feed(sid, 0, "rows", *blocks[0])
        rep = svc.feed(sid, 2, "rows", *blocks[2])  # a hole at seq 1
        return rep, svc.finish(sid, timeout=30)

    (rep, v), (jrep, jv) = both(scenario)
    assert rep == jrep
    assert (rep["op"], rep["expected"], rep["got"]) == ("quarantined", 1, 2)
    assert _wire_safe(v) == _wire_safe(jv)
    assert v["valid?"] == "unknown"
    assert "gap in block sequence" in json.dumps(v)


def test_a_duplicate_seq_is_an_idempotent_ack():
    h = History()

    def scenario(svc):
        sid = feed_stream(svc, h)
        rep = svc.feed(sid, 0, "rows", *h.blocks()[0])
        return rep, svc.finish(sid, timeout=30)

    (rep, v), (jrep, jv) = both(scenario)
    assert rep == jrep == {"op": "accepted", "stream": "s0", "seq": 0,
                           "dup": True}
    assert _wire_safe(v) == _wire_safe(jv)
    assert families(v) == oracle(h)


def test_abort_frees_the_admission_slot():
    def scenario(svc):
        sid = svc.open("queue", None, kind="stream")["stream"]
        rej = svc.open("queue", None, kind="stream")
        aborted = svc.abort(sid)
        again = svc.open("queue", None, kind="stream")
        return rej, aborted, again

    port, jax = both(scenario, max_streams=1)
    assert port == jax
    rej, aborted, again = port
    assert (rej["op"], rej["reason"]) == ("rejected", SATURATED)
    assert aborted["op"] == "aborted" and again["op"] == "opened"


@pytest.mark.parametrize("workload,item", [("nonesuch", None),
                                           ("stream", "item 6"),
                                           ("elle", "item 7"),
                                           ("mutex", "item 8")])
def test_a_workload_not_ported_is_a_loud_refusal(workload, item):
    """An unknown workload is refused as the JAX service refuses it; a
    family the port does not have yet is refused the same way, naming
    its ROADMAP.md item, and no worker dies of it."""
    svc = port_svc()
    try:
        r = svc.open(workload, None)
        h = History(n_ops=80)
        v = svc.finish(feed_stream(svc, h), timeout=30)
        stats = svc.stats()
    finally:
        svc.close()
    assert (r["op"], r["reason"]) == ("error", "bad-workload")
    if item:
        assert "not ported yet" in r["error"] and item in r["error"]
    assert stats["workers_alive"] == 2 and stats["worker_deaths"] == 0
    assert families(v) == oracle(h)
    if item is None:
        jax = jax_svc()
        try:
            assert jax.open(workload, None)["reason"] == r["reason"]
        finally:
            jax.close()


def test_the_default_device_is_the_card():
    """Like every entry point of the port, the service runs on the card
    unless the CPU is asked for: without one it raises, never falls
    back."""
    import torch

    from jepsen_tpu_torch.device import NoDeviceError

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(NoDeviceError):
        IngestService(registry=Registry())
    with pytest.raises(NoDeviceError):
        CheckerServer(host="127.0.0.1", port=0, metrics_registry=Registry())


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------


def test_the_stream_cap_rejects_saturated():
    def scenario(svc):
        opened = [svc.open("queue", None)["op"] for _ in range(2)]
        return opened, svc.open("queue", None)

    port, jax = both(scenario, max_streams=2)
    assert port == jax
    opened, rej = port
    assert opened == ["opened", "opened"]
    assert (rej["reason"], rej["saturated"]) == (SATURATED, "streams")


def test_the_ingress_cap_rejects_a_block_without_consuming_it():
    h = History(n_ops=120)
    blocks = h.blocks(64)

    def scenario(svc):
        sid = svc.open("queue", None, kind="stream")["stream"]
        rejects = 0
        for seq, (blk, n) in enumerate(blocks):
            for _ in range(2000):  # bounded: re-offer the same seq
                rep = svc.feed(sid, seq, "rows", blk, n)
                if rep["op"] == "accepted":
                    break
                assert (rep["op"], rep["reason"]) == ("rejected", SATURATED)
                rejects += 1
                time.sleep(0.02)
            else:
                raise AssertionError("the ingress queue never drained")
        return rejects, svc.finish(sid, timeout=60)

    (rejects, v), (jrejects, jv) = both(
        scenario, workers=1, ingress_cap=2, block_delay_s=0.2)
    assert rejects > 0 and jrejects > 0
    assert families(v) == families(jv) == oracle(h)
    assert v["provenance"]["blocks"] == jv["provenance"]["blocks"] == len(
        blocks)


def test_saturation_accounting_balances():
    corpus = [History(n_ops=60, seed=s) for s in range(24)]

    def scenario(svc):
        ids, rejects = [], 0
        for h in corpus:
            rep = svc.submit("queue", None, "rows", h.rows, h.n_ops)
            if rep["op"] == "accepted":
                ids.append(rep["id"])
            else:
                assert rep["op"] == "rejected"
                rejects += 1
        got = svc.collect(ids, timeout=60)
        assert not got["pending"]
        return len(got["done"]), rejects

    for done, rejects in both(scenario, workers=1, ingress_cap=2,
                              block_delay_s=0.05):
        assert done + rejects == len(corpus) and rejects > 0


# ---------------------------------------------------------------------------
# worker death (the JEPSEN_TPU_SERVE_DIE_AFTER hook)
# ---------------------------------------------------------------------------


def test_a_kill_mid_stream_recovers_to_the_oracle():
    corpus = [History(n_ops=300, seed=s, duplicated=s % 2) for s in range(4)]

    def scenario(svc):
        sids = [feed_stream(svc, h, block_rows=64) for h in corpus]
        return [svc.finish(s, timeout=60) for s in sids], svc.stats()

    for verdicts, stats in both(scenario, die_after=(0, 3)):
        assert stats["worker_deaths"] == 1
        degraded = [v for v in verdicts if "degraded" in v]
        assert len(degraded) >= 1
        assert degraded[0]["degraded"]["dead_workers"] == ["svcworker0"]
        assert degraded[0]["degraded"]["requeued_blocks"]
        for v, h in zip(verdicts, corpus):
            assert families(v) == oracle(h)


def test_the_die_after_hook_is_read_from_the_environment(monkeypatch):
    from jepsen_tpu_torch.service.stream import DIE_AFTER_ENV, _parse_die_after

    assert DIE_AFTER_ENV == "JEPSEN_TPU_SERVE_DIE_AFTER"
    assert _parse_die_after("1:4") == (1, 4)
    assert _parse_die_after("bad") is None and _parse_die_after("") is None
    monkeypatch.setenv(DIE_AFTER_ENV, "0:2")
    svc = port_svc()
    try:
        assert svc._die_after == (0, 2)
    finally:
        svc.close()


def test_all_workers_dead_fails_loud_not_silent():
    h = History(n_ops=200)

    def scenario(svc):
        v = svc.finish(feed_stream(svc, h, block_rows=64, dying=True),
                       timeout=30)
        return v, svc.open("queue", None)

    (v, rej), (jv, jrej) = both(scenario, workers=1, die_after=(0, 1))
    for verdict, reject in ((v, rej), (jv, jrej)):
        assert verdict["valid?"] == "unknown"
        assert "quarantined" in json.dumps(verdict)
        assert (reject["op"], reject["saturated"]) == (
            "rejected", "no-live-workers")


def test_a_zero_kill_run_claims_no_recovery():
    h = History(n_ops=200)

    def scenario(svc):
        v = svc.finish(feed_stream(svc, h), timeout=30)
        return v, svc.stats()

    for v, stats in both(scenario):
        assert stats["worker_deaths"] == stats["block_requeues"] == 0
        assert "degraded" not in v


# ---------------------------------------------------------------------------
# the verdict cache
# ---------------------------------------------------------------------------


def test_a_content_addressed_hit_round_trip():
    h = History(n_ops=200, lost=1)
    key = hashlib.sha256(np.ascontiguousarray(h.rows).tobytes()).hexdigest()

    def scenario(svc):
        rep = svc.submit("queue", None, "rows", h.rows, h.n_ops)
        cold = svc.collect([rep["id"]], timeout=30)["done"][rep["id"]]
        return cold, svc.open("queue", None, content_key=key), svc.stats()

    (cold, hit, stats), (jcold, jhit, jstats) = both(
        scenario, cache=VerdictCache(8, registry=Registry()))
    assert hit["op"] == jhit["op"] == "cached"
    assert _wire_safe(hit["verdict"]) == _wire_safe(jhit["verdict"])
    assert _wire_safe(cold) == _wire_safe(jcold)
    assert cold["provenance"]["content_sha256"] == key
    assert stats["cache"] == jstats["cache"]


def test_degraded_verdicts_are_never_cached():
    h = History(n_ops=200)
    key = hashlib.sha256(np.ascontiguousarray(h.rows).tobytes()).hexdigest()

    def scenario(svc):
        v = svc.finish(feed_stream(svc, h, block_rows=64, dying=True),
                       timeout=30)
        miss = svc.open("queue", None, content_key=key)
        if miss["op"] == "opened":
            svc.abort(miss["stream"])
        return v, miss

    for v, miss in both(scenario, cache=VerdictCache(8, registry=Registry()),
                        workers=1, die_after=(0, 2)):
        assert "degraded" in v or v["valid?"] == "unknown"
        assert miss["op"] != "cached"


def test_the_cache_key_is_the_jax_packages():
    for opts in ({}, {"delivery": "at-least-once"}):
        for workload in ("queue", "stream"):
            assert cache_key("c" * 64, workload, opts) == jax_cache_key(
                "c" * 64, workload, opts)
    keys = {cache_key("c" * 64, "queue", {}),
            cache_key("c" * 64, "queue", {"delivery": "at-least-once"}),
            cache_key("c" * 64, "stream", {})}
    assert len(keys) == 3
    assert contract_key("queue", {"a": 1}) == contract_key("queue", {"a": 1})


def test_cache_seed_from_a_store(tmp_path):
    """A recorded run with a fresh ``.jtc`` and a ``results.json`` seeds
    one entry in both packages, under the same key, naming the run."""
    from jepsen_tpu.history.columnar import pack_jtc
    from jepsen_tpu.history.store import write_history_jsonl

    run = tmp_path / "runs" / "r1"
    run.mkdir(parents=True)
    sh = synth_history(SynthSpec(n_ops=80, seed=2))
    write_history_jsonl(run / "history.jsonl", sh.ops)
    (run / "results.json").write_text(json.dumps({"valid?": True}))
    pack_jtc(run / "history.jsonl")
    (tmp_path / "runs" / "bare").mkdir()
    (tmp_path / "runs" / "bare" / "results.json").write_text("{}")
    port = VerdictCache(8, registry=Registry())
    jax = JaxCache(8, registry=JaxRegistry())
    assert port.seed_from_store(tmp_path) == jax.seed_from_store(tmp_path) == 1
    assert port._entries == jax._entries
    (entry,) = port._entries.values()
    assert entry["report_ref"] == "runs/r1"


def test_a_report_ref_survives_a_re_put():
    cache = VerdictCache(capacity=8, registry=Registry())
    cache.put("k1", {"valid?": True}, report_ref="runs/r0001")
    cache.put("k1", {"valid?": True})
    assert cache.get("k1")["report_ref"] == "runs/r0001"
    cache.put("k1", {"valid?": True}, report_ref="runs/r0002")
    assert cache.get("k1")["report_ref"] == "runs/r0002"
    cache.put("k2", {"valid?": True})
    assert "report_ref" not in cache.get("k2")


# ---------------------------------------------------------------------------
# over the wire
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def server():
    srv = CheckerServer(host="127.0.0.1", port=0, device="cpu",
                        metrics_registry=Registry())
    srv.start_background()
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture()
def client(server):
    with CheckerClient(port=server.port, timeout=60) as c:
        yield c


def test_a_wire_stream_equals_the_oracle_with_value_sets(client):
    h = History(n_ops=300, lost=1)
    sid = client.stream_open("queue")["stream"]
    for seq, (blk, n) in enumerate(h.blocks()):
        assert client.stream_feed_rows(sid, seq, blk, n)["op"] == "accepted"
    v = client.stream_finish(sid, timeout=30)
    eng = SegmentedChecker("queue", device="cpu")
    eng.feed_rows(h.rows, h.n_ops)
    want = eng.finish()
    assert {k: v[k] for k in FAMILIES} == {k: want[k] for k in FAMILIES}
    assert isinstance(v["queue"]["lost"], set)


def test_submit_batch_and_collect(client):
    corpus = [History(n_ops=100, seed=s) for s in range(3)]
    rep = client.submit_batch_rows("queue", [h.rows for h in corpus],
                                   [h.n_ops for h in corpus])
    assert rep["op"] == "submitted"
    ids = [r["id"] for r in rep["replies"]]
    got = client.collect(ids, timeout=30)
    assert not got["pending"]
    for i, h in zip(ids, corpus):
        assert families(got["done"][i]) == oracle(h)


def test_a_torn_block_quarantines_its_stream_and_the_connection_survives(
        client):
    h = History(n_ops=200)
    blocks = h.blocks()
    sid = client.stream_open("queue")["stream"]
    client.stream_feed_rows(sid, 0, *blocks[0])
    blk = np.ascontiguousarray(blocks[1][0], np.int32)
    raw = blk.tobytes()
    hdr = {"op": "stream-feed", "stream": sid, "seq": 1,
           "n_ops": blocks[1][1],
           "arrays": [{"name": "rows", "dtype": str(blk.dtype),
                       "shape": list(blk.shape),
                       "crc32": zlib.crc32(raw) ^ 0xDEADBEEF}]}
    hb = json.dumps(hdr).encode()
    client.sock.sendall(struct.pack(">4sI", MAGIC, len(hb)) + hb + raw)
    reply, _ = recv_frame(client.sock)
    assert reply["op"] == "quarantined" and "torn" in reply["error"]
    v = client.stream_finish(sid, timeout=30)
    assert v["valid?"] == "unknown"
    assert "torn" in json.dumps(v, default=sorted)
    assert client.ping()["op"] == "pong"
    h2 = History(n_ops=100, seed=9)
    sid2 = client.stream_open("queue")["stream"]
    client.stream_feed_rows(sid2, 0, h2.rows, h2.n_ops)
    assert families(client.stream_finish(sid2, timeout=30)) == oracle(h2)


def test_service_stats_over_the_wire(client):
    stats = client.service_stats()
    assert stats["op"] == "stats"
    assert "workers_alive" in stats and "admission_rejects" in stats


def test_subscribed_windows_end_in_the_verdict(server, client):
    h = History(n_ops=200, duplicated=1)
    sid = client.stream_open("queue")["stream"]
    blocks = h.blocks(64)
    for seq, (blk, n) in enumerate(blocks):
        client.stream_feed_rows(sid, seq, blk, n)
    v = client.stream_finish(sid, timeout=30)
    windows = list(client.subscribe_windows(sid, timeout=30))
    assert [w["window"] for w in windows] == list(range(len(blocks) + 1))
    assert windows[-1]["final"] is True
    assert {k: windows[-1]["verdict"][k] for k in FAMILIES} == {
        k: v[k] for k in FAMILIES}


def test_a_torn_subscription_resumes_exactly_once(monkeypatch):
    from jepsen_tpu_torch.service.server import SUB_DROP_ENV

    monkeypatch.setenv(SUB_DROP_ENV, "2")
    srv = CheckerServer(host="127.0.0.1", port=0, device="cpu",
                        metrics_registry=Registry())
    srv.start_background()
    try:
        h = History(n_ops=200)
        with CheckerClient(port=srv.port, timeout=30,
                           retry=RetryPolicy(attempts=4, base_s=0.01,
                                             seed=1)) as c:
            sid = c.stream_open("queue")["stream"]
            for seq, (blk, n) in enumerate(h.blocks(64)):
                c.stream_feed_rows(sid, seq, blk, n)
            c.stream_finish(sid, timeout=30)
            windows = [w["window"] for w in c.subscribe_windows(sid)]
        assert windows == list(range(len(h.blocks(64)) + 1))
    finally:
        srv.shutdown()
        srv.server_close()


def test_the_streamed_digest_equals_the_jtc_content_key(tmp_path, client):
    """One address at three sites: the ``.jtc`` content key of either
    package and the digest the service computes over the streamed
    blocks (``check_jtc`` opens with the file's key, and a repeat hits
    the cache)."""
    from jepsen_tpu.history.columnar import read_jtc as jax_read_jtc
    from jepsen_tpu.history.store import write_history_jsonl
    from jepsen_tpu_torch.history.columnar import read_jtc, write_jtc

    sh = synth_history(SynthSpec(n_ops=150, seed=4))
    src = tmp_path / "h.jsonl"
    write_history_jsonl(src, sh.ops)
    path = write_jtc(src, "queue", rows=_rows_for(
        [Op.from_json(op.to_json()) for op in sh.ops]))
    key = read_jtc(path)[0].content_key()
    assert key == jax_read_jtc(path)[0].content_key()
    first = client.check_jtc(path, block_rows=64, timeout=30)
    assert first["provenance"]["content_sha256"] == key
    again = client.check_jtc(path, block_rows=64, timeout=30)
    assert again["op"] == "cached"
    assert families(again["verdict"]) == families(first)


# ---------------------------------------------------------------------------
# client retry
# ---------------------------------------------------------------------------


def test_retry_delays_are_bounded_growing_and_the_jax_clients():
    rp = RetryPolicy(attempts=5, base_s=0.1, cap_s=1.0, jitter=0.5, seed=7)
    jrp = JaxRetry(attempts=5, base_s=0.1, cap_s=1.0, jitter=0.5, seed=7)
    rng, jrng = random.Random(7), random.Random(7)
    delays = [rp.delay_s(k, rng) for k in range(6)]
    assert delays == [jrp.delay_s(k, jrng) for k in range(6)]
    assert all(d <= 1.0 for d in delays)
    assert delays[0] <= 0.1 and max(delays[3:]) >= 0.4


def test_a_spent_budget_is_machine_readable(server):
    svc = server.ingest_service()
    held = []
    for _ in range(10_000):
        r = svc.open("queue", None, kind="stream")
        if r["op"] != "opened":
            break
        held.append(r["stream"])
    try:
        with CheckerClient(port=server.port, timeout=30, retry=RetryPolicy(
                attempts=3, base_s=0.01, cap_s=0.02, seed=1)) as c:
            with pytest.raises(ServiceUnavailable) as ei:
                c.stream_open("queue")
        reason = ei.value.reason
        assert (reason["reason"], reason["attempts"]) == (SATURATED, 3)
        assert reason["last"]["saturated"] == "streams"
    finally:
        for sid in held:
            svc.abort(sid)
