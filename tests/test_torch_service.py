"""The port's checker service ≡ the JAX package's over the wire: the
framing in both directions (a frame either package writes decodes in the
other, torn and CRC'd frames included), the ``check`` op of
``tests/test_service.py::TestSidecar`` on the port's server, clients and
servers of the two packages crossed both ways with equal replies, the
wire's dtypes narrowed to K1's contract (a value that does not fit is a
protocol error, never a wrap), the refused ``check-stream`` and
``check-elle`` ops, and the ``/metrics`` endpoint."""

import json
import socket
import struct
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest

from jepsen_tpu.checkers.queue_lin import check_queue_lin_cpu
from jepsen_tpu.checkers.total_queue import check_total_queue_cpu
from jepsen_tpu.history.synth import SynthSpec, synth_batch, synth_history
from jepsen_tpu.service import CheckerClient as JaxClient
from jepsen_tpu.service import CheckerServer as JaxServer
from jepsen_tpu.service import protocol as jax_protocol
from jepsen_tpu_torch.checkers.fused import check_queue_batch
from jepsen_tpu_torch.history.ops import Op
from jepsen_tpu_torch.obs.metrics import Registry
from jepsen_tpu_torch.service import CheckerClient, CheckerServer
from jepsen_tpu_torch.service import protocol
from jepsen_tpu_torch.service.cache import VerdictCache

SPECS = [
    SynthSpec(n_ops=150, seed=3),
    SynthSpec(n_ops=150, lost=2, seed=4),
    SynthSpec(n_ops=150, duplicated=2, seed=5),
    SynthSpec(n_ops=150, unexpected=1, seed=6),
]


def port_ops(ops):
    return [Op.from_json(op.to_json()) for op in ops]


@pytest.fixture(scope="module")
def server():
    srv = CheckerServer(host="127.0.0.1", port=0, device="cpu",
                        metrics_registry=Registry())
    srv.start_background()
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def jax_server():
    srv = JaxServer(host="127.0.0.1", port=0)
    srv.start_background()
    yield srv
    srv.shutdown()
    srv.server_close()


@pytest.fixture()
def client(server):
    with CheckerClient(port=server.port, timeout=60) as c:
        yield c


FRAMES = [
    ({"op": "check", "k": 1}, {
        "x": np.arange(12, dtype=np.int32).reshape(3, 4),
        "m": np.array([[True, False]]),
        "v": np.array([-1, 7, 300], dtype=np.int16),
        "f": np.array([[0, 2, -1]], dtype=np.int8),
    }),
    ({"op": "ping"}, {}),
]


@pytest.mark.parametrize("crc", [False, True])
@pytest.mark.parametrize("writer,reader", [(protocol, jax_protocol),
                                           (jax_protocol, protocol)],
                         ids=["port-to-jax", "jax-to-port"])
def test_a_frame_either_package_writes_decodes_in_the_other(writer, reader,
                                                            crc):
    for header, arrays in FRAMES:
        a, b = socket.socketpair()
        try:
            writer.send_frame(a, header, arrays, crc=crc)
            got_h, got = reader.recv_frame(b)
        finally:
            a.close()
            b.close()
        assert {k: v for k, v in got_h.items() if k != "arrays"} == header
        assert sorted(got) == sorted(arrays)
        for k, arr in arrays.items():
            want = arr.astype(np.uint8) if arr.dtype == bool else arr
            assert got[k].dtype == want.dtype.newbyteorder("<")
            np.testing.assert_array_equal(got[k], want)
    assert protocol.MAGIC == jax_protocol.MAGIC == b"JTQ1"
    assert protocol.MAX_PAYLOAD == jax_protocol.MAX_PAYLOAD


def _torn_bytes(sid="s9", seq=4):
    arr = np.arange(8, dtype=np.int32)
    raw = arr.tobytes()
    hdr = {
        "op": "stream-feed", "stream": sid, "seq": seq,
        "arrays": [{"name": "rows", "dtype": "int32", "shape": [8],
                    "crc32": zlib.crc32(raw) ^ 1}],
    }
    hb = json.dumps(hdr).encode()
    return struct.pack(">4sI", b"JTQ1", len(hb)) + hb + raw


@pytest.mark.parametrize("writer", [protocol, jax_protocol],
                         ids=["port-writes", "jax-writes"])
def test_a_torn_frame_is_consumed_and_names_its_arrays(writer):
    a, b = socket.socketpair()
    try:
        a.sendall(_torn_bytes())
        writer.send_frame(a, {"op": "ping"})  # the next frame, same socket
        with pytest.raises(protocol.TornPayloadError) as ei:
            protocol.recv_frame(b)
        assert ei.value.header["stream"] == "s9"
        assert ei.value.torn == ["rows"]
        header, _ = protocol.recv_frame(b)  # still in frame sync
        assert header["op"] == "ping"
    finally:
        a.close()
        b.close()


def test_bad_magic_and_oversized_header_are_refused():
    for raw in (b"XXXX" + b"\x00" * 4,
                struct.pack(">4sI", b"JTQ1", protocol.MAX_PAYLOAD + 1)):
        a, b = socket.socketpair()
        try:
            a.sendall(raw)
            with pytest.raises(protocol.ProtocolError):
                protocol.recv_frame(b)
        finally:
            a.close()
            b.close()


def test_crc_opt_in_round_trip():
    a, b = socket.socketpair()
    try:
        arr = np.arange(6, dtype=np.int32).reshape(2, 3)
        protocol.send_frame(a, {"op": "stream-feed"}, {"rows": arr}, crc=True)
        header, arrays = protocol.recv_frame(b)
        assert header["arrays"][0]["crc32"] == zlib.crc32(arr.tobytes())
        np.testing.assert_array_equal(arrays["rows"], arr)
    finally:
        a.close()
        b.close()


def test_ping(client):
    pong = client.ping()
    assert (pong["op"], pong["backend"], pong["device_count"]) == (
        "pong", "cpu", 1)


def test_clean_histories_valid(client):
    shs = synth_batch(4, SynthSpec(n_ops=120))
    results = client.check_histories([port_ops(s.ops) for s in shs])
    assert len(results) == 4 and all(r["valid?"] for r in results)


def test_verdicts_equal_the_cpu_oracles_and_the_jax_server(client,
                                                           jax_server):
    histories = [synth_history(s).ops for s in SPECS]
    remote = client.check_histories([port_ops(h) for h in histories])
    with JaxClient(port=jax_server.port) as jc:
        want = jc.check_histories(histories)
    assert remote == want
    in_process = check_queue_batch([port_ops(h) for h in histories],
                                   device="cpu")
    for h, r, p in zip(histories, remote, in_process):
        assert r["queue"] == check_total_queue_cpu(h) == p["queue"]
        lin = check_queue_lin_cpu(h)
        lin.pop("delivery")
        p["linear"].pop("delivery")
        assert r["linear"] == lin == p["linear"]
        assert r["valid?"] == (r["queue"]["valid?"] and
                               r["linear"]["valid?"])


def test_concurrent_clients(server):
    histories = [port_ops(s.ops) for s in synth_batch(2, SynthSpec(n_ops=60))]
    errors, done = [], []

    def worker():
        try:
            with CheckerClient(port=server.port, timeout=60) as c:
                done.append(len(c.check_histories(histories)))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors and done == [2] * 4
    assert not any(t.is_alive() for t in threads)


def test_unknown_op_is_an_error_not_a_disconnect(client):
    with pytest.raises(RuntimeError, match="unknown op"):
        client._call({"op": "nonsense"})
    assert client.ping()["op"] == "pong"


@pytest.mark.parametrize("op,item", [("check-stream", "item 6"),
                                     ("check-elle", "item 7")])
def test_unported_ops_are_refused_and_the_connection_stays(client, op,
                                                           item):
    with pytest.raises(RuntimeError, match=f"not ported yet.*{item}"):
        client._call({"op": op, "space": 4, "histories": [[]]})
    assert client.ping()["op"] == "pong"


def _arrays(f=0, typ=0, value=0, mask=1, dtype=np.int32, shape=(1, 8)):
    return {"f": np.full(shape, f, dtype), "type": np.full(shape, typ, dtype),
            "value": np.full(shape, value, dtype),
            "mask": np.full(shape, mask, bool)}


@pytest.mark.parametrize("header,arrays,match", [
    ({"value_space": 0}, _arrays(), "value_space"),
    ({"value_space": 128}, {**_arrays(), "mask": None}, "missing arrays"),
    ({"value_space": 128}, _arrays(f=200), "'f' holds"),
    ({"value_space": 128}, _arrays(typ=-129), "'type' holds"),
    ({"value_space": 128}, _arrays(value=40_000), "'value' holds"),
    ({"value_space": 1 << 20}, _arrays(value=1 << 33, dtype=np.int64),
     "'value' holds"),
    ({"value_space": 128}, {**_arrays(), "f": np.zeros((2, 8), np.int32)},
     "one \\[B, L\\] shape"),
    ({"value_space": 128}, {**_arrays(), "f": np.zeros((1, 8), np.float32)},
     "must be integer"),
], ids=["value-space", "missing", "f-range", "type-range", "value-int16",
        "value-int32", "shape", "float"])
def test_a_wire_batch_outside_k1s_contract_is_a_protocol_error(
        client, jax_server, header, arrays, match):
    arrays = {k: v for k, v in arrays.items() if v is not None}
    with pytest.raises(RuntimeError, match=match):
        client._call({"op": "check", **header}, arrays)
    assert client.ping()["op"] == "pong"


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.uint8])
def test_any_integer_wire_dtype_gives_the_same_reply(client, jax_server,
                                                     dtype):
    """The JAX client sends its packer's dtypes, the port's int8/int16;
    the server narrows whatever arrives, so equal values give equal
    replies, as the JAX server's."""
    from jepsen_tpu.history.encode import pack_histories

    packed = pack_histories([synth_history(s).ops for s in SPECS])
    arrays = {k: np.asarray(getattr(packed, k)) for k in
              ("f", "type", "value", "mask")}
    if dtype == np.uint8:  # f/type codes are -1..3: only the mask fits
        arrays["mask"] = arrays["mask"].astype(np.uint8)
    else:
        arrays = {k: (v.astype(dtype) if k != "value" or np.iinfo(
            dtype).max >= packed.value_space else v)
            for k, v in arrays.items()}
    header = {"op": "check", "value_space": packed.value_space}
    got, _ = client._call(header, arrays)
    with JaxClient(port=jax_server.port) as jc:
        want, _ = jc._call(header, arrays)
    assert got["results"] == want["results"]
    assert len(got["results"]) == len(SPECS)


def test_jax_client_to_port_server_and_back(server, jax_server):
    """Crossed clients and servers: the JAX client against the port's
    server and the port's client against the JAX server give the same
    replies as each client against its own package's server, for the
    check op and a stream."""
    from jepsen_tpu.history.columnar import iter_row_blocks
    from jepsen_tpu.history.rows import _rows_for

    histories = [synth_history(s).ops for s in SPECS]
    rows = _rows_for(synth_history(SynthSpec(n_ops=300, seed=8,
                                             lost=1)).ops)

    def run(client, ops_of):
        checked = client.check_histories([ops_of(h) for h in histories])
        sid = client.stream_open("queue")["stream"]
        for seq, (blk, n) in enumerate(iter_row_blocks(rows, 100)):
            assert client.stream_feed_rows(sid, seq, blk, n)["op"] == (
                "accepted")
        v = client.stream_finish(sid, timeout=60)
        v.pop("provenance")
        return checked, v

    with JaxClient(port=server.port) as jc_port, \
            CheckerClient(port=jax_server.port, timeout=60) as pc_jax, \
            JaxClient(port=jax_server.port) as jc_jax, \
            CheckerClient(port=server.port, timeout=60) as pc_port:
        a = run(jc_port, lambda h: h)
        b = run(pc_jax, port_ops)
        c = run(jc_jax, lambda h: h)
        d = run(pc_port, port_ops)
    assert a == b == c == d
    assert a[1]["valid?"] is False and a[1]["queue"]["lost-count"] == 1


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), e.headers


def test_metrics_and_report_routes(tmp_path):
    from jepsen_tpu_torch.obs.metrics import REPORT_NOT_PORTED, serve_metrics

    reg = Registry()
    reg.counter("service.requests", op="check").inc(3)
    cache = VerdictCache(4, registry=reg)
    cache.put("k-run", {"valid?": True}, report_ref="runs/r1")
    cache.put("k-wire", {"valid?": True})

    class _NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **kw):
            return None

    urllib.request.install_opener(urllib.request.build_opener(_NoRedirect))
    try:
        for wired, store in ((cache, str(tmp_path)), (None, None)):
            srv = serve_metrics("127.0.0.1", 0, reg, store=store,
                                cache=lambda c=wired: c)
            srv.start_background()
            base = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                status, body, _ = _get(base + "/metrics")
                assert status == 200
                assert 'jepsen_tpu_service_requests{op="check"} 3' in body
                status, _, hdrs = _get(base + "/report/by-key/k-run")
                if wired is None:
                    assert status == 503
                    assert _get(base + "/report/r1")[0] == 404
                    continue
                assert (status, hdrs["Location"]) == (302, "/report/runs/r1/")
                assert _get(base + "/report/by-key/k-wire")[0] == 404
                assert _get(base + "/report/by-key/nope")[0] == 404
                status, body, _ = _get(base + "/report/runs/r1/")
                assert status == 501 and "items 5 and 10" in body
                assert "items 5 and 10" in REPORT_NOT_PORTED
                assert _get(base + "/other")[0] == 404
            finally:
                srv.shutdown()
                srv.server_close()
    finally:
        urllib.request.install_opener(urllib.request.build_opener())
    # peeks never counted as hits or misses
    assert cache.stats()["hits"] == cache.stats()["misses"] == 0
