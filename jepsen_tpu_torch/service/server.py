"""The checker service's server.

The port's counterpart of the JAX package's ``service/server.py``: a
long-lived process that owns the card and answers check requests and
streamed histories from many clients at once, over the framing of
``service/protocol.py`` (byte-compatible: a client of either package
talks to a server of either, with the same replies).

Ops:

- ``ping``: ``{"op": "pong", "backend": "cuda" | "cpu", "device_count"}``;
- ``check``: arrays ``f``/``type``/``value``/``mask`` of shape ``[B, L]``
  in any integer dtype, and ``value_space``: per-history total-queue and
  queue-linearizability verdicts, from one K1 launch and both
  classifiers (:func:`_check_arrays`);
- the streaming surface of ``service/stream.py``: ``stream-open``,
  ``stream-feed``, ``stream-finish``, ``stream-abort``, ``submit-batch``,
  ``collect``, ``cache-get``, ``service-stats`` and ``stream-subscribe``.

``check-stream`` and ``check-elle`` answer an ``error`` naming their
ROADMAP.md items and the connection stays open.  The device mesh of the
JAX server waits for ROADMAP.md item 9.  A fault of the card or of K1
(:data:`~jepsen_tpu_torch.device.DEVICE_FAULTS`) answers the request
that met it with an ``error``, fails every open stream, and stops the
server; :func:`serve_forever` then raises it (``serve-checker`` exits
2).
"""

from __future__ import annotations

import logging
import os
import socketserver
import threading
import time
from typing import Any

import numpy as np
import torch

from jepsen_tpu_torch.device import DEVICE_FAULTS, resolve_device
from jepsen_tpu_torch.service.protocol import (
    ProtocolError,
    TornPayloadError,
    no_delay,
    recv_frame,
    send_frame,
)

logger = logging.getLogger(__name__)

REQUIRED_ARRAYS = ("f", "type", "value", "mask")

#: the streaming ingestion surface (``service/stream.py``)
_STREAM_OPS = frozenset({
    "stream-open", "stream-feed", "stream-finish", "stream-abort",
    "submit-batch", "collect", "cache-get", "service-stats",
})

#: where the batch ops of the other families stand in ROADMAP.md
NOT_PORTED_OPS = {
    "check-stream": "Open items §1, item 6 (stream family)",
    "check-elle": "Open items §1, item 7 (elle family)",
}

#: chaos hook: ``"<n>"`` tears the first subscription on this server
#: (socket closed abruptly) after pushing n verdict-window frames; it is
#: used once, so the client's reconnect lands on a healthy push loop
SUB_DROP_ENV = "JEPSEN_TPU_SERVE_SUB_DROP_AFTER"

#: how long a push loop waits for the next window before it answers
#: with a machine-readable timeout frame (never a silent hang)
SUBSCRIBE_IDLE_TIMEOUT_S = 120.0

_INT8 = np.iinfo(np.int8)
_INT16 = np.iinfo(np.int16)
_INT32 = np.iinfo(np.int32)


def _narrowed(name: str, a: np.ndarray, info) -> np.ndarray:
    """``a`` (any integer dtype) in the dtype of ``info``; a value that
    does not fit is a :class:`ProtocolError`, never a wrap."""
    if a.dtype.kind not in "iub":
        raise ProtocolError(f"array {name!r} must be integer, got {a.dtype}")
    if a.size and (int(a.min()) < info.min or int(a.max()) > info.max):
        raise ProtocolError(
            f"array {name!r} holds {int(a.min())}..{int(a.max())}, outside "
            f"{info.dtype}")
    return a.astype(info.dtype, copy=False)


def wire_batch(arrays: dict[str, np.ndarray], value_space: int):
    """The four wire columns as a packed batch on the host in K1's
    contract: int8 ``f``/``type``, int16 ``value`` where ``value_space``
    is at most 32,767 and int32 above, bool ``mask`` (nonzero is set).
    The JAX client sends its packer's dtypes, the port's sends these;
    either is narrowed here, before anything reaches the card."""
    from jepsen_tpu_torch.checkers.segmented import _k1_input

    missing = [k for k in REQUIRED_ARRAYS if k not in arrays]
    if missing:
        raise ProtocolError(f"missing arrays: {missing}")
    shapes = {k: tuple(arrays[k].shape) for k in REQUIRED_ARRAYS}
    if len(set(shapes.values())) != 1 or len(shapes["f"]) != 2:
        raise ProtocolError(f"arrays must share one [B, L] shape: {shapes}")
    f = _narrowed("f", arrays["f"], _INT8)
    typ = _narrowed("type", arrays["type"], _INT8)
    value = _narrowed("value", arrays["value"],
                      _INT16 if value_space <= _INT16.max else _INT32)
    if arrays["mask"].dtype.kind not in "iub":
        raise ProtocolError(f"array 'mask' must be integer or bool, got "
                            f"{arrays['mask'].dtype}")
    mask = arrays["mask"] != 0
    # frames are read-only buffers: copy only what is not writable
    return _k1_input(*(torch.from_numpy(np.require(c, requirements="CW"))
                       for c in (f, typ, value, mask)), value_space)


def _check_arrays(
    arrays: dict[str, np.ndarray], value_space: int, device
) -> dict[str, Any]:
    """The ``check`` op: the wire batch through
    :func:`~jepsen_tpu_torch.checkers.fused.combined_tensor_check` on
    ``device`` (one K1 launch and both classifiers, exactly-once), in the
    reply shape of the JAX server."""
    import dataclasses

    from jepsen_tpu_torch.checkers.fused import (
        combined_tensor_check,
        queue_results,
    )

    packed = wire_batch(arrays, value_space)
    if packed.batch == 0:
        return {"op": "result", "results": []}
    packed = dataclasses.replace(packed, **{
        k: getattr(packed, k).to(device) for k in ("f", "type", "value",
                                                   "mask")})
    out = []
    for r in queue_results(*combined_tensor_check(packed, packed_out=True)):
        out.append({
            "queue": _jsonable(r["queue"]),
            "linear": _jsonable(r["linear"]),
            "valid?": bool(r["queue"]["valid?"] and r["linear"]["valid?"]),
        })
    return {"op": "result", "results": out}


def _jsonable(d: dict[str, Any]) -> dict[str, Any]:
    """Result maps hold value sets; the wire header is JSON."""
    return {
        k: sorted(v) if isinstance(v, (set, frozenset)) else v
        for k, v in d.items()
    }


class _Handler(socketserver.BaseRequestHandler):
    def setup(self):
        no_delay(self.request)

    def handle(self):
        server: CheckerServer = self.server  # type: ignore[assignment]
        while True:
            try:
                header, arrays = recv_frame(self.request)
            except TornPayloadError as e:
                # the frame was fully consumed (connection still in
                # sync): quarantine exactly the poisoned stream, reply,
                # keep serving this connection
                try:
                    send_frame(self.request, server.torn_reply(e))
                except (ProtocolError, ConnectionError, OSError):
                    return
                continue
            except (ProtocolError, ConnectionError, OSError):
                return
            if header.get("op") == "stream-subscribe":
                # push mode: the reply rhythm inverts — the server sends
                # verdict-window frames as segments close, until the
                # terminal window (or the chaos tear) ends the loop
                try:
                    if not self._handle_subscribe(server, header):
                        return
                    continue
                except (ProtocolError, ConnectionError, OSError):
                    return
            try:
                reply = server.dispatch(header, arrays)
                send_frame(self.request, reply)
            except ProtocolError as e:
                send_frame(self.request, {"op": "error", "error": str(e)})
            except DEVICE_FAULTS as e:
                # the card's or K1's fault: answered, then the server
                # stops (never served on as if it were the data's)
                send_frame(self.request, {
                    "op": "error", "error": f"{type(e).__name__}: {e}",
                    "reason": "device-fault"})
                server.fail_device(e)
            except Exception as e:  # noqa: BLE001 — report, keep serving
                logger.exception("check failed")
                send_frame(self.request, {"op": "error", "error": repr(e)})

    def _handle_subscribe(self, server: "CheckerServer", header) -> bool:
        """Run one subscription push loop.  Returns True to keep the
        connection (back to the request rhythm after the terminal
        window), False to close it (chaos tear / dead subscriber)."""
        import queue as queue_mod

        server.metrics.counter(
            "service.requests", op="stream-subscribe"
        ).inc()
        svc = server.ingest_service()
        sid = str(header.get("stream"))
        if header.get("stream") is None:
            raise ProtocolError("stream-subscribe requires stream")
        from_window = int(header.get("from_window", 0))
        ack, replay, q = svc.subscribe(sid, from_window)
        if ack.get("op") != "subscribed":
            send_frame(self.request, ack)
            return True
        drop_after = server.take_sub_drop()
        pushed = 0
        final_seen = False
        try:
            send_frame(self.request, ack)
            for w in replay:
                send_frame(self.request, w)
                pushed += 1
                final_seen = final_seen or bool(w.get("final"))
                if drop_after is not None and pushed >= drop_after:
                    logger.error(
                        "%s hook: tearing subscription on %s after %d "
                        "window(s)", SUB_DROP_ENV, sid, pushed,
                    )
                    return False
            if final_seen or q is None:
                if not final_seen:
                    # stream already done but the terminal window fell
                    # outside the replay range: say so, never hang
                    send_frame(self.request, {
                        "op": "subscribe-done", "stream": sid,
                        "pushed": pushed,
                    })
                return True
            deadline = None
            while True:
                try:
                    w = q.get(timeout=0.5)
                except queue_mod.Empty:
                    if deadline is None:
                        deadline = (
                            time.monotonic() + SUBSCRIBE_IDLE_TIMEOUT_S
                        )
                    elif time.monotonic() > deadline:
                        send_frame(self.request, {
                            "op": "subscribe-timeout", "stream": sid,
                            "idle_s": SUBSCRIBE_IDLE_TIMEOUT_S,
                            "pushed": pushed,
                        })
                        return True
                    continue
                deadline = None
                send_frame(self.request, w)
                pushed += 1
                if drop_after is not None and pushed >= drop_after:
                    logger.error(
                        "%s hook: tearing subscription on %s after %d "
                        "window(s)", SUB_DROP_ENV, sid, pushed,
                    )
                    return False
                if w.get("final"):
                    return True
        finally:
            svc.unsubscribe(sid, q)


class CheckerServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 8640,
        metrics_registry=None,
        ingest_opts: dict | None = None,
        cache_capacity: int = 4096,
        store: str | None = None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        #: the fault of the card or of K1 that stopped the server, if any
        self.device_fault: BaseException | None = None
        super().__init__((host, port), _Handler)
        # streaming ingestion (stream-open/feed/finish, submit/collect):
        # built lazily on first streaming op so batch-only deployments
        # never pay the worker pool; constructor knobs flow through
        self._ingest = None
        self._ingest_lock = threading.Lock()
        self._ingest_opts = dict(ingest_opts or {})
        self._cache_capacity = cache_capacity
        self._store = store
        # one check on the card at a time: connections multiplex onto
        # it serially
        self._device_lock = threading.Lock()
        # every check op lands its wall latency in a quantile sketch of
        # this registry, which /metrics renders as p50/p90/p99
        from jepsen_tpu_torch.obs import metrics as obs_metrics

        self.metrics = (
            obs_metrics.REGISTRY
            if metrics_registry is None
            else metrics_registry
        )
        self._metrics_srv = None
        # chaos: arm the one-shot subscription tear from the env
        self._sub_drop: int | None = None
        spec = os.environ.get(SUB_DROP_ENV)
        if spec:
            try:
                self._sub_drop = int(spec)
            except ValueError:
                logger.error("%s=%r malformed (want int); ignoring",
                             SUB_DROP_ENV, spec)

    def take_sub_drop(self) -> int | None:
        """Take the one-shot torn-subscription hook (the first subscriber
        is torn; its reconnect must find a healthy loop)."""
        with self._ingest_lock:
            n, self._sub_drop = self._sub_drop, None
            return n

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start_metrics(
        self,
        host: str = "0.0.0.0",
        port: int = 9640,
        store: str | None = None,
    ):
        """Serve the registry as Prometheus text on ``GET
        http://host:port/metrics``, and ``GET /report/by-key/<key>`` (a
        peek into the verdict cache, 302 to the recorded run) and, with
        ``store``, ``GET /report/<run>`` (501 until the report renderer
        is ported); returns the HTTP server (``.server_address[1]`` is
        the bound port)."""
        from jepsen_tpu_torch.obs import metrics as obs_metrics

        self._metrics_srv = obs_metrics.serve_metrics(
            host, port, self.metrics, store=store,
            # lazy: the ingest core (and with it the cache) may not be
            # built yet when the metrics endpoint comes up
            cache=lambda: (
                self._ingest.cache if self._ingest is not None else None
            ),
        )
        self._metrics_srv.start_background()
        return self._metrics_srv

    def server_close(self):
        if self._metrics_srv is not None:
            self._metrics_srv.shutdown()
            self._metrics_srv.server_close()
            self._metrics_srv = None
        if self._ingest is not None:
            self._ingest.close()
            self._ingest = None
        super().server_close()

    def ingest_service(self):
        """The lazily-built streaming ingestion core (thread-safe)."""
        if self._ingest is None:
            with self._ingest_lock:
                if self._ingest is None:
                    from jepsen_tpu_torch.service.cache import VerdictCache
                    from jepsen_tpu_torch.service.stream import (
                        IngestService,
                    )

                    cache = VerdictCache(
                        capacity=self._cache_capacity,
                        registry=self.metrics,
                    )
                    if self._store:
                        try:
                            n = cache.seed_from_store(self._store)
                            if n:
                                logger.info(
                                    "verdict cache seeded with %d "
                                    "recorded run(s) from %s",
                                    n, self._store,
                                )
                        except Exception:  # noqa: BLE001 — serve anyway
                            logger.exception(
                                "cache seed from %s failed", self._store
                            )
                        self._export_fleet_gauges()
                    svc = IngestService(
                        cache=cache,
                        registry=self.metrics,
                        device=self.device,
                        **self._ingest_opts,
                    )
                    svc.on_device_fault = self.fail_device
                    self._ingest = svc
        return self._ingest

    def fail_device(self, err: BaseException) -> None:
        """A fault of the card or of K1: latched once, every open stream
        fails with its text, and the server stops serving (off this
        thread: ``shutdown`` waits for the serving loop)."""
        with self._ingest_lock:
            if self.device_fault is not None:
                return
            self.device_fault = err
        logger.error("checker server stopping on a fault of the card or "
                     "of K1: %s: %s", type(err).__name__, err)
        if self._ingest is not None:
            self._ingest.fail_device(err)
        threading.Thread(target=self.shutdown, name="svc-fault-stop",
                         daemon=True).start()

    def _export_fleet_gauges(self) -> None:
        """The backing store's prefix-checkpoint index size as a gauge on
        ``/metrics``.  Telemetry only: a failure costs the gauge, never
        the service.  The CAS dedup and per-config baseline gauges of the
        JAX server wait for ``history/cas.py`` and
        ``report/baselines.py`` (ROADMAP.md, Open items §1)."""
        try:
            from jepsen_tpu_torch.history.prefix_index import (
                DEFAULT_INDEX_DIR,
                PrefixCheckpointIndex,
            )

            st = PrefixCheckpointIndex(
                os.path.join(self._store, DEFAULT_INDEX_DIR)
            ).stats()
            self.metrics.gauge("fleet.prefix_index_entries").set(
                st["entries"]
            )
        except Exception:  # noqa: BLE001 — telemetry only
            logger.debug("prefix index gauge skipped", exc_info=True)

    def torn_reply(self, e: TornPayloadError) -> dict[str, Any]:
        """Map a torn frame to its stream: poison evidence quarantines
        exactly that stream (never folded into a verdict); torn frames
        outside a stream are a plain error reply."""
        hdr = e.header
        sid = hdr.get("stream")
        if hdr.get("op") == "stream-feed" and sid is not None:
            self.metrics.counter(
                "service.torn_blocks", op="stream-feed"
            ).inc()
            return self.ingest_service().quarantine_stream(
                str(sid),
                f"torn block on the wire (seq {hdr.get('seq')}): {e}",
            )
        return {"op": "error", "error": str(e), "torn": e.torn}

    def dispatch(
        self, header: dict[str, Any], arrays: dict[str, np.ndarray]
    ) -> dict[str, Any]:
        from jepsen_tpu_torch.obs import trace as obs_trace

        op = header.get("op")
        if op in ("check", "check-stream", "check-elle"):
            t0 = time.perf_counter()
            try:
                reply = self._dispatch(op, header, arrays)
            except Exception:
                self.metrics.counter("service.errors", op=op).inc()
                raise
            dt = time.perf_counter() - t0
            self.metrics.counter("service.requests", op=op).inc()
            self.metrics.counter("service.histories", op=op).inc(
                len(reply.get("results", ()))
            )
            self.metrics.sketch("service.check_latency_s", op=op).add(dt)
            # the handler thread's own track: concurrent requests overlap
            # in time (t0 is taken before the device lock)
            obs_trace.complete(f"service.{op}", t0, t0 + dt)
            return reply
        if op in _STREAM_OPS:
            self.metrics.counter("service.requests", op=op).inc()
        return self._dispatch(op, header, arrays)

    def _dispatch(
        self, op, header: dict[str, Any], arrays: dict[str, np.ndarray]
    ) -> dict[str, Any]:
        if op in _STREAM_OPS:
            return self._dispatch_stream(op, header, arrays)
        if op == "ping":
            return {
                "op": "pong",
                "backend": self.device.type,
                "device_count": (torch.cuda.device_count()
                                 if self.device.type == "cuda" else 1),
            }
        if op == "check":
            value_space = int(header.get("value_space", 0))
            if value_space <= 0:
                raise ProtocolError("value_space must be positive")
            with self._device_lock:
                return _check_arrays(arrays, value_space, self.device)
        if op in NOT_PORTED_OPS:
            raise ProtocolError(
                f"op {op!r} is not ported yet (ROADMAP.md, "
                f"{NOT_PORTED_OPS[op]})")
        raise ProtocolError(f"unknown op {op!r}")

    def _dispatch_stream(
        self, op, header: dict[str, Any], arrays: dict[str, np.ndarray]
    ) -> dict[str, Any]:
        """The always-on streaming surface: every reply is a plain
        machine-readable dict (``opened`` / ``accepted`` / ``rejected``
        with ``SATURATED`` / ``quarantined`` / a verdict) — admission
        decisions are data, not exceptions."""
        svc = self.ingest_service()
        if op == "stream-open":
            workload = header.get("workload")
            if not workload:
                raise ProtocolError("stream-open requires workload")
            return svc.open(
                str(workload),
                opts=header.get("opts") or {},
                content_key=header.get("content_key"),
                deadline_s=header.get("deadline_s"),
            )
        if op == "stream-feed":
            sid = header.get("stream")
            seq = header.get("seq")
            if sid is None or seq is None:
                raise ProtocolError("stream-feed requires stream and seq")
            if "rows" in arrays:
                payload = arrays["rows"]
                bkind = "rows"
                n_ops = int(header.get("n_ops", payload.shape[0]))
            elif "ops_block" in header:
                payload = header["ops_block"]
                bkind = "ops"
                n_ops = int(header.get("n_ops", len(payload)))
            else:
                raise ProtocolError(
                    "stream-feed requires a rows array or an ops_block"
                )
            return svc.feed(str(sid), int(seq), bkind, payload, n_ops)
        if op == "stream-finish":
            sid = header.get("stream")
            if sid is None:
                raise ProtocolError("stream-finish requires stream")
            verdict = svc.finish(str(sid), timeout=header.get("timeout"))
            if "op" not in verdict:
                verdict = dict(verdict)
                verdict["op"] = "verdict"
            return verdict
        if op == "stream-abort":
            sid = header.get("stream")
            if sid is None:
                raise ProtocolError("stream-abort requires stream")
            return svc.abort(str(sid))
        if op == "submit-batch":
            # the fleet path: one frame = many histories (concatenated
            # rows + offsets), one admission decision each
            workload = header.get("workload")
            if not workload:
                raise ProtocolError("submit-batch requires workload")
            if "rows" not in arrays or "offsets" not in arrays:
                raise ProtocolError(
                    "submit-batch requires rows and offsets arrays"
                )
            rows = arrays["rows"]
            offsets = np.asarray(arrays["offsets"], np.int64)
            n_ops = header.get("n_ops") or []
            keys = header.get("content_keys") or []
            opts = header.get("opts") or {}
            replies = []
            for i in range(len(offsets) - 1):
                blk = rows[int(offsets[i]) : int(offsets[i + 1])]
                replies.append(svc.submit(
                    str(workload), opts, "rows", blk,
                    int(n_ops[i]) if i < len(n_ops) else blk.shape[0],
                    content_key=keys[i] if i < len(keys) else None,
                ))
            return {"op": "submitted", "replies": replies}
        if op == "collect":
            ids = header.get("ids") or []
            return svc.collect(
                [str(i) for i in ids],
                timeout=float(header.get("timeout", 0.0)),
            )
        if op == "cache-get":
            key = header.get("content_key")
            if not key:
                raise ProtocolError("cache-get requires content_key")
            if svc.cache is None:
                return {"op": "miss"}
            from jepsen_tpu_torch.service.cache import cache_key

            entry = svc.cache.get(cache_key(
                str(key), str(header.get("workload", "queue")),
                header.get("opts") or {},
            ))
            if entry is None:
                return {"op": "miss"}
            out = {"op": "cached", "verdict": entry["verdict"]}
            if "report_ref" in entry:
                out["report_ref"] = entry["report_ref"]
            return out
        if op == "service-stats":
            from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats

            stats = svc.stats()
            stats["op"] = "stats"
            # K1's own count of its launches in this process (the check
            # op's, the batcher's and the workers')
            stats["k1_launches"] = fused_queue_stats.launches
            return stats
        raise ProtocolError(f"unknown stream op {op!r}")

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


def serve_forever(
    host: str = "0.0.0.0",
    port: int = 8640,
    store: str = "store",
    metrics_port: int = 9640,
    workers: int = 2,
    max_streams: int = 256,
    ingress_cap: int = 1024,
    stream_deadline_s: float = 120.0,
    batch: bool = False,
    target_batch: int = 32,
    max_batch_wait_ms: float = 25.0,
    warmup: bool = False,
    warmup_buckets=((128, 128), (256, 256)),
    device: str | torch.device = "cuda",
) -> None:
    """Serve until interrupted (SIGINT returns normally).  ``device`` is
    where every check runs; there is no fallback to the CPU.  A fault of
    the card or of K1 stops the server and raises here."""
    srv = CheckerServer(
        host, port, store=store, device=device,
        ingest_opts={
            "workers": workers,
            "max_streams": max_streams,
            "ingress_cap": ingress_cap,
            "stream_deadline_s": stream_deadline_s,
            "batch": batch,
            "target_batch": target_batch,
            "max_batch_wait_ms": max_batch_wait_ms,
            "warmup": warmup,
            "warmup_buckets": tuple(warmup_buckets),
        },
    )
    try:
        if batch and warmup:
            # the batcher is built with the ingest core: build it now, so
            # the warm-up runs at start and not on a stream's latency path
            srv.ingest_service()
        metrics_note = "off"
        if metrics_port >= 0:
            try:
                msrv = srv.start_metrics(host, metrics_port, store=store)
                metrics_note = (
                    f"http://{host}:{msrv.server_address[1]}/metrics"
                )
            except OSError as e:
                # a busy metrics port must not take the checker down
                print(f"warning: /metrics endpoint unavailable ({e}); "
                      f"serving checks without it")
        kind = (torch.cuda.get_device_name(srv.device)
                if srv.device.type == "cuda" else "cpu")
        print(
            f"checker sidecar on {host}:{srv.port} (backend={kind}, "
            f"mesh=None, metrics={metrics_note})", flush=True,
        )
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
    finally:
        srv.server_close()
    if srv.device_fault is not None:
        raise srv.device_fault
