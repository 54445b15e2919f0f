"""Metrics registry: counters, gauges, mergeable quantile sketches.

The port's own copy of the JAX package's ``obs/metrics.py``: the same
classes, the same sketch arithmetic, the same Prometheus text and the
same HTTP endpoint (:func:`serve_metrics`), so that the same samples
give the same quantiles and the same text in both packages.

Naming: dotted lowercase ``subsystem.metric`` with a unit suffix (``_s``
seconds, ``_bytes``), labels for bounded dimensions only
(``stage=produce``, ``reason=corrupt``).  Prometheus rendering mangles
``pipeline.stage_busy_s`` to ``jepsen_tpu_pipeline_stage_busy_s``.

Quantiles come from a log-bucketed sketch (DDSketch-style): values land
in geometric buckets ``gamma**k`` with ``gamma = (1+alpha)/(1-alpha)``,
so any quantile is answered within relative error ``alpha`` (default
1%) from O(log range) integers, and two sketches with the same ``alpha``
merge by adding bucket counts.

Thread-safety: metric mutation takes the metric's lock; registry
creation takes the registry lock.
"""

from __future__ import annotations

import math
import threading
from typing import Iterable

_NO_LABELS: tuple = ()


class Counter:
    """Monotonic-by-convention counter.  ``set`` exists for the stats
    VIEW layer (a run-scoped registry mirroring an externally computed
    total); cumulative registries should only ``inc``."""

    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._v += n

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    @property
    def value(self) -> float:
        return self._v

    kind = "counter"


class Gauge(Counter):
    """A counter whose ``set`` is the normal API (point-in-time value)."""

    __slots__ = ()
    kind = "gauge"


class QuantileSketch:
    """Mergeable log-bucketed quantile sketch (relative-accuracy
    ``alpha``).  Non-positive values land in the zero bucket and report
    as 0.0 — latencies/sizes are the domain, not signed data."""

    __slots__ = ("alpha", "_gamma", "_log_gamma", "_buckets", "_zero",
                 "_count", "_sum", "_lock")

    kind = "summary"

    def __init__(self, alpha: float = 0.01):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha out of range: {alpha}")
        self.alpha = alpha
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._log_gamma = math.log(self._gamma)
        self._buckets: dict[int, int] = {}
        self._zero = 0
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def add(self, x: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += x
            if x <= 0.0:
                self._zero += 1
                return
            k = math.ceil(math.log(x) / self._log_gamma)
            self._buckets[k] = self._buckets.get(k, 0) + 1

    def merge(self, other: "QuantileSketch") -> None:
        if abs(other.alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketches with different alpha: "
                f"{self.alpha} vs {other.alpha}"
            )
        with other._lock:
            buckets = dict(other._buckets)
            zero, count, total = other._zero, other._count, other._sum
        with self._lock:
            self._zero += zero
            self._count += count
            self._sum += total
            for k, n in buckets.items():
                self._buckets[k] = self._buckets.get(k, 0) + n

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    # -- plain-data round-trip (the cluster-telemetry STATS wire form) --
    def state(self) -> dict:
        """Plain-JSON state: bucket counts keyed by stringified index.
        Two states with the same alpha ADD bucket-wise, which is what
        lets an out-of-process node ship its fsync sketch over the admin
        ``STATS`` line and the poller merge successive deltas into a
        live registry sketch (obs/cluster.py)."""
        with self._lock:
            return {
                "alpha": self.alpha,
                "count": self._count,
                "sum": self._sum,
                "zero": self._zero,
                "buckets": {str(k): n for k, n in self._buckets.items()},
            }

    @classmethod
    def from_state(cls, state: dict) -> "QuantileSketch":
        s = cls(alpha=float(state.get("alpha", 0.01)))
        s.merge_state(state)
        return s

    def merge_state(self, state: dict) -> None:
        """Add a :meth:`state` dict into this sketch (same-alpha rule as
        :meth:`merge`)."""
        alpha = float(state.get("alpha", 0.01))
        if abs(alpha - self.alpha) > 1e-12:
            raise ValueError(
                f"cannot merge sketch state with different alpha: "
                f"{self.alpha} vs {alpha}"
            )
        with self._lock:
            self._count += int(state.get("count", 0))
            self._sum += float(state.get("sum", 0.0))
            self._zero += int(state.get("zero", 0))
            for k, n in (state.get("buckets") or {}).items():
                k = int(k)
                self._buckets[k] = self._buckets.get(k, 0) + int(n)

    def quantile(self, q: float) -> float:
        """The q-quantile (0 <= q <= 1) within relative error alpha;
        NaN on an empty sketch."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile out of range: {q}")
        with self._lock:
            if self._count == 0:
                return float("nan")
            rank = q * (self._count - 1)
            seen = self._zero
            if rank < seen:
                return 0.0
            for k in sorted(self._buckets):
                seen += self._buckets[k]
                if rank < seen:
                    # bucket k covers (gamma**(k-1), gamma**k]; its
                    # midpoint estimate is within alpha of any member
                    return 2.0 * self._gamma**k / (self._gamma + 1.0)
            return 2.0 * self._gamma ** max(self._buckets) / (self._gamma + 1.0)


def sketch_state_delta(prev: dict | None, cur: dict) -> dict:
    """``cur - prev`` for two :meth:`QuantileSketch.state` dicts from
    the SAME monotonically-growing sketch — the increment the poller
    merges into a live registry sketch each sample.  A count that went
    backwards means the source restarted (fresh sketch): the whole
    ``cur`` is the delta then."""
    if prev is None or int(cur.get("count", 0)) < int(prev.get("count", 0)):
        return cur
    pb = prev.get("buckets") or {}
    buckets = {}
    for k, n in (cur.get("buckets") or {}).items():
        d = int(n) - int(pb.get(k, 0))
        if d > 0:
            buckets[k] = d
    return {
        "alpha": cur.get("alpha", 0.01),
        "count": int(cur.get("count", 0)) - int(prev.get("count", 0)),
        "sum": float(cur.get("sum", 0.0)) - float(prev.get("sum", 0.0)),
        "zero": int(cur.get("zero", 0)) - int(prev.get("zero", 0)),
        "buckets": buckets,
    }


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items())) if labels else _NO_LABELS


class Registry:
    """Name+labels → metric.  Run-scoped instances back stats views
    (``PipelineStats.metrics``); the process-global :data:`REGISTRY`
    keeps cumulative counts across runs."""

    def __init__(self):
        self._metrics: dict[tuple[str, tuple], object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, labels: dict, **kw):
        key = (name, _label_key(labels))
        got = self._metrics.get(key)
        if got is None:
            with self._lock:
                got = self._metrics.get(key)
                if got is None:
                    got = self._metrics[key] = cls(**kw)
        if not isinstance(got, cls) or (cls is Counter and type(got) is not Counter):
            raise TypeError(
                f"metric {name!r}{labels} already registered as "
                f"{type(got).__name__}, not {cls.__name__}"
            )
        return got

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def sketch(self, name: str, alpha: float = 0.01, **labels) -> QuantileSketch:
        return self._get(QuantileSketch, name, labels, alpha=alpha)

    def value(self, name: str, **labels) -> float:
        """The current value of a counter/gauge; 0.0 when never touched
        (reads must not materialize metrics)."""
        got = self._metrics.get((name, _label_key(labels)))
        return got.value if isinstance(got, Counter) else 0.0

    def items(self) -> Iterable[tuple[str, tuple, object]]:
        with self._lock:
            snap = list(self._metrics.items())
        for (name, labels), metric in sorted(snap, key=lambda kv: kv[0]):
            yield name, labels, metric

    def snapshot(self) -> dict:
        """Plain-data view (for JSON evidence/artifacts): counters and
        gauges by rendered key; sketches as {count, sum, p50, p90, p99}."""
        out: dict = {}
        for name, labels, metric in self.items():
            key = name + "".join(f"{{{k}={v}}}" for k, v in labels)
            if isinstance(metric, QuantileSketch):
                out[key] = {
                    "count": metric.count,
                    "sum": metric.sum,
                    "p50": metric.quantile(0.50),
                    "p90": metric.quantile(0.90),
                    "p99": metric.quantile(0.99),
                }
            else:
                out[key] = metric.value
        return out


#: the process-global registry: cumulative pipeline, cache and segmented
#: counters and sketches
REGISTRY = Registry()


# ---------------------------------------------------------------------------
# Prometheus text rendering + the /metrics HTTP endpoint
# ---------------------------------------------------------------------------

_PROM_QUANTILES = (0.5, 0.9, 0.99)


def _prom_name(name: str) -> str:
    mangled = "".join(
        c if c.isalnum() or c == "_" else "_" for c in name
    )
    return f"jepsen_tpu_{mangled}"


def _prom_labels(labels: tuple, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _trace_health_lines() -> list[str]:
    """Span-ring health, rendered with every registry: occupancy (filled
    slots / capacity), the records dropped by wrap, and the spans recorded
    per track (emit-time totals, so a render never scans the ring)."""
    from jepsen_tpu_torch.obs import trace as _trace

    capacity = _trace.ring_capacity()
    recorded = _trace.spans_recorded()
    occupancy = min(recorded, capacity) / capacity if capacity else 0.0
    lines = [
        "# TYPE jepsen_tpu_trace_ring_occupancy gauge",
        f"jepsen_tpu_trace_ring_occupancy {occupancy}",
        "# TYPE jepsen_tpu_trace_spans_dropped_total counter",
        f"jepsen_tpu_trace_spans_dropped_total {_trace.dropped()}",
    ]
    by_track = _trace.track_span_counts()
    if by_track:
        lines.append("# TYPE jepsen_tpu_trace_spans_total counter")
        for track in sorted(by_track):
            lines.append(
                f'jepsen_tpu_trace_spans_total{{track="{track}"}} '
                f"{by_track[track]}"
            )
    return lines


def render_prometheus(registry: Registry | None = None) -> str:
    """The registry in the Prometheus text exposition format (v0.0.4).
    Sketches render as summaries with p50/p90/p99 quantile labels;
    the span-ring health block (:func:`_trace_health_lines`) rides
    every render."""
    registry = registry or REGISTRY
    lines: list[str] = []
    typed: set[str] = set()
    for name, labels, metric in registry.items():
        pname = _prom_name(name)
        if pname not in typed:
            typed.add(pname)
            lines.append(f"# TYPE {pname} {metric.kind}")
        if isinstance(metric, QuantileSketch):
            for q in _PROM_QUANTILES:
                v = metric.quantile(q)
                qlabel = 'quantile="%g"' % q
                lines.append(
                    f"{pname}{_prom_labels(labels, qlabel)} "
                    f"{v if v == v else 'NaN'}"
                )
            lines.append(f"{pname}_count{_prom_labels(labels)} {metric.count}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} {metric.sum}")
        else:
            lines.append(f"{pname}{_prom_labels(labels)} {metric.value}")
    lines += _trace_health_lines()
    return "\n".join(lines) + "\n"


#: what ``GET /report/<run>`` answers until the report renderer is ported
REPORT_NOT_PORTED = (
    "per-run reports need the report renderer, which is not ported yet "
    "(ROADMAP.md, Open items §1, items 5 and 10)"
)


def serve_metrics(
    host: str = "0.0.0.0",
    port: int = 9640,
    registry: Registry | None = None,
    store: str | None = None,
    cache=None,
):
    """A stdlib HTTP server answering ``GET /metrics`` with the
    Prometheus text of ``registry`` (default: the global one).  With
    ``cache`` (a verdict cache, or a zero-argument callable returning one
    or None: the service builds its cache lazily), also ``GET
    /report/by-key/<cache-key>``: a read-only peek that answers 302 to
    the entry's recorded run under ``/report/``, 404 when there is no
    entry or it names no run, 503 when no cache is wired.  With
    ``store``, ``GET /report/<run>`` answers 501: rendering a run's
    report is not ported yet.  Returns the server (``.server_address``
    carries the bound port; :meth:`start_background` serves it on a
    daemon thread; ``.shutdown()`` and ``.server_close()`` stop it)."""
    import http.server

    reg = registry or REGISTRY

    class _Handler(http.server.BaseHTTPRequestHandler):
        def _serve_report_by_key(self, key: str) -> None:
            vc = cache() if callable(cache) else cache
            if vc is None:
                self.send_error(503, "verdict cache not wired on this "
                                "service")
                return
            entry = vc.peek(key.strip("/"))
            if entry is None:
                self.send_error(404, "no cached verdict under that key")
                return
            ref = entry.get("report_ref")
            if not ref:
                self.send_error(
                    404,
                    "cached verdict has no recorded run to browse "
                    "(served from the wire, not the store)",
                )
                return
            self.send_response(302)
            self.send_header(
                "Location", "/report/" + str(ref).strip("/") + "/"
            )
            self.end_headers()

        def do_GET(self):  # noqa: N802 - stdlib API
            path = self.path.split("?", 1)[0]
            if cache is not None and path.startswith("/report/by-key/"):
                self._serve_report_by_key(path[len("/report/by-key/"):])
                return
            if store is not None and path.startswith("/report/"):
                self.send_error(501, "report rendering not ported",
                                REPORT_NOT_PORTED)
                return
            if path != "/metrics":
                self.send_error(
                    404,
                    "only /metrics (and /report/<run>, when a store "
                    "is wired) lives here",
                )
                return
            body = render_prometheus(reg).encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrapes are periodic; stay quiet
            pass

    class _Server(http.server.ThreadingHTTPServer):
        allow_reuse_address = True
        daemon_threads = True

        def start_background(self) -> threading.Thread:
            t = threading.Thread(target=self.serve_forever, daemon=True)
            t.start()
            return t

    return _Server((host, port), _Handler)
