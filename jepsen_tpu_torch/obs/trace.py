"""Ring-buffer span tracer.

The port's own copy of the JAX package's ``obs/trace.py``: spans,
instant events and complete records in one fixed-capacity ring.

- **Off is free.**  Tracing is off by default; an off ``span()`` or
  ``event()`` is one module-global read and a shared no-op context
  manager, with no allocation per span.
- **Recording never blocks.**  Each record claims a monotonically
  increasing slot (``itertools.count``, atomic under the GIL) and
  writes one tuple into ``ring[slot % capacity]``.  When the ring wraps
  the oldest records are overwritten, and :func:`dropped` counts them.
- **Tracks.**  Every record carries a track id: the recording thread's
  name by default, or an explicit one (``segmented``, ``lane0``).
- **Clock.**  ``time.perf_counter_ns()``; :func:`complete` takes the
  float ``time.perf_counter()`` seconds the pipeline already measures.
"""

from __future__ import annotations

import itertools
import threading
import time

#: record kinds (index 0 of every ring tuple)
KIND_SPAN = "X"  # complete span: (X, name, track, t0_ns, dur_ns, args)
KIND_EVENT = "i"  # instant event: (i, name, track, t_ns, None, args)

_DEFAULT_CAPACITY = 1 << 16


class _State:
    """One enabled tracing session: the ring and its slot counter."""

    __slots__ = ("ring", "capacity", "slots", "high", "t0_ns",
                 "track_spans")

    def __init__(self, capacity: int):
        self.capacity = max(256, int(capacity))
        self.ring: list = [None] * self.capacity
        self.slots = itertools.count()
        # highest claimed slot count, maintained by _emit: the read APIs
        # (snapshot/spans_recorded) must not consume the counter.  The
        # unlocked write races only with other emitters and converges to
        # the max within one in-flight record — read-side accuracy, not
        # a correctness invariant
        self.high = 0
        self.t0_ns = time.perf_counter_ns()
        # per-track RECORDED span totals (monotonic, survive ring
        # wrap) — maintained at emit time so the /metrics health block
        # never has to scan the whole ring per scrape.  Same accuracy
        # contract as `high`: unlocked read-modify-write, a rare lost
        # increment under emitter races costs gauge accuracy only
        self.track_spans: dict = {}


#: None = disabled.  Read once per call; enable/disable swap the whole
#: object so a mid-flight recorder thread sees either the old ring or
#: the new one, never a half-initialized state.
_state: _State | None = None


def enable(capacity: int = _DEFAULT_CAPACITY) -> None:
    """Start a fresh recording (clears any previous ring)."""
    global _state
    _state = _State(capacity)


def disable() -> None:
    """Stop recording.  The ring stays readable via :func:`snapshot`
    until the next :func:`enable`."""
    global _state
    st = _state
    _state = None
    # keep the last session readable for post-run export
    if st is not None:
        _last[0] = st


#: the most recently disabled session (export-after-disable)
_last: list = [None]


def is_enabled() -> bool:
    return _state is not None


def _track() -> str:
    return threading.current_thread().name


def _emit(st: _State, rec: tuple) -> None:
    i = next(st.slots)
    st.ring[i % st.capacity] = rec
    if i >= st.high:
        st.high = i + 1
    if rec[0] == KIND_SPAN:
        d = st.track_spans
        d[rec[2]] = d.get(rec[2], 0) + 1


class _Span:
    """An enabled span: records one KIND_SPAN tuple on exit."""

    __slots__ = ("_st", "name", "track", "args", "t0")

    def __init__(self, st: _State, name: str, track: str | None, args):
        self._st = st
        self.name = name
        self.track = track
        self.args = args
        self.t0 = 0

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        _emit(
            self._st,
            (
                KIND_SPAN,
                self.name,
                self.track or _track(),
                self.t0,
                t1 - self.t0,
                self.args,
            ),
        )


class _Noop:
    """The disabled path: one shared reentrant no-op context manager."""

    __slots__ = ()

    def __enter__(self) -> "_Noop":
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _Noop()


def span(name: str, track: str | None = None, args: dict | None = None):
    """``with span("pipeline.produce", track="lane0"): ...`` — records a
    complete span over the block.  Disabled: returns the shared no-op
    (no allocation).  ``args`` must be a pre-built dict or None — build
    it behind :func:`is_enabled` on hot paths so the off-path never
    allocates."""
    st = _state
    if st is None:
        return _NOOP
    return _Span(st, name, track, args)


def event(name: str, track: str | None = None, args: dict | None = None) -> None:
    """Record an instant annotation (a point on a track's timeline)."""
    st = _state
    if st is None:
        return
    _emit(
        st,
        (KIND_EVENT, name, track or _track(), time.perf_counter_ns(), None, args),
    )


def complete(
    name: str,
    t0_s: float,
    t1_s: float,
    track: str | None = None,
    args: dict | None = None,
) -> None:
    """Record a span from already-measured ``time.perf_counter()``
    seconds (same clock as ``perf_counter_ns``) — the pipeline's
    serialized check-interval accounting and the nemesis START/STOP
    pairing measure once and feed stats and trace both."""
    st = _state
    if st is None:
        return
    _emit(
        st,
        (
            KIND_SPAN,
            name,
            track or _track(),
            int(t0_s * 1e9),
            max(0, int((t1_s - t0_s) * 1e9)),
            args,
        ),
    )


def _session() -> _State | None:
    return _state if _state is not None else _last[0]


def snapshot() -> list[tuple]:
    """The recorded tuples, oldest first (ring order), from the live
    session or — after :func:`disable` — the last one."""
    st = _session()
    if st is None:
        return []
    n = st.high
    if n <= st.capacity:
        recs = st.ring[:n]
    else:
        k = n % st.capacity
        recs = st.ring[k:] + st.ring[:k]
    return [r for r in recs if r is not None]


def spans_recorded() -> int:
    """Total records claimed this session (including any the ring has
    since overwritten)."""
    st = _session()
    return st.high if st is not None else 0


def dropped() -> int:
    """Records overwritten by ring wrap-around (0 when capacity held)."""
    st = _session()
    if st is None:
        return 0
    return max(0, st.high - st.capacity)


def ring_capacity() -> int:
    """The ring's slot count (live session or — after :func:`disable`
    — the last one); 0 when no session ever ran."""
    st = _session()
    return st.capacity if st is not None else 0


def track_span_counts() -> dict:
    """``{track: spans recorded}`` for the live (or last) session —
    monotonic emit-time totals (wrap-dropped spans stay counted), so a
    scrape never scans the ring."""
    st = _session()
    return dict(st.track_spans) if st is not None else {}
