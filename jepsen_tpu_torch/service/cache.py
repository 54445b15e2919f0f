"""Content-addressed verdict cache of the checker service.

The port's own copy of the JAX package's ``service/cache.py``: the same
key, so that a content key declared to either package's service names
the same verdict.  Checking is a pure function of (history bytes, model,
contract), so a verdict can be served by a hash lookup instead of a
device dispatch.  The key is

    sha256( content_digest || 0x00 || canonical-JSON([workload, opts]) )

where ``content_digest`` is the sha256 of the history's substrate bytes
(:meth:`~jepsen_tpu_torch.history.columnar.Jtc.content_key` of a
``.jtc``, or the running digest of the block payloads a wire stream
delivered: the server hashes what it received, so a key a client
declares can never bind a verdict to other bytes).

Changed bytes are a different key, so an entry is never wrong, only
unreachable, and the LRU bound evicts it.  Only clean verdicts are
cached: a quarantined or ``degraded`` verdict reflects this run's
faults, not the history, and is recomputed, never replayed.

An entry may carry a ``report_ref`` (a store-relative run directory):
:meth:`VerdictCache.seed_from_store` builds such entries from recorded
runs, for the report route of ``obs/metrics.py::serve_metrics``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Any

log = logging.getLogger(__name__)


def contract_key(workload: str, opts: dict | None) -> str:
    """Canonical (model, contract) half of the cache key: the checker
    options that change verdict semantics, JSON-canonicalized."""
    return json.dumps(
        [workload, dict(opts or {})], sort_keys=True, separators=(",", ":")
    )


def cache_key(content_digest: str, workload: str, opts: dict | None) -> str:
    """The full content-addressed key: (substrate sha256, model,
    contract) → one hex digest."""
    h = hashlib.sha256()
    h.update(content_digest.encode())
    h.update(b"\x00")
    h.update(contract_key(workload, opts).encode())
    return h.hexdigest()


class VerdictCache:
    """Thread-safe LRU of verdicts keyed by :func:`cache_key`.

    ``get``/``put`` maintain the shared obs counters
    (``service.cache_hits`` / ``service.cache_misses``) so ``/metrics``
    answers the hit rate live."""

    def __init__(self, capacity: int = 4096, registry=None):
        if capacity <= 0:
            raise ValueError("cache capacity must be positive")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._entries: OrderedDict[str, dict] = OrderedDict()
        if registry is None:
            from jepsen_tpu_torch.obs.metrics import REGISTRY as registry  # noqa: N813
        self._hits = registry.counter("service.cache_hits")
        self._misses = registry.counter("service.cache_misses")

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def get(self, key: str) -> dict | None:
        """The cached entry ``{"verdict": ..., "report_ref": ...?}`` or
        None; counts a hit/miss either way."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
        if entry is None:
            self._misses.inc()
            return None
        self._hits.inc()
        return entry

    def peek(self, key: str) -> dict | None:
        """Read-only lookup: no LRU reorder, no hit/miss accounting, so
        that browsing ``/report/by-key/<key>`` never changes the cache
        or its hit rate."""
        with self._lock:
            return self._entries.get(key)

    def put(
        self,
        key: str,
        verdict: dict[str, Any],
        report_ref: str | None = None,
    ) -> None:
        entry = {"verdict": verdict}
        with self._lock:
            if report_ref is None:
                # a live re-check of a seeded history keeps its
                # recorded run: the refreshed entry still names it
                prev = self._entries.get(key)
                if prev is not None:
                    report_ref = prev.get("report_ref")
            if report_ref is not None:
                entry["report_ref"] = report_ref
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def stats(self) -> dict[str, int]:
        with self._lock:
            n = len(self._entries)
        return {
            "entries": n,
            "capacity": self.capacity,
            "hits": int(self._hits.value),
            "misses": int(self._misses.value),
        }

    def seed_from_store(
        self, store_root: str | Path, limit: int | None = None
    ) -> int:
        """Seed entries from recorded runs: every run directory with a
        ``results.json`` verdict and a fresh ``.jtc`` substrate becomes
        a cache entry whose ``report_ref`` names the run for the report
        route.  Returns the number of entries seeded; malformed runs are
        skipped (a cache seed never refuses to serve).  Runs whose
        substrate was dehydrated into the content-addressed section
        store (a ``.casman.json`` manifest, no ``.jtc``) are not seeded
        yet: that reader, ``history/cas.py``, is not ported (ROADMAP.md,
        Open items §1); such a history misses and is checked again."""
        from jepsen_tpu_torch.report.index import run_content_refs

        seeded = 0
        for digest, workload, opts, verdict, rel in run_content_refs(
            Path(store_root)
        ):
            self.put(
                cache_key(digest, workload, opts), verdict, report_ref=rel
            )
            seeded += 1
            if limit is not None and seeded >= limit:
                break
        return seeded
