"""Recorded runs under a store: their directories, and the content refs
that seed the service's verdict cache.

The port's own copy of the two store walks of the JAX package's
``report/index.py`` that the service needs (``run_dirs`` and
``run_content_refs``, ``.jtc`` branch).  The page rendering of that
module waits for the report renderer (ROADMAP.md, Open items §1, items
5 and 10), and the ``.casman.json`` branch for ``history/cas.py``.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

from jepsen_tpu_torch.history.store import EDN_FILE, HISTORY_FILE, RESULTS_FILE

log = logging.getLogger(__name__)


def _under_symlink(d: Path, root: Path) -> bool:
    cur = d
    while cur != root and cur != cur.parent:
        if cur.is_symlink():
            return True
        cur = cur.parent
    return False


def run_dirs(root: str | Path) -> list[Path]:
    """Every run directory under ``root`` (one holding a recorded history
    or a ``results.json``), sorted by path; ``latest``/``current``
    symlinks are skipped and resolved paths deduplicated, so no run
    appears twice."""
    root = Path(root)
    seen: set = set()
    out = []
    for pat in (RESULTS_FILE, HISTORY_FILE, EDN_FILE):
        for p in sorted(root.rglob(pat)):
            d = p.parent
            if _under_symlink(d, root):
                continue
            r = d.resolve()
            if r in seen:
                continue
            seen.add(r)
            out.append(d)
    return sorted(out)


def run_content_refs(root: str | Path):
    """Yields ``(digest, workload, opts, verdict, rel)`` for every run
    directory under ``root`` holding both a ``results.json`` verdict and
    a fresh ``.jtc`` substrate; a stale, corrupt or absent substrate is
    skipped (a seed never serves a verdict for bytes it cannot address).

    ``digest`` is the substrate's
    :meth:`~jepsen_tpu_torch.history.columnar.Jtc.content_key`, ``opts``
    the default contract (recorded runs do not keep checker options, so
    another contract checks again instead of hitting), and ``rel`` the
    run directory relative to ``root``, the ``report_ref`` a hit serves
    beside the verdict.  A run whose substrate lives only in the
    content-addressed section store (a ``.casman.json`` manifest) is not
    seeded: ``history/cas.py`` is not ported."""
    from jepsen_tpu_torch.history.columnar import load_jtc

    root = Path(root)
    for d in run_dirs(root):
        results_path = d / RESULTS_FILE
        src = d / HISTORY_FILE
        if not results_path.is_file() or not src.is_file():
            continue
        try:
            jtc = load_jtc(src)
        except Exception as e:  # noqa: BLE001 - skip, never refuse
            log.warning("unaddressable substrate under %s: %s", d, e)
            continue
        if jtc is None or jtc.workload is None:
            continue
        try:
            verdict = json.loads(results_path.read_text())
        except (OSError, ValueError) as e:
            log.warning("unreadable results.json under %s: %s", d, e)
            continue
        yield (jtc.content_key(), jtc.workload, {}, verdict,
               str(d.relative_to(root)))
