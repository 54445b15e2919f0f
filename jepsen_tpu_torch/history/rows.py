"""Row explosion: histories -> ``[n, 8]`` int32 row matrices, and
their store cache.

The per-op half of packing (``encode.pack_histories`` = explosion +
assembly).  A copy of the JAX package's ``_rows_for``, so that both
packages explode a history into the same rows.

Also the packed-row store cache: the ``[n, 8]`` matrix is a pure
function of ``history.jsonl``, so it is kept beside the history and a
later check loads it instead of parsing the JSONL again.  Its backing
store is the ``.jtc`` columnar substrate (``history/columnar.py``); the
older per-directory ``rows.npz`` is still read, and written when
``JEPSEN_TPU_NO_JTC=1`` disables the substrate.  Both formats and their
freshness rules are the JAX package's, so a store cached by one package
is served to the other.
"""

from __future__ import annotations

import hashlib
import os
import threading
import zipfile
from pathlib import Path
from typing import Sequence

import numpy as np

from jepsen_tpu_torch.history.ops import NO_VALUE, Op, OpType

#: legacy cache file name, sibling of history.jsonl in a run dir
ROWS_CACHE = "rows.npz"

_COLUMNS = (
    "index", "process", "type", "f", "value", "time_ms", "latency_ms",
    "first",
)


def _rows_for(history: Sequence[Op]) -> np.ndarray:
    """Explode one history into an ``[n, 8]`` int32 row matrix (the last
    column is the 0/1 first-row flag).

    Completion latencies come from a stable sort on process: a
    completion's latency is against the immediately preceding row of its
    process iff that row is its open INVOKE (a process has at most one
    open op).  Drain completions explode by ``np.repeat`` into one row per
    drained value; an empty drain becomes one ``NO_VALUE`` row.
    """
    n = len(history)
    if n == 0:
        return np.zeros((0, len(_COLUMNS)), np.int32)
    idx_l, proc_l, typ_l, f_l, time_l, val_l = zip(
        *[
            (op.index, op.process, op.type, op.f, op.time, op.value)
            for op in history
        ]
    )
    idx = np.asarray(idx_l, np.int32)
    proc = np.asarray(proc_l, np.int32)
    typ = np.asarray(typ_l, np.int32)
    f = np.asarray(f_l, np.int32)
    times = np.asarray(time_l, np.int64)  # ns: exceeds int32
    t_ms = np.where(times >= 0, times // 1_000_000, -1)

    order = np.argsort(proc, kind="stable")
    sp, st, s_inv = proc[order], times[order], typ[order] == int(OpType.INVOKE)
    ok = np.zeros(n, bool)
    ok[1:] = (
        ~s_inv[1:]
        & (sp[1:] == sp[:-1])
        & s_inv[:-1]
        & (st[:-1] >= 0)
        & (st[1:] >= 0)
    )
    lat_sorted = np.full(n, -1, np.int64)
    lat_sorted[1:][ok[1:]] = (st[1:] - st[:-1])[ok[1:]] // 1_000_000
    lat = np.empty(n, np.int64)
    lat[order] = lat_sorted

    # scalars resolve inline; lists leave a sentinel and are exploded
    # below only when present
    _LIST = NO_VALUE - 1  # impossible as a real value (values ≥ 0 or NO_VALUE)
    scalar_vals = [
        v
        if type(v) is int  # exact-type fast path; subclasses fall through
        else (
            _LIST
            if isinstance(v, (list, tuple))
            else (int(v) if isinstance(v, int) else NO_VALUE)  # e.g. bool
        )
        for v in val_l
    ]
    plain = _LIST not in scalar_vals
    if plain:
        flat_vals = scalar_vals
    else:
        counts = np.ones(n, np.int64)
        flat_vals = []
        for r, v in enumerate(scalar_vals):
            seq = val_l[r]
            if v != _LIST or not isinstance(seq, (list, tuple)):
                # scalar — including a real value equal to the sentinel,
                # which the type check disambiguates
                flat_vals.append(v)
                continue
            if seq:
                counts[r] = len(seq)
                flat_vals.extend(
                    x if isinstance(x, int) else NO_VALUE for x in seq
                )
            else:
                flat_vals.append(NO_VALUE)

    out = np.empty((len(flat_vals), len(_COLUMNS)), np.int32)
    if plain:
        rep = slice(None)
        first = np.ones(n, np.int32)
    else:
        rep = np.repeat(np.arange(n), counts)
        first = np.zeros(len(rep), np.int32)
        first[np.cumsum(counts) - counts] = 1
    v64 = np.asarray(flat_vals, np.int64)
    i32 = np.iinfo(np.int32)
    if v64.size and (
        int(v64.max()) > i32.max
        or int(v64.min()) < min(i32.min, _LIST)
        or int(t_ms.max(initial=0)) > i32.max
    ):
        # a silently int32-wrapped value would alias onto a legitimate one
        # and evade the packer's value_space guard
        raise OverflowError(
            "op value or timestamp exceeds the int32 packing range "
            f"(value range [{v64.min()}, {v64.max()}], "
            f"max time_ms {t_ms.max(initial=0)})"
        )
    out[:, 0] = idx[rep]
    out[:, 1] = proc[rep]
    out[:, 2] = typ[rep]
    out[:, 3] = f[rep]
    out[:, 4] = v64.astype(np.int32)
    out[:, 5] = t_ms[rep].astype(np.int32)
    out[:, 6] = np.where(first == 1, lat[rep], -1).astype(np.int32)
    out[:, 7] = first
    return out


# ---------------------------------------------------------------------------
# Packed-row store cache
# ---------------------------------------------------------------------------


def _history_digest(jsonl_path: Path) -> str:
    h = hashlib.sha256()
    with open(jsonl_path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cache_path_for(jsonl_path: str | Path) -> Path:
    return Path(jsonl_path).with_name(ROWS_CACHE)


def save_rows_cache(
    jsonl_path: str | Path,
    workload: str,
    rows: np.ndarray,
) -> None:
    """Keep the exploded ``[n, 8]`` matrix as the rows section of the
    sibling ``.jtc`` (other sections of that file are kept); with the
    substrate disabled, as the legacy npz.  Best-effort: a cache that
    cannot be written never fails the check that tried to leave it."""
    from jepsen_tpu_torch.history import columnar

    if columnar.update_jtc(
        jsonl_path, workload, rows=np.asarray(rows, np.int32)
    ):
        return
    _save_rows_npz(jsonl_path, workload, rows)


def _save_rows_npz(
    jsonl_path: str | Path, workload: str, rows: np.ndarray
) -> None:
    """The legacy npz writer: stamped with the JSONL's (size, mtime_ns)
    and content hash, atomic, best-effort."""
    jsonl_path = Path(jsonl_path)
    target = cache_path_for(jsonl_path)
    tmp = target.with_name(
        f"{ROWS_CACHE}.{os.getpid()}.{threading.get_ident()}.tmp"
    )
    try:
        st = os.stat(jsonl_path)
        meta = np.array(
            [
                workload,
                _history_digest(jsonl_path),
                str(st.st_size),
                str(st.st_mtime_ns),
            ]
        )
        with open(tmp, "wb") as fh:
            np.savez(fh, rows=rows.astype(np.int32), meta=meta)
        os.replace(tmp, target)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _load_cache(jsonl_path: Path) -> tuple[str, np.ndarray] | None:
    """The legacy npz's freshness rule, two-tier: the stat fast path
    trusts the cache without reading the JSONL only when the JSONL's
    (size, mtime_ns) both match the stamp AND the cache file is strictly
    newer than the JSONL (so a rewrite within one mtime tick is never
    served stale); otherwise the content hash decides."""
    target = cache_path_for(jsonl_path)
    try:
        cache_mtime = os.stat(target).st_mtime_ns
        with np.load(target, allow_pickle=False) as z:
            meta = [str(x) for x in z["meta"]]
            rows = z["rows"]
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None
    if len(meta) == 4:
        workload, digest, size, mtime_ns = meta
        try:
            st = os.stat(jsonl_path)
        except OSError:
            return None
        if (
            str(st.st_size) == size
            and str(st.st_mtime_ns) == mtime_ns
            and cache_mtime > st.st_mtime_ns
        ):
            return workload, rows
    else:  # the older hash-only format
        workload, digest = meta[:2]
    if digest != _history_digest(jsonl_path):
        return None
    return workload, rows


def load_rows_cache(
    jsonl_path: str | Path,
) -> tuple[str, np.ndarray] | None:
    """``(workload, rows)`` when a fresh cache exists for this source;
    None when absent, unreadable or stale.  The ``.jtc`` first, then the
    legacy npz.  A corrupt ``.jtc`` is logged and counts as a miss."""
    from jepsen_tpu_torch.history import columnar

    jtc = columnar.consult(jsonl_path)
    if jtc is not None:
        rows = jtc.rows()
        if rows is not None and jtc.workload is not None:
            return jtc.workload, rows
    got = _load_cache(Path(jsonl_path))
    if got is None:
        return None
    workload, rows = got
    return workload, np.asarray(rows, np.int32)


def rows_with_cache(
    jsonl_path: str | Path, history=None
) -> tuple[str, np.ndarray, bool]:
    """Load-through cache: ``(workload, rows, was_hit)``.  A miss packs
    the source (the native packer first, which returns None on input it
    flags; then the Python path, which raises the canonical error) and
    leaves the cache behind.  Pass ``history`` when the caller already
    parsed the ops: a miss then skips the parse."""
    from jepsen_tpu_torch.history.fastpack import pack_file
    from jepsen_tpu_torch.history.ops import workload_of
    from jepsen_tpu_torch.history.store import read_history

    cached = load_rows_cache(jsonl_path)
    if cached is not None:
        return (*cached, True)
    if history is None:
        fast = pack_file(jsonl_path)
        if fast is not None:
            workload, rows = fast
            save_rows_cache(jsonl_path, workload, rows)
            return workload, rows, False
        history = read_history(jsonl_path)
    workload = workload_of(history)
    rows = _rows_for(history)
    save_rows_cache(jsonl_path, workload, rows)
    return workload, rows, False
