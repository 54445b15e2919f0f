"""The store-level packed cache of the queue family.

A re-check of a whole store reads one small cache per history
(``history/rows.py``) and then assembles the batch.  Both are pure
functions of the history set, so the assembled :class:`PackedHistories`
columns are kept once per store root as ``packed_store.npz``; a later
``bench-check`` loads nine arrays from one file and goes straight to the
device.

The port's counterpart of the queue half of the JAX package's
``history/storecache.py``: the same file name, fields, dtypes and
freshness rule, so that a store cached by either package serves the
other.  Where the JAX package builds device arrays from the file, the
port builds CPU tensors, which the caller places.  The stream, elle and
mutex caches come with those families.

Freshness: the cache stamps every member ``(relpath, size, mtime_ns)``;
a load stats the same files (no reads) and rejects the cache on any
difference, additions, removals and reordering included, and requires
the cache file to be strictly newer than every member, so that a member
rewritten within the stamp's mtime tick is never served stale.  A
rejected cache falls through to the per-file layer.  Writes are atomic
(temp + rename) and best-effort.
"""

from __future__ import annotations

import os
import threading
import zipfile
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

STORE_CACHE = "packed_store.npz"

#: array fields of PackedHistories, in constructor order
_FIELDS = (
    "index",
    "process",
    "type",
    "f",
    "value",
    "time_ms",
    "latency_ms",
    "mask",
    "first",
)


def _fingerprint(paths: Sequence[str | Path], root: Path) -> np.ndarray:
    rows = []
    for p in paths:
        p = Path(p)
        st = os.stat(p)
        try:
            rel = str(p.resolve().relative_to(root.resolve()))
        except ValueError:
            rel = str(p.resolve())
        rows.append(f"{rel}\x00{st.st_size}\x00{st.st_mtime_ns}")
    return np.array(rows)


def save_packed_store_cache(
    store_root: str | Path, paths: Sequence[str | Path], packed
) -> None:
    """Keep the assembled columns of ``packed`` for exactly this file
    set (order included)."""
    root = Path(store_root)
    target = root / STORE_CACHE
    tmp = root / f"{STORE_CACHE}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        arrays = {
            name: getattr(packed, name).cpu().numpy() for name in _FIELDS
        }
        with open(tmp, "wb") as fh:
            np.savez(
                fh,
                fingerprint=_fingerprint(paths, root),
                value_space=np.int64(packed.value_space),
                **arrays,
            )
        os.replace(tmp, target)
    except (OSError, ValueError):
        try:
            os.unlink(tmp)
        except OSError:
            pass


def load_packed_store_cache(
    store_root: str | Path, paths: Sequence[str | Path]
):
    """The cached :class:`PackedHistories`, as CPU tensors, when it is
    fresh for exactly this file set (order included); else None."""
    from jepsen_tpu_torch.history.encode import PackedHistories

    root = Path(store_root)
    target = root / STORE_CACHE
    try:
        cache_mtime = os.stat(target).st_mtime_ns
        for p in paths:
            if os.stat(p).st_mtime_ns >= cache_mtime:
                return None  # a member as new as the cache: same tick
        with np.load(target, allow_pickle=False) as z:
            stamp = z["fingerprint"]
            current = _fingerprint(paths, root)
            if stamp.shape != current.shape or not (stamp == current).all():
                return None
            cols = {name: torch.from_numpy(z[name]) for name in _FIELDS}
            return PackedHistories(
                **cols, value_space=int(z["value_space"])
            )
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None
