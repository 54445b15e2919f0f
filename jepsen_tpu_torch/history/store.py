"""Reading and writing recorded histories and their analysis results.

A run directory holds the recorded history (``history.jsonl``, or
jepsen's ``history.edn``) and the analysis results (``results.json``).
A store is a tree of run directories, ``<root>/<test-name>/<timestamp>/``,
with ``current`` and ``latest`` links to the newest run (:class:`Store`);
:func:`history_paths` walks it.  The port's counterpart of the JAX
package's ``history/store.py``.
"""

from __future__ import annotations

import json
import os
import time as _time
from pathlib import Path
from typing import Any, Iterable, Sequence

from jepsen_tpu_torch.history.ops import Op

HISTORY_FILE = "history.jsonl"
RESULTS_FILE = "results.json"
EDN_FILE = "history.edn"


def write_history_jsonl(path: str | Path, history: Iterable[Op]) -> None:
    with open(path, "w") as fh:
        for op in history:
            fh.write(json.dumps(op.to_json()) + "\n")


def read_history(path: str | Path) -> list[Op]:
    """Read a history file by format: jepsen ``*.edn`` or JSONL."""
    p = Path(path)
    if p.suffix == ".edn":
        from jepsen_tpu_torch.history.edn import read_history_edn

        return read_history_edn(p)
    return read_history_jsonl(p)


def read_history_jsonl(path: str | Path) -> list[Op]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(Op.from_json(json.loads(line)))
    return out


def history_paths(root: str | Path) -> list[Path]:
    """Every stored history under ``root``: each ``history.jsonl``,
    sorted, then each ``history.edn`` that has no ``history.jsonl``
    beside it (an exported twin of a JSONL run is not loaded twice), as
    the JAX package's store walk orders them."""
    root = Path(root)
    return sorted(root.glob(f"**/{HISTORY_FILE}")) + [
        p
        for p in sorted(root.glob(f"**/{EDN_FILE}"))
        if not (p.parent / HISTORY_FILE).exists()
    ]


def resolve_history_path(path: str | Path) -> Path:
    """A history file (JSONL or EDN), a run directory, or a store root,
    which resolves to its ``latest`` run: the history to check.  Raises
    ``FileNotFoundError`` when there is none."""
    path = Path(path)
    if path.is_file():
        return path
    for name in (HISTORY_FILE, EDN_FILE):
        if (path / name).is_file():
            return path / name
        latest = path / "latest"
        if latest.exists() and (latest / name).is_file():
            return (latest / name).resolve()
    raise FileNotFoundError(f"no {HISTORY_FILE} (or {EDN_FILE}) under {path}")


def _pack_jtc(src: Path, history: Sequence[Op]) -> None:
    """Cut the row section of the sibling ``.jtc`` at record time, so that
    the first re-check maps it and skips the parse.  Best-effort: the
    history itself is already on disk.  The port computes the row section
    of every family; the stream, elle and mutex sections come with their
    checkers."""
    from jepsen_tpu_torch.history import columnar
    from jepsen_tpu_torch.history.ops import workload_of
    from jepsen_tpu_torch.history.rows import _rows_for

    try:
        columnar.write_jtc(src, workload_of(history), rows=_rows_for(history))
    except Exception:  # noqa: BLE001 - the cache is an optimization only
        pass


class Store:
    """``<root>/<test-name>/<timestamp>/`` run directories with
    ``current``/``latest`` links to the newest run that recorded a
    history."""

    def __init__(self, root: str | Path = "store"):
        self.root = Path(root)

    def run_dir(self, test_name: str, timestamp: str | None = None) -> Path:
        ts = timestamp or _time.strftime("%Y%m%dT%H%M%S")
        d = self.root / test_name / ts
        n = 1
        while d.exists():  # two runs in one second get their own dirs
            d = self.root / test_name / f"{ts}-{n}"
            n += 1
        d.mkdir(parents=True)
        # the links move when a history is saved, so that a run that
        # records nothing never takes `latest` from one that did
        return d

    def link_run(self, test_name: str, d: Path) -> None:
        self._relink(self.root / test_name / "current", d)
        self._relink(self.root / "current", d)
        self._relink(self.root / "latest", d)

    @staticmethod
    def _relink(link: Path, target: Path) -> None:
        link.parent.mkdir(parents=True, exist_ok=True)
        if link.is_symlink() or link.exists():
            link.unlink()
        os.symlink(target.resolve(), link)

    def save_history(self, run_dir: Path, history: Sequence[Op]) -> Path:
        p = run_dir / HISTORY_FILE
        write_history_jsonl(p, history)
        _pack_jtc(p, history)
        self.link_run(run_dir.parent.name, run_dir)
        return p

    def save_history_edn(self, run_dir: Path, history: Sequence[Op]) -> Path:
        """The same, in jepsen's layout; the ``.jtc`` is stamped against
        the EDN bytes unless a JSONL history (which keeps the run
        directory's one ``.jtc``) is beside it."""
        from jepsen_tpu_torch.history.edn import write_history_edn

        p = run_dir / EDN_FILE
        write_history_edn(p, history)
        if not (run_dir / HISTORY_FILE).exists():
            _pack_jtc(p, history)
        self.link_run(run_dir.parent.name, run_dir)
        return p


def save_results(run_dir: str | Path, results: dict[str, Any]) -> Path:
    """Write ``results.json`` into a run directory (sets and arrays
    serialized)."""
    p = Path(run_dir) / RESULTS_FILE
    with open(p, "w") as fh:
        json.dump(results, fh, indent=2, default=json_default)
    return p


def json_default(o: Any):
    """``json.dumps`` hook for result maps: sets render as sorted lists,
    arrays as lists, numpy scalars as numbers."""
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    if hasattr(o, "tolist"):
        return o.tolist()
    if hasattr(o, "item"):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o)}")
