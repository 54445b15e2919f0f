"""Reading and writing recorded histories and their analysis results.

A run directory holds the recorded history (``history.jsonl``) and the
analysis results (``results.json``).  A store is a tree of run
directories; :func:`history_paths` walks it.  The port reads JSONL
histories only: jepsen's EDN format (``history.edn``) needs an EDN
reader, which is not ported yet, and every reader here refuses such a
file by name rather than skipping it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable

from jepsen_tpu_torch.history.ops import Op

HISTORY_FILE = "history.jsonl"
RESULTS_FILE = "results.json"
EDN_FILE = "history.edn"


def _refuse_edn(path: Path) -> None:
    raise NotImplementedError(
        f"{path}: an EDN history; the port's EDN reader (the counterpart of "
        "jepsen_tpu/history/edn.py) is not ported yet (ROADMAP.md, Open "
        "items §1)"
    )


def write_history_jsonl(path: str | Path, history: Iterable[Op]) -> None:
    with open(path, "w") as fh:
        for op in history:
            fh.write(json.dumps(op.to_json()) + "\n")


def read_history(path: str | Path) -> list[Op]:
    """Read a history file by format.  JSONL only: an ``.edn`` file
    raises ``NotImplementedError``."""
    p = Path(path)
    if p.suffix == ".edn":
        _refuse_edn(p)
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
    """Every stored history under ``root``, sorted: each
    ``history.jsonl``.  An EDN history without a JSONL twin in its run
    directory raises ``NotImplementedError``."""
    root = Path(root)
    for p in sorted(root.glob(f"**/{EDN_FILE}")):
        if not (p.parent / HISTORY_FILE).exists():
            _refuse_edn(p)
    return sorted(root.glob(f"**/{HISTORY_FILE}"))


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
