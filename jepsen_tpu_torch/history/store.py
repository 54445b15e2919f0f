"""Reading and writing recorded histories as JSONL.

A run directory holds the recorded history (``history.jsonl``) and the
analysis results (``results.json``) that the JAX package's ``check``
wrote for it.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable

from jepsen_tpu_torch.history.ops import Op

HISTORY_FILE = "history.jsonl"
RESULTS_FILE = "results.json"


def write_history_jsonl(path: str | Path, history: Iterable[Op]) -> None:
    with open(path, "w") as fh:
        for op in history:
            fh.write(json.dumps(op.to_json()) + "\n")


def read_history_jsonl(path: str | Path) -> list[Op]:
    out = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(Op.from_json(json.loads(line)))
    return out


def json_default(o: Any):
    """``json.dumps`` hook for result maps: sets render as sorted lists."""
    if isinstance(o, (set, frozenset)):
        return sorted(o)
    raise TypeError(f"not JSON serializable: {type(o)}")
