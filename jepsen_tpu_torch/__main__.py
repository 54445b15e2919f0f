"""Command line: ``python -m jepsen_tpu_torch check [--delivery …] RUN_DIR…``.

``check`` re-checks recorded queue histories: for each run directory (or
``history.jsonl`` file) it runs total-queue (``queue``) and per-value
queue linearizability (``linear``) on the card, prints the composed
result map as JSON and the verdict banner.  The delivery contract
defaults to the one recorded in the run's ``results.json``, else
exactly-once, so a re-check never silently tightens a verdict.  The exit
code is 0 when every run is valid, 1 otherwise.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from jepsen_tpu_torch.checkers.fused import check_queue_batch
from jepsen_tpu_torch.checkers.protocol import VALID, merge_valid
from jepsen_tpu_torch.checkers.queue_lin import DELIVERIES
from jepsen_tpu_torch.history.ops import workload_of
from jepsen_tpu_torch.history.store import (
    HISTORY_FILE,
    RESULTS_FILE,
    json_default,
    read_history_jsonl,
)

GOOD_BANNER = "Everything looks good! ヽ('ー`)ノ"
INVALID_BANNER = "Analysis invalid! ಠ~ಠ"


def _history_path(path: Path) -> Path:
    if path.is_file():
        return path
    if (path / HISTORY_FILE).is_file():
        return path / HISTORY_FILE
    raise FileNotFoundError(f"no {HISTORY_FILE} under {path}")


def check_run(path: Path, delivery: str | None, device: str) -> dict:
    """The composed ``queue`` + ``linear`` result map of one recorded
    queue history."""
    hpath = _history_path(path)
    history = read_history_jsonl(hpath)
    workload = workload_of(history)
    if workload != "queue":
        raise ValueError(f"{hpath}: a {workload} history; only queue is ported")
    if delivery is None:
        try:
            prev = json.loads((hpath.parent / RESULTS_FILE).read_text())
        except (OSError, ValueError):
            prev = {}
        delivery = prev.get("linear", {}).get("delivery") or "exactly-once"
    # one pack and one stats pass for both verdicts
    result = check_queue_batch([history], delivery, device)[0]
    result[VALID] = merge_valid(r[VALID] for r in result.values())
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="re-check recorded queue histories")
    c.add_argument("runs", nargs="+", type=Path, metavar="RUN_DIR",
                   help="run directory or history.jsonl")
    c.add_argument("--delivery", choices=DELIVERIES, default=None,
                   help="the queue's delivery contract (default: the one "
                   "recorded in results.json, else exactly-once)")
    c.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                   "version)")
    args = p.parse_args(argv)

    verdicts = []
    for run in args.runs:
        result = check_run(run, args.delivery, args.device)
        print(json.dumps(result, indent=1, default=json_default))
        print(GOOD_BANNER if result[VALID] is True else INVALID_BANNER)
        verdicts.append(result[VALID])
    return 0 if merge_valid(verdicts) is True else 1


if __name__ == "__main__":
    sys.exit(main())
