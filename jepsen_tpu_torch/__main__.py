"""Command line of the port.

``python -m jepsen_tpu_torch check [--delivery …] [--serial] RUN_DIR…``
re-checks recorded queue histories: for each run directory (or
``history.jsonl`` file) it composes ``perf`` with total-queue (``queue``)
and per-value queue linearizability (``linear``), prints the result map
as JSON and the verdict banner, and writes into the run directory what
the JAX package's ``check`` writes there: ``results.json``, the two
``perf`` graphs (``latency-raw.png``, ``rate.png``) and the row cache
(``history.jtc``).  ``queue`` and ``linear`` come from the history file
through the pipeline executor (``parallel/pipeline.py``); ``--serial``
checks the parsed ops with the checker classes instead, with the same
result.  The delivery contract defaults to the one recorded in the
run's ``results.json``, else exactly-once, so that a re-check never
silently tightens a verdict.  Exit code: 0 when every run is valid, 1
when one is invalid, 3 when the verdict is unknown.

``python -m jepsen_tpu_torch bench-check --pipeline STORE`` classifies
every history under a store as the JAX command does (a file with no
fresh cache is parsed once, and its cache written), checks those of the
majority family through the pipeline executor (only the queue family is
ported; another raises) and prints one JSON line: counts, wall time, the
end-to-end rate, the executor's stage overlap, ``device_idle_frac``
(the JAX package's name for the share of wall time with no batch in
flight, which is not the card's own idle time), ``classify_s`` (the
classification before the run, outside ``wall_s``) and the device it
ran on.

Both take ``--device`` (default ``cuda``, which raises without a card;
``cpu`` runs the plain versions).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from jepsen_tpu_torch.checkers.protocol import UNKNOWN, VALID, compose, merge_valid
from jepsen_tpu_torch.checkers.queue_lin import DELIVERIES
from jepsen_tpu_torch.history.ops import workload_of
from jepsen_tpu_torch.history.store import (
    HISTORY_FILE,
    RESULTS_FILE,
    json_default,
    read_history,
    save_results,
)

GOOD_BANNER = "Everything looks good! ヽ('ー`)ノ"
INVALID_BANNER = "Analysis invalid! ಠ~ಠ"
UNKNOWN_BANNER = "Analysis result unknown ¯\\_(ツ)_/¯"


def _history_path(path: Path) -> Path:
    if path.is_file():
        return path
    if (path / HISTORY_FILE).is_file():
        return path / HISTORY_FILE
    raise FileNotFoundError(f"no {HISTORY_FILE} under {path}")


def _checker_for(hpath: Path, delivery: str, device: str, serial: bool):
    """``perf`` + ``queue`` + ``linear``, as the JAX package's
    ``_checker_for`` composes them for a queue history."""
    from jepsen_tpu_torch.checkers.perf import Perf

    if serial:
        from jepsen_tpu_torch.checkers.queue_lin import QueueLinearizability
        from jepsen_tpu_torch.checkers.total_queue import TotalQueue

        family = {
            "queue": TotalQueue(device=device),
            "linear": QueueLinearizability(delivery=delivery, device=device),
        }
    else:
        from jepsen_tpu_torch.parallel.pipeline import PipelinedChecker

        shared: dict = {}
        family = {
            sub: PipelinedChecker("queue", hpath, sub, shared=shared,
                                  delivery=delivery, device=device)
            for sub in ("queue", "linear")
        }
    return compose({"perf": Perf(out_dir=hpath.parent, device=device),
                    **family})


def check_run(path: Path, delivery: str | None, device: str,
              serial: bool = False) -> dict:
    """The composed ``perf`` + ``queue`` + ``linear`` result map of one
    recorded queue history, also written to the run's
    ``results.json``."""
    hpath = _history_path(path).resolve()
    try:
        prev = json.loads((hpath.parent / RESULTS_FILE).read_text())
    except (OSError, ValueError):
        prev = {}
    if prev.get("log-file-pattern"):
        # the JAX package re-scans the node logs then; dropping the scan
        # could turn a log-invalidated run valid
        raise NotImplementedError(
            f"{hpath.parent}: the run was judged with a log-file-pattern "
            "checker, which is not ported yet")
    history = read_history(hpath)
    workload = workload_of(history)
    if workload != "queue":
        raise NotImplementedError(
            f"{hpath}: a {workload} history; only the queue family is "
            "ported (ROADMAP.md, Open items §1)")
    if delivery is None:
        delivery = prev.get("linear", {}).get("delivery") or "exactly-once"
    checker = _checker_for(hpath, delivery, device, serial)
    t0 = time.perf_counter()
    result = checker.check({}, history)
    dt = time.perf_counter() - t0
    print(f"# checked {len(history)} ops on {device} in {dt * 1e3:.1f} ms",
          file=sys.stderr)
    if "error" in result["perf"]["latency-graph"]:
        print(f"# perf: {result['perf']['latency-graph']['error']}; no "
              "graphs were written", file=sys.stderr)
    save_results(hpath.parent, result)
    return result


def _device_name(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _classify(paths) -> list[str]:
    """The workload of each file, as the JAX package's ``bench-check``
    classifies it: from a fresh cache, else by the native packer, whose
    rows are kept as the file's cache (so the check that follows reads
    them, and no file is parsed twice), else by the Python parse."""
    from jepsen_tpu_torch.history.fastpack import pack_files
    from jepsen_tpu_torch.history.rows import load_rows_cache, save_rows_cache

    kinds: list = [None] * len(paths)
    misses = []
    for i, p in enumerate(paths):
        got = load_rows_cache(p)
        if got is not None:
            kinds[i] = got[0]
        else:
            misses.append(i)
    for i, got in zip(misses, pack_files([paths[i] for i in misses])):
        if got is not None:
            save_rows_cache(paths[i], got[0], got[1])
            kinds[i] = got[0]
        else:
            kinds[i] = workload_of(read_history(paths[i]))
    return kinds


def bench_check_pipeline(
    store: str | Path,
    *,
    chunk: int = 64,
    serial: bool = False,
    delivery: str | None = None,
    fail_fast: bool = False,
    device: str = "cuda",
):
    """``bench-check --pipeline``: the histories of the majority family
    under ``store`` through
    :func:`~jepsen_tpu_torch.parallel.pipeline.check_sources`.
    Returns ``(summary, results, stats)``; ``summary`` is the JSON line
    the command prints."""
    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.history.store import history_paths
    from jepsen_tpu_torch.parallel.pipeline import check_sources

    dev = resolve_device(device)
    paths = history_paths(store)
    if not paths:
        raise FileNotFoundError(f"no histories under {store}")
    t0 = time.perf_counter()
    kinds = _classify(paths)
    classify_s = time.perf_counter() - t0
    print(f"# classified {len(paths)} histories in {classify_s:.3f} s",
          file=sys.stderr)
    # the majority family, as the JAX command picks it; one that is not
    # ported raises in check_sources, naming its ROADMAP.md item
    workload = max(sorted(set(kinds)), key=kinds.count)
    keep = [p for k, p in zip(kinds, paths) if k == workload]
    if len(keep) != len(paths):
        print(f"# mixed store: benching {len(keep)} {workload} histories, "
              f"skipping {len(paths) - len(keep)} of other families",
              file=sys.stderr)
    results, stats = check_sources(
        workload, keep, chunk=chunk, serial=serial, fail_fast=fail_fast,
        delivery=delivery or "exactly-once", device=dev,
    )
    n_invalid = sum(
        1 for r in results
        if not (r["queue"][VALID] is True and r["linear"][VALID] is True)
    )
    summary = {
        "histories": stats.histories,
        "batches": stats.batches,
        "mode": "serial" if serial else "pipeline",
        "lanes": stats.lanes,
        "dropped": stats.dropped,
        "wall_s": stats.wall_s,
        "pipeline_e2e_histories_per_sec":
            stats.histories / max(stats.wall_s, 1e-9),
        "stage_overlap_frac": stats.stage_overlap_frac,
        "device_idle_frac": stats.device_idle_frac,
        "invalid": n_invalid,
        "quarantined": stats.quarantined,
        "classify_s": classify_s,
        "device": _device_name(dev),
    }
    return summary, results, stats


def _banner(verdict) -> str:
    if verdict is True:
        return GOOD_BANNER
    return UNKNOWN_BANNER if verdict == UNKNOWN else INVALID_BANNER


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="re-check recorded queue histories")
    c.add_argument("runs", nargs="+", type=Path, metavar="RUN_DIR",
                   help="run directory or history.jsonl")
    c.add_argument("--delivery", choices=DELIVERIES, default=None,
                   help="the queue's delivery contract (default: the one "
                   "recorded in results.json, else exactly-once)")
    c.add_argument("--serial", action="store_true",
                   help="check the parsed ops with the checker classes, "
                   "not the history file through the pipeline executor "
                   "(same results)")
    b = sub.add_parser("bench-check",
                       help="check the histories under a store (queue family)")
    b.add_argument("store", type=Path, metavar="STORE",
                   help="directory tree holding history.jsonl files")
    b.add_argument("--pipeline", action="store_true", required=True,
                   help="through the pipeline executor (the only mode "
                   "ported)")
    b.add_argument("--serial", action="store_true",
                   help="run the same stages one after another, without "
                   "overlap (same results)")
    b.add_argument("--chunk", type=int, default=64,
                   help="histories per pipeline chunk (default 64)")
    b.add_argument("--delivery", choices=DELIVERIES, default=None,
                   help="the queue's delivery contract (default "
                   "exactly-once)")
    b.add_argument("--fail-fast", dest="fail_fast", action="store_true",
                   help="abort on any stage failure instead of "
                   "quarantining the history")
    for sp in (c, b):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "plain versions)")
    args = p.parse_args(argv)

    if args.cmd == "bench-check":
        summary, _, _ = bench_check_pipeline(
            args.store, chunk=args.chunk, serial=args.serial,
            delivery=args.delivery, fail_fast=args.fail_fast,
            device=args.device,
        )
        print("# device_idle_frac: the share of wall time with no batch "
              "in flight, not the card's own idle time", file=sys.stderr)
        print(json.dumps(summary))
        return 0
    verdicts = []
    for run in args.runs:
        result = check_run(run, args.delivery, args.device, args.serial)
        print(json.dumps(result, indent=1, default=json_default))
        print(_banner(result[VALID]))
        verdicts.append(result[VALID])
    verdict = merge_valid(verdicts)
    return 0 if verdict is True else 3 if verdict == UNKNOWN else 1


if __name__ == "__main__":
    sys.exit(main())
