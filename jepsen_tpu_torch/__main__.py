"""Command line of the port.

``python -m jepsen_tpu_torch check [--delivery …] [--serial] HISTORY…``
re-checks recorded queue histories.  Each HISTORY is a history file
(JSONL or EDN), a run directory, or a store root, which resolves to its
``latest`` run.  It composes ``perf`` with total-queue (``queue``) and
per-value queue linearizability (``linear``), prints the result map as
JSON and the verdict banner, and writes into the run directory what the
JAX package's ``check`` writes there: ``results.json``, the two ``perf``
graphs (``latency-raw.png``, ``rate.png``) and the row cache
(``history.jtc``).  ``queue`` and ``linear`` come from the history file
through the pipeline executor (``parallel/pipeline.py``); ``--serial``
checks the parsed ops with the checker classes instead, with the same
result.  The delivery contract defaults to the one recorded in the
run's ``results.json``, else exactly-once, so that a re-check never
silently tightens a verdict.  ``--segment-ops N [--resume]`` streams the
history through the segmented engine (``checkers/segmented.py``) instead:
bounded memory, a checkpoint after every segment, the same verdicts.

``python -m jepsen_tpu_torch bench-check`` checks a batch of queue
histories in one packed call (K1 and both classifiers) and prints one
JSON line of counts and times: synthetic ones (``--count``/``--ops``,
one lost value each), or those under a store (``--histories STORE``),
through the store-level packed cache, with ``--workers`` processes
packing rows.  ``bench-check --pipeline STORE`` instead replays the
store through the pipeline executor, as the JAX command does.

``python -m jepsen_tpu_torch synth`` writes synthetic queue histories
into a store, as JSONL or EDN.

``python -m jepsen_tpu_torch serve-checker`` runs the checker service
(``service/server.py``) until SIGINT: ``check`` requests and streamed
histories from many clients, with ``--batch`` coalescing streams'
segments into K1 launches on ``[B, L]`` stacks.

``check``, ``bench-check`` and ``serve-checker`` take ``--device``
(default ``cuda``; ``cpu`` runs the plain versions).  Exit codes: 0
valid (or a server stopped by SIGINT), 1 invalid, 3 unknown; 2 for a
usage or environment error (a missing history, a family or option that
is not ported, no card for ``--device cuda``, a kernel that does not
build or launch, a CUDA error), with a one-line ``error: …`` on stderr.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

from jepsen_tpu_torch.checkers.protocol import UNKNOWN, VALID, compose, merge_valid
from jepsen_tpu_torch.checkers.queue_lin import DELIVERIES
from jepsen_tpu_torch.history.encode import TENSOR_FIELDS
from jepsen_tpu_torch.history.ops import workload_of
from jepsen_tpu_torch.history.store import (
    RESULTS_FILE,
    json_default,
    read_history,
    resolve_history_path,
    save_results,
)

GOOD_BANNER = "Everything looks good! ヽ('ー`)ノ"
INVALID_BANNER = "Analysis invalid! ಠ~ಠ"
UNKNOWN_BANNER = "Analysis result unknown ¯\\_(ツ)_/¯"


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


def _recorded_results(hpath: Path) -> dict:
    try:
        return json.loads((hpath.parent / RESULTS_FILE).read_text())
    except (OSError, ValueError):
        return {}


def check_run(path: Path, delivery: str | None, device: str,
              serial: bool = False) -> dict:
    """The composed ``perf`` + ``queue`` + ``linear`` result map of one
    recorded queue history, also written to the run's
    ``results.json``."""
    hpath = resolve_history_path(path).resolve()
    prev = _recorded_results(hpath)
    if prev.get("log-file-pattern"):
        # the JAX package re-scans the node logs then; dropping the scan
        # could turn a log-invalidated run valid
        raise NotImplementedError(
            f"{hpath.parent}: the run was judged with a log-file-pattern "
            "checker, which is not ported yet")
    history = read_history(hpath)
    workload = workload_of(history)
    _refuse_family(workload, "check")
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


def _classify(paths, keep_rows: bool = False):
    """The workload of each file, as the JAX package's ``bench-check``
    classifies it: from a fresh cache, else by the native packer, whose
    rows are kept as the file's cache (so the check that follows reads
    them, and no file is parsed twice), else by the Python parse.
    Returns ``(kinds, rows)``; with ``keep_rows``, ``rows[i]`` is queue
    file i's row matrix, read once, and None for other families."""
    from jepsen_tpu_torch.history.fastpack import pack_files
    from jepsen_tpu_torch.history.rows import (
        load_rows_cache,
        rows_with_cache,
        save_rows_cache,
    )

    t0 = time.perf_counter()
    kinds: list = [None] * len(paths)
    rows: list = [None] * len(paths)
    misses = []
    for i, p in enumerate(paths):
        got = load_rows_cache(p)
        if got is None:
            misses.append(i)
        else:
            kinds[i] = got[0]
            rows[i] = got[1] if keep_rows else None
    n_fast = 0
    for i, got in zip(misses, pack_files([paths[i] for i in misses])):
        if got is not None:
            save_rows_cache(paths[i], got[0], got[1])
            kinds[i] = got[0]
            rows[i] = got[1] if keep_rows else None
            n_fast += 1
        else:
            history = read_history(paths[i])
            kinds[i] = workload_of(history)
            if keep_rows and kinds[i] == "queue":
                rows[i] = rows_with_cache(paths[i], history=history)[1]
    print(f"# classified {len(paths)} histories in "
          f"{time.perf_counter() - t0:.3f} s ({len(paths) - len(misses)} "
          f"from the packed-row cache, {n_fast} native-packed)",
          file=sys.stderr)
    return kinds, [r if k == "queue" else None
                   for k, r in zip(kinds, rows)]


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
    kinds, _ = _classify(paths)
    classify_s = time.perf_counter() - t0
    workload, keep = _majority_family(kinds, paths, store)
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


class UsageError(Exception):
    """An argument out of its range."""


def _refuse_family(workload: str, what: str) -> None:
    from jepsen_tpu_torch.parallel.pipeline import NOT_PORTED

    if workload in NOT_PORTED:
        raise NotImplementedError(
            f"{what} of {workload} histories is not ported yet "
            f"(ROADMAP.md, {NOT_PORTED[workload]})")


def _majority_family(kinds, items, src, workload: str = "auto"):
    """The family to bench (the majority where ``workload`` is auto, as
    the JAX command picks it) and the items of that family, with the
    mixed-store note.  A family not ported raises, naming its
    ROADMAP.md item."""
    if workload == "auto":
        workload = max(sorted(set(kinds)), key=kinds.count)
    _refuse_family(workload, "bench-check")
    keep = [item for kind, item in zip(kinds, items) if kind == workload]
    if len(keep) != len(items):
        print(f"# mixed store: benching {len(keep)} {workload} histories, "
              f"skipping {len(items) - len(keep)} of other families",
              file=sys.stderr)
    if not keep:
        raise FileNotFoundError(f"no {workload} histories under {src}")
    return workload, keep


def _available_workers(workers: int) -> int:
    """``workers`` capped to the cores this process may run on; 0 (serial)
    where only one is."""
    if workers < 0:
        raise UsageError(f"--workers must be >= 0, got {workers}")
    avail = len(os.sched_getaffinity(0))
    if workers > avail:
        print(f"# --workers {workers} capped to {avail} available "
              f"core(s){' — running serially' if avail <= 1 else ''}",
              file=sys.stderr)
        return avail if avail > 1 else 0
    return workers


def _profiler(profile, dev):
    """A ``torch.profiler`` session over the pack and the check, with the
    card's activity where the check runs on it; a null context without
    ``profile``."""
    if not profile:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch_profile(activities=acts)


#: the Chrome trace ``bench-check --profile DIR`` writes under DIR
PROFILE_TRACE = "bench_check_trace.json"


def bench_check(
    histories: str | Path | None = None,
    *,
    count: int = 256,
    ops: int = 470,
    workload: str = "auto",
    workers: int = 0,
    profile: str | Path | None = None,
    device: str = "cuda",
) -> dict:
    """``bench-check`` without ``--pipeline``: one batch of queue
    histories (synthetic, or those under ``histories``) packed and
    checked in one call, exactly-once, as the JAX command does (it reads
    ``--delivery`` only with ``--pipeline``).  Returns the JSON line the
    command prints."""
    from jepsen_tpu_torch.checkers.fused import combined_tensor_check
    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.history.encode import pack_histories, pack_row_matrices
    from jepsen_tpu_torch.history.store import history_paths
    from jepsen_tpu_torch.history.storecache import (
        load_packed_store_cache,
        save_packed_store_cache,
    )

    dev = resolve_device(device)
    workers = _available_workers(workers)
    if not histories and workload not in ("auto", "queue"):
        _refuse_family(workload, "bench-check")
    mats = synth = packed_pre = None
    t_produce = None  # the workers' synth/read and row explosion
    store_cache_dst = None  # (root, paths) to keep after a fresh pack
    paths: list = []
    if histories:
        paths = history_paths(histories)
        if not paths:
            raise FileNotFoundError(f"no histories under {histories}")
        if workload in ("auto", "queue"):
            t0 = time.perf_counter()
            packed_pre = load_packed_store_cache(histories, paths)
            if packed_pre is not None:
                print(f"# store cache hit: {packed_pre.batch} packed "
                      f"histories in {time.perf_counter() - t0:.2f}s (no "
                      f"per-file reads, no assembly)", file=sys.stderr)
    if packed_pre is not None:
        pass
    elif workers and not histories:
        from jepsen_tpu_torch.history.parpack import synth_queue_rows_parallel

        t0 = time.perf_counter()
        mats = synth_queue_rows_parallel(count, ops, lost=1, workers=workers)
        t_produce = time.perf_counter() - t0
        print(f"# {workers} workers synthesized+exploded {len(mats)} "
              f"histories in {t_produce:.1f}s", file=sys.stderr)
    elif workers and workload in ("auto", "queue"):
        from jepsen_tpu_torch.history.parpack import read_rows_parallel

        t0 = time.perf_counter()
        tagged = read_rows_parallel(paths, workers)
        t_produce = time.perf_counter() - t0
        workload, mats = _majority_family(
            [kind for kind, _m in tagged], [m for _k, m in tagged],
            histories, workload)
        print(f"# {workers} workers read+exploded {len(tagged)} stored "
              f"histories in {t_produce:.1f}s", file=sys.stderr)
    elif histories:
        kinds, rows = _classify(paths, keep_rows=True)
        workload, mats = _majority_family(kinds, rows, histories, workload)
    else:
        from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch

        synth = [sh.ops for sh in synth_batch(count, SynthSpec(n_ops=ops),
                                              lost=1)]
        print(f"# generated {len(synth)} synthetic histories",
              file=sys.stderr)
    if histories and mats is not None and len(mats) == len(paths):
        # a store of queue histories only: keep the assembled columns, so
        # that the next re-check skips the per-file reads and the assembly
        store_cache_dst = (histories, paths)

    with _profiler(profile, dev) as prof:
        t0 = time.perf_counter()
        if packed_pre is not None:
            packed = dataclasses.replace(packed_pre, **{
                k: getattr(packed_pre, k).to(dev) for k in TENSOR_FIELDS})
        elif mats is not None:
            packed = pack_row_matrices(mats, device=dev)
        else:
            packed = pack_histories(synth, device=dev)
        t_pack = time.perf_counter() - t0
        if store_cache_dst is not None:
            save_packed_store_cache(*store_cache_dst, packed)
        combined_tensor_check(packed)  # warm-up
        _sync(dev)
        t1 = time.perf_counter()
        tq, ql = combined_tensor_check(packed)
        _sync(dev)
        t_check = time.perf_counter() - t1
    n_invalid = int((~(tq.valid & ql.valid)).sum())
    if profile:
        Path(profile).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(profile) / PROFILE_TRACE))
        print(f"# wrote profiler trace under {profile}", file=sys.stderr)
    n_hist = packed.batch
    return {
        "histories": n_hist,
        "ops_per_history": packed.length,
        **({"produce_s": t_produce} if t_produce is not None else {}),
        "pack_s": t_pack,
        "check_s": t_check,
        "histories_per_sec": n_hist / max(t_check, 1e-9),
        "invalid": n_invalid,
        "device": _device_name(dev),
    }


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def synth(
    store: str | Path,
    *,
    count: int = 16,
    ops: int = 470,
    lost: int = 0,
    duplicated: int = 0,
    unexpected: int = 0,
    fmt: str = "jsonl",
    workload: str = "queue",
) -> list[Path]:
    """Write ``count`` synthetic queue histories into ``store``, one run
    directory each under ``synth/`` (as JSONL, or EDN with
    ``fmt="edn"``), as the JAX command does.  Returns the history
    files."""
    from jepsen_tpu_torch.history.store import Store
    from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch

    _refuse_family(workload, "synth")
    st = Store(store)
    shs = synth_batch(count, SynthSpec(n_ops=ops), lost=lost,
                      duplicated=duplicated, unexpected=unexpected)
    out = []
    for i, sh in enumerate(shs):
        d = st.run_dir("synth", f"{time.strftime('%Y%m%dT%H%M%S')}-{i:04d}")
        if fmt == "edn":
            out.append(st.save_history_edn(d, sh.ops))
        else:
            out.append(st.save_history(d, sh.ops))
    return out


def check_segmented(path: Path, args) -> dict:
    """``check --segment-ops N``: one history through the segmented
    engine, its result written to the run's ``results.json``."""
    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.obs.metrics import REGISTRY
    from jepsen_tpu_torch.parallel.pipeline import (
        NOT_PORTED,
        check_source_segmented,
    )

    if args.carry_cap is not None:
        raise NotImplementedError(
            "--carry-cap bounds the mutex family's open-class carry, which "
            f"is not ported yet (ROADMAP.md, {NOT_PORTED['mutex']}); the "
            "queue family's carry is unbounded")
    dev = resolve_device(args.device)
    hpath = resolve_history_path(path).resolve()
    # a re-check inherits the delivery contract the run was judged at
    delivery = args.delivery or _recorded_results(hpath).get(
        "linear", {}).get("delivery")
    t0 = time.perf_counter()
    result, _stats = check_source_segmented(
        None, hpath, segment_ops=args.segment_ops, resume=args.resume,
        device=dev, delivery=delivery, prefix_index=args.prefix_index,
    )
    dt = time.perf_counter() - t0
    meta = result["segmented"]
    sk = REGISTRY.sketch("segmented.segment_check_s")
    resumed = (f", resumed from segment {meta['resumed_from']}"
               if meta.get("resumed") else "")
    print(f"# segmented check: {meta['ops']} ops in {meta['segments']} "
          f"segments of {meta['segment_ops']} in {dt:.2f} s (segment p50 "
          f"{sk.quantile(0.5) * 1e3:.1f} ms / p99 "
          f"{sk.quantile(0.99) * 1e3:.1f} ms{resumed})", file=sys.stderr)
    pfx = meta.get("resumed_from_prefix")
    if pfx:
        print(f"# fleet memory: resumed from prefix anchor @ segment "
              f"{pfx['segment_idx']} (offset {pfx['offset']}, "
              f"{pfx['substrate']})", file=sys.stderr)
    if meta.get("quarantined-segments"):
        print(f"# QUARANTINED: {meta['quarantined-segments']} poisoned "
              "segment(s) — verdict capped at unknown with evidence",
              file=sys.stderr)
    save_results(hpath.parent, result)
    return result


def _banner(verdict) -> str:
    if verdict is True:
        return GOOD_BANNER
    return UNKNOWN_BANNER if verdict == UNKNOWN else INVALID_BANNER


def _cmd_check(args) -> int:
    verdicts = []
    for run in args.runs:
        if args.segment_ops:
            result = check_segmented(run, args)
        else:
            result = check_run(run, args.delivery, args.device, args.serial)
        print(json.dumps(result, indent=1, default=json_default))
        print(_banner(result[VALID]))
        verdicts.append(result[VALID])
    verdict = merge_valid(verdicts)
    return 0 if verdict is True else 3 if verdict == UNKNOWN else 1


def _cmd_bench_check(args) -> int:
    from jepsen_tpu_torch.parallel.pipeline import (
        MULTI_NOT_PORTED,
        NOT_PORTED,
    )

    if args.engine:
        raise NotImplementedError(
            "--engine selects the mutex family's engine, which is not "
            f"ported yet (ROADMAP.md, {NOT_PORTED['mutex']})")
    if args.mesh or args.lanes is not None or args.reduce:
        raise NotImplementedError(
            "--mesh, --lanes and --reduce are not ported yet (ROADMAP.md, "
            f"{MULTI_NOT_PORTED})")
    histories = args.histories or args.store
    if args.pipeline and histories:
        summary, _, _ = bench_check_pipeline(
            histories, chunk=args.chunk, serial=args.serial,
            delivery=args.delivery, fail_fast=args.fail_fast,
            device=args.device,
        )
        print("# device_idle_frac: the share of wall time with no batch "
              "in flight, not the card's own idle time", file=sys.stderr)
    else:
        summary = bench_check(
            histories, count=args.count, ops=args.ops,
            workload=args.workload, workers=args.workers,
            profile=args.profile, device=args.device,
        )
    print(json.dumps(summary))
    return 0


def _cmd_serve_checker(args) -> int:
    from jepsen_tpu_torch.parallel.pipeline import MULTI_NOT_PORTED
    from jepsen_tpu_torch.service.server import serve_forever

    if args.seq != 1:
        raise NotImplementedError(
            f"--seq {args.seq}: sharding histories over a device mesh is "
            f"not ported yet (ROADMAP.md, {MULTI_NOT_PORTED})")
    buckets = []
    for part in str(args.warmup_buckets).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            length, space = part.split(":", 1)
            buckets.append((int(length), int(space)))
        except ValueError:
            raise UsageError(
                f"--warmup-buckets: {part!r} is not L:V") from None
    serve_forever(
        host=args.host, port=args.port, store=args.store,
        metrics_port=args.metrics_port, workers=args.workers,
        max_streams=args.max_streams, ingress_cap=args.ingress_cap,
        stream_deadline_s=args.stream_deadline,
        batch=args.batch, target_batch=args.target_batch,
        max_batch_wait_ms=args.max_batch_wait_ms,
        warmup=args.warmup, warmup_buckets=tuple(buckets),
        device=args.device,
    )
    return 0


def _cmd_synth(args) -> int:
    paths = synth(args.store, count=args.count, ops=args.ops,
                  lost=args.lost, duplicated=args.duplicated,
                  unexpected=args.unexpected, fmt=args.format,
                  workload=args.workload)
    print(f"wrote {len(paths)} histories under {args.store}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m jepsen_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("check", help="re-check recorded queue histories")
    c.add_argument("runs", nargs="+", type=Path, metavar="HISTORY",
                   help="history file (JSONL or EDN), run directory, or "
                   "store root (its latest run)")
    c.add_argument("--delivery", choices=DELIVERIES, default=None,
                   help="the queue's delivery contract (default: the one "
                   "recorded in results.json, else exactly-once)")
    c.add_argument("--serial", action="store_true",
                   help="check the parsed ops with the checker classes, "
                   "not the history file through the pipeline executor "
                   "(same results)")
    c.add_argument("--segment-ops", dest="segment_ops", type=int, default=0,
                   metavar="N",
                   help="stream the history N ops at a time through the "
                   "segmented engine: bounded memory, a checkpoint after "
                   "every segment beside the history, the same verdicts; "
                   "a poisoned segment makes the verdict unknown with "
                   "evidence")
    c.add_argument("--resume", action="store_true",
                   help="with --segment-ops: go on from the newest valid "
                   "checkpoint (a torn one is refused loudly and the "
                   "previous one, or a run from scratch, takes over)")
    c.add_argument("--carry-cap", dest="carry_cap", type=int, default=None,
                   metavar="OPS",
                   help="with --segment-ops: bound the mutex family's "
                   "open-class carry (not ported; the queue family's "
                   "carry is unbounded)")
    c.add_argument("--prefix-index", dest="prefix_index", default=None,
                   metavar="DIR",
                   help="with --segment-ops: fleet prefix resume; publish "
                   "every full-segment checkpoint into a content-keyed "
                   "index under DIR, and resume a re-submitted history "
                   "from the deepest anchor whose (prefix sha256, offset) "
                   "matches its bytes, to the verdict of a check from "
                   "scratch")
    c.set_defaults(fn=_cmd_check)

    b = sub.add_parser("bench-check",
                       help="check a batch of synthetic or stored histories")
    b.add_argument("store", nargs="?", type=Path, metavar="STORE",
                   help="with --pipeline: the store to replay (the same "
                   "as --histories)")
    b.add_argument("--histories", type=Path, default=None,
                   help="directory tree holding history files")
    b.add_argument("--count", type=int, default=256,
                   help="synthetic histories (default 256)")
    b.add_argument("--ops", type=int, default=470,
                   help="invocations per synthetic history (default 470)")
    b.add_argument("--workload",
                   choices=("auto", "queue", "stream", "elle", "mutex"),
                   default="auto")
    b.add_argument("--workers", type=int, default=0,
                   help="worker processes that synthesize or read and "
                   "explode rows (queue family; capped to the available "
                   "cores)")
    b.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the pack "
                   f"and the check to DIR/{PROFILE_TRACE}")
    b.add_argument("--pipeline", action="store_true",
                   help="replay the store through the pipeline executor")
    b.add_argument("--serial", action="store_true",
                   help="with --pipeline: run the same stages one after "
                   "another, without overlap (same results)")
    b.add_argument("--chunk", type=int, default=64,
                   help="with --pipeline: histories per chunk (default 64)")
    b.add_argument("--delivery", choices=DELIVERIES, default=None,
                   help="with --pipeline: the queue's delivery contract "
                   "(default exactly-once; without --pipeline the batch "
                   "is checked exactly-once, as the JAX command does)")
    b.add_argument("--fail-fast", dest="fail_fast", action="store_true",
                   help="with --pipeline: abort on any stage failure "
                   "instead of quarantining the history")
    b.add_argument("--engine", choices=("classic", "tensor", "pcomp"),
                   default=None, help="mutex family only (not ported)")
    b.add_argument("--mesh", action="store_true", help="not ported")
    b.add_argument("--lanes", type=int, default=None, metavar="N",
                   help="not ported")
    b.add_argument("--reduce", action="store_true", help="not ported")
    b.set_defaults(fn=_cmd_bench_check)
    for sp in (c, b):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "plain versions)")

    s = sub.add_parser("synth", help="write synthetic queue histories into "
                       "a store")
    s.add_argument("--format", choices=("jsonl", "edn"), default="jsonl",
                   help="history file format (edn: jepsen's own layout)")
    s.add_argument("--store", default="store", help="store root")
    s.add_argument("--workload",
                   choices=("queue", "stream", "elle", "mutex"),
                   default="queue")
    s.add_argument("--count", type=int, default=16)
    s.add_argument("--ops", type=int, default=470)
    s.add_argument("--lost", type=int, default=0)
    s.add_argument("--duplicated", type=int, default=0)
    s.add_argument("--unexpected", type=int, default=0)
    s.set_defaults(fn=_cmd_synth)

    sc = sub.add_parser(
        "serve-checker",
        help="run the checker service (check requests and streamed "
        "histories over TCP)")
    sc.add_argument("--host", default="0.0.0.0")
    sc.add_argument("--port", type=int, default=8640)
    sc.add_argument("--seq", type=int, default=1,
                    help="seq-parallel shards per history on a device mesh "
                    "(only 1: the mesh is not ported)")
    sc.add_argument("--store", default="store",
                    help="store root: seeds the verdict cache from its "
                    "recorded runs, and its ckpt_index/ feeds the prefix "
                    "index gauge")
    sc.add_argument("--metrics-port", dest="metrics_port", type=int,
                    default=9640,
                    help="Prometheus text /metrics endpoint; 0 = an "
                    "ephemeral port, -1 = off")
    sc.add_argument("--workers", type=int, default=2,
                    help="checker workers running streams' carry engines "
                    "(a dead worker's streams requeue onto survivors)")
    sc.add_argument("--max-streams", dest="max_streams", type=int,
                    default=256,
                    help="open streams admitted at once; opens past it are "
                    "rejected SATURATED")
    sc.add_argument("--ingress-cap", dest="ingress_cap", type=int,
                    default=1024,
                    help="blocks accepted and not yet checked, over all "
                    "streams; feeds past it are rejected SATURATED")
    sc.add_argument("--stream-deadline", dest="stream_deadline", type=float,
                    default=120.0,
                    help="seconds an open stream may sit idle before it is "
                    "quarantined as overdue")
    sc.add_argument("--batch", action="store_true",
                    help="continuous batching: coalesce ready segments of "
                    "all streams into shape-bucketed K1 launches on [B, L] "
                    "stacks, at the target size or the latency budget, "
                    "whichever comes first")
    sc.add_argument("--target-batch", dest="target_batch", type=int,
                    default=32,
                    help="--batch: segments per super-batch (the launch's "
                    "batch is the next power of two)")
    sc.add_argument("--max-batch-wait-ms", dest="max_batch_wait_ms",
                    type=float, default=25.0,
                    help="--batch: the longest a bucket's oldest segment "
                    "waits before a partial batch is launched")
    sc.add_argument("--warmup", action="store_true",
                    help="--batch: at start, allocate each bucket's ring "
                    "and launch K1 once per bucket; hits and misses on "
                    "/metrics")
    sc.add_argument("--warmup-buckets", dest="warmup_buckets",
                    default="128:128,256:256",
                    help="--warmup: comma-separated L:V buckets")
    sc.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                    "versions, only when asked)")
    sc.set_defaults(fn=_cmd_serve_checker)
    return p


def _error(e: BaseException) -> int:
    """A usage or environment error: one ``error:`` line, then any further
    text (a compiler's output), and exit code 2."""
    head, _, rest = str(e).partition("\n")
    print(f"error: {head}", file=sys.stderr)
    if rest:
        print(rest, file=sys.stderr)
    return 2


def main(argv=None) -> int:
    from jepsen_tpu_torch.device import DEVICE_FAULTS

    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except (FileNotFoundError, NotImplementedError, UsageError,
            *DEVICE_FAULTS) as e:
        return _error(e)


if __name__ == "__main__":
    sys.exit(main())
