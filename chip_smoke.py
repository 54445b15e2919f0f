#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jepsen_tpu_torch``) on one card.

Run from the root of the repository, on a host with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. the card, from torch and from ``nvidia-smi``;
2. build the CUDA kernel from ``jepsen_tpu_torch/csrc`` with nvcc, and
   beside it print what ``nvcc -Xptxas -v`` says of each instantiation
   (registers, spills) and how many 128-bit loads and stores its SASS
   holds (``cuobjdump -sass``);
3. hold the kernel bit-exact against its plain PyTorch version on the
   card on every load path (:func:`exact_cases`): the anomaly corpus,
   L=128, L and V off multiples of 128, 16 and 4, int32 values
   (V=40,000), ``[L]``, ``[B, L]`` and int64 positions, columns placed
   off a 16-byte boundary or not contiguous, B=1, V=1, several row
   chunks; each case says
   which load path it took, and both paths must be reached;
4. the main path at full width: 128 distinct synthetic histories
   (470 ops, 5 processes, one lost and one duplicated value each) packed
   at L=1024 and tiled to B=10,240, checked through the kernel under
   both delivery contracts and both output layouts; the tensors equal
   the plain path on the card, the result maps of the 128 distinct
   histories equal the CPU oracles, and the kernel's launch count rose;
5. ``python -m jepsen_tpu_torch check`` on copies of two recorded runs
   (``check`` writes results, graphs and caches into the run
   directory), whose ``queue``/``linear`` maps must equal the run's
   ``results.json`` and whose ``perf`` map must name the same graphs;
6. timing at the main-path shape: the kernel, its plain version, the
   stages and the device check back to back with CUDA events (host
   overhead included where it exceeds the card's time), the kernel
   again by device time and by its wrapper's host time per call (calls
   enqueued behind a sleep on the card, see ``jepsen_tpu_torch.timing``),
   and the device check with the host->device copy of its four columns,
   from pageable memory and through the pipeline's pinned staging ring;
7. the pipeline at full width: a store of 10,240 JSONL histories (the
   128 distinct histories of the bench spec, 64 clean and 64 with one
   lost and one duplicated value, each written 80 times) through
   ``bench-check --pipeline``, cold (its classification parses each
   file natively and writes its ``.jtc``, as the JAX command's does),
   warm, warm ``--serial`` and warm at chunk 1024: every pass must
   count 5,120 invalid and none quarantined, give each history the CPU
   oracles' maps, launch K1 once per batch on its vector path, and
   serial must equal overlapped; then the producer's work per history
   (cache read, native parse, ``.jtc`` write, host pack) timed alone,
   and K1 timed at the pipeline's batch of 64 histories;
8. ``bench-check`` without ``--pipeline`` (``__main__.bench_check``):
   phase 7's store twice, the first run writing the store-level packed
   cache and the second checking all 10,240 histories from it in one K1
   call (L=1024, V=256; 5,120 invalid), then 1024 synthetic histories of
   1000 ops packed by ``min(8, cores)`` worker processes (999 invalid,
   the JAX package's count on the same seeds); each run prints
   ``pack_s``, ``check_s``, ``histories_per_sec`` and ``invalid``; K1 at
   the store's shape against its plain version, timed; and one
   ``--profile`` run, whose ten longest device operations it prints;
9. the segmented engine (``check --segment-ops 65536``) over a
   1,000,016-op queue history (SEGMENTED.md's configuration, written by
   :func:`write_long_history`) with one lost value and one duplicate
   across segment boundaries: through JSONL, then through the ``.jtc``
   the monolithic ``check`` of the file leaves, then killed after
   segment 7 (``JEPSEN_TPU_SEG_DIE_AFTER``) and resumed; every run's
   maps equal the monolithic check's, ``resumed`` only on the resumed
   run, no quarantine, one K1 launch per segment (the shapes printed);
   the per-segment p50/p99, the stats and merge halves timed apart, and
   K1 at the segment shapes B=1 × L=65,536 × V=32,768 (int16) and
   V=65,536 (int32) with ``[L]`` pos, against its plain version, timed;
10. the checker service as a user starts it: ``python -m
   jepsen_tpu_torch serve-checker --batch --warmup --warmup-buckets
   128:128,256:256 --target-batch 32 --max-batch-wait-ms 25`` (a second
   such server for the latency probe, and two servers without
   ``--batch``, one with the worker-death hook
   ``JEPSEN_TPU_SERVE_DIE_AFTER=0:3``) as processes on ports each picks
   and names in its banner, driven over TCP by the port's
   ``CheckerClient`` at the JAX
   service bench's standalone configuration: the ``check`` op over
   12,000 histories of 40 ops in requests of 1,000 and over phase 7's
   10,240 histories at L=1024 in requests of 1,024 (every reply equal to
   the in-process ``check_queue_batch`` on the card, one K1 launch per
   request in the server; histories/s over the wire, the server's
   ``service.check_latency_s`` p50/p99); 64 concurrent streams of 100
   blocks of 64 rows with coalescing on and off (every verdict equal to
   its serial oracle, the segmented engine on the CPU; blocks/s admitted
   to verdict), then the bench's latency probe, 64 streams paced at 0.6
   of the coalescing-on rate (``service.batch_fill``,
   ``batch_coalesce_s`` and ``batch_dispatch_s`` p50/p99 at full load
   and under the probe; every dispatched bucket a warm-up hit,
   no salvage, K1 launches by bucket equal to the server's K1 count); 6
   streams of 1,200 ops with worker 0 killed at its 3rd block (verdicts
   equal to the oracle, the recovery claimed); a content key streamed
   before hitting the verdict cache and ``/metrics`` showing the
   counters; every server stopped by SIGINT with exit code 0; and K1 at
   the batcher's buckets (B=32, L=V=128 and 256, ``[B, L]`` pos) and the
   ``check`` op's batches against its plain version, timed.

The second-to-last line is the kernel table as JSON (K1's entry lists
its bench, segment and service shapes under ``shapes``, and the service
servers' K1 counts under ``service_launches``); the last line is
``{"ok": true, "device": {...}}``.  A good run also appends its kernel
table, build report and timings, with the card, to
``chiprun_out/chip_smoke.jsonl``.  Without a CUDA device, or without the
package beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import random
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RECORD = ROOT / "chiprun_out" / "chip_smoke.jsonl"  # one line per good run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT32_OPS_PER_S = 67e12  # H100 SXM 32-bit rate outside the tensor cores
OPS_PER_ROW = 12  # integer compares, selects and atomics per row of K1
STORES = (
    ("store/cluster_r12_nemesis_queue", "at-least-once"),
    ("store/rabbitmq-simple-partition/20260730T165911", None),
)


def _equal_fields(x, y, what: str) -> None:
    for f in dataclasses.fields(x):
        a, b = getattr(x, f.name), getattr(y, f.name)
        same = torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
        if not same:
            raise AssertionError(f"{what}: field {f.name} differs")


def _head(t, n: int):
    """The first ``n`` histories of a result dataclass."""
    return dataclasses.replace(
        t,
        **{
            f.name: getattr(t, f.name)[:n]
            for f in dataclasses.fields(t)
            if isinstance(getattr(t, f.name), torch.Tensor)
        },
    )


def _stats_err(k, p) -> int:
    """Largest absolute difference over the six stats."""
    return max(
        int((getattr(k, f).long() - getattr(p, f).long()).abs().max())
        for f in "aexdst"
    )


def _host_ms(fn, n: int = 10) -> float:
    """Host-clock time per call of ``fn`` over ``n`` calls that end in a
    synchronize (after two warm-up calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def _random_packed(rng, B: int, L: int, V: int, dev):
    from jepsen_tpu_torch.history.encode import from_reference_arrays

    vdt = np.int16 if V <= np.iinfo(np.int16).max else np.int32
    cols = {
        "f": rng.integers(0, 6, (B, L)).astype(np.int8),
        "type": rng.integers(0, 4, (B, L)).astype(np.int8),
        "value": rng.integers(-1, V, (B, L)).astype(vdt),
        "mask": rng.random((B, L)) < 0.9,
    }
    for k in ("index", "process", "time_ms", "latency_ms"):
        cols[k] = np.full((B, L), -1, np.int32)
    cols["first"] = cols["mask"].copy()
    return from_reference_arrays(cols, V, dev)


def _offset(t: torch.Tensor) -> torch.Tensor:
    """``t`` copied into a contiguous tensor that starts one element past
    an aligned address, as a slice of a larger buffer would."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@dataclasses.dataclass
class ExactCase:
    name: str
    packed: object  # PackedHistories on the CPU
    pos: torch.Tensor | None = None
    shift: tuple[str, ...] = ()  # columns placed off a 16-byte boundary
    path: str = "vector"  # the load path K1 must take


def exact_cases() -> list[ExactCase]:
    """Phase 3's inputs, made from fixed seeds on the CPU."""
    from jepsen_tpu_torch.history.encode import pack_histories
    from jepsen_tpu_torch.history.rows import _rows_for
    from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch
    from jepsen_tpu_torch.timing import LENGTH

    rng = np.random.default_rng(20261016)
    cases = []
    for anomalies in ({}, {"lost": 2}, {"duplicated": 1},
                      {"unexpected": 1}, {"phantom_fail": 1},
                      {"causality": 1}):
        shs = synth_batch(4, SynthSpec(n_ops=200), **anomalies)
        cases.append(ExactCase(
            f"corpus{anomalies}",
            pack_histories([s.ops for s in shs], device="cpu")))
    shs = synth_batch(2, SynthSpec(n_ops=40))
    cases.append(ExactCase("L=128", pack_histories(
        [s.ops for s in shs], length=128, device="cpu")))
    hs = [s.ops for s in synth_batch(3, SynthSpec(n_ops=100),
                                     lost=1, causality=1)]
    rows = [_rows_for(h) for h in hs]
    V = max(int(r[:, 4].max()) for r in rows) + 1
    V += V % 128 == 0
    L = max(r.shape[0] for r in rows) + 3
    L += L % 128 == 0
    cases.append(ExactCase(f"L={L},V={V}", pack_histories(
        hs, length=L, value_space=V, device="cpu"), path="scalar"))
    cases.append(ExactCase("int32 values V=40000, L=1000",
                           _random_packed(rng, 16, 1000, 40_000, "cpu"),
                           path="scalar"))
    p = _random_packed(rng, 12, 777, 5000, "cpu")
    pos = torch.from_numpy(
        rng.integers(0, 2**31 - 1, (12, 777)).astype(np.int32))
    cases.append(ExactCase("explicit pos V=5000", p, pos, path="scalar"))

    def positions(shape, dtype=np.int32):
        return torch.from_numpy(
            rng.integers(-5, 2**31 - 1, shape).astype(dtype))

    main = (LENGTH, 384)
    strided = _random_packed(rng, 12, *main, "cpu")
    cases += [
        ExactCase("int32 values V=40000, L=1024",
                  _random_packed(rng, 8, 1024, 40_000, "cpu")),
        ExactCase("[L] pos", _random_packed(rng, 12, *main, "cpu"),
                  positions(LENGTH)),
        ExactCase("[B, L] pos", _random_packed(rng, 12, *main, "cpu"),
                  positions((12, LENGTH))),
        ExactCase("int64 [B, L] pos", _random_packed(rng, 12, *main, "cpu"),
                  positions((12, LENGTH), np.int64)),
        ExactCase("int64 [L] pos", _random_packed(rng, 12, *main, "cpu"),
                  positions(LENGTH, np.int64)),
        ExactCase("f off a 16-byte boundary",
                  _random_packed(rng, 12, *main, "cpu"), shift=("f",),
                  path="scalar"),
        ExactCase("value and pos off a 16-byte boundary",
                  _random_packed(rng, 12, *main, "cpu"),
                  positions((12, LENGTH)), shift=("value", "pos"),
                  path="scalar"),
        ExactCase("L=1000 (L % 16 != 0)",
                  _random_packed(rng, 12, 1000, 384, "cpu"), path="scalar"),
        ExactCase("V=382 (V % 4 != 0)",
                  _random_packed(rng, 12, LENGTH, 382, "cpu"), path="scalar"),
        ExactCase("B=1", _random_packed(rng, 1, *main, "cpu")),
        ExactCase("f column-major (not contiguous)", dataclasses.replace(
            strided, f=strided.f.t().contiguous().t())),
        ExactCase("V=1", _random_packed(rng, 8, LENGTH, 1, "cpu"),
                  path="scalar"),
        ExactCase("B=9 (B % 4 != 0)", _random_packed(rng, 9, *main, "cpu")),
        ExactCase("L=3088, four row chunks, [B, L] pos",
                  _random_packed(rng, 6, 3088, 384, "cpu"),
                  positions((6, 3088))),
        ExactCase("L=3000, three row chunks",
                  _random_packed(rng, 6, 3000, 384, "cpu"), path="scalar"),
    ]
    return cases


def check_exact_case(case: ExactCase, dev) -> tuple[str, int]:
    """Runs one case through K1 on ``dev`` and through the plain version
    on the card and on the CPU; raises unless all three agree exactly and
    K1 took the case's load path.  Returns the path and the largest
    absolute difference."""
    from jepsen_tpu_torch.history.encode import TENSOR_FIELDS
    from jepsen_tpu_torch.ops.queue_stats import (
        fused_queue_stats,
        queue_stats_plain,
    )

    packed = case.packed
    g = dataclasses.replace(packed, **{
        k: getattr(packed, k).to(dev) for k in TENSOR_FIELDS})
    gpos = None if case.pos is None else case.pos.to(dev)
    g = dataclasses.replace(g, **{
        k: _offset(getattr(g, k)) for k in case.shift if k != "pos"})
    if "pos" in case.shift:
        gpos = _offset(gpos)
    k = fused_queue_stats(g, gpos)
    path = fused_queue_stats.last_path
    pl = queue_stats_plain(g.f, g.type, g.value, g.mask, g.value_space, gpos)
    torch.cuda.synchronize()
    err = _stats_err(k, pl)
    _equal_fields(k, pl, f"K1 vs plain on the card, {case.name}")
    cpu = queue_stats_plain(packed.f, packed.type, packed.value,
                            packed.mask, packed.value_space, case.pos)
    _equal_fields(dataclasses.replace(k, **{
        f: getattr(k, f).cpu() for f in "aexdst"}), cpu,
        f"K1 vs plain on the CPU, {case.name}")
    if path != case.path:
        raise AssertionError(
            f"{case.name}: K1 took the {path} path, not the {case.path} path")
    return path, err


_KERNEL_RE = re.compile(r"queue_stats_kernelI([si])Lb([01])ELb([01])E")


def _kernel_label(mangled: str) -> str:
    m = _KERNEL_RE.search(mangled)
    if not m:
        return mangled
    return (f"{'int16' if m[1] == 's' else 'int32'} values, "
            f"{'vector' if m[2] == '1' else 'scalar'} path"
            f"{', pos' if m[3] == '1' else ''}")


def _ptxas_report(proc: subprocess.Popen) -> dict:
    """Registers and spills of each kernel, from ``-Xptxas -v``."""
    out, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc -Xptxas -v failed:\n{out}")
    report, name = {}, None
    for line in out.splitlines():
        print(f"ptxas: {line.strip()}")
        if m := re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line):
            name = _kernel_label(m[1])
            report.setdefault(name, {})
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) "
                                      r"bytes spill loads", line)):
            report[name].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report[name]["registers"] = int(m[1])
    return report


def _sass_report(lib: Path, nvcc: str, report: dict) -> None:
    """Counts of 128-bit global loads and stores per kernel, from
    ``cuobjdump -sass`` of the built library."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc).parent / "cuobjdump")
    if not Path(tool).is_file():
        print("sass: the toolkit has no cuobjdump; no SASS evidence")
        return
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    name = None
    for line in out.splitlines():
        if m := re.search(r"Function : (\w+)", line):
            name = _kernel_label(m[1])
            report.setdefault(name, {}).update(ldg=0, ldg_128=0, stg_128=0)
        elif name and re.search(r"\bLDG\.", line):
            report[name]["ldg"] += 1
            report[name]["ldg_128"] += bool(re.search(r"\bLDG\.[\w.]*128\b", line))
        elif name and re.search(r"\bSTG\.[\w.]*128\b", line):
            report[name]["stg_128"] += 1
    for name, r in report.items():
        print(f"sass: {name}: {r}")


class Smoke:
    def __init__(self):
        self.dev = torch.device("cuda", 0)
        self.card = ""
        self.kernel = {}
        self.timing = {}
        self.build = {}
        self.exact = []
        self.matplotlib = None
        self.pipeline = {}
        self.bench = {}
        self.segmented = {}
        self.service = {}
        self.shapes = []  # K1's shapes on the bench and segmented paths
        self.tmp = Path(tempfile.mkdtemp(prefix="chip_smoke-"))

    def card_phase(self):
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        self.card = smi
        print(f"card: {name} (torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.device_count()} device(s))")
        print(smi)

    def build_phase(self):
        from jepsen_tpu_torch.ops import _build

        t0 = time.perf_counter()
        nvcc = _build._nvcc()
        src = _build.CSRC / "queue_stats.cu"
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        flags = [f for f in _build.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC")]
        # the resource report compiles beside the build, not after it
        ptxas = subprocess.Popen(
            [nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o",
             str(_build.BUILD_DIR / "queue_stats.cubin"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lib = _build.build("queue_stats")
        _build.load("queue_stats")
        print(f"build: queue_stats.cu with nvcc {' '.join(_build.NVCC_FLAGS)} "
              f"in {time.perf_counter() - t0:.2f} s")
        self.build = _ptxas_report(ptxas)
        _sass_report(lib, nvcc, self.build)

    def exact_phase(self):
        for case in exact_cases():
            path, err = check_exact_case(case, self.dev)
            p = case.packed
            pos = "none" if case.pos is None else (
                f"{list(case.pos.shape)} {case.pos.dtype}")
            print(f"exact: {case.name} B={p.batch} L={p.length} "
                  f"V={p.value_space} value={p.value.dtype} pos={pos} "
                  f"load path={path} max_abs_err={err}")
            self.exact.append({"case": case.name, "path": path,
                               "max_abs_err": err})
        paths = {e["path"] for e in self.exact}
        if paths != {"vector", "scalar"}:
            raise AssertionError(f"phase 3 reached only the {paths} path(s)")

    def main_phase(self):
        from jepsen_tpu_torch.checkers.fused import combined_tensor_check
        from jepsen_tpu_torch.checkers.queue_lin import (
            check_queue_lin_cpu,
            queue_lin_tensor_check,
            queue_lin_tensors_to_results,
        )
        from jepsen_tpu_torch.checkers.total_queue import (
            _tensors_to_results,
            check_total_queue_cpu,
            total_queue_tensor_check,
        )
        from jepsen_tpu_torch.ops.queue_stats import (
            fused_queue_stats,
            queue_stats_plain,
        )
        from jepsen_tpu_torch.timing import (
            BASE_HISTORIES,
            MAIN_B,
            main_batch,
            tile,
        )

        hs, host = main_batch()
        reps = MAIN_B // BASE_HISTORIES
        g = tile(host, reps, self.dev)
        print(f"main: B={g.batch} L={g.length} V={g.value_space} "
              f"({BASE_HISTORIES} distinct histories x {reps})")
        runs = [(d, po) for d in ("exactly-once", "at-least-once")
                for po in (False, True)]
        torch.cuda.synchronize()
        fused_queue_stats.launches = 0
        outs = {r: combined_tensor_check(g, r[0], packed_out=r[1]) for r in runs}
        torch.cuda.synchronize()
        launches = fused_queue_stats.launches
        if launches <= 0:
            raise AssertionError("the main path launched no K1 kernel")
        print(f"main: K1 launches on the main path = {launches}, load path "
              f"{fused_queue_stats.last_path}")
        oracle_tq = [check_total_queue_cpu(h) for h in hs]
        for (delivery, po), (tq, ql) in outs.items():
            what = f"{delivery}, packed_out={po}"
            _equal_fields(tq, total_queue_tensor_check(g, po),
                          f"total-queue kernel vs plain, {what}")
            _equal_fields(ql, queue_lin_tensor_check(g, delivery, po),
                          f"queue-lin kernel vs plain, {what}")
            for v in (tq.valid, ql.valid):
                tiles = v.view(reps, BASE_HISTORIES)
                if not torch.equal(tiles, tiles[:1].expand_as(tiles)):
                    raise AssertionError(f"tiles disagree, {what}")
            if _tensors_to_results(_head(tq, BASE_HISTORIES)) != oracle_tq:
                raise AssertionError(f"total-queue maps vs oracle, {what}")
            lin = queue_lin_tensors_to_results(_head(ql, BASE_HISTORIES))
            for r in lin:
                r["delivery"] = delivery
            if lin != [check_queue_lin_cpu(h, delivery) for h in hs]:
                raise AssertionError(f"queue-lin maps vs oracle, {what}")
            print(f"main: {what}: tensors == plain path, "
                  f"{BASE_HISTORIES} maps == CPU oracles, "
                  f"valid {int(tq.valid.sum())}/{int(ql.valid.sum())} "
                  f"of {g.batch}")
        k = fused_queue_stats(g)
        pl = queue_stats_plain(g.f, g.type, g.value, g.mask, g.value_space)
        torch.cuda.synchronize()
        err = _stats_err(k, pl)
        _equal_fields(k, pl, "K1 vs plain at the main-path shape")
        self.kernel.update(launches=launches, max_abs_err=err)
        self.g, self.host = g, host

    def recorded_phase(self):
        from jepsen_tpu_torch.__main__ import main as cli
        from jepsen_tpu_torch.checkers.perf import MATPLOTLIB_MISSING
        from jepsen_tpu_torch.checkers.protocol import VALID, merge_valid
        from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats

        for store, delivery in STORES:
            with tempfile.TemporaryDirectory() as tmp:
                # check writes results, graphs and caches into the run dir
                run = Path(tmp) / "run"
                run.mkdir()
                for name in ("history.jsonl", "results.json", "history.jtc"):
                    if (ROOT / store / name).is_file():
                        shutil.copy2(ROOT / store / name, run / name)
                argv = ["check", str(run), "--device", str(self.dev)]
                if delivery:
                    argv += ["--delivery", delivery]
                buf = io.StringIO()
                fused_queue_stats.launches = 0
                with contextlib.redirect_stdout(buf):
                    rc = cli(argv)
                torch.cuda.synchronize()
                launches = fused_queue_stats.launches
                graphs = sorted(p.name for p in run.glob("*.png"))
            *body, banner = buf.getvalue().rstrip("\n").split("\n")
            got = json.loads("\n".join(body))
            want = json.loads((ROOT / store / "results.json").read_text())
            for fam in ("queue", "linear"):
                for key, val in want[fam].items():
                    g = got[fam][key]
                    same = (sorted(g) == sorted(val)
                            if isinstance(val, list) else g == val)
                    if not same:
                        raise AssertionError(
                            f"{store}: {fam}[{key!r}] = {g!r}, recorded {val!r}")
            perf = got["perf"]
            for key, val in want["perf"].items():
                if not isinstance(val, dict):
                    if perf[key] != val:
                        raise AssertionError(f"{store}: perf[{key!r}]")
                    continue
                g = perf[key]
                if g[VALID] is not True or (
                    Path(g["file"]).name != Path(val["file"]).name
                    if "file" in g else g.get("error") != MATPLOTLIB_MISSING
                ):
                    raise AssertionError(f"{store}: perf[{key!r}] = {g!r}, "
                                         f"recorded {val!r}")
            self.matplotlib = "file" in perf["latency-graph"]
            if self.matplotlib and graphs != ["latency-raw.png", "rate.png"]:
                raise AssertionError(f"{store}: graphs written: {graphs}")
            valid = merge_valid([got[f][VALID] for f in ("perf", "queue",
                                                          "linear")])
            if launches <= 0 or rc != (0 if valid is True else 1):
                raise AssertionError(f"{store}: rc={rc} launches={launches}")
            print(f"recorded: {store}: queue/linear == results.json "
                  f"({sum(len(want[f]) for f in ('queue', 'linear'))} keys), "
                  f"perf graphs {graphs or perf['latency-graph']['error']}, "
                  f"K1 launches={launches}, {banner}")

    def timing_phase(self):
        from jepsen_tpu_torch.checkers.fused import combined_tensor_check
        from jepsen_tpu_torch.checkers.queue_lin import queue_lin_classify
        from jepsen_tpu_torch.checkers.total_queue import total_queue_classify
        from jepsen_tpu_torch.history.encode import TENSOR_FIELDS
        from jepsen_tpu_torch.ops.queue_stats import (
            fused_queue_stats,
            queue_stats_plain,
        )
        from jepsen_tpu_torch.parallel.staging import StagingRing
        from jepsen_tpu_torch.timing import event_ms, queued_ms

        g, host = self.g, self.host
        B, L, V = g.batch, g.length, g.value_space

        ms = event_ms(lambda: fused_queue_stats(g), 50)
        plain_ms = event_ms(lambda: queue_stats_plain(
            g.f, g.type, g.value, g.mask, V), 10)
        device_ms, host_us = queued_ms(lambda: fused_queue_stats(g), 50)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (g.f, g.type, g.value, g.mask)) + B * 6 * V * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_ROW * B * L / INT32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"timing: K1 {ms:.6f} ms back to back through the wrapper "
              f"({device_ms:.6f} ms device time, {bound_ms / device_ms:.1%} "
              f"of the bound; the wrapper's host time {host_us:.3f} us per "
              f"call), plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms "
              f"({nbytes} bytes; ops bound {ops_ms:.6f} ms), at B={B} L={L} "
              f"V={V} on {self.card}")

        check_ms = event_ms(
            lambda: combined_tensor_check(g, packed_out=True), 20)
        st = fused_queue_stats(g)
        tq_ms = event_ms(lambda: total_queue_classify(
            st.a, st.e, st.d, packed_out=True), 20)
        ql_ms = event_ms(lambda: queue_lin_classify(
            st.a, st.x, st.s, st.d, st.t, packed_out=True), 20)
        print(f"timing: each stage alone: K1 {ms:.6f} ms, total-queue "
              f"classify {tq_ms:.6f} ms, queue-lin classify {ql_ms:.6f} ms; "
              f"the device check as a whole {check_ms:.6f} ms, on {self.card}")
        cols = ("f", "type", "value", "mask")
        blank = {k: getattr(g, k) for k in TENSOR_FIELDS if k not in cols}
        tiled = {k: getattr(host, k).repeat(B // host.batch, 1) for k in cols}

        def copied_check():
            dev_cols = {k: t.to(self.dev) for k, t in tiled.items()}
            p = dataclasses.replace(g, **dev_cols, **blank)
            return combined_tensor_check(p, packed_out=True)

        ring = StagingRing(self.dev, depth=2)
        compute = torch.cuda.current_stream(self.dev)
        host_b = dataclasses.replace(host, **tiled, **{
            k: getattr(host, k).repeat(B // host.batch, 1)
            for k in TENSOR_FIELDS if k not in cols})

        def ring_check():
            # what the pipeline's place and check stages do: fill a pinned
            # slot, copy it on the side stream, check on the compute stream
            return combined_tensor_check(ring.stage(host_b, compute),
                                         packed_out=True)

        pinned = {k: t.pin_memory() for k, t in tiled.items()}

        def prefilled_check():
            dev_cols = {k: t.to(self.dev, non_blocking=True)
                        for k, t in pinned.items()}
            p = dataclasses.replace(g, **dev_cols, **blank)
            return combined_tensor_check(p, packed_out=True)

        copy_ms = _host_ms(copied_check)
        ring_ms = _host_ms(ring_check)
        prefilled_ms = _host_ms(prefilled_check)
        print(f"timing: device check (K1 + both classifiers, packed out) "
              f"{check_ms:.6f} ms = {B / check_ms * 1e3:.1f} histories/s "
              f"without the host->device copy; with it {copy_ms:.6f} ms = "
              f"{B / copy_ms * 1e3:.1f} histories/s from pageable memory, "
              f"{ring_ms:.6f} ms = {B / ring_ms * 1e3:.1f} histories/s "
              f"through the pinned staging ring (slot filled on the host), "
              f"{prefilled_ms:.6f} ms from pinned memory already filled, "
              f"on {self.card}")
        self.timing = {
            "B": B, "L": L, "V": V, "k1_ms": ms, "plain_ms": plain_ms,
            "k1_device_ms": device_ms, "k1_host_us": host_us,
            "bound_ms": bound_ms, "total_queue_classify_ms": tq_ms,
            "queue_lin_classify_ms": ql_ms, "device_check_ms": check_ms,
            "device_check_hist_per_s": B / check_ms * 1e3,
            "with_copy_ms": copy_ms, "with_copy_hist_per_s": B / copy_ms * 1e3,
            "with_copy_pinned_ring_ms": ring_ms,
            "with_copy_pinned_ring_hist_per_s": B / ring_ms * 1e3,
            "with_copy_pinned_prefilled_ms": prefilled_ms,
        }
        self.kernel.update(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes"
            if bytes_ms >= ops_ms else "operations", library_ms=None,
            device_ms=device_ms, host_us=host_us,
        )

    def pipeline_phase(self):
        from jepsen_tpu_torch.__main__ import bench_check_pipeline
        from jepsen_tpu_torch.checkers.queue_lin import check_queue_lin_cpu
        from jepsen_tpu_torch.checkers.total_queue import check_total_queue_cpu
        from jepsen_tpu_torch.history.encode import pack_histories
        from jepsen_tpu_torch.history.rows import _rows_for
        from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch
        from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats
        from jepsen_tpu_torch.parallel.pipeline import _pow2_bucket
        from jepsen_tpu_torch.timing import BASE_HISTORIES, MAIN_B, N_OPS
        from jepsen_tpu_torch.timing import event_ms, queued_ms

        half = BASE_HISTORIES // 2
        spec = SynthSpec(n_ops=N_OPS, n_processes=5)
        hs = [sh.ops for sh in synth_batch(half, spec)] + [
            sh.ops for sh in synth_batch(
                half, dataclasses.replace(spec, seed=half),
                lost=1, duplicated=1)]
        reps = MAIN_B // BASE_HISTORIES
        oracle = [{"queue": check_total_queue_cpu(h),
                   "linear": check_queue_lin_cpu(h, "exactly-once")}
                  for h in hs]
        texts = ["".join(json.dumps(op.to_json()) + "\n" for op in h)
                 for h in hs]
        store = self.tmp / "store"  # the bench phase reads it again
        t0 = time.perf_counter()
        # sorted walk order: rep-major, so history k is hs[k % 128]
        for r in range(reps):
            for i, text in enumerate(texts):
                d = store / f"r{r:02d}" / f"h{i:03d}"
                d.mkdir(parents=True)
                (d / "history.jsonl").write_text(text)
        n = reps * len(hs)
        nbytes = sum(len(t) for t in texts) * reps
        print(f"pipeline: wrote {n} histories ({nbytes} bytes of JSONL) "
              f"in {time.perf_counter() - t0:.2f} s")
        passes = [("cold", 64, False), ("warm", 64, False),
                  ("warm serial", 64, True), ("warm", 1024, False)]
        maps = {}
        for name, chunk, serial in passes:
            torch.cuda.synchronize()
            fused_queue_stats.launches = 0
            fused_queue_stats.last_path = None
            t0 = time.perf_counter()
            summary, results, stats = bench_check_pipeline(
                store, chunk=chunk, serial=serial, device=str(self.dev))
            call_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = fused_queue_stats.launches
            print(json.dumps(summary))
            want_launches = math.ceil(n / chunk)
            if (summary["histories"], summary["invalid"],
                    summary["quarantined"]) != (n, n // 2, 0):
                raise AssertionError(f"pipeline {name} chunk {chunk}: "
                                     f"{summary}")
            if (launches, fused_queue_stats.last_path) != (
                    want_launches, "vector"):
                raise AssertionError(
                    f"pipeline {name} chunk {chunk}: K1 launched "
                    f"{launches} times (want {want_launches}), last on "
                    f"the {fused_queue_stats.last_path} path")
            for k, r in enumerate(results):
                if r != oracle[k % len(hs)]:
                    raise AssertionError(
                        f"pipeline {name} chunk {chunk}: history {k} "
                        "differs from the CPU oracles")
            if name == "cold" and len(list(store.glob("*/*/history.jtc"))
                                      ) != n:
                raise AssertionError("the cold pass left no .jtc caches")
            maps[(name, chunk)] = results
            rec = {
                "pass": name, "chunk": chunk, "mode": summary["mode"],
                "histories": n, "batches": stats.batches,
                "invalid": summary["invalid"],
                "quarantined": summary["quarantined"],
                "k1_launches": launches, "wall_s": stats.wall_s,
                "classify_s": summary["classify_s"], "call_s": call_s,
                "pipeline_e2e_histories_per_sec":
                    summary["pipeline_e2e_histories_per_sec"],
                "device_idle_frac": stats.device_idle_frac,
                "stage_overlap_frac": stats.stage_overlap_frac,
                "produce_busy_s": stats.produce_busy_s,
                "place_busy_s": stats.place_busy_s,
                "check_busy_s": stats.check_busy_s,
            }
            self.pipeline.setdefault("passes", []).append(rec)
            print(f"pipeline: {name} chunk {chunk}: {n} histories, "
                  f"{launches} K1 launches (vector), "
                  f"{rec['pipeline_e2e_histories_per_sec']:.1f} "
                  f"histories/s over wall {stats.wall_s:.6f} s "
                  f"after {summary['classify_s']:.6f} s of "
                  f"classification (the whole call with the walk and "
                  f"result maps {call_s:.6f} s), no batch in flight "
                  f"(device_idle_frac) {stats.device_idle_frac:.4f}, "
                  f"stage overlap "
                  f"{stats.stage_overlap_frac:.4f}, busy s produce "
                  f"{stats.produce_busy_s:.6f} place "
                  f"{stats.place_busy_s:.6f} check "
                  f"{stats.check_busy_s:.6f}, on {self.card}")
        if maps[("warm serial", 64)] != maps[("warm", 64)]:
            raise AssertionError("serial and overlapped maps differ")
        self.pipeline["producer_ms_per_history"] = _producer_breakdown(
            sorted(store.glob("*/*/history.jsonl"))[:1024])
        print(f"pipeline: the producer's work per history, over 1024 "
              f"stored histories: {self.pipeline['producer_ms_per_history']}"
              f" (ms), on {self.card}")
        # K1 at the pipeline's batch: 64 histories, power-of-two L and V
        mats = [_rows_for(h) for h in hs[:64]]
        L = _pow2_bucket(max(m.shape[0] for m in mats))
        V = _pow2_bucket(max(int(m[:, 4].max()) for m in mats) + 1)
        packed = pack_histories(hs[:64], length=L, value_space=V,
                                device=self.dev)
        ms = event_ms(lambda: fused_queue_stats(packed), 50)
        device_ms, host_us = queued_ms(lambda: fused_queue_stats(packed), 50)
        if fused_queue_stats.last_path != "vector":
            raise AssertionError("K1 left its vector path at B=64")
        print(f"pipeline: K1 at B=64 L={L} V={V}: {ms:.6f} ms back to back "
              f"through the wrapper, {device_ms:.6f} ms device time, "
              f"wrapper host time {host_us:.3f} us per call, on {self.card}")
        self.pipeline["k1_b64"] = {"B": 64, "L": L, "V": V, "ms": ms,
                                   "device_ms": device_ms, "host_us": host_us}
        self.kernel["pipeline_launches"] = [
            r["k1_launches"] for r in self.pipeline["passes"]]


    def bench_phase(self):
        """``bench-check`` without ``--pipeline``: phase 7's store twice
        (the first run writes the store-level packed cache, the second
        checks all 10,240 histories from it in one K1 call), once more
        under ``--profile``, then 1024 synthetic histories of 1000 ops
        packed by worker processes."""
        from jepsen_tpu_torch.__main__ import PROFILE_TRACE, bench_check
        from jepsen_tpu_torch.history.storecache import STORE_CACHE
        from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats

        store = self.tmp / "store"
        n = len(list(store.glob("*/*/history.jsonl")))
        (store / STORE_CACHE).unlink(missing_ok=True)
        cores = len(os.sched_getaffinity(0))
        workers = min(8, cores) if cores > 1 else 0
        runs = [
            ("store, cache written", dict(histories=store), n, n // 2),
            ("store, cache hit", dict(histories=store), n, n // 2),
            ("synthetic", dict(count=SYNTH_COUNT, ops=SYNTH_OPS,
                               workers=workers), SYNTH_COUNT, SYNTH_INVALID),
        ]
        for name, kw, want_n, want_invalid in runs:
            torch.cuda.synchronize()
            fused_queue_stats.launches = 0
            err = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(err):
                summary = bench_check(device=str(self.dev), **kw)
            call_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = fused_queue_stats.launches
            print(json.dumps(summary))
            hit = "store cache hit" in err.getvalue()
            if (summary["histories"], summary["invalid"], launches) != (
                    want_n, want_invalid, 2):
                raise AssertionError(
                    f"bench {name}: {summary}, {launches} K1 launches (want "
                    f"{want_n} histories, {want_invalid} invalid, 2 launches)")
            if hit != (name == "store, cache hit"):
                raise AssertionError(f"bench {name}: store cache hit={hit}")
            if name == "store, cache written" and not (
                    store / STORE_CACHE).is_file():
                raise AssertionError("bench: no store cache was written")
            rec = {"run": name, **summary, "k1_launches": launches,
                   "call_s": call_s, "workers": kw.get("workers", 0)}
            self.bench.setdefault("runs", []).append(rec)
            print(f"bench: {name}: {summary['histories']} histories at "
                  f"L={summary['ops_per_history']}, pack_s "
                  f"{summary['pack_s']}, check_s {summary['check_s']}, "
                  f"{summary['histories_per_sec']} histories/s, invalid "
                  f"{summary['invalid']}, {launches} K1 launches (warm-up "
                  f"and timed, each over the whole batch), the whole call "
                  f"{call_s:.6f} s, on {self.card}")
        self.shapes.append({"phase": "bench", **self._bench_k1_timing(store),
                            "launches": self.bench["runs"][1]["k1_launches"]})
        prof = self.tmp / "profile"
        with contextlib.redirect_stderr(io.StringIO()):
            bench_check(store, profile=prof, device=str(self.dev))
        self.bench["top_device_ops"] = top = _device_ops(prof / PROFILE_TRACE)
        print(f"bench: profile of a cache-hit run (the pack's copies, the "
              f"warm-up and the timed check): {top['device_ops']} device "
              f"operations, {top['device_us']} us of device time in all, of "
              f"which {top['kernels']} kernels {top['kernel_us']} us, K1 "
              f"{top['k1_us']} us, on {self.card}")
        for op in top["longest"]:
            print(f"bench: profile: {op['dur_us']} us {op['name']}")
        for name, tot in top["by_name"]:
            print(f"bench: profile: {tot} us in all: {name}")

    def _bench_k1_timing(self, store: Path) -> dict:
        """K1 at the bench's shape (every history of the store in one
        call), from the store-level cache: exact against the plain
        version, timed, and its bound."""
        from jepsen_tpu_torch.history.encode import TENSOR_FIELDS
        from jepsen_tpu_torch.history.store import history_paths
        from jepsen_tpu_torch.history.storecache import load_packed_store_cache
        from jepsen_tpu_torch.ops.queue_stats import (
            fused_queue_stats,
            queue_stats_plain,
        )
        from jepsen_tpu_torch.timing import event_ms, queued_ms

        t0 = time.perf_counter()
        paths = history_paths(store)
        t1 = time.perf_counter()
        host = load_packed_store_cache(store, paths)
        t2 = time.perf_counter()
        self.bench["cache_hit_walk_s"] = t1 - t0
        self.bench["cache_hit_load_s"] = t2 - t1
        print(f"bench: a cache hit's host work before the pack: the store "
              f"walk {t1 - t0:.6f} s, the cache's stat check and load "
              f"{t2 - t1:.6f} s, for {len(paths)} histories, on {self.card}")
        g = dataclasses.replace(host, **{
            k: getattr(host, k).to(self.dev) for k in TENSOR_FIELDS})
        B, L, V = g.batch, g.length, g.value_space
        k = fused_queue_stats(g)
        pl = queue_stats_plain(g.f, g.type, g.value, g.mask, V)
        torch.cuda.synchronize()
        err = _stats_err(k, pl)
        _equal_fields(k, pl, "K1 vs plain at the bench shape")
        ms = event_ms(lambda: fused_queue_stats(g), 50)
        plain_ms = event_ms(lambda: queue_stats_plain(
            g.f, g.type, g.value, g.mask, V), 10)
        device_ms, host_us = queued_ms(lambda: fused_queue_stats(g), 50)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (g.f, g.type, g.value, g.mask)) + B * 6 * V * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_ROW * B * L / INT32_OPS_PER_S * 1e3
        print(f"bench: K1 at B={B} L={L} V={V}: {ms:.6f} ms back to back, "
              f"{device_ms:.6f} ms device time "
              f"({max(bytes_ms, ops_ms) / device_ms:.1%} of the "
              f"{max(bytes_ms, ops_ms):.6f} ms bound, {nbytes} bytes), "
              f"wrapper host time {host_us:.3f} us, plain {plain_ms:.6f} ms, "
              f"max_abs_err {err}, {fused_queue_stats.last_path} path, on "
              f"{self.card}")
        return {"B": B, "L": L, "V": V,
                "value": str(g.value.dtype).removeprefix("torch."),
                "pos": None, "ms": ms, "device_ms": device_ms,
                "host_us": host_us, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "max_abs_err": err,
                "load_path": fused_queue_stats.last_path}

    def segmented_phase(self):
        """``check --segment-ops 65536`` over a 1,000,016-op queue history
        with one lost value and one duplicate across segment boundaries:
        through JSONL, through ``.jtc`` (left by the monolithic ``check``),
        and killed after segment 7 then resumed; every run's maps equal the
        monolithic check's, K1 launched once per segment."""
        from jepsen_tpu_torch.__main__ import main as cli
        from jepsen_tpu_torch.checkers import segmented
        from jepsen_tpu_torch.checkers.segmented import checkpoint_path_for
        from jepsen_tpu_torch.obs.metrics import (
            REGISTRY,
            QuantileSketch,
            sketch_state_delta,
        )
        from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats

        run = self.tmp / "segmented"
        run.mkdir()
        hp = run / "history.jsonl"
        t0 = time.perf_counter()
        n_ops, lost, dup = write_long_history(hp)
        print(f"segmented: wrote {n_ops} ops ({hp.stat().st_size} bytes), "
              f"lost value {lost}, duplicate {dup}, in "
              f"{time.perf_counter() - t0:.2f} s")
        shapes = []
        real = segmented._dispatch

        def recording(packed, pos):
            shapes.append((packed.batch, packed.length, packed.value_space,
                           str(packed.value.dtype).removeprefix("torch."),
                           "x".join(map(str, pos.shape))))
            return real(packed, pos)

        segmented._dispatch = recording
        sketches = ("segment_check_s", "segment_prepare_s",
                    "segment_device_s", "segment_merge_s")

        def run_cli(name, argv, env=None):
            shapes.clear()
            before = {k: REGISTRY.sketch(f"segmented.{k}").state()
                      for k in sketches}
            torch.cuda.synchronize()
            fused_queue_stats.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli([*argv, "--device", str(self.dev), str(run)])
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            *body, _banner = buf.getvalue().rstrip("\n").split("\n")
            result = json.loads("\n".join(body))
            rec = {"run": name, "rc": rc, "wall_s": wall,
                   "k1_launches": fused_queue_stats.launches}
            for k in sketches:
                d = REGISTRY.sketch(f"segmented.{k}")
                delta = QuantileSketch.from_state(
                    sketch_state_delta(before[k], d.state()))
                if delta.count:  # the monolithic check has no segments
                    rec[k] = {"count": delta.count, "sum": delta.sum,
                              "p50": delta.quantile(0.5),
                              "p99": delta.quantile(0.99)}
            # each K1 call's (B, L, V, value dtype, pos shape), counted
            rec["shapes"] = [[*k, c] for k, c in sorted(
                collections.Counter(shapes).items())]
            return result, rec

        try:
            results = {}
            results["jsonl"], rec = run_cli(
                "jsonl", ["check", "--segment-ops", str(SEGMENT_OPS)])
            self.segmented["runs"] = [rec]
            results["mono"], mono = run_cli("monolithic", ["check"])
            if not (run / "history.jtc").is_file():
                raise AssertionError("the monolithic check left no .jtc")
            results["jtc"], rec = run_cli(
                "jtc", ["check", "--segment-ops", str(SEGMENT_OPS)])
            self.segmented["runs"].append(rec)
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "jepsen_tpu_torch", "check",
                 "--segment-ops", str(SEGMENT_OPS), "--device",
                 str(self.dev), str(run)],
                env={**os.environ, "JEPSEN_TPU_SEG_DIE_AFTER": "7"},
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            killed_s = time.perf_counter() - t0
            ckpt = json.loads(checkpoint_path_for(hp).read_text())
            if proc.returncode != 137 or ckpt["segment_idx"] != 7:
                raise AssertionError(
                    f"segmented: the killed run exited {proc.returncode} "
                    f"at segment {ckpt['segment_idx']}:\n{proc.stderr[-3000:]}")
            results["resumed"], rec = run_cli(
                "resumed", ["check", "--segment-ops", str(SEGMENT_OPS),
                            "--resume"])
            rec["killed_run_s"] = killed_s
            self.segmented["runs"].append(rec)
        finally:
            segmented._dispatch = real
        n_seg = -(-n_ops // SEGMENT_OPS)
        want = results["mono"]
        if want["queue"]["lost"] != [lost] or want["queue"]["duplicated"] != [
                dup] or want["linear"]["duplicate"] != [dup]:
            raise AssertionError(f"segmented: the monolithic check found "
                                 f"{want['queue']}, {want['linear']}")
        for name in ("jsonl", "jtc", "resumed"):
            got, meta = results[name], results[name]["segmented"]
            rec = next(r for r in self.segmented["runs"] if r["run"] == name)
            for fam in ("queue", "linear", "valid?"):
                if got[fam] != want[fam]:
                    raise AssertionError(f"segmented {name}: {fam} differs "
                                         "from the monolithic check")
            want_launches = n_seg - 8 if name == "resumed" else n_seg
            if (meta["resumed"] != (name == "resumed")
                    or meta["quarantined-segments"]
                    or meta["substrate"] != ("jsonl" if name == "jsonl"
                                             else "jtc")
                    or rec["k1_launches"] != want_launches
                    or rec["segment_check_s"]["count"] != want_launches
                    or rec["rc"] != 1):
                raise AssertionError(f"segmented {name}: {meta}, {rec}")
            print(f"segmented: {name}: {meta['ops']} ops in {meta['segments']}"
                  f" segments of {SEGMENT_OPS}, {rec['k1_launches']} K1 "
                  f"launches at (B, L, V, value, pos) {rec['shapes']}, "
                  f"segment p50 {rec['segment_check_s']['p50'] * 1e3:.3f} ms"
                  f" / p99 {rec['segment_check_s']['p99'] * 1e3:.3f} ms; in "
                  f"all, stats (prepare {rec['segment_prepare_s']['sum']:.6f}"
                  f" s + device {rec['segment_device_s']['sum']:.6f} s) and "
                  f"merge {rec['segment_merge_s']['sum']:.6f} s; wall "
                  f"{rec['wall_s']:.6f} s; resumed={meta['resumed']}, "
                  f"quarantined 0, on {self.card}")
        print(f"segmented: monolithic check of {n_ops} ops: "
              f"{mono['k1_launches']} K1 launch, wall {mono['wall_s']:.6f} s,"
              f" maps equal all three segmented runs, on {self.card}")
        self.segmented["monolithic"] = mono
        timed = self._segment_k1_timing(hp)
        self.segmented["k1"] = [{"shape": list(k), **v}
                                for k, v in timed.items()]
        for (B, L, V, dt, pos), t in timed.items():
            # launches at this shape in the three segmented runs
            launches = sum(c for r in self.segmented["runs"]
                           for *shape, c in r["shapes"]
                           if shape == [B, L, V, dt, pos])
            self.shapes.append({"phase": "segmented", "B": B, "L": L, "V": V,
                                "value": dt, "pos": f"[{pos}]", **t,
                                "launches": launches})

    def service_phase(self):
        """The checker service as a user starts it: ``serve-checker
        --batch --warmup`` (and two servers without ``--batch``, one with
        the worker-death hook) as processes, driven over TCP by the
        port's ``CheckerClient``: the ``check`` op over 12,000 small
        histories and over phase 7's 10,240 histories, 64 concurrent
        streams with coalescing on and off, a worker killed mid-feed,
        and the verdict cache; every reply and verdict equal to the
        port's in-process check or serial oracle, K1 launched by every
        check request and every coalesced super-batch, each server
        stopped by SIGINT with exit code 0."""
        from jepsen_tpu_torch.checkers.fused import check_queue_batch
        from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch
        from jepsen_tpu_torch.timing import BASE_HISTORIES, MAIN_B, N_OPS

        store = self.tmp / "service-store"
        store.mkdir()
        caps = ["--max-streams", str(BAT_MAX_STREAMS), "--ingress-cap",
                str(BAT_INGRESS_CAP)]
        batching = [
            "--batch", "--warmup", "--warmup-buckets", "128:128,256:256",
            "--target-batch", str(TARGET_BATCH), "--max-batch-wait-ms",
            str(MAX_BATCH_WAIT_MS), *caps]
        servers = {
            "batch": _ServerProc("batch", store, self.tmp, batching),
            "probe": _ServerProc("probe", store, self.tmp, batching),
            "serial": _ServerProc("serial", store, self.tmp, caps),
            "chaos": _ServerProc("chaos", store, self.tmp, [], env={
                "JEPSEN_TPU_SERVE_DIE_AFTER": f"0:{KILL_BLOCK}"}),
        }
        try:
            for srv in servers.values():  # started together, awaited here
                print(f"service: {srv.name}: {srv.wait_banner()}")
            a = servers["batch"]
            # the check op: 12,000 histories of 40 ops, then phase 7's
            # 10,240 histories at L=1024
            base = _serve_corpus(SERVE_BASE, SERVE_OPS, SERVE_SEED)
            half = BASE_HISTORIES // 2
            spec = SynthSpec(n_ops=N_OPS, n_processes=5)
            store_hs = [sh.ops for sh in synth_batch(half, spec)] + [
                sh.ops for sh in synth_batch(
                    half, dataclasses.replace(spec, seed=half), lost=1,
                    duplicated=1)]
            requests = []
            for name, hs, n, per, length in (
                    ("small", base, SERVE_HISTORIES, SERVE_REQUEST, None),
                    ("store", store_hs, MAIN_B, STORE_REQUEST, 1024)):
                want = [_wire_ref(r) for r in check_queue_batch(
                    hs, device=self.dev)]
                rec, request = a.check_arm(hs, n, per, length, want)
                requests.append((request, rec["k1_launches"]))
                self.service.setdefault("check", []).append(
                    {"corpus": name, **rec})
                print(f"service: check over the wire, {name}: "
                      f"{rec['histories']} histories in {rec['requests']} "
                      f"requests of B={rec['B']} L={rec['L']} V={rec['V']}: "
                      f"{rec['histories_per_s']:.1f} histories/s over the "
                      f"wire ({rec['wall_s']:.6f} s; per request "
                      f"{rec['client_ms_per_request']:.3f} ms at the "
                      f"client, {rec['server_ms_per_request']:.3f} ms in "
                      f"the server's check), {rec['k1_launches']} "
                      f"K1 launches in the server, replies == in-process "
                      f"check_queue_batch, {rec['invalid']} invalid, on "
                      f"{self.card}")
            lat = a.metrics()
            q = lat.get("jepsen_tpu_service_check_latency_s", {})
            self.service["check_latency_s"] = {
                k: q.get(f'op="check",quantile="{k}"') for k in ("0.5",
                                                                "0.99")}
            print(f"service: server's service.check_latency_s p50 "
                  f"{self.service['check_latency_s']['0.5']} s / p99 "
                  f"{self.service['check_latency_s']['0.99']} s, on "
                  f"{self.card}")
            # continuous batching: 64 streams of 100 blocks x 64 rows,
            # coalescing on, then off
            corpus = [_stream_entry(h) for h in _serve_corpus(
                8, max(64, BAT_BLOCK_ROWS * BAT_BLOCKS // 2),
                SERVE_SEED + 400)]
            arms = {}
            for arm, srv in (("on", a), ("off", servers["serial"])):
                arms[arm] = rec = srv.stream_arm(corpus, BAT_STREAMS,
                                                 BAT_BLOCK_ROWS, threads=8)
                print(f"service: coalescing {arm}: {BAT_STREAMS} streams, "
                      f"{rec['blocks']} blocks admitted to verdict in "
                      f"{rec['wall_s']:.6f} s = {rec['blocks_per_s']:.1f} "
                      f"blocks/s, {rec['k1_launches']} K1 launches, "
                      f"verdicts == serial oracle; p50/p99 "
                      f"service.block_check_s (a worker's block) "
                      f"{rec['sketches']['block_check_s']}, "
                      f"service.submit_to_verdict_s (open to verdict) "
                      f"{rec['sketches']['submit_to_verdict_s']}, on "
                      f"{self.card}")
            # the latency probe: a fresh batching server, fed below the
            # coalescing-on arm's measured capacity
            probe = servers["probe"]
            pace = BAT_PROBE_LOAD * arms["on"]["blocks_per_s"]
            probe_corpus = [_stream_entry(h) for h in _serve_corpus(
                8, max(64, BAT_BLOCK_ROWS * BAT_BLOCKS // 8),
                SERVE_SEED + 401)]
            arms["probe"] = rec = probe.stream_arm(
                probe_corpus, BAT_STREAMS, BAT_BLOCK_ROWS, threads=8,
                pace_rate=pace)
            rec["pace_blocks_per_s"] = pace
            bat = arms["on"]["stats"]["batcher"]
            self.service["batching"] = {
                arm: {k: v for k, v in r.items() if k != "stats"}
                for arm, r in arms.items()}
            for arm, srv in (("on", a), ("probe", probe)):
                m = srv.metrics()
                self.service["batching"][arm]["batcher_sketches"] = {
                    k: {p: m.get(f"jepsen_tpu_service_{k}", {}).get(
                        f'quantile="{p}"') for p in ("0.5", "0.99")}
                    for k in ("batch_fill", "batch_coalesce_s",
                              "batch_dispatch_s")}
            self.service["batching"]["batcher"] = bat
            for b in (bat, arms["probe"]["stats"]["batcher"]):
                if b["salvages"] or b["warmup_misses"] or not b[
                        "warmup_hits"]:
                    raise AssertionError(f"service: batcher {b}")
            if arms["on"]["k1_launches"] != sum(
                    bat["bucket_launches"].values()) or not (
                    0 < bat["bucket_launches"].get("128x128", 0)
                    < arms["on"]["blocks"]):
                raise AssertionError(
                    f"service: {arms['on']['k1_launches']} K1 launches, "
                    f"by bucket {bat['bucket_launches']}")
            for arm, what in (("on", "at full offered load"),
                              ("probe", f"paced at {pace:.1f} blocks/s")):
                sk = self.service["batching"][arm]["batcher_sketches"]
                b = arms[arm]["stats"]["batcher"]
                print(f"service: coalescing on, {what} "
                      f"({arms[arm]['blocks']} blocks, "
                      f"{arms[arm]['blocks_per_s']:.1f} blocks/s): "
                      f"batch_fill p50/p99 {sk['batch_fill']}, "
                      f"batch_coalesce_s {sk['batch_coalesce_s']}, "
                      f"batch_dispatch_s {sk['batch_dispatch_s']}; warm-up "
                      f"hits {b['warmup_hits']} misses "
                      f"{b['warmup_misses']}; batch_salvages "
                      f"{b['salvages']}; K1 launches by bucket "
                      f"{b['bucket_launches']}; on {self.card}")
            self.service["host_ms_per_block"] = cost = _merge_cost(
                corpus[0][0], self.dev)
            print(f"service: a landed block's host work in the collector, "
                  f"ms per block over one stream's {cost['blocks']} blocks "
                  f"(its stats prepared and launched once beforehand): "
                  f"merge {cost['merge']:.6f}, verdict window "
                  f"{cost['window']:.6f}, carry footprint "
                  f"{cost['footprint']:.6f}; before it, the feed's frames "
                  f"both ways {cost['wire']:.6f} and the prep "
                  f"{cost['prep']:.6f}; all in one interpreter, on "
                  f"{self.card}")
            # chaos: worker 0 dies mid-feed of its 3rd block
            chaos = [_stream_entry(h) for h in _serve_corpus(
                CHAOS_STREAMS, CHAOS_OPS, SERVE_SEED + 200)]
            rec = servers["chaos"].stream_arm(
                chaos, CHAOS_STREAMS, max(64, 2 * CHAOS_OPS // CHAOS_BLOCKS),
                threads=1, chaos=True)
            self.service["chaos"] = {k: v for k, v in rec.items()
                                     if k != "stats"}
            print(f"service: chaos: {CHAOS_STREAMS} streams, worker 0 "
                  f"killed at its block {KILL_BLOCK}: "
                  f"{rec['stats']['worker_deaths']} death, "
                  f"{rec['stats']['block_requeues']} requeued block(s), "
                  f"{rec['degraded']} verdict(s) claim the recovery, all "
                  f"== serial oracle")
            # the verdict cache: a content key streamed above hits
            hit = a.cache_arm(corpus[1])
            self.service["cache"] = hit
            print(f"service: cache: {hit}")
            self._service_k1_timing(requests, bat["bucket_launches"])
        finally:
            rcs = {name: srv.stop() for name, srv in servers.items()}
        self.service["exit_codes"] = rcs
        print(f"service: servers stopped by SIGINT: exit codes {rcs}")
        if any(rcs.values()):
            raise AssertionError(f"service: a server exited {rcs}")
        self.kernel["service_launches"] = {
            "check": sum(c["k1_launches"] for c in self.service["check"]),
            "coalesced": arms["on"]["k1_launches"],
            "uncoalesced": arms["off"]["k1_launches"]}

    def _service_k1_timing(self, check_requests, bucket_launches):
        """K1 at the service's shapes: the batcher's two buckets, B=32 at
        L=V=128 and L=V=256 with a ``[B, L]`` pos (random segments, each
        with its own global positions), and the ``check`` op's batches:
        bit-exact against the plain version, timed, and its bound."""
        from jepsen_tpu_torch.checkers.segmented import _k1_input
        from jepsen_tpu_torch.ops.queue_stats import (
            fused_queue_stats,
            queue_stats_plain,
        )
        from jepsen_tpu_torch.timing import event_ms, queued_ms

        cases = []
        for L, V in ((128, 128), (256, 256)):
            p = _bucket_preps(TARGET_BATCH, L, V, seed=L)
            cols = [torch.from_numpy(np.stack([q[k] for q in p])).to(self.dev)
                    for k in ("f", "typ", "val", "mask", "pos")]
            cases.append((_k1_input(*cols[:4], V), cols[4], "[B, L]",
                          bucket_launches.get(f"{L}x{V}", 0)))
        for request, launches in check_requests:
            g = dataclasses.replace(request, **{
                k: getattr(request, k).to(self.dev)
                for k in ("f", "type", "value", "mask")})
            cases.append((g, None, None, launches))
        for packed, pos, pos_kind, launches in cases:
            B, L, V = packed.batch, packed.length, packed.value_space
            k = fused_queue_stats(packed, pos)
            pl = queue_stats_plain(packed.f, packed.type, packed.value,
                                   packed.mask, V, pos)
            torch.cuda.synchronize()
            err = _stats_err(k, pl)
            _equal_fields(k, pl, f"K1 vs plain at B={B} L={L} V={V}")
            ms = event_ms(lambda: fused_queue_stats(packed, pos), 50)
            plain_ms = event_ms(lambda: queue_stats_plain(
                packed.f, packed.type, packed.value, packed.mask, V, pos),
                10)
            device_ms, host_us = queued_ms(
                lambda: fused_queue_stats(packed, pos), 50)
            ins = [packed.f, packed.type, packed.value, packed.mask]
            nbytes = sum(t.numel() * t.element_size() for t in (
                *ins, *([pos] if pos is not None else []))) + B * 6 * V * 4
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = OPS_PER_ROW * B * L / INT32_OPS_PER_S * 1e3
            rec = {"phase": "service", "B": B, "L": L, "V": V,
                   "value": str(packed.value.dtype).removeprefix("torch."),
                   "pos": pos_kind, "ms": ms, "device_ms": device_ms,
                   "host_us": host_us, "plain_ms": plain_ms,
                   "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms
                   else "operations", "bytes": nbytes,
                   "max_abs_err": err,
                   "load_path": fused_queue_stats.last_path,
                   "launches": launches}
            self.shapes.append(rec)
            print(f"service: K1 at B={B} L={L} V={V} pos={pos_kind}: "
                  f"{ms:.6f} ms back to back, {device_ms:.6f} ms device "
                  f"time ({max(bytes_ms, ops_ms) / device_ms:.1%} of the "
                  f"{max(bytes_ms, ops_ms):.6f} ms bound, {nbytes} bytes), "
                  f"wrapper host time {host_us:.3f} us, plain "
                  f"{plain_ms:.6f} ms, max_abs_err {err}, "
                  f"{fused_queue_stats.last_path} path, {launches} launches "
                  f"in the service run, on {self.card}")

    def _segment_k1_timing(self, hp) -> dict:
        """K1 at the segment shapes B=1 × L=65,536 × V=32,768 (int16 ids,
        segment 1 of the long history) and V=65,536 (int32 ids, a segment
        of 40,000 distinct values), with ``[L]`` pos: bit-exact against
        the plain version, timed, and its bound."""
        from jepsen_tpu_torch.checkers.segmented import (
            _k1_input,
            queue_prepare_rows,
        )
        from jepsen_tpu_torch.history.columnar import load_jtc
        from jepsen_tpu_torch.ops.queue_stats import (
            fused_queue_stats,
            queue_stats_plain,
        )
        from jepsen_tpu_torch.timing import event_ms, queued_ms

        rows = load_jtc(hp).rows()
        idx = rows[:, 0]
        lo, hi = (int(np.searchsorted(idx, k * SEGMENT_OPS)) for k in (1, 2))
        wide = _wide_rows(40_000)
        out = {}
        for r in (rows[lo:hi], wide):
            prep = queue_prepare_rows(r, r[:, 0].astype(np.int64))
            cols = [torch.from_numpy(prep[k]).unsqueeze(0).to(self.dev)
                    for k in ("f", "typ", "val", "mask")]
            packed = _k1_input(*cols, prep["V"])
            pos = torch.from_numpy(prep["pos"]).to(self.dev)
            k = fused_queue_stats(packed, pos)
            pl = queue_stats_plain(packed.f, packed.type, packed.value,
                                   packed.mask, packed.value_space, pos)
            torch.cuda.synchronize()
            err = _stats_err(k, pl)
            _equal_fields(k, pl, f"K1 vs plain at L={prep['L']} V={prep['V']}")
            ms = event_ms(lambda: fused_queue_stats(packed, pos), 50)
            plain_ms = event_ms(lambda: queue_stats_plain(
                packed.f, packed.type, packed.value, packed.mask,
                packed.value_space, pos), 10)
            device_ms, host_us = queued_ms(
                lambda: fused_queue_stats(packed, pos), 50)
            L, V = prep["L"], prep["V"]
            nbytes = sum(t.numel() * t.element_size()
                         for t in (*cols, pos)) + 24 * V
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = OPS_PER_ROW * L / INT32_OPS_PER_S * 1e3
            dt = str(cols[2].dtype).removeprefix("torch.")
            out[(1, L, V, dt, str(L))] = {
                "ms": ms, "device_ms": device_ms, "host_us": host_us,
                "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes, "max_abs_err": err,
                "load_path": fused_queue_stats.last_path}
            print(f"segmented: K1 at B=1 L={L} V={V} {dt} values, [L] pos: "
                  f"{ms:.6f} ms back to back, {device_ms:.6f} ms device time "
                  f"({max(bytes_ms, ops_ms) / device_ms:.1%} of the "
                  f"{max(bytes_ms, ops_ms):.6f} ms bound, {nbytes} bytes), "
                  f"wrapper host time {host_us:.3f} us, plain {plain_ms:.6f}"
                  f" ms, max_abs_err {err}, {fused_queue_stats.last_path} "
                  f"path, on {self.card}")
        return out


#: the service phase's configuration: the JAX service bench's standalone
#: defaults (``tools/bench_serve.py``, its argument parser): the check
#: arm's 12,000 histories of 40 ops (16 distinct, seed 16, the first with
#: one lost value) in requests of 1,000; the batching arm's 64 streams of
#: 100 blocks of 64 rows (8 distinct histories of 3,200 ops, seed 416),
#: target batch 32 within 25 ms, both arms' servers admitting 72 streams
#: and 8,192 blocks in flight (the bench's ``max_streams`` and
#: ``ingress_cap``), then the latency probe: 64 streams of 800 ops (seed
#: 417) fed at 0.6 of the coalescing-on arm's measured blocks/s, so that
#: ``batch_coalesce_s`` reads the scheduler's hold and not saturation
#: queueing; the chaos arm's 6 streams of 1,200 ops in about 8 blocks
#: (seed 216), worker 0 killed at its 3rd block
SERVE_HISTORIES, SERVE_BASE, SERVE_OPS, SERVE_SEED = 12_000, 16, 40, 16
SERVE_REQUEST, STORE_REQUEST = 1_000, 1_024
BAT_STREAMS, BAT_BLOCKS, BAT_BLOCK_ROWS = 64, 100, 64
TARGET_BATCH, MAX_BATCH_WAIT_MS = 32, 25.0
BAT_MAX_STREAMS = BAT_STREAMS + 8
BAT_INGRESS_CAP = max(256, 4 * BAT_STREAMS * TARGET_BATCH)
BAT_PROBE_LOAD = 0.6
CHAOS_STREAMS, CHAOS_OPS, CHAOS_BLOCKS, KILL_BLOCK = 6, 1_200, 8, 3


def _serve_corpus(n_base: int, n_ops: int, seed: int) -> list:
    """``n_base`` distinct queue histories (the first with one lost
    value), as the JAX service bench synthesizes its corpus."""
    from jepsen_tpu_torch.history.synth import SynthSpec, synth_history

    return [synth_history(SynthSpec(n_ops=n_ops, seed=seed + i,
                                    lost=1 if i == 0 else 0)).ops
            for i in range(n_base)]


def _stream_entry(ops) -> tuple:
    """``(rows, n_ops, serial oracle's families)`` of one history: the
    oracle is the port's segmented engine on the CPU, fed whole."""
    from jepsen_tpu_torch.checkers.segmented import SegmentedChecker
    from jepsen_tpu_torch.history.rows import _rows_for

    rows = _rows_for(ops)
    eng = SegmentedChecker("queue", device="cpu")
    eng.feed_rows(rows, len(ops))
    return rows, len(ops), _families(eng.finish())


def _families(v: dict) -> dict:
    from jepsen_tpu_torch.service.stream import _wire_safe

    return {k: _wire_safe(v.get(k)) for k in ("queue", "linear", "valid?")}


def _wire_ref(r: dict) -> dict:
    """One history's check maps as the wire's ``check`` op answers them
    (no delivery key in ``linear``), from a reply or an in-process
    result."""
    from jepsen_tpu_torch.service.stream import _wire_safe

    lin = {k: v for k, v in r["linear"].items() if k != "delivery"}
    return {"queue": _wire_safe(r["queue"]), "linear": _wire_safe(lin),
            "valid?": bool(r["queue"]["valid?"] and lin["valid?"])}


def _bucket_preps(B: int, L: int, V: int, seed: int = 0) -> list:
    """``B`` random prepared segments of the batcher's bucket ``(L, V)``,
    each with its own increasing global positions."""
    from jepsen_tpu_torch.checkers.segmented import local_id_dtype

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(B):
        mask = np.zeros(L, bool)
        mask[: int(rng.integers(1, L + 1))] = True
        out.append({
            "f": rng.integers(-1, 3, L).astype(np.int8),
            "typ": rng.integers(-1, 4, L).astype(np.int8),
            "val": rng.integers(-1, V, L).astype(local_id_dtype(V)),
            "pos": np.sort(rng.integers(0, 2**31 - 1, L)).astype(np.int32),
            "mask": mask,
        })
    return out


def _merge_cost(rows, dev) -> dict:
    """Milliseconds per block of the host work around K1 for one stream
    (64-row blocks), each piece timed alone: the feed's frames (encoded
    and decoded both ways), the connection thread's prep, then the
    collector's carry merge, verdict window and carry footprint."""
    from jepsen_tpu_torch.checkers.segmented import (
        SegmentedChecker,
        queue_prepare_rows,
        queue_stats_from_prepared,
    )
    from jepsen_tpu_torch.history.columnar import iter_row_blocks

    blocks = list(iter_row_blocks(rows, BAT_BLOCK_ROWS))
    t0 = time.perf_counter()
    preps = [queue_prepare_rows(b, b[:, 0].astype(np.int64))
             for b, _n in blocks]
    prep = time.perf_counter() - t0
    stats = [queue_stats_from_prepared(p, dev) for p in preps]
    eng = SegmentedChecker("queue", device="cpu")
    out = {"merge": 0.0, "window": 0.0, "footprint": 0.0}
    for st, (_b, n) in zip(stats, blocks):
        t0 = time.perf_counter()
        eng.merge_queue_stats(st, n)
        t1 = time.perf_counter()
        eng.verdict_so_far()
        t2 = time.perf_counter()
        eng.state_nbytes()
        t3 = time.perf_counter()
        out["merge"] += t1 - t0
        out["window"] += t2 - t1
        out["footprint"] += t3 - t2
    # one feed's frames both ways over a socket pair: what the client and
    # the server's connection thread encode and decode for each block
    import socket

    from jepsen_tpu_torch.service.protocol import recv_frame, send_frame

    a, b = socket.socketpair()
    try:
        t0 = time.perf_counter()
        for seq, (blk, n_ops) in enumerate(blocks):
            send_frame(a, {"op": "stream-feed", "stream": "s0", "seq": seq,
                           "n_ops": n_ops},
                       {"rows": np.ascontiguousarray(blk, np.int32)},
                       crc=True)
            recv_frame(b)
            send_frame(b, {"op": "accepted", "stream": "s0", "seq": seq,
                           "queue_depth": 1})
            recv_frame(a)
        out["wire"] = time.perf_counter() - t0
    finally:
        a.close()
        b.close()
    n = len(blocks)
    return {"blocks": n, "prep": prep / n * 1e3,
            **{k: v / n * 1e3 for k, v in out.items()}}


class _ServerProc:
    """One ``serve-checker`` process on the card, on ports it picks
    itself (``--port 0 --metrics-port 0``) and names in its banner, and
    the arms that drive it through the port's ``CheckerClient``."""

    def __init__(self, name: str, store: Path, tmp: Path, args: list,
                 env: dict | None = None):
        self.name = name
        self.port = self.metrics_port = None
        self.log = tmp / f"serve-{name}.log"
        with open(self.log, "w") as fh:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "jepsen_tpu_torch", "serve-checker",
                 "--host", "127.0.0.1", "--port", "0", "--metrics-port", "0",
                 "--store", str(store), *args],
                cwd=ROOT, env={**os.environ, **(env or {})},
                stdout=subprocess.PIPE, stderr=fh, text=True)

    def wait_banner(self, timeout: float = 180.0) -> str:
        import re
        import threading

        timer = threading.Timer(timeout, self.proc.kill)
        timer.start()
        try:
            line = self.proc.stdout.readline()
        finally:
            timer.cancel()
        got = re.match(r"checker sidecar on [^ ]+:(\d+) \(.*, metrics="
                       r"http://[^ ]+:(\d+)/metrics\)$", line.strip())
        if not got:
            raise AssertionError(f"service: the {self.name} server did not "
                                 f"start: {line!r}\n"
                                 f"{self.log.read_text()[-3000:]}")
        self.port, self.metrics_port = map(int, got.groups())
        return line.strip()

    def client(self):
        """A client that re-offers a rejected (SATURATED) block with a
        short backoff, as an honest client does."""
        from jepsen_tpu_torch.service import CheckerClient, RetryPolicy

        return CheckerClient("127.0.0.1", self.port, timeout=300,
                             retry=RetryPolicy(attempts=500, base_s=0.001,
                                               cap_s=0.02, seed=0))

    def stats(self) -> dict:
        with self.client() as c:
            return c.service_stats()

    def metrics(self) -> dict:
        """``/metrics`` as ``{name: {labels: value}}``."""
        import urllib.request

        url = f"http://127.0.0.1:{self.metrics_port}/metrics"
        with urllib.request.urlopen(url, timeout=60) as r:
            text = r.read().decode()
        out: dict = {}
        for line in text.splitlines():
            if line and not line.startswith("#"):
                key, value = line.rsplit(" ", 1)
                name, _, labels = key.partition("{")
                out.setdefault(name, {})[labels.rstrip("}")] = float(value)
        return out

    def check_arm(self, hs, n: int, per: int, length, want):
        """``n`` histories (``hs`` repeated) in requests of ``per`` over
        the ``check`` op, packed once; every reply equal to ``want``."""
        from jepsen_tpu_torch.history.encode import pack_histories

        packed = pack_histories(hs, length=length, device="cpu")
        idx = torch.arange(per) % len(hs)
        request = dataclasses.replace(packed, **{
            k: getattr(packed, k)[idx] for k in ("f", "type", "value",
                                                 "mask")})
        before = self.stats()["k1_launches"]
        m0 = self.metrics()
        with self.client() as c:
            t0 = time.perf_counter()
            replies = [c.check_packed(request) for _ in range(n // per)]
            wall = time.perf_counter() - t0
        launches = self.stats()["k1_launches"] - before
        m1 = self.metrics()
        # the server's own time per request (its check, not the reply's
        # encoding, transfer and decoding): the sketch's sum over count
        d = {k: m1[f"jepsen_tpu_service_check_latency_s_{k}"]['op="check"']
             - m0.get(f"jepsen_tpu_service_check_latency_s_{k}", {}).get(
                 'op="check"', 0.0) for k in ("sum", "count")}
        for reply in replies:
            for i, r in enumerate(reply):
                if _wire_ref(r) != want[i % len(hs)]:
                    raise AssertionError(
                        f"service: check reply {i} differs from the "
                        "in-process check_queue_batch")
        if launches != len(replies):
            raise AssertionError(f"service: {len(replies)} check requests "
                                 f"launched K1 {launches} times")
        rec = {"histories": per * len(replies), "requests": len(replies),
               "B": request.batch, "L": request.length,
               "V": request.value_space, "wall_s": wall,
               "histories_per_s": per * len(replies) / wall,
               "client_ms_per_request": wall / len(replies) * 1e3,
               "server_ms_per_request": d["sum"] / d["count"] * 1e3,
               "k1_launches": launches,
               "invalid": sum(not r["valid?"] for rep in replies
                              for r in rep)}
        return rec, request

    def stream_arm(self, corpus, n_streams: int, block_rows: int,
                   threads: int, chaos: bool = False,
                   pace_rate: float | None = None) -> dict:
        """``n_streams`` concurrent streams (``corpus`` repeated) fed
        round-robin from ``threads`` connections, admitted to verdict;
        every verdict equal to its serial oracle.  ``pace_rate``
        (blocks/s, over all connections) holds the feed below capacity,
        as the bench's latency probe does."""
        import itertools
        import threading

        from jepsen_tpu_torch.history.columnar import iter_row_blocks

        nc = len(corpus)
        blocks = [list(iter_row_blocks(rows, block_rows))
                  for rows, _n, _o in corpus]
        total = sum(len(blocks[i % nc]) for i in range(n_streams))
        verdicts: list = [None] * n_streams
        errors: list = []
        tickets = itertools.count()

        def work(j):
            try:
                with self.client() as c:
                    mine = list(range(j, n_streams, threads))
                    sids = {i: c.stream_open("queue")["stream"]
                            for i in mine}
                    cur = dict.fromkeys(mine, 0)
                    while any(cur[i] < len(blocks[i % nc]) for i in mine):
                        for i in mine:
                            b = blocks[i % nc]
                            if cur[i] >= len(b):
                                continue
                            if pace_rate:
                                wait = (t0 + next(tickets) / pace_rate
                                        - time.perf_counter())
                                if wait > 0:
                                    time.sleep(wait)
                            rep = c.stream_feed_rows(sids[i], cur[i],
                                                     *b[cur[i]])
                            if rep["op"] != "accepted":
                                raise AssertionError(f"service: {rep}")
                            cur[i] += 1
                    for i in mine:
                        verdicts[i] = c.stream_finish(sids[i], timeout=300)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        before = self.stats()["k1_launches"]
        workers = [threading.Thread(target=work, args=(j,))
                   for j in range(threads)]
        t0 = time.perf_counter()
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=600)
        wall = time.perf_counter() - t0
        if errors or any(w.is_alive() for w in workers):
            raise AssertionError(f"service: {self.name} streams failed: "
                                 f"{errors[:1]}")
        stats = self.stats()
        for i, v in enumerate(verdicts):
            if _families(v) != corpus[i % nc][2]:
                raise AssertionError(f"service: {self.name} stream {i} "
                                     "differs from its serial oracle")
        degraded = sum("degraded" in v for v in verdicts)
        if chaos and (stats["worker_deaths"] != 1 or not degraded):
            raise AssertionError(f"service: chaos claimed no recovery: "
                                 f"{stats}")
        if not chaos and (degraded or stats["worker_deaths"]):
            raise AssertionError(f"service: {self.name}: {stats}")
        m = self.metrics()
        sketches = {k: {p: v if (v := m.get(f"jepsen_tpu_service_{k}", {})
                                 .get(f'quantile="{p}"')) == v else None
                        for p in ("0.5", "0.99")}
                    for k in ("block_check_s", "submit_to_verdict_s")}
        return {"streams": n_streams, "blocks": total, "wall_s": wall,
                "blocks_per_s": total / wall, "degraded": degraded,
                "k1_launches": stats["k1_launches"] - before,
                "sketches": sketches, "stats": stats}

    def cache_arm(self, entry) -> dict:
        """A content key streamed before hits the verdict cache, by
        ``cache-get`` and by ``stream-open``; ``/metrics`` shows the
        service's counters."""
        import hashlib

        rows, _n, families = entry
        key = hashlib.sha256(np.ascontiguousarray(rows).tobytes()).hexdigest()
        with self.client() as c:
            got = c.cache_get(key, "queue")
            opened = c.stream_open("queue", content_key=key)
        if got["op"] != "cached" or opened["op"] != "cached" or _families(
                opened["verdict"]) != families:
            raise AssertionError(f"service: cache {got['op']} / "
                                 f"{opened['op']}")
        names = ("jepsen_tpu_service_cache_hits",
                 "jepsen_tpu_service_warmup_hits",
                 "jepsen_tpu_service_batch_salvages",
                 "jepsen_tpu_service_bucket_launches",
                 "jepsen_tpu_service_batch_fill")
        m = self.metrics()
        missing = [n for n in names if n not in m]
        if missing:
            raise AssertionError(f"service: /metrics lacks {missing}")
        return {"cache_get": got["op"], "stream_open": opened["op"],
                "cache": self.stats()["cache"],
                "cache_hits_metric": m["jepsen_tpu_service_cache_hits"][""]}

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            self.proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate(timeout=30)
        return self.proc.returncode


#: the segmented phase's configuration, SEGMENTED.md's: about 1,000,016
#: ops (the writer's count for seed 7) in segments of 65,536
LONG_OPS = 1_000_000
SEGMENT_OPS = 65_536
#: the bench phase's synthetic run, and its count of invalid histories,
#: the JAX package's on the same seeds (a seed with no acknowledged value
#: still queued at the drain gets no loss injected)
SYNTH_COUNT, SYNTH_OPS, SYNTH_INVALID = 1024, 1000, 999


def write_long_history(path: Path, n_ops: int = LONG_OPS, seed: int = 7):
    """Stream a synthetic queue history of about ``n_ops`` ops to
    ``path`` with memory bounded by the queue's depth: values off one
    counter, five processes, every acknowledged value dequeued in FIFO
    order, as the JAX package's long-history bench writes it; plus one
    lost value (acknowledged just before the boundary of segment 3 and
    never read) and one duplicate (a value read in segment 2 read again
    in segment 9).  Returns ``(ops written, lost value, duplicate)``."""
    rng = random.Random(seed)
    nxt, clock, written = 0, 0, 0
    fifo: list[int] = []
    lost = dup = first_read = None
    lost_at, dup_at = 3 * SEGMENT_OPS - 6, 9 * SEGMENT_OPS + 10
    with open(path, "w") as fh:

        def emit(type_, f, process, value):
            nonlocal clock, written
            clock += rng.randrange(1, 2_000_000)
            fh.write(json.dumps({
                "index": written, "type": type_, "f": f,
                "process": process, "time": clock, "value": value}) + "\n")
            written += 1

        while written < n_ops - 4:
            p = rng.randrange(5)
            if lost is None and written >= lost_at:
                lost, nxt = nxt, nxt + 1
                emit("invoke", "enqueue", p, lost)
                emit("ok", "enqueue", p, lost)  # never queued: lost
            elif dup is None and written >= dup_at:
                dup = first_read
                emit("invoke", "dequeue", p, None)
                emit("ok", "dequeue", p, dup)  # read a second time
            elif fifo and (len(fifo) > 16 or rng.random() < 0.45):
                v = fifo.pop(0)
                emit("invoke", "dequeue", p, None)
                emit("ok", "dequeue", p, v)
                if first_read is None and written > 2 * SEGMENT_OPS:
                    first_read = v
            else:
                v, nxt = nxt, nxt + 1
                emit("invoke", "enqueue", p, v)
                emit("ok", "enqueue", p, v)
                fifo.append(v)
        while fifo:
            v = fifo.pop(0)
            emit("invoke", "dequeue", 0, None)
            emit("ok", "dequeue", 0, v)
    return written, lost, dup


def _wide_rows(n_values: int, seed: int = 0) -> np.ndarray:
    """The rows of one segment whose queue rows hold ``n_values`` distinct
    values in 1.5 rows each (every other value enqueued and acknowledged,
    the rest only read), at global positions past 2**20: at 40,000 values,
    L=65,536 and V=65,536."""
    from jepsen_tpu_torch.history.ops import Op, OpF, OpType
    from jepsen_tpu_torch.history.rows import _rows_for

    rng = np.random.default_rng(seed)
    ops = []
    for i, v in enumerate(rng.permutation(4 * n_values)[:n_values].tolist()):
        if i % 2:
            ops.append(Op(OpType.OK, OpF.DEQUEUE, 7, v, time=4))
        else:
            ops += [Op.invoke(OpF.ENQUEUE, v % 5, v, time=1),
                    Op(OpType.OK, OpF.ENQUEUE, v % 5, v, time=2)]
    for i, op in enumerate(ops):
        op.index = (1 << 20) + i
    return _rows_for(ops)


def _device_ops(trace: Path, n: int = 10) -> dict:
    """The ``n`` longest device operations of a ``torch.profiler`` Chrome
    trace (kernels, copies, sets), and the ``n`` names with the most
    device time in all, in µs."""
    events = json.loads(trace.read_text())["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in (
        "kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:  # the profiler saw no card activity: nothing to rank
        return {"device_ops": 0, "device_us": 0.0, "kernels": 0,
                "kernel_us": 0.0, "k1_us": 0.0, "longest": [], "by_name": []}
    longest = sorted(dev, key=lambda e: -e["dur"])[:n]
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    return {
        "device_ops": len(dev),
        "device_us": sum(e["dur"] for e in dev),
        "kernels": len(kernels),
        "kernel_us": sum(e["dur"] for e in kernels),
        "k1_us": sum(e["dur"] for e in kernels
                     if "queue_stats_kernel" in e["name"]),
        "longest": [{"name": e["name"], "cat": e["cat"], "dur_us": e["dur"]}
                    for e in longest],
        "by_name": sorted(by_name.items(), key=lambda kv: -kv[1])[:n],
    }


def _producer_breakdown(paths) -> dict:
    """Milliseconds per history of each piece of the pipeline's host
    stage, timed alone over ``paths`` (whose ``.jtc`` exist): a cache
    read (``load_rows_cache``), of which the ``.jtc`` file's bytes alone;
    the host pack of 64-history chunks; and what a cold pass does
    instead of the cache read, the native parse and the ``.jtc`` write."""
    from jepsen_tpu_torch.history.encode import pack_row_matrices
    from jepsen_tpu_torch.history.fastpack import pack_files
    from jepsen_tpu_torch.history.rows import load_rows_cache, save_rows_cache
    from jepsen_tpu_torch.parallel.pipeline import _pow2_bucket

    out, n = {}, len(paths)
    t0 = time.perf_counter()
    mats = [load_rows_cache(p)[1] for p in paths]
    out["cache_read"] = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for p in paths:
        p.with_suffix(".jtc").read_bytes()
    out["jtc_bytes_read"] = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for i in range(0, n, 64):
        chunk = mats[i:i + 64]
        pack_row_matrices(
            chunk, length=_pow2_bucket(max(m.shape[0] for m in chunk)),
            value_space=_pow2_bucket(max(int(m[:, 4].max()) for m in chunk)
                                     + 1), device="cpu")
    out["host_pack"] = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    parsed = pack_files(paths, use_jtc=False)
    out["native_parse"] = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    for p, (workload, rows) in zip(paths, parsed):
        save_rows_cache(p, workload, rows)
    out["jtc_write"] = (time.perf_counter() - t0) / n * 1e3
    return out


def _record(rec: dict) -> None:
    """Append one run's kernel table and timings to ``RECORD``, so that
    each run's numbers are kept and not only the end of its output."""
    RECORD.parent.mkdir(parents=True, exist_ok=True)
    rec = {"at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()), **rec}
    with RECORD.open("a") as fh:
        fh.write(json.dumps(rec) + "\n")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import jepsen_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable: {e}", file=sys.stderr)
        return 2
    s = Smoke()
    # each phase with the phase it needs
    phases = [(s.card_phase, None), (s.build_phase, None),
              (s.exact_phase, "build_phase"), (s.main_phase, "build_phase"),
              (s.recorded_phase, "build_phase"), (s.timing_phase, "main_phase"),
              (s.pipeline_phase, "build_phase"),
              (s.bench_phase, "pipeline_phase"),
              (s.segmented_phase, "build_phase"),
              (s.service_phase, "build_phase")]
    failed = []
    try:
        for phase, needs in phases:
            if needs in failed:
                failed.append(phase.__name__)
                print(f"SKIPPED: {phase.__name__} (needs {needs})",
                      file=sys.stderr)
                continue
            t0 = time.perf_counter()
            try:
                phase()
            except Exception:
                traceback.print_exc()
                failed.append(phase.__name__)
                print(f"FAILED: {phase.__name__}", file=sys.stderr)
            print(f"# {phase.__name__}: {time.perf_counter() - t0:.2f} s",
                  file=sys.stderr)
    finally:
        shutil.rmtree(s.tmp, ignore_errors=True)
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    kernel = {
        "name": "queue_stats",
        "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/queue_stats.cu",
        "replaces": "jepsen_tpu/ops/pallas_stats.py:76",
        **s.kernel,
        "shapes": s.shapes,
    }
    _record({"card": s.card, "torch": torch.__version__,
             "kernels": [kernel], "timing": s.timing, "build": s.build,
             "exact": s.exact, "pipeline": s.pipeline, "bench": s.bench,
             "segmented": s.segmented, "service": s.service,
             "matplotlib": s.matplotlib})
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
