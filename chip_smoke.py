#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jepsen_tpu_torch``) on one card.

Run from the root of the repository, on a host with one NVIDIA H100:

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

1. the card, from torch and from ``nvidia-smi``;
2. build the CUDA kernel from ``jepsen_tpu_torch/csrc`` with nvcc;
3. hold the kernel bit-exact against its plain PyTorch version on the
   card: the anomaly corpus, L=128, L and V off multiples of 128, int32
   values (V > 32767), explicit positions;
4. the main path at full width: 128 distinct synthetic histories
   (470 ops, 5 processes, one lost and one duplicated value each) packed
   at L=1024 and tiled to B=10,240, checked through the kernel under
   both delivery contracts and both output layouts; the tensors equal
   the plain path on the card, the result maps of the 128 distinct
   histories equal the CPU oracles, and the kernel's launch count rose;
5. ``python -m jepsen_tpu_torch check`` on two recorded runs, whose
   ``queue``/``linear`` maps must equal the run's ``results.json``;
6. timing with CUDA events at the main-path shape.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  A good run also appends its kernel
table and timings, with the card, to ``chiprun_out/chip_smoke.jsonl``.  Without a CUDA device, or without the
package beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RECORD = ROOT / "chiprun_out" / "chip_smoke.jsonl"  # one line per good run
BASE_HISTORIES = 128
N_OPS = 470
LENGTH = 1024
MAIN_B = 10_240
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


def _main_batch():
    """128 distinct histories packed at L=1024 on the host."""
    from jepsen_tpu_torch.history.encode import pack_histories
    from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch

    base = synth_batch(
        BASE_HISTORIES, SynthSpec(n_ops=N_OPS, n_processes=5),
        lost=1, duplicated=1,
    )
    hs = [sh.ops for sh in base]
    return hs, pack_histories(hs, length=LENGTH, device="cpu")


def _tile(packed, reps: int, dev):
    from jepsen_tpu_torch.history.encode import TENSOR_FIELDS

    return dataclasses.replace(
        packed,
        **{k: getattr(packed, k).repeat(reps, 1).to(dev) for k in TENSOR_FIELDS},
    )


class Smoke:
    def __init__(self):
        self.dev = torch.device("cuda", 0)
        self.card = ""
        self.kernel = {}
        self.timing = {}

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
        _build.build("queue_stats")
        _build.load("queue_stats")
        print(f"build: queue_stats.cu with nvcc {' '.join(_build.NVCC_FLAGS)} "
              f"in {time.perf_counter() - t0:.2f} s")

    def exact_phase(self):
        from jepsen_tpu_torch.history.encode import TENSOR_FIELDS, pack_histories
        from jepsen_tpu_torch.history.rows import _rows_for
        from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch
        from jepsen_tpu_torch.ops.queue_stats import (
            fused_queue_stats,
            queue_stats_plain,
        )

        rng = np.random.default_rng(20261016)
        cases = []
        for anomalies in ({}, {"lost": 2}, {"duplicated": 1},
                          {"unexpected": 1}, {"phantom_fail": 1},
                          {"causality": 1}):
            shs = synth_batch(4, SynthSpec(n_ops=200), **anomalies)
            cases.append((f"corpus{anomalies}",
                          pack_histories([s.ops for s in shs], device="cpu"),
                          None))
        shs = synth_batch(2, SynthSpec(n_ops=40))
        cases.append(("L=128", pack_histories(
            [s.ops for s in shs], length=128, device="cpu"), None))
        hs = [s.ops for s in synth_batch(3, SynthSpec(n_ops=100),
                                         lost=1, causality=1)]
        rows = [_rows_for(h) for h in hs]
        V = max(int(r[:, 4].max()) for r in rows) + 1
        V += V % 128 == 0
        L = max(r.shape[0] for r in rows) + 3
        L += L % 128 == 0
        cases.append((f"L={L},V={V}", pack_histories(
            hs, length=L, value_space=V, device="cpu"), None))
        cases.append(("int32 values V=40000",
                      _random_packed(rng, 16, 1000, 40_000, "cpu"), None))
        p = _random_packed(rng, 12, 777, 5000, "cpu")
        pos = torch.from_numpy(
            rng.integers(0, 2**31 - 1, (12, 777)).astype(np.int32))
        cases.append(("explicit pos V=5000", p, pos))
        for name, packed, pos in cases:
            g = dataclasses.replace(packed, **{
                k: getattr(packed, k).to(self.dev) for k in TENSOR_FIELDS})
            gpos = None if pos is None else pos.to(self.dev)
            k = fused_queue_stats(g, gpos)
            pl = queue_stats_plain(g.f, g.type, g.value, g.mask,
                                   g.value_space, gpos)
            torch.cuda.synchronize()
            err = _stats_err(k, pl)
            _equal_fields(k, pl, f"K1 vs plain on the card, {name}")
            cpu = queue_stats_plain(packed.f, packed.type, packed.value,
                                    packed.mask, packed.value_space, pos)
            _equal_fields(dataclasses.replace(k, **{
                f: getattr(k, f).cpu() for f in "aexdst"}), cpu,
                f"K1 vs plain on the CPU, {name}")
            print(f"exact: {name} B={packed.batch} L={packed.length} "
                  f"V={packed.value_space} value={packed.value.dtype} "
                  f"max_abs_err={err}")

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

        hs, host = _main_batch()
        reps = MAIN_B // BASE_HISTORIES
        g = _tile(host, reps, self.dev)
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
        print(f"main: K1 launches on the main path = {launches}")
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
        from jepsen_tpu_torch.checkers.protocol import VALID, merge_valid
        from jepsen_tpu_torch.ops.queue_stats import fused_queue_stats

        for store, delivery in STORES:
            argv = ["check", str(ROOT / store), "--device", str(self.dev)]
            if delivery:
                argv += ["--delivery", delivery]
            buf = io.StringIO()
            fused_queue_stats.launches = 0
            with contextlib.redirect_stdout(buf):
                rc = cli(argv)
            torch.cuda.synchronize()
            launches = fused_queue_stats.launches
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
            valid = merge_valid([got["queue"][VALID], got["linear"][VALID]])
            if launches <= 0 or rc != (0 if valid is True else 1):
                raise AssertionError(f"{store}: rc={rc} launches={launches}")
            print(f"recorded: {store}: queue/linear == results.json "
                  f"({sum(len(want[f]) for f in ('queue', 'linear'))} keys), "
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

        g, host = self.g, self.host
        B, L, V = g.batch, g.length, g.value_space

        def event_ms(fn, n: int) -> float:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / n

        ms = event_ms(lambda: fused_queue_stats(g), 50)
        plain_ms = event_ms(lambda: queue_stats_plain(
            g.f, g.type, g.value, g.mask, V), 10)
        nbytes = sum(t.numel() * t.element_size()
                     for t in (g.f, g.type, g.value, g.mask)) + B * 6 * V * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = OPS_PER_ROW * B * L / INT32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"timing: K1 {ms:.6f} ms, plain {plain_ms:.6f} ms, bound "
              f"{bound_ms:.6f} ms ({nbytes} bytes; ops bound "
              f"{ops_ms:.6f} ms) at B={B} L={L} V={V} on {self.card}")

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

        for _ in range(2):
            copied_check()
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            copied_check()
        torch.cuda.synchronize()
        copy_ms = (time.perf_counter() - t0) / n * 1e3
        print(f"timing: device check (K1 + both classifiers, packed out) "
              f"{check_ms:.6f} ms = {B / check_ms * 1e3:.1f} histories/s "
              f"without the host->device copy; {copy_ms:.6f} ms = "
              f"{B / copy_ms * 1e3:.1f} histories/s with it, on {self.card}")
        self.timing = {
            "B": B, "L": L, "V": V, "k1_ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "total_queue_classify_ms": tq_ms,
            "queue_lin_classify_ms": ql_ms, "device_check_ms": check_ms,
            "device_check_hist_per_s": B / check_ms * 1e3,
            "with_copy_ms": copy_ms, "with_copy_hist_per_s": B / copy_ms * 1e3,
        }
        self.kernel.update(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes"
            if bytes_ms >= ops_ms else "operations", library_ms=None,
        )


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
              (s.recorded_phase, "build_phase"), (s.timing_phase, "main_phase")]
    failed = []
    for phase, needs in phases:
        if needs in failed:
            failed.append(phase.__name__)
            print(f"SKIPPED: {phase.__name__} (needs {needs})", file=sys.stderr)
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
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    kernel = {
        "name": "queue_stats",
        "route": "cuda",
        "source": "jepsen_tpu_torch/csrc/queue_stats.cu",
        "replaces": "jepsen_tpu/ops/pallas_stats.py:76",
        **s.kernel,
    }
    _record({"card": s.card, "torch": torch.__version__,
             "kernels": [kernel], "timing": s.timing})
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
