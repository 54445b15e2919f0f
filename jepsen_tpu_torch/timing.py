"""Timing on the card, and K1 of two checkouts timed in turns.

    python -m jepsen_tpu_torch.timing OLD_ROOT NEW_ROOT

times the per-value stats kernel K1 of two checkouts of this repository
on one card, at ``chip_smoke.py``'s main-path shape (:func:`main_batch`),
in the order old, new, new, old.  Each turn is a process of its own that
imports the ``jepsen_tpu_torch`` of its checkout and calls that
checkout's own ``fused_queue_stats``, so each kernel is launched through
the binding it was built with.  Each turn holds K1 bit-exact against the
checkout's plain version, and both checkouts must give the same stats.
A turn reports K1 per call three ways: back to back through the wrapper
(CUDA events, host overhead included where it exceeds the kernel's
time), by device time, and by the wrapper's host time.  It prints the
card and one JSON line per turn.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

BASE_HISTORIES = 128
N_OPS = 470
LENGTH = 1024
MAIN_B = 10_240
SLEEP_CYCLES = 200_000_000  # about 0.1 s: holds the card while calls enqueue
TURNS = ("old", "new", "new", "old")


def main_batch():
    """128 distinct synthetic histories (470 ops, 5 processes, one lost
    and one duplicated value each) packed at L=1024 on the host."""
    from jepsen_tpu_torch.history.encode import pack_histories
    from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch

    base = synth_batch(
        BASE_HISTORIES, SynthSpec(n_ops=N_OPS, n_processes=5),
        lost=1, duplicated=1,
    )
    hs = [sh.ops for sh in base]
    return hs, pack_histories(hs, length=LENGTH, device="cpu")


def tile(packed, reps: int, dev):
    """``packed`` repeated ``reps`` times along the batch, on ``dev``."""
    import dataclasses

    from jepsen_tpu_torch.history.encode import TENSOR_FIELDS

    return dataclasses.replace(
        packed,
        **{k: getattr(packed, k).repeat(reps, 1).to(dev) for k in TENSOR_FIELDS},
    )


def event_ms(fn, n: int) -> float:
    """Time per call of ``fn`` over ``n`` calls back to back, by CUDA
    events: host overhead between launches counts where it exceeds the
    device's time."""
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


def queued_ms(fn, n: int) -> tuple[float, float]:
    """``(device ms, host µs)`` per call of ``fn``: ``n`` calls are
    enqueued behind a sleep on the card, so the card runs them without
    host gaps and the host enqueues them without waiting on the card.
    Fails if the sleep ended before the last call was enqueued."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    end.record()
    if start.query():
        raise AssertionError("the card reached the timed calls before they "
                             "were all enqueued; raise SLEEP_CYCLES")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host_us


def _turn(root: Path) -> dict:
    """One turn, in a process whose ``jepsen_tpu_torch`` is ``root``'s."""
    sys.path.insert(0, str(root))
    import jepsen_tpu_torch
    from jepsen_tpu_torch.ops.queue_stats import (
        fused_queue_stats,
        queue_stats_plain,
    )

    if not Path(jepsen_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {jepsen_tpu_torch.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    _, host = main_batch()
    g = tile(host, MAIN_B // BASE_HISTORIES, dev)
    k = fused_queue_stats(g)
    p = queue_stats_plain(g.f, g.type, g.value, g.mask, g.value_space)
    digest = hashlib.sha256()
    for f in "aexdst":
        if not torch.equal(getattr(k, f), getattr(p, f)):
            raise AssertionError(f"{root}: K1 differs from plain in {f}")
        digest.update(getattr(k, f).cpu().numpy().tobytes())
    ms = event_ms(lambda: fused_queue_stats(g), 50)
    device_ms, host_us = queued_ms(lambda: fused_queue_stats(g), 50)
    return {"root": str(root), "B": g.batch, "L": g.length,
            "V": g.value_space, "ms": ms, "device_ms": device_ms,
            "host_us": host_us, "stats_sha256": digest.hexdigest()}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--turn"]:  # one turn, in a process of its own
        print(json.dumps(_turn(Path(argv[1]).resolve())))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, help="root of the earlier checkout")
    ap.add_argument("new", type=Path, help="root of the later checkout")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    digests = set()
    for which in TURNS:
        root = getattr(args, which).resolve()
        # -P: the checkout on sys.path is the only jepsen_tpu_torch found
        proc = subprocess.run(
            [sys.executable, "-P", __file__, "--turn", str(root)],
            capture_output=True, text=True, timeout=600, check=False,
        )
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rec = {"turn": which, "card": card,
               **json.loads(proc.stdout.strip().splitlines()[-1])}
        digests.add(rec["stats_sha256"])
        print(json.dumps(rec), flush=True)
    if len(digests) != 1:
        print("the two checkouts' stats differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
