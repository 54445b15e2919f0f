"""Parallel host packing: row explosion in worker processes.

At batched-replay scale host packing, not the card, sets the wall time.
Row explosion (``rows._rows_for``) is per history and independent, so
this module fans it out over worker processes: each worker synthesizes
its seed range or reads its chunk of files itself, and only the compact
``[n, 8]`` int32 row matrices come back (no ``Op`` object and no tensor
crosses the process boundary); the one ``pack_row_matrices`` assembly
stays in the parent.  The port's counterpart of the JAX package's
``history/parpack.py``.

Workers are plain subprocesses running ``python -m
jepsen_tpu_torch.history.parpack IN OUT`` with an explicit environment:
the repository root importable and ``CUDA_VISIBLE_DEVICES`` empty, so
that no worker ever opens the card.  Work goes in and rows come out as
pickle files; a worker that fails is a loud error.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Sequence

#: the module the workers run
WORKER_MODULE = "jepsen_tpu_torch.history.parpack"


def _synth_queue_rows(args):  # pragma: no cover - runs in child processes
    count, start_seed, n_ops, lost = args
    from jepsen_tpu_torch.history.rows import _rows_for
    from jepsen_tpu_torch.history.synth import SynthSpec, synth_batch

    return [
        _rows_for(sh.ops)
        for sh in synth_batch(
            count, SynthSpec(n_ops=n_ops, seed=start_seed), lost=lost
        )
    ]


def _read_rows(paths):  # pragma: no cover - runs in child processes
    from jepsen_tpu_torch.history.rows import rows_with_cache

    # load-through cache: a fresh cache skips the parse; a miss leaves
    # one behind for the next check
    return [rows_with_cache(p)[:2] for p in paths]


_WORKER_FNS = {"synth": _synth_queue_rows, "read": _read_rows}


def _worker_env() -> dict:
    """The child environment: the repository root first on
    ``PYTHONPATH``, and no card visible."""
    env = dict(os.environ)
    repo_root = str(Path(__file__).resolve().parents[2])
    kept = [
        p
        for p in env.get("PYTHONPATH", "").split(os.pathsep)
        if p and p != repo_root
    ]
    env["PYTHONPATH"] = os.pathsep.join([repo_root, *kept])
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def _worker_argv(fin: str, fout: str) -> list[str]:
    return [sys.executable, "-m", WORKER_MODULE, fin, fout]


def _fan_out(fn_name: str, chunks, workers: int):
    import pickle
    import shutil
    import subprocess
    import tempfile

    env = _worker_env()
    tmpdir = tempfile.mkdtemp(prefix="jt-parpack-")
    procs = []
    try:
        for i, chunk in enumerate(chunks):
            fin = os.path.join(tmpdir, f"in{i}.pkl")
            fout = os.path.join(tmpdir, f"out{i}.pkl")
            with open(fin, "wb") as fh:
                pickle.dump((fn_name, chunk), fh)
            procs.append(
                (subprocess.Popen(_worker_argv(fin, fout), env=env), fout)
            )
        out = []
        for p, fout in procs:
            rc = p.wait()
            if rc != 0:
                raise RuntimeError(
                    f"pack worker exited rc={rc} (cmd: {p.args})"
                )
            with open(fout, "rb") as fh:
                out.extend(pickle.load(fh))
        return out
    finally:
        for p, _f in procs:
            if p.poll() is None:  # an earlier worker's failure aborts us
                p.kill()
                p.wait()
        shutil.rmtree(tmpdir, ignore_errors=True)


def _worker_main(argv) -> int:  # pragma: no cover - child process entry
    import pickle

    fin, fout = argv
    with open(fin, "rb") as fh:
        fn_name, chunk = pickle.load(fh)
    result = _WORKER_FNS[fn_name](chunk)
    with open(fout, "wb") as fh:
        pickle.dump(result, fh)
    return 0


def synth_queue_rows_parallel(
    count: int, n_ops: int, lost: int, workers: int, base_seed: int = 0
):
    """Synthesize and explode ``count`` queue histories across
    ``workers`` processes: the same row matrices, in the same order, as
    the serial ``synth_batch`` → ``_rows_for`` (chunk c covers seeds
    ``base_seed + [start, start+k)``)."""
    bounds = [
        (count * w // workers, count * (w + 1) // workers)
        for w in range(workers)
    ]
    chunks = [
        (hi - lo, base_seed + lo, n_ops, lost)
        for lo, hi in bounds
        if hi > lo
    ]
    return _fan_out("synth", chunks, len(chunks))


def read_rows_parallel(paths: Sequence, workers: int):
    """Read and explode stored histories (JSONL or EDN) across workers,
    in order: ``[(workload, rows_matrix), ...]``, so that the caller
    applies the same family filter as the serial path."""
    paths = [str(p) for p in paths]
    chunks = [
        paths[len(paths) * w // workers : len(paths) * (w + 1) // workers]
        for w in range(workers)
    ]
    chunks = [c for c in chunks if c]
    return _fan_out("read", chunks, len(chunks))


if __name__ == "__main__":  # pragma: no cover - child process entry
    sys.exit(_worker_main(sys.argv[1:]))
