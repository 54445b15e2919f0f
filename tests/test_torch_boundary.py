"""The port's boundary: it imports neither JAX nor the JAX package,
initializes no CUDA context when imported, and never falls back to the
CPU when CUDA was asked for and no card is present."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from jepsen_tpu_torch.checkers.fused import check_queue_batch, combined_tensor_check
from jepsen_tpu_torch.entry import entry
from jepsen_tpu_torch.history.encode import pack_histories
from jepsen_tpu_torch.history.synth import SynthSpec, synth_history

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "jepsen_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "jepsen_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


#: modules the scans must cover by name (the service slice's among them)
REQUIRED = ("service/protocol.py", "service/cache.py", "service/stream.py",
            "service/batcher.py", "service/server.py", "service/client.py",
            "report/index.py", "history/prefix_index.py")


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    scanned = {p.relative_to(PORT).as_posix() for p in files
               if p.is_relative_to(PORT)}
    assert set(REQUIRED) <= scanned
    bad = [
        (str(p.relative_to(REPO)), m)
        for p in files
        for m in _imported_modules(p)
        if _forbidden(m)
    ]
    assert bad == []
    assert not _forbidden("jepsen_tpu_torch.ops")


def test_importing_the_port_loads_no_jax_and_no_cuda_context():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, json, sys, torch\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps({'loaded': sorted(k for k in sys.modules if k in "
        f"{list(FORBIDDEN)!r} or k.startswith(('jax.', 'jepsen_tpu.'))), "
        "'cuda': torch.cuda.is_initialized()}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["loaded"] == [] and report["cuda"] is False
    assert len(modules) > 10
    assert {"jepsen_tpu_torch." + m.removesuffix(".py").replace("/", ".")
            for m in REQUIRED} <= set(modules)


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    h = synth_history(SynthSpec(n_ops=30)).ops
    with pytest.raises(RuntimeError, match="no CUDA device"):
        combined_tensor_check(pack_histories([h]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_queue_batch([h])
    fn, args = entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(*args)


def test_parpack_children_run_the_port_module_and_import_no_jax(tmp_path):
    """A pack worker is started by the command line ``_fan_out`` uses: the
    port's module, with no card visible, importing nothing of JAX or the
    JAX package; its rows are the serial path's."""
    import pickle

    from jepsen_tpu_torch.history.parpack import _worker_argv, _worker_env
    from jepsen_tpu_torch.history.rows import _rows_for
    from jepsen_tpu_torch.history.synth import synth_batch

    fin, fout = tmp_path / "in.pkl", tmp_path / "out.pkl"
    fin.write_bytes(pickle.dumps(("synth", (2, 5, 30, 1))))
    argv = _worker_argv(str(fin), str(fout))
    assert argv[1:3] == ["-m", "jepsen_tpu_torch.history.parpack"]
    env = _worker_env()
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    p = subprocess.run(argv, env={**env, "PYTHONPROFILEIMPORTTIME": "1"},
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in p.stderr.splitlines()
                if line.startswith("import time:")}
    assert "jepsen_tpu_torch.history.synth" in imported
    assert [m for m in imported if _forbidden(m)] == []
    got = pickle.loads(fout.read_bytes())
    want = [_rows_for(sh.ops) for sh in synth_batch(
        2, SynthSpec(n_ops=30, seed=5), lost=1)]
    assert len(got) == 2 and all((a == b).all() for a, b in zip(got, want))


def test_serve_checker_process_loads_no_jax(tmp_path):
    """``serve-checker`` as a process (on the CPU, asked for), from its
    banner to SIGINT: every module it imported is the port's or another
    package's, none of JAX or the JAX package."""
    import signal
    import threading

    errlog = tmp_path / "stderr.txt"
    with open(errlog, "w") as err_fh:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "jepsen_tpu_torch",
             "serve-checker", "--device", "cpu", "--host", "127.0.0.1",
             "--port", "0", "--metrics-port", "0", "--batch", "--warmup",
             "--store", str(tmp_path)],
            cwd=REPO, stdout=subprocess.PIPE, stderr=err_fh, text=True)
    watchdog = threading.Timer(120, proc.kill)  # a hung start fails, late
    watchdog.start()
    try:
        banner = proc.stdout.readline()
        assert banner.startswith("checker sidecar on 127.0.0.1:"), banner
        proc.send_signal(signal.SIGINT)
        proc.communicate(timeout=60)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    err = errlog.read_text()
    assert proc.returncode == 0, err[-2000:]
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in err.splitlines()
                if line.startswith("import time:")}
    assert {"jepsen_tpu_torch.service.server",
            "jepsen_tpu_torch.service.batcher",
            "jepsen_tpu_torch.service.stream"} <= imported
    assert [m for m in imported if _forbidden(m)] == []
