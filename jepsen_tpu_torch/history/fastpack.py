"""Native history packing: JSONL -> ``[n, 8]`` int32 rows in C++.

The port's own ``ctypes`` binding of the repository's
``native/rows_packer.cpp``, which fuses the JSONL parse, the workload
classification and the row explosion of ``rows._rows_for`` into one
pass, bit for bit the same rows.  The library is built with ``g++`` at
its first use into ``jepsen_tpu_torch/_build/`` (keyed on a hash of the
source and the flags); nothing is built when the module is imported.  A
library that fails to build raises, with the compiler's text.

:func:`pack_file` returns None on input the C parser flags (malformed
JSON, unknown enum names, out-of-range values) and on ``.edn`` paths:
the caller then reads the file with the Python packer, which raises
the canonical error.  Before parsing, each entry point serves a
stat-fresh sibling ``.jtc`` (``history/columnar.py``) without a parse;
``JEPSEN_TPU_NO_JTC=1`` turns that off, as it does on the Python side.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from jepsen_tpu_torch.obs import trace as obs_trace

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "rows_packer.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread",
             "-shared")

#: workload codes of the C ABI, in order
_WORKLOADS = ("queue", "stream", "elle", "mutex")


class _JtPackResult(ctypes.Structure):
    _fields_ = [
        ("rows", ctypes.POINTER(ctypes.c_int32)),
        ("n_rows", ctypes.c_int64),
        ("workload", ctypes.c_int32),
        ("err", ctypes.c_int32),
        ("err_line", ctypes.c_int64),
    ]


_load_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _lib_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"librows_packer-{digest[:16]}.so"


def build() -> Path:
    """Compile ``native/rows_packer.cpp`` unless its library exists;
    return the library.  Raises ``RuntimeError`` with the compiler's
    output when the build fails."""
    lib = _lib_path()
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
           str(SOURCE)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              check=False)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]} to build {SOURCE.name}: "
                           f"{e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{cmd[0]} failed for {SOURCE.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}")
    os.replace(tmp, lib)  # atomic against a concurrent build
    return lib


def _load() -> ctypes.CDLL:
    """The packer library, built at the first call."""
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        res = ctypes.POINTER(_JtPackResult)
        lib.jt_pack_file.restype = res
        lib.jt_pack_file.argtypes = [ctypes.c_char_p]
        lib.jt_pack_free.restype = None
        lib.jt_pack_free.argtypes = [res]
        lib.jt_pack_files.restype = ctypes.POINTER(res)
        lib.jt_pack_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32, ctypes.c_int32]
        lib.jt_files_free.restype = None
        lib.jt_files_free.argtypes = [ctypes.c_void_p]
        lib.jt_jtc_disable.restype = None
        lib.jt_jtc_disable.argtypes = [ctypes.c_int32]
        _lib = lib
        return lib


#: serializes batch calls that turn the native ``.jtc`` serve off: the
#: switch is process-wide, so such a caller holds it for its whole batch
_no_jtc_lock = threading.Lock()


class _jtc_disabled:
    """Context manager: turn the native ``.jtc`` serve off for one batch
    call when ``active``."""

    def __init__(self, lib, active: bool):
        self.lib = lib if active else None

    def __enter__(self):
        if self.lib is not None:
            _no_jtc_lock.acquire()
            self.lib.jt_jtc_disable(1)
        return self

    def __exit__(self, *exc):
        if self.lib is not None:
            self.lib.jt_jtc_disable(0)
            _no_jtc_lock.release()
        return False


def _conv_pack(r) -> tuple[str, np.ndarray] | None:
    if r.err != 0:
        return None
    n = int(r.n_rows)
    if n == 0:
        rows = np.zeros((0, 8), np.int32)
    else:
        rows = np.ctypeslib.as_array(r.rows, shape=(n, 8)).copy()
    return _WORKLOADS[r.workload], rows


def pack_file(jsonl_path: str | Path) -> tuple[str, np.ndarray] | None:
    """``(workload, rows)`` of a JSONL history by the native packer, or
    None for an ``.edn`` path or input the C parser flags."""
    p = Path(jsonl_path)
    if p.suffix == ".edn":
        return None
    lib = _load()
    res = lib.jt_pack_file(str(p).encode())
    if not res:
        return None
    try:
        return _conv_pack(res.contents)
    finally:
        lib.jt_pack_free(res)


def pack_files(paths, threads: int = 0, use_jtc: bool = True) -> list:
    """:func:`pack_file` of many files in one native call over a thread
    pool (``threads=0``: one per core), with the GIL released for the
    whole batch: ``[(workload, rows) | None, ...]`` aligned with
    ``paths``.  ``use_jtc=False`` turns the ``.jtc`` serve off for this
    batch, so every file is parsed."""
    lib = _load()
    out: list = [None] * len(paths)
    idx = [i for i, p in enumerate(paths) if Path(p).suffix != ".edn"]
    if not idx:
        return out
    arr = (ctypes.c_char_p * len(idx))(
        *[str(Path(paths[i])).encode() for i in idx])
    # one trace span per native batch, as the JAX package records it; its
    # args are built only when the tracer is on
    span = obs_trace.span(
        "fastpack.jt_pack_files",
        args={"files": len(idx), "part": 0, "n_parts": 1, "use_jtc": use_jtc}
        if obs_trace.is_enabled() else None)
    with span, _jtc_disabled(lib, not use_jtc):
        res = lib.jt_pack_files(arr, len(idx), int(threads))
    if not res:
        raise MemoryError("the native packer could not allocate its "
                          f"result table for {len(idx)} files")
    try:
        for j, i in enumerate(idx):
            r = res[j]
            if r:
                try:
                    out[i] = _conv_pack(r.contents)
                finally:
                    lib.jt_pack_free(r)
    finally:
        lib.jt_files_free(res)
    return out
