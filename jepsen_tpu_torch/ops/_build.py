"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` compiles into a shared library with a plain C
interface, ``_build/lib<name>-<hash>.so``, keyed on a hash of the source
and the flags, and is loaded with ``ctypes``.  Nothing is built when the
package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from jepsen_tpu_torch.device import DeviceFault

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


class KernelBuildError(DeviceFault):
    """A kernel could not be built: its first line says which, the rest
    is the compiler's text."""


class KernelLaunchError(DeviceFault):
    """A kernel's launcher returned a CUDA error."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    raise KernelBuildError(
        "nvcc not found: put it on PATH or set CUDA_HOME")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return the
    library."""
    lib = _lib_path(name)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        check=False,
    )
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{proc.stdout}"
        )
    os.replace(tmp, lib)  # atomic against a concurrent build
    return lib


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name)))
