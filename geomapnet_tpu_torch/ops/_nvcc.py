"""Build a CUDA source of ``geomapnet_tpu_torch/csrc/`` at first use and bind
it with ctypes.

Every kernel of the port is a ``.cu`` file with a plain C entry point. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``geomapnet_tpu_torch/_build/``, named by a hash of its source and flags (an
edited source rebuilds; the old library stays unused), and loaded once per
process. ``ptxas -v`` reports each kernel's registers, shared memory and
spills; the report is kept beside the library (:func:`build_log`). Nothing
here runs at import: the CPU tests import every module of the port on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build", "build_log",
           "load", "tool"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# never --use_fast_math: the kernels' rounding is held bit for bit against
# their plain PyTorch versions
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH,
    else under ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``)."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put it on PATH); "
                       "it is needed to build the port's CUDA kernels")


def _library(source: str) -> Path:
    src = CSRC / source
    key = hashlib.sha1(src.read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libgm_{src.stem}_{key}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into ``_build/`` (keyed by a hash of its
    source and flags) unless that library exists; return its path."""
    lib = _library(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [tool(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} ({proc.returncode}):\n{proc.stdout}\n"
            f"{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build_log(source: str) -> str:
    """What ``nvcc`` and ``ptxas -v`` printed when ``csrc/<source>`` was
    built (the library is built first if needed)."""
    return build(source).with_suffix(".log").read_text()


def load(source: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built if needed; ``bind``
    sets its functions' ``argtypes`` / ``restype`` once, at first load."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _libs[source] = lib
    return lib
