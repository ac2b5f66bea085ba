"""Build the native image-IO library at first use:
``python -m geomapnet_tpu_torch.native.build`` builds it ahead of time.

``imageio.cc`` (a copy of :mod:`geomapnet_tpu.native`'s source) is compiled
with ``g++`` against libpng and libjpeg into ``geomapnet_tpu_torch/_build/``,
as :mod:`geomapnet_tpu_torch.ops._nvcc` builds the CUDA kernels. The
library's name carries a hash of the source, the flags and the host's CPU:
``-march=native`` code runs only on the kind of CPU that built it, and a
build directory copied to another host must not be reused there. The
compiler writes to a temporary name that is then renamed, so processes that
build at once never load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import sys
import threading
from pathlib import Path

__all__ = ["SOURCE", "BUILD_DIR", "FLAGS", "LIBS", "BuildError", "build",
           "command", "library_path"]

SOURCE = Path(__file__).resolve().parent / "imageio.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lpng", "-ljpeg", "-lpthread")


class BuildError(RuntimeError):
    """The compiler refused the library; the message is its output."""


def _host_cpu() -> str:
    """What ``-march=native`` depends on: the machine and, on Linux, the
    CPU's model and feature flags."""
    lines = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    lines.append(line.strip())
                if len(lines) == 3:
                    break
    except OSError:
        pass
    return "\n".join(lines)


def library_path() -> Path:
    """Where this host's build of the library lives (it may not exist)."""
    key = hashlib.sha1(SOURCE.read_bytes() + " ".join(FLAGS + LIBS).encode()
                       + _host_cpu().encode()).hexdigest()[:12]
    return BUILD_DIR / f"libgm_imageio_{key}.so"


def command(out: Path) -> list[str]:
    return ["g++", *FLAGS, str(SOURCE), "-o", str(out), *LIBS]


def build(verbose: bool = False) -> Path:
    """Compile the library unless this host's build exists; return its path.
    Raises :class:`BuildError` with the compiler's output when it fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = command(tmp)
    if verbose:
        print(" ".join(cmd))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:   # no g++ at all
        raise BuildError(f"{cmd[0]}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError((proc.stderr or proc.stdout).strip()
                         or f"g++ exited with {proc.returncode}")
    os.replace(tmp, lib)
    if verbose:
        print(f"built {lib}")
    return lib


if __name__ == "__main__":
    try:
        build(verbose=True)
    except BuildError as e:
        print(e, file=sys.stderr)
        sys.exit(1)
