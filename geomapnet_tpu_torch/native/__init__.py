"""Native (C++) batch image decoder, bound with ctypes.

The port's counterpart of :mod:`geomapnet_tpu.native`, with the same names
and the same C ABI. ``imageio.cc`` is a copy of the JAX package's source
(tests/test_torch_import_isolation.py pins it). The library is built with
``g++`` against libpng and libjpeg the first time something here needs it
(:mod:`geomapnet_tpu_torch.native.build`), into the gitignored
``geomapnet_tpu_torch/_build/``; the JAX package's checked-in ``.so`` is
never loaded.

``decode_batch`` decodes and resizes a whole batch on a C++ thread pool into
one contiguous array (batch reads through io_uring, or pread where the
kernel or a seccomp policy refuses it, or with ``GM_DISABLE_URING=1``).

When the library cannot be built (no g++, or no libpng / libjpeg headers),
:func:`available` is False, the compiler's message is printed once to
stderr and kept (:func:`build_error`), and every decode call raises a
``RuntimeError`` that carries it: a caller that asked for the native path
never gets PIL in its place.
"""

from __future__ import annotations

import ctypes
import sys
import threading
from pathlib import Path

import numpy as np

from . import build as _build

__all__ = [
    "available",
    "build_error",
    "decode_batch",
    "decode_batch_gray",
    "decode_batch_gray16",
    "decode_image",
    "io_backend",
    "lib_path",
    "require",
]

_LIB = None
_TRIED = False
_ERROR: str | None = None
_lock = threading.Lock()


def lib_path() -> Path:
    """This host's build of the library (built on first use)."""
    return _build.library_path()


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    paths = ctypes.POINTER(ctypes.c_char_p)
    lib.gm_decode_image.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int,
                                    ctypes.c_int]
    lib.gm_decode_image.restype = ctypes.c_int
    for name, out in (("gm_decode_batch", u8p), ("gm_decode_batch_gray", u8p),
                      ("gm_decode_batch_gray16",
                       ctypes.POINTER(ctypes.c_uint16))):
        fn = getattr(lib, name)
        fn.argtypes = [paths, ctypes.c_int, out, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, u8p]
        fn.restype = ctypes.c_int
    lib.gm_io_backend.argtypes = []
    lib.gm_io_backend.restype = ctypes.c_char_p


def _load():
    global _LIB, _TRIED, _ERROR
    with _lock:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            lib = ctypes.CDLL(str(_build.build()))
        except (_build.BuildError, OSError) as e:
            _ERROR = str(e)
            print(f"geomapnet_tpu_torch.native: the native decoder could not "
                  f"be built on this host:\n{_ERROR}", file=sys.stderr)
            return None
        _bind(lib)
        _LIB = lib
        return lib


def available() -> bool:
    """True when the library is built (building it at the first call) and
    loaded."""
    return _load() is not None


def build_error() -> str | None:
    """The compiler's message when the library could not be built (None when
    it was, or before the first attempt)."""
    _load()
    return _ERROR


def require():
    """The loaded library; raises ``RuntimeError`` with the compiler's
    message when it cannot be built."""
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "the native decoder is not available on this host (it needs g++ "
            "and the libpng and libjpeg headers); building "
            f"{_build.SOURCE.name} failed with:\n{_ERROR}")
    return lib


def io_backend() -> str | None:
    """Batch-read backend the library chose for this process: ``"io_uring"``
    (async kernel reads; ``GM_DISABLE_URING=1`` opts out) or ``"pread"``.
    None when the library cannot be built."""
    lib = _load()
    if lib is None:
        return None
    return lib.gm_io_backend().decode()


def _paths(paths) -> ctypes.Array:
    return (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_image(path: str, out_h: int, out_w: int) -> np.ndarray | None:
    """Decode+resize one image to (out_h, out_w, 3) uint8 (None on failure)."""
    lib = require()
    out = np.empty((out_h, out_w, 3), np.uint8)
    ok = lib.gm_decode_image(str(path).encode(), _u8(out), out_h, out_w)
    return out if ok else None


def decode_batch(paths, out_h: int, out_w: int, n_threads: int = 4
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Decode+resize a batch into (N, out_h, out_w, 3) uint8.

    Returns (batch, ok_mask); a failed image leaves its slot unspecified and
    is flagged False in the mask (callers substitute a neighbour, as the
    reference's safe_collate does).
    """
    lib = require()
    n = len(paths)
    out = np.empty((n, out_h, out_w, 3), np.uint8)
    ok = np.zeros(n, np.uint8)
    lib.gm_decode_batch(_paths(paths), n, _u8(out), out_h, out_w, n_threads,
                        _u8(ok))
    return out, ok.astype(bool)


def decode_batch_gray16(paths, h: int, w: int, n_threads: int = 4
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Decode 16-bit single-channel PNGs (7Scenes depth, millimetres) into
    (N, h, w) uint16 at native resolution. Images whose size or bit depth
    differ are flagged failed in the ok mask."""
    lib = require()
    n = len(paths)
    out = np.empty((n, h, w), np.uint16)
    ok = np.zeros(n, np.uint8)
    lib.gm_decode_batch_gray16(
        _paths(paths), n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        h, w, n_threads, _u8(ok))
    return out, ok.astype(bool)


def decode_batch_gray(paths, h: int, w: int, n_threads: int = 4
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Decode raw single-channel (Bayer) PNGs into (N, h, w) uint8: no
    resize and no channel promotion, the mosaic goes to the device intact
    for the demosaic pipeline. Images whose native size differs from
    (h, w) are flagged failed in the ok mask."""
    lib = require()
    n = len(paths)
    out = np.empty((n, h, w), np.uint8)
    ok = np.zeros(n, np.uint8)
    lib.gm_decode_batch_gray(_paths(paths), n, _u8(out), h, w, n_threads,
                             _u8(ok))
    return out, ok.astype(bool)
