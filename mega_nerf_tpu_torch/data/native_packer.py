"""ctypes bindings for the native shuffle-gather packer (native/packer.cpp).

A copy of the JAX package's `data/native_packer.py`. Builds
`native/libpacker.so` with `make -C native` on first use (cached); without
a compiler it gathers with numpy instead. The filesystem dataset's disk
flush shuffles every buffered column through it. It logs once which path
ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOGGED = False
_NATIVE_DIR = Path(__file__).parent.parent.parent / "native"


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _NATIVE_DIR / "libpacker.so"
    if not so.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    for name, elem in (
        ("shuffle_gather_f32", ctypes.POINTER(ctypes.c_float)),
        ("shuffle_gather_u8", ctypes.POINTER(ctypes.c_uint8)),
        ("shuffle_gather_i32", ctypes.POINTER(ctypes.c_int32)),
    ):
        fn = getattr(lib, name)
        fn.argtypes = [elem, i64p, elem, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int]
        fn.restype = None
    _LIB = lib
    return lib


_FN_BY_DTYPE = {
    np.dtype(np.float32): ("shuffle_gather_f32", ctypes.c_float),
    np.dtype(np.uint8): ("shuffle_gather_u8", ctypes.c_uint8),
    np.dtype(np.int32): ("shuffle_gather_i32", ctypes.c_int32),
}


def _log_path(native: bool) -> None:
    global _LOGGED
    if not _LOGGED:
        _LOGGED = True
        print("shuffle_gather: " + (f"native packer ({_NATIVE_DIR / 'libpacker.so'})"
                                    if native else "numpy gather (no native packer)"),
              flush=True)


def shuffle_gather(arr: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """out[i] = arr[perm[i]] for 1D/2D arrays of f32/u8/i32 rows: the
    multithreaded native gather when the packer library loads, numpy
    otherwise. Equal to `arr[perm]` either way."""
    lib = _load()
    _log_path(lib is not None)
    entry = _FN_BY_DTYPE.get(arr.dtype)
    if lib is None or entry is None:
        return np.ascontiguousarray(arr[perm])

    arr = np.ascontiguousarray(arr)
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    n = perm.shape[0]
    width = 1 if arr.ndim == 1 else int(np.prod(arr.shape[1:]))
    out = np.empty((n,) if arr.ndim == 1 else (n, *arr.shape[1:]), arr.dtype)

    name, ctype = entry
    getattr(lib, name)(
        arr.ctypes.data_as(ctypes.POINTER(ctype)),
        perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctype)),
        n,
        width,
        min(8, os.cpu_count() or 1),
    )
    return out
