"""Build and load the port's CUDA kernels.

Each `csrc/*.cu` source compiles with `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes` (no PyTorch headers,
so a build takes seconds). Builds happen at first use, into `build/` at the
repository root (listed in `.gitignore`), and are redone when the source, or
a header beside it (`csrc/*.cuh`, which a source may include), is newer than
the library. `build_all()` starts one `nvcc` per source, all at
once, and waits for them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
SOURCES = ("eval_fwd", "eval_wide", "train_fwd", "train_bwd", "weight_grad",
           "train_wide", "eval_f32", "train_f32", "wide_f32")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    newest = max(p.stat().st_mtime for p in [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")])
    return not lib.exists() or lib.stat().st_mtime < newest


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.tmp.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    return proc


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    (BUILD_DIR / f"{name}.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(proc.tmp_path, _lib_path(name))  # type: ignore[attr-defined]
    return log


def build_all() -> Dict[str, str]:
    """Compile every stale source concurrently -> {name: nvcc log}."""
    procs = {n: _start(n) for n in SOURCES if _stale(n)}
    return {n: _finish(n, p) for n, p in procs.items()}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib
