"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/<name>-<hash>.so`` at the
root of the checkout, where ``<hash>`` is the hash of the source: an edited
source builds anew, an unchanged one loads the library already there.  The
library is loaded with ``ctypes``.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class BuildInfo(NamedTuple):
    """What one build did: the library path, seconds spent, ptxas lines."""

    path: Path
    seconds: float
    log: str


_LIBS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only on a host with the CUDA toolkit")
    return found


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless a library of this source exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or nothing
    return BuildInfo(out, seconds, proc.stdout + proc.stderr)


def load(name: str):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu`` (built if needed)
    and the :class:`BuildInfo` of the build that made it."""
    if name not in _LIBS:
        info = build(name)
        _LIBS[name] = (ctypes.CDLL(str(info.path)), info)
    return _LIBS[name]
