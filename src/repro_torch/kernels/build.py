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
#: -split-compile=0 compiles a source's kernels in parallel threads, which
#: speeds up fused_sinr's build (24 template instantiations) on an 8-core host
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-split-compile=0")


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


def _paths(name: str):
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build_all(names) -> dict:
    """Compile ``csrc/<name>.cu`` for every name whose library does not
    exist yet, one ``nvcc`` each, all started together; returns
    ``{name: BuildInfo}``."""
    started, infos = {}, {}
    for name in names:
        src, out = _paths(name)
        if out.exists():
            infos[name] = BuildInfo(out, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        started[name] = (src, out, tmp, proc, time.perf_counter())
    done = {name: proc.communicate() + (time.perf_counter() - t0,)
            for name, (_, _, _, proc, t0) in started.items()}
    for name, (src, out, tmp, proc, _) in started.items():
        stdout, stderr, seconds = done[name]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit "
                               f"{proc.returncode}):\n{stdout}\n{stderr}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
        infos[name] = BuildInfo(out, seconds, stdout + stderr)
    return infos


def build(name: str) -> BuildInfo:
    """Compile ``csrc/<name>.cu`` unless a library of this source exists."""
    return build_all([name])[name]


def load(name: str):
    """The loaded ``ctypes`` library of ``csrc/<name>.cu`` (built if needed)
    and the :class:`BuildInfo` of the build that made it."""
    if name not in _LIBS:
        info = build(name)
        _LIBS[name] = (ctypes.CDLL(str(info.path)), info)
    return _LIBS[name]


def load_all() -> dict:
    """Build every source of ``csrc/`` at once and load each library:
    ``{name: (library, BuildInfo)}``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    for name, info in build_all([n for n in names if n not in _LIBS]).items():
        _LIBS[name] = (ctypes.CDLL(str(info.path)), info)
    return {name: _LIBS[name] for name in names}
