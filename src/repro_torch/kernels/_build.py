"""Build and load the CUDA kernels: ``nvcc`` by hand into one shared
library per source with a plain C interface, loaded with ``ctypes``.

The library is built at first use from the sources under ``csrc/`` and
nothing else, into ``_build/`` beside this file (override with the
``REPRO_TORCH_BUILD_DIR`` environment variable).  Its file name carries a
hash of the source, so an edited source is rebuilt and a stale library is
never loaded.  A failed build raises with the compiler's output: there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds the last build of each source took (0.0 = found already built)
build_seconds: Dict[str, float] = {}


def build_dir() -> Path:
    override = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(override) if override else Path(__file__).resolve().parent / "_build"


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and under $CUDA_HOME, default "
        "/usr/local/cuda): the CUDA kernels cannot be built here"
    )


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library of ``csrc/<name>.cu``, building it first
    if this process has not and no up-to-date build is on disk."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS
    digest = hashlib.sha1(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:12]
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{name}_{digest}.so"
    if lib_path.exists():
        build_seconds[name] = 0.0
    else:
        tmp = out_dir / f".{lib_path.name}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *flags, "-o", str(tmp), str(src)]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)    # atomic: a reader never sees half a file
        build_seconds[name] = time.time() - t0
    _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]
