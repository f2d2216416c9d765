"""Build and load the CUDA kernels: ``nvcc`` by hand into one shared
library per source with a plain C interface, loaded with ``ctypes``.

A library is built at first use from the sources under ``csrc/`` and
nothing else, into ``_build/`` beside this file (override with the
``REPRO_TORCH_BUILD_DIR`` environment variable).  A library's file name
carries a hash of its source and of the shared headers under ``csrc/``,
so an edited source or header is rebuilt and a stale library is never
loaded.  A failed build raises with the compiler's
output: there is no fallback.  The argument checks the wrappers share are
here too.
"""

from __future__ import annotations

import ctypes
import functools
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
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
#: seconds the last build of each source took (0.0 = found already built)
build_seconds: Dict[str, float] = {}
#: what ptxas said of each kernel in this process's builds (``-Xptxas -v``):
#: library -> [{"kernel", "registers", "smem_bytes", "spill_stores",
#: "spill_loads", "stack_bytes"}, ...]
ptxas_usage: Dict[str, list] = {}
#: the compiler's warnings in this process's builds, by library, with
#: ptxas's "Potential Performance Loss" notes (it serialises wgmma there)
build_warnings: Dict[str, list] = {}


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


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is, or will be, built: the
    name hashes the source, every header under ``csrc/`` and the flags."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return build_dir() / f"lib{name}_{digest}.so"


def load(name: str) -> ctypes.CDLL:
    """Return the loaded library of ``csrc/<name>.cu``, building it first
    if this process has not and no up-to-date build is on disk."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    lib_path = library_path(name)
    if lib_path.exists():
        build_seconds[name] = 0.0
    else:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f".{lib_path.name}.{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {src}:\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib_path)    # atomic: a reader never sees half a file
        build_seconds[name] = time.time() - t0
        ptxas_usage[name] = parse_ptxas(proc.stdout + proc.stderr)
        build_warnings[name] = [
            ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "warning" in ln.lower() or "Performance Loss" in ln]
    _LIBS[name] = ctypes.CDLL(str(lib_path))
    return _LIBS[name]


def parse_ptxas(log: str) -> list:
    """Per kernel entry, registers, shared memory, spills and stack from
    ``ptxas -v``'s lines (``Compiling entry function '...'``, ``Function
    properties for ...``, ``Used N registers, ...``)."""
    import re
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "smem_bytes": 0,
                   "spill_stores": 0, "spill_loads": 0, "stack_bytes": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = (
                int(m.group(1)), int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return rows


# ------------------------------------------------- shared by the wrappers ----

def raise_on(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")


def check_tensor(t, name: str, dtype, shape) -> None:
    """A kernel argument must be a contiguous CUDA tensor of this dtype
    and shape (a tuple)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream_of(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the C entry points
    take it: the raw handle, read without building a Stream object (a
    wrapper runs once a layer per decoded token, so its host time is part
    of a forward's)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def call_on(t, entry, *args) -> int:
    """``entry(*args)`` with ``t``'s device the current one, as a launch
    needs (it goes to the current device, and the stream of another is
    refused there); the device is switched only when it is not current."""
    import torch
    index = t.get_device()
    if index == torch.cuda.current_device():
        return entry(*args)
    with torch.cuda.device(index):
        return entry(*args)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


_MAX_DYN: Dict[tuple, int] = {}
#: (name, device as given) -> bind()'s result, for devices with an index
_BOUND: Dict[tuple, tuple] = {}


def bind(name: str, entries, argtypes, device):
    """``(library, dynamic shared-memory limit)`` of ``csrc/<name>.cu`` on
    the CUDA ``device``: built and loaded at first use, each of ``entries``
    given ``argtypes`` and an ``int`` (cudaError_t) result, and the
    library's ``<name>_init`` run once on every device it is used on (it
    raises the kernels' shared-memory limit there and reports what a
    block's dynamic part may take).  Looked up in one dict after the
    first call on a device with an index (a tensor's device has one)."""
    hit = _BOUND.get((name, device))
    if hit is not None:
        return hit
    import torch
    lib = load(name)
    init = getattr(lib, f"{name}_init")
    if init.argtypes is None:           # first use in this process
        for entry in entries:
            getattr(lib, entry).argtypes = argtypes
            getattr(lib, entry).restype = ctypes.c_int
        init.restype = ctypes.c_int
        init.argtypes = [ctypes.POINTER(ctypes.c_int)]
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"expected a CUDA device, got {dev}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if (name, index) not in _MAX_DYN:
        max_dyn = ctypes.c_int(0)
        with torch.cuda.device(index):
            raise_on(init(ctypes.byref(max_dyn)), f"{name}_init")
        _MAX_DYN[(name, index)] = max_dyn.value
    out = lib, _MAX_DYN[(name, index)]
    if dev.index is not None:
        _BOUND[(name, device)] = out
    return out


def check_same_device(*tensors) -> None:
    if len({t.get_device() for t in tensors}) != 1:
        raise ValueError("all arguments must lie on one device")


def check_aligned(t, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: expected a 16-byte aligned tensor")
