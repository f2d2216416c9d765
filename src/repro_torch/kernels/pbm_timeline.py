"""Wrappers of the three Hopper buffer-pool kernels (``csrc/pbm_timeline.cu``).

Counterparts of the JAX package's ``repro.kernels.pbm_timeline``
(``batched_evict_kernel``, ``fifo_grant_kernel``, ``wake_solve_kernel``),
each over a leading lane axis: one thread block per lane.  Every wrapper
checks device, dtype, shape and contiguity, allocates its outputs with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises when the launch is refused, and adds one to its
``launches`` count where it launches — nowhere else.  The plain PyTorch
versions that define the semantics are in :mod:`repro_torch.kernels.ref`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensor's
device.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = None
_MAX_DYN = {}   # device index -> dynamic shared-memory limit: evict, grant, wake


def library(device):
    """``(library, shared-memory limits)`` for the CUDA ``device``: built
    and loaded at first use, and the kernels' shared-memory limit raised
    once on every device they are launched on."""
    global _LIB
    if _LIB is None:
        lib = _build.load("pbm_timeline")
        evict_args = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P]
        lib.pbm_batched_evict_f32.argtypes = evict_args
        lib.pbm_batched_evict_i32.argtypes = evict_args
        lib.pbm_fifo_grant.argtypes = [_P, _P, _I, _P, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _P]
        lib.pbm_wake_solve.argtypes = [_P, _P, _I, _P, _P, _P, _P,
                                       _I, _I, _I, _I, _P]
        lib.pbm_init.argtypes = [ctypes.POINTER(ctypes.c_int)]
        _LIB = lib
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"expected a CUDA device, got {device}")
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    if index not in _MAX_DYN:
        limits = (ctypes.c_int * 3)()
        with torch.cuda.device(index):
            _raise_on(_LIB.pbm_init(limits), "pbm_init")
        _MAX_DYN[index] = tuple(limits)
    return _LIB, _MAX_DYN[index]


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} (cudaError_t)")


def _check(t: torch.Tensor, name: str, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _sizes_stride(sizes: torch.Tensor, L: int, P: int) -> int:
    """Lane stride of ``sizes``: one shared ``(P,)`` row or ``(L, P)``."""
    if sizes.dim() == 1:
        _check(sizes, "sizes", torch.float32, (P,))
        return 0
    _check(sizes, "sizes", torch.float32, (L, P))
    return P


def _sort_len(P: int, max_dyn: int, name: str) -> int:
    """Length of the row a block sorts in shared memory: the power of two
    at or above ``P`` (at least one warp), 8 bytes an entry.  Raises above
    what one block can hold."""
    n = max(32, 1 << (max(P, 1) - 1).bit_length())
    most = min(_LIB.pbm_max_sort_len(), max_dyn // 8)
    if n > most:
        raise ValueError(
            f"{name}: P={P} pages sort as {n} entries ({8 * n} bytes of "
            f"shared memory per lane); one block holds at most {most} "
            "(page-split candidate selection is not ported yet)"
        )
    return n


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def batched_evict_kernel(key, sizes, evictable, need_free, *,
                         vmax: int = 64) -> torch.Tensor:
    """Evict mask ``(L, P)`` bool; ``key`` is f32 or i32 (two
    instantiations, the integer one never touches a float)."""
    L, P = key.shape
    _check(key, "key", key.dtype, (L, P))
    lib, max_dyn = library(key.device)
    if key.dtype == torch.float32:
        fn = lib.pbm_batched_evict_f32
    elif key.dtype == torch.int32:
        fn = lib.pbm_batched_evict_i32
    else:
        raise TypeError(f"key: expected float32 or int32, got {key.dtype}")
    stride = _sizes_stride(sizes, L, P)
    _check(evictable, "evictable", torch.bool, (L, P))
    _check(need_free, "need_free", torch.float32, (L,))
    n = _sort_len(P, max_dyn[0], "batched_evict")
    out = torch.empty((L, P), dtype=torch.bool, device=key.device)
    with torch.cuda.device(key.device):
        err = fn(key.data_ptr(), sizes.data_ptr(), stride,
                 evictable.data_ptr(), need_free.data_ptr(), out.data_ptr(),
                 L, P, int(vmax), n, _stream(key))
    _raise_on(err, "batched_evict launch")
    batched_evict_kernel.launches += 1
    return out


def fifo_grant_kernel(key, sizes, budget, pops, *, vmax: int = 16,
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(mask (L, P) bool, granted_bytes (L,) f32, n_granted (L,) i32)``."""
    L, P = key.shape
    _check(key, "key", torch.int32, (L, P))
    lib, max_dyn = library(key.device)
    stride = _sizes_stride(sizes, L, P)
    _check(budget, "budget", torch.float32, (L,))
    _check(pops, "pops", torch.int32, (L,))
    n_sort = _sort_len(P, max_dyn[1], "fifo_grant")
    mask = torch.empty((L, P), dtype=torch.bool, device=key.device)
    nbytes = torch.empty((L,), dtype=torch.float32, device=key.device)
    n = torch.empty((L,), dtype=torch.int32, device=key.device)
    with torch.cuda.device(key.device):
        err = lib.pbm_fifo_grant(
            key.data_ptr(), sizes.data_ptr(), stride, budget.data_ptr(),
            pops.data_ptr(), mask.data_ptr(), nbytes.data_ptr(),
            n.data_ptr(), L, P, int(vmax), n_sort, _stream(key))
    _raise_on(err, "fifo_grant launch")
    fifo_grant_kernel.launches += 1
    return mask, nbytes, n


def wake_solve_kernel(key, sizes, credit0, inc, pops, *,
                      h_cap: int = 64) -> torch.Tensor:
    """Grant step per page, ``(L, P)`` i32 in ``1..h_cap``, sentinel
    ``h_cap + 1``."""
    L, P = key.shape
    _check(key, "key", torch.int32, (L, P))
    lib, max_dyn = library(key.device)
    stride = _sizes_stride(sizes, L, P)
    _check(credit0, "credit0", torch.float32, (L,))
    _check(inc, "inc", torch.float32, (L,))
    _check(pops, "pops", torch.int32, (L,))
    if not 1 <= int(h_cap) <= lib.pbm_max_h_cap():
        raise ValueError(f"wake_solve: h_cap={h_cap} outside "
                         f"1..{lib.pbm_max_h_cap()}")
    n = _sort_len(P, max_dyn[2], "wake_solve")
    out = torch.empty((L, P), dtype=torch.int32, device=key.device)
    with torch.cuda.device(key.device):
        err = lib.pbm_wake_solve(
            key.data_ptr(), sizes.data_ptr(), stride, credit0.data_ptr(),
            inc.data_ptr(), pops.data_ptr(), out.data_ptr(),
            L, P, int(h_cap), n, _stream(key))
    _raise_on(err, "wake_solve launch")
    wake_solve_kernel.launches += 1
    return out


batched_evict_kernel.launches = 0
fifo_grant_kernel.launches = 0
wake_solve_kernel.launches = 0

KERNELS = {
    "batched_evict": batched_evict_kernel,
    "fifo_grant": fifo_grant_kernel,
    "wake_solve": wake_solve_kernel,
}


def launch_counts() -> dict:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
