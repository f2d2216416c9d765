"""Wrapper of the Hopper chunked SSD scan kernel (``csrc/mamba2_scan.cu``).

Counterpart of the JAX package's ``repro.kernels.mamba2_scan``
(``mamba2_scan_kernel``): the Mamba2 selective scan per (batch, head),
chunk by chunk, the ``(P, N)`` state carried in f32, one thread block per
(head, batch row).  The wrapper checks device, dtype, shape, contiguity
and the kernel's shared-memory need, allocates the output with
``torch.empty``, launches on PyTorch's current stream without
synchronising, raises when the launch is refused, and adds one to
``mamba2_scan_kernel.launches`` where it launches — nowhere else.  The
plain PyTorch version that defines the semantics is
:func:`repro_torch.kernels.ref.mamba2_scan_ref`; :mod:`repro_torch.kernels.ops`
picks between the two by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import (call_on, check_same_device, check_tensor, raise_on,
                     stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "mamba2_scan_f32",
          torch.bfloat16: "mamba2_scan_bf16"}
_ARGS = [_P] * 5 + [_I] * 5 + [_P]
CHUNK = 64


def library(device):
    """``(library, dynamic shared-memory limit)`` on the CUDA ``device``:
    built and loaded at first use."""
    return _build.bind("mamba2_scan", _ENTRY.values(), _ARGS, device)


def smem_bytes(P: int, N: int) -> int:
    """Dynamic shared memory of one block, f32: the chunk's x (64 x P), B
    and C (64 x (N + 1) each), the decay-weighted C B^T (64 x 65), the
    state (P x (N + 1)) and three per-step rows."""
    Q = CHUNK
    return 4 * (Q * P + 2 * Q * (N + 1) + Q * (Q + 1) + P * (N + 1) + 3 * Q)


def mamba2_scan_kernel(xh, a, b, c) -> torch.Tensor:
    """``y`` ``(B, T, H, P)`` in ``xh.dtype``: ``xh`` ``(B, T, H, P)`` f32 or
    bf16, ``a`` ``(B, T, H)`` f32, ``b``/``c`` ``(B, T, N)`` of xh's dtype."""
    if xh.dim() != 4 or b.dim() != 3:
        raise ValueError("expected xh (B, T, H, P), a (B, T, H), "
                         "b and c (B, T, N)")
    B, T, H, P = xh.shape
    N = b.shape[-1]
    if xh.dtype not in _ENTRY:
        raise TypeError(f"xh: expected float32 or bfloat16, got {xh.dtype}")
    check_tensor(xh, "xh", xh.dtype, (B, T, H, P))
    check_tensor(a, "a", torch.float32, (B, T, H))
    check_tensor(b, "b", xh.dtype, (B, T, N))
    check_tensor(c, "c", xh.dtype, (B, T, N))
    check_same_device(xh, a, b, c)
    if min(B, T, H, P, N) < 1:
        raise ValueError("every dimension must be at least 1")
    lib, max_dyn = library(xh.device)
    if smem_bytes(P, N) > max_dyn:
        raise ValueError(f"mamba2_scan: {smem_bytes(P, N)} bytes of shared "
                         f"memory per block (P={P}, N={N}), the device "
                         f"allows {max_dyn}")
    y = torch.empty_like(xh)
    err = call_on(xh, getattr(lib, _ENTRY[xh.dtype]),
                  xh.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  y.data_ptr(), B, T, H, P, N, stream_of(xh))
    raise_on(err, "mamba2_scan launch")
    mamba2_scan_kernel.launches += 1
    return y


mamba2_scan_kernel.launches = 0
