"""Wrapper of the Hopper chunkwise mLSTM kernel (``csrc/mlstm.cu``).

Counterpart of the JAX package's ``repro.kernels.mlstm``
(``mlstm_chunked_kernel``, oracle ``gla_ref``): gated linear attention with
a matrix memory ``C (K, P)`` and normaliser ``n (K)`` carried in f32 over
chunks.  ``P`` is split over thread blocks (32 columns each), so that a
block's slice of ``C`` fits in shared memory at K = 512.  The wrapper
checks device, dtype, shape, contiguity and the kernel's shared-memory
need, allocates the output with ``torch.empty``, launches on PyTorch's
current stream without synchronising, raises when the launch is refused,
and adds one to ``mlstm_chunked_kernel.launches`` where it launches —
nowhere else.  The plain PyTorch version that defines the semantics is
:func:`repro_torch.kernels.ref.mlstm_chunked_ref`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensor's
device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import (call_on, check_same_device, check_tensor, raise_on,
                     stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "mlstm_f32", torch.bfloat16: "mlstm_bf16"}
_ARGS = [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]
CHUNK, P_TILE, K_TILE = 64, 32, 32


def library(device):
    """``(library, dynamic shared-memory limit)`` on the CUDA ``device``:
    built and loaded at first use."""
    return _build.bind("mlstm", _ENTRY.values(), _ARGS, device)


def smem_bytes(K: int) -> int:
    """Dynamic shared memory of one block, f32: the state slice (K x 32)
    and normaliser (K), the q and k tiles (64 x 33 each), v (64 x 32), the
    gated scores (64 x 65) and five per-step rows."""
    Q = CHUNK
    return 4 * (K * P_TILE + K + 2 * Q * (K_TILE + 1) + Q * P_TILE
                + Q * (Q + 1) + 5 * Q)


def mlstm_chunked_kernel(q, k, v, a, i) -> torch.Tensor:
    """``y`` ``(B, T, H, P)`` in ``v.dtype``: ``q``/``k`` ``(B, T, H, K)``
    and ``v`` ``(B, T, H, P)`` f32 or bf16 (one dtype), ``a``/``i``
    ``(B, T, H)`` f32."""
    if q.dim() != 4 or v.dim() != 4:
        raise ValueError("expected q, k (B, T, H, K), v (B, T, H, P), "
                         "a and i (B, T, H)")
    B, T, H, K = q.shape
    P = v.shape[-1]
    if v.dtype not in _ENTRY:
        raise TypeError(f"v: expected float32 or bfloat16, got {v.dtype}")
    check_tensor(q, "q", v.dtype, (B, T, H, K))
    check_tensor(k, "k", v.dtype, (B, T, H, K))
    check_tensor(v, "v", v.dtype, (B, T, H, P))
    check_tensor(a, "a", torch.float32, (B, T, H))
    check_tensor(i, "i", torch.float32, (B, T, H))
    check_same_device(q, k, v, a, i)
    if min(B, T, H, K, P) < 1:
        raise ValueError("every dimension must be at least 1")
    lib, max_dyn = library(v.device)
    if smem_bytes(K) > max_dyn:
        raise ValueError(f"mlstm: {smem_bytes(K)} bytes of shared memory per "
                         f"block (K={K}), the device allows {max_dyn}")
    y = torch.empty_like(v)
    err = call_on(v, getattr(lib, _ENTRY[v.dtype]),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
                  i.data_ptr(), y.data_ptr(), B, T, H, K, P, K ** -0.5,
                  stream_of(v))
    raise_on(err, "mlstm launch")
    mlstm_chunked_kernel.launches += 1
    return y


mlstm_chunked_kernel.launches = 0
