"""Wrapper of the Hopper flash-attention kernel (``csrc/flash_attention.cu``).

Counterpart of the JAX package's ``repro.kernels.flash_attention``
(``flash_attention_kernel``): causal / sliding-window / full attention with
an online softmax.  bf16 runs on the tensor cores (``wgmma``, K/V through
TMA), one block of two warpgroups per (128-query tile, head, batch row),
the head dimension zero-padded to a multiple of 64 in shared memory; f32
runs P V on the tensor cores as 3xTF32 (``mma.sync`` m16n8k8, each operand
split into two TF32 values, three products a pair: ~22 bits of each
product) and Q K^T by FFMA with d in order (the plain version's rounding of
the scores, which the softmax's exponent amplifies), one block of four
warps per (64-query tile, head, batch row), K/V tiles through
``cp.async`` in two stages.  Both take
dh a multiple of 8 up to 256.  Unlike the Pallas kernel it takes GQA K/V as
given, ``(B, S, Hk, dh)``.
The wrapper checks device, dtype, shape, contiguity, alignment and the
kernel's limits, allocates the output with ``torch.empty``, launches on
PyTorch's current stream without synchronising, raises when the launch is
refused, and adds one to ``flash_attention_kernel.launches`` where it
launches — nowhere else.  The plain PyTorch version that defines the
semantics is :func:`repro_torch.kernels.ref.flash_attention_ref`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensor's
device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._build import (call_on, check_aligned, check_same_device, check_tensor,
                     raise_on, stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_ARGS = [_P] * 4 + [_I] * 9 + [ctypes.c_float, _P]
#: the kernel takes a head dimension that is a multiple of VEC up to MAX_DH
VEC, MAX_DH = 8, 256
#: the f32 kernel's query rows per block
BLOCK_Q = 64
#: the bf16 kernel: query rows per block, K/V ring stages
TC_BLOCK_Q, TC_STAGES = 128, 2


def library(device):
    """``(library, dynamic shared-memory limit)`` on the CUDA ``device``:
    built and loaded at first use."""
    return _build.bind("flash_attention", _ENTRY.values(), _ARGS, device)


def tc_tiles(dh: int):
    """``(padded head dimension, keys per tile)`` of the bf16 kernel."""
    dhp = -(-dh // 64) * 64
    return dhp, (128 if dhp <= 128 else 64)


def f32_tiles(dh: int):
    """``(keys per tile, row stride in floats)`` of the f32 kernel: the
    stride is 4 modulo 32, so that a warp's reads hit 32 banks."""
    return (64 if dh <= 64 else 32 if dh <= 128 else 16), \
        dh + (36 - dh % 32) % 32


def smem_bytes(dh: int, dtype=torch.float32) -> int:
    """Dynamic shared memory of one block.  f32: the 64-row Q tile and two
    stages of K and V tiles, at the row stride.  bf16: the 128-row Q tile
    and two stages of K and V tiles at the padded head dimension, plus 1 KB
    to align them to the swizzle atom."""
    if dtype == torch.bfloat16:
        dhp, bk = tc_tiles(dh)
        return 2 * dhp * (TC_BLOCK_Q + TC_STAGES * 2 * bk) + 1024
    bk, ld = f32_tiles(dh)
    return 4 * (BLOCK_Q + 4 * bk) * ld


def flash_attention_kernel(q, k, v, causal: bool = True,
                           window: Optional[int] = None,
                           offset: Optional[int] = None) -> torch.Tensor:
    """``(B, T, H, dh)`` in ``q.dtype``: ``q`` ``(B, T, H, dh)`` f32 or bf16,
    ``k``/``v`` ``(B, S, Hk, dh)`` of q's dtype; query ``t`` and key ``s``
    are ``t - s + offset`` apart (default ``S - T``)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("expected q (B, T, H, dh) and k, v (B, S, Hk, dh)")
    B, T, H, dh = q.shape
    S, Hk = k.shape[1], k.shape[2]
    if q.dtype not in _ENTRY:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    check_tensor(q, "q", q.dtype, (B, T, H, dh))
    check_tensor(k, "k", q.dtype, (B, S, Hk, dh))
    check_tensor(v, "v", q.dtype, (B, S, Hk, dh))
    check_same_device(q, k, v)
    if min(B, T, S, H, Hk) < 1:
        raise ValueError("every dimension must be at least 1")
    if H % Hk:
        raise ValueError(f"H={H} is not a multiple of Hk={Hk}")
    if dh % VEC or not VEC <= dh <= MAX_DH:
        raise ValueError(f"flash_attention: dh={dh}; the kernel takes a "
                         f"multiple of {VEC} up to {MAX_DH}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_aligned(t, name)
    lib, max_dyn = library(q.device)
    smem = smem_bytes(dh, q.dtype)
    if smem > max_dyn:
        raise ValueError(f"flash_attention: {smem} bytes of shared memory "
                         f"per block, the device allows {max_dyn}")
    off = S - T if offset is None else int(offset)
    win = -1 if window is None else int(window)
    out = torch.empty_like(q)
    err = call_on(q, getattr(lib, _ENTRY[q.dtype]),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, T, S, H, Hk, dh, int(causal), win, off, dh ** -0.5,
                  stream_of(q))
    raise_on(err, "flash_attention launch")
    flash_attention_kernel.launches += 1
    return out


flash_attention_kernel.launches = 0
