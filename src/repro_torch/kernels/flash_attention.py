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
``cp.async`` in two stages.  Both kernels take dh a multiple of 8 up to
256, and the f32 one any multiple of 8 past it (its output's columns in
slices of 256, a block a slice, each forming the scores over the whole
dh).  The wrapper takes every dh the Pallas kernel takes: a dh off 8 is
zero-padded to the next multiple of 8 (zero columns add exact zeros to
every score and output column; the scale is the true dh's) and the output
cut back; a bf16 call past 256 runs the f32 kernel on operands upcast to
f32, its output rounded to bf16.  It refuses a width only where a block's
shared memory does not fit the device.  Unlike the Pallas kernel it takes
GQA K/V as given, ``(B, S, Hk, dh)``.
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
import torch.nn.functional as F

from . import _build
from ._build import (call_on, check_aligned, check_same_device, check_tensor,
                     raise_on, stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_DTYPE_NAME = {torch.float32: "f32", torch.bfloat16: "bf16"}
_ARGS = [_P] * 4 + [_I] * 9 + [ctypes.c_float, _P]
#: the kernels take a head dimension that is a multiple of VEC, the bf16
#: kernel up to MAX_DH; the f32 kernel past MAX_DH in output slices of it
VEC, MAX_DH = 8, 256
#: the f32 kernel's query rows per block; its keys per tile past MAX_DH
BLOCK_Q, WIDE_BK = 64, 8
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
    """Dynamic shared memory of one block of the kernel that runs a
    (padded) ``dh`` in ``dtype``.  f32: the 64-row Q tile and two stages of
    K and V tiles, at the row stride (past MAX_DH the V tiles at one
    output slice's).  bf16: the 128-row Q tile and two stages of K and V
    tiles at the padded head dimension, plus 1 KB to align them to the
    swizzle atom."""
    if dtype == torch.bfloat16 and dh <= MAX_DH:
        dhp, bk = tc_tiles(dh)
        return 2 * dhp * (TC_BLOCK_Q + TC_STAGES * 2 * bk) + 1024
    if dh > MAX_DH:
        return 4 * ((BLOCK_Q + 2 * WIDE_BK) * f32_tiles(dh)[1]
                    + 2 * WIDE_BK * f32_tiles(MAX_DH)[1])
    bk, ld = f32_tiles(dh)
    return 4 * (BLOCK_Q + 4 * bk) * ld


def launch_plan(dh: int, dtype) -> tuple:
    """``(padded dh, dtype the kernel runs in)`` of a call: dh up to the
    next multiple of VEC; bf16 past MAX_DH on the f32 kernel."""
    dhp = -(-dh // VEC) * VEC
    return dhp, (torch.float32 if dhp > MAX_DH else dtype)


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
    if min(B, T, S, H, Hk, dh) < 1:
        raise ValueError("every dimension must be at least 1")
    if H % Hk:
        raise ValueError(f"H={H} is not a multiple of Hk={Hk}")
    check_tensor(q, "q", q.dtype, (B, T, H, dh))
    check_tensor(k, "k", q.dtype, (B, S, Hk, dh))
    check_tensor(v, "v", q.dtype, (B, S, Hk, dh))
    check_same_device(q, k, v)
    dhp, run_dtype = launch_plan(dh, q.dtype)
    lib, max_dyn = library(q.device)
    smem = smem_bytes(dhp, run_dtype)
    if smem > max_dyn:
        raise ValueError(
            f"flash_attention: dh={dh} takes {smem} bytes of shared memory "
            f"per block ({_DTYPE_NAME[run_dtype]} kernel), the device "
            f"allows {max_dyn}")
    qk, kk, vk = (x if dhp == dh else F.pad(x, (0, dhp - dh))
                  for x in (q, k, v))
    if run_dtype != q.dtype:
        qk, kk, vk = qk.float(), kk.float(), vk.float()
    for t, name in ((qk, "q"), (kk, "k"), (vk, "v")):
        check_aligned(t, name)
    off = S - T if offset is None else int(offset)
    win = -1 if window is None else int(window)
    out = torch.empty_like(qk)
    err = call_on(q, getattr(lib, _ENTRY[run_dtype]),
                  qk.data_ptr(), kk.data_ptr(), vk.data_ptr(), out.data_ptr(),
                  B, T, S, H, Hk, dhp, int(causal), win, off, dh ** -0.5,
                  stream_of(q))
    raise_on(err, "flash_attention launch")
    flash_attention_kernel.launches += 1
    if dhp != dh:
        out = out[..., :dh].contiguous()
    return out.to(q.dtype)


flash_attention_kernel.launches = 0
