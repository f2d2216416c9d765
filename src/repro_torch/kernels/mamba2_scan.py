"""Wrapper of the Hopper chunked SSD scan (``csrc/mamba2_scan.cu``).

Counterpart of the JAX package's ``repro.kernels.mamba2_scan``
(``mamba2_scan_kernel``): the Mamba2 selective scan, split as SSD is into
three passes that run in parallel over (batch, chunk, head) — the chunk
states, a short recurrence over them per (batch, head), the chunk scan —
with the ``(P, N)`` states carried in f32 in a work buffer that the wrapper
allocates with ``torch.empty`` (335 MB at 1 x 32,768 tokens of zamba2).
bf16 runs its products on the tensor cores, f32 in FFMA.  The wrapper
checks device, dtype, shape, contiguity, alignment and the kernels'
shared-memory need, allocates the output and the work buffer, launches on
PyTorch's current stream without synchronising, raises when a launch is
refused, and adds one to
``mamba2_scan_kernel.launches`` per call — nowhere else — however many
CUDA launches the call makes (three: ``chip_smoke.py`` counts them).  The
kernels' tiles take P and N multiples of 16 with P <= 64 and N <= 128
(``MAX_P``, ``MAX_N``).  A wider head is run as P / d heads of width d (the
largest multiple of 16 that divides P and is at most ``MAX_P``): the rows
of the state h (P x N) are independent and share the head's decay, B and
C, so ``xh`` and ``y`` are viewed as (B, T, H P / d, d) and only the decay
is repeated over the sub-heads (:func:`sub_heads`).  The wrapper refuses P
or N not a multiple of 16, and N > 128, before it looks at the device.
The plain PyTorch
version that defines the semantics is
:func:`repro_torch.kernels.ref.mamba2_scan_ref`; :mod:`repro_torch.kernels.ops`
picks between the two by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import (call_on, check_aligned, check_same_device, check_tensor,
                     raise_on, stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "mamba2_scan_f32",
          torch.bfloat16: "mamba2_scan_bf16"}
_ARGS = [_P] * 5 + [_I] * 5 + [_P, _P]
#: the widest head (P) and state (N) the kernels' tiles take (kMaxP,
#: kMaxN); a wider head is split into sub-heads of at most MAX_P
MAX_P, MAX_N = 64, 128


def sub_heads(P: int) -> tuple:
    """``(d, P // d)``: the width d of the sub-heads a head of width P runs
    as, the largest multiple of 16 that divides P and is at most MAX_P (P a
    multiple of 16), and their number."""
    d = next(d for d in range(MAX_P, 0, -16) if P % d == 0)
    return d, P // d


def library(device):
    """``(library, dynamic shared-memory limit)`` on the CUDA ``device``:
    built and loaded at first use.  ``library.mamba2_scan_chunk(bf16)`` is
    a path's chunk length, ``mamba2_scan_smem_bytes(bf16, P, N)`` its
    blocks' shared memory (-1 for widths the kernels do not take)."""
    return _build.bind("mamba2_scan", _ENTRY.values(), _ARGS, device)


def mamba2_scan_kernel(xh, a, b, c) -> torch.Tensor:
    """``y`` ``(B, T, H, P)`` in ``xh.dtype``: ``xh`` ``(B, T, H, P)`` f32 or
    bf16, ``a`` ``(B, T, H)`` f32, ``b``/``c`` ``(B, T, N)`` of xh's dtype;
    P and N multiples of 16, N <= 128."""
    if xh.dim() != 4 or b.dim() != 3:
        raise ValueError("expected xh (B, T, H, P), a (B, T, H), "
                         "b and c (B, T, N)")
    B, T, H, P = xh.shape
    N = b.shape[-1]
    if not (16 <= P and 16 <= N <= MAX_N and P % 16 == 0 and N % 16 == 0):
        raise ValueError(f"mamba2_scan: P={P}, N={N}; the kernels take "
                         f"multiples of 16 with N <= {MAX_N} (P > {MAX_P} "
                         f"as sub-heads of at most {MAX_P})")
    if xh.dtype not in _ENTRY:
        raise TypeError(f"xh: expected float32 or bfloat16, got {xh.dtype}")
    check_tensor(xh, "xh", xh.dtype, (B, T, H, P))
    check_tensor(a, "a", torch.float32, (B, T, H))
    check_tensor(b, "b", xh.dtype, (B, T, N))
    check_tensor(c, "c", xh.dtype, (B, T, N))
    check_same_device(xh, a, b, c)
    for t, name in ((xh, "xh"), (b, "b"), (c, "c")):   # 16-byte copies
        check_aligned(t, name)
    if min(B, T, H) < 1:
        raise ValueError("every dimension must be at least 1")
    d, n_sub = sub_heads(P)
    if n_sub > 1:           # contiguous views; the decay is the one copy
        xh, a = xh.view(B, T, H * n_sub, d), a.repeat_interleave(n_sub, -1)
        H, P = H * n_sub, d
    lib, max_dyn = library(xh.device)
    bf16 = int(xh.dtype == torch.bfloat16)
    need = lib.mamba2_scan_smem_bytes(bf16, P, N)
    if need < 0:
        raise ValueError(f"mamba2_scan: the library refuses P={P}, N={N}")
    if need > max_dyn:
        raise ValueError(f"mamba2_scan: {need} bytes of shared memory per "
                         f"block (P={P}, N={N}), the device allows {max_dyn}")
    y = torch.empty_like(xh)
    # the chunk states (B, nc, H, P, N), then the chunk decays (B, nc, H)
    nc = -(-T // lib.mamba2_scan_chunk(bf16))
    work = torch.empty(B * nc * H * (P * N + 1), dtype=torch.float32,
                       device=xh.device)
    err = call_on(xh, getattr(lib, _ENTRY[xh.dtype]),
                  xh.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
                  y.data_ptr(), B, T, H, P, N, work.data_ptr(), stream_of(xh))
    raise_on(err, "mamba2_scan launch")
    mamba2_scan_kernel.launches += 1
    return y.view(B, T, H // n_sub, P * n_sub)


mamba2_scan_kernel.launches = 0
