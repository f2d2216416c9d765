"""Wrapper of the Hopper chunked SSD scan (``csrc/mamba2_scan.cu``).

Counterpart of the JAX package's ``repro.kernels.mamba2_scan``
(``mamba2_scan_kernel``): the Mamba2 selective scan, split as SSD is into
three passes that run in parallel over (batch, chunk, head) — the chunk
states, a short recurrence over them per (batch, head), the chunk scan —
with the ``(P, N)`` states carried in f32 in a work buffer that the wrapper
allocates with ``torch.empty`` (4 B nc H (P N + 1) bytes, nc chunks: 335 MB
at 1 x 32,768 tokens of zamba2).  bf16 runs its products on the tensor
cores, f32 in FFMA.  The wrapper checks device, dtype, shape, contiguity,
alignment and the kernels' shared-memory need, allocates the output and
the work buffers, launches on PyTorch's current stream without
synchronising, raises when a launch is refused, and adds one to
``mamba2_scan_kernel.launches`` per call — nowhere else — however many
CUDA launches the call makes (three; four past ``MAX_N``: ``chip_smoke.py``
counts them).

It takes every (P, N) the JAX kernel takes (:func:`plan`).  The kernels'
tiles take P and N multiples of 16 with P <= 64 and a state slice of N <=
128 columns (``MAX_P``, ``MAX_N``), and the rest follows from the
arithmetic:

* an off-16 P or N is padded with zeros to the next multiple of 16 (at
  least 16): zero columns of x, B or C add exact zeros to y, and the padded
  columns of y are cut off;
* a wider head runs as P / d heads of width d (the largest multiple of 16
  that divides the padded P and is at most ``MAX_P``): the rows of h (P x
  N) are independent and share the head's decay, B and C, so ``xh`` and
  ``y`` are viewed as (B, T, H P / d, d) and only the decay is repeated
  over the sub-heads (:func:`sub_heads`);
* a wider state runs as S slices of at most ``MAX_N`` columns: y is a sum
  over n and each column of h evolves on its own under a decay that does
  not depend on n, so each slice's blocks write its share of y in f32 (S B
  T H P floats more, allocated with ``torch.empty``) and a fourth launch
  adds the shares in slice order, rounding once.

What the wrapper still refuses, it refuses by the device's shared memory,
with the numbers.  The plain PyTorch version that defines the semantics is
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
_ARGS = [_P] * 5 + [_I] * 6 + [_P, _P, _P]
#: the widest head (P) and state slice (N) the kernels' tiles take (kMaxP,
#: kMaxN); a wider head runs as sub-heads of at most MAX_P, a wider state
#: as slices of at most MAX_N
MAX_P, MAX_N = 64, 128


def _up16(n: int) -> int:
    return max(16, -(-n // 16) * 16)


def n_slices(N: int) -> list:
    """``[(n0, width), ...]``: the state slices a (padded, multiple of 16)
    width N runs as, as even as multiples of 16 allow, each at most
    ``MAX_N``; one slice ``(0, N)`` when ``N <= MAX_N``."""
    units = N // 16
    per = 16 * -(-units // -(-N // MAX_N))
    return [(n0, min(per, N - n0)) for n0 in range(0, N, per)]


def plan(P: int, N: int) -> dict:
    """How the kernels take a head of width P and a state of width N:
    ``P_pad`` / ``N_pad`` (the next multiple of 16, at least 16), the
    sub-head width ``d`` and their number ``n_sub``, and the state
    ``slices`` (:func:`n_slices`)."""
    Pp, Np = _up16(P), _up16(N)
    d, n_sub = sub_heads(Pp)
    return {"P_pad": Pp, "N_pad": Np, "d": d, "n_sub": n_sub,
            "slices": n_slices(Np)}


def _padded(t, width: int):
    """``t`` with its last axis zero-padded to ``width`` (``t`` itself when
    it is that wide), allocated with ``torch.empty``."""
    if t.shape[-1] == width:
        return t
    out = torch.empty(*t.shape[:-1], width, dtype=t.dtype, device=t.device)
    out[..., :t.shape[-1]] = t
    out[..., t.shape[-1]:] = 0
    return out


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
    any P and N (:func:`plan`)."""
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
    for t, name in ((xh, "xh"), (b, "b"), (c, "c")):   # 16-byte copies
        check_aligned(t, name)
    if min(B, T, H, P, N) < 1:
        raise ValueError("every dimension must be at least 1")
    pl = plan(P, N)
    Pp, Np, d, n_sub = pl["P_pad"], pl["N_pad"], pl["d"], pl["n_sub"]
    ns, S = pl["slices"][0][1], len(pl["slices"])
    lib, max_dyn = library(xh.device)
    bf16 = int(xh.dtype == torch.bfloat16)
    need = lib.mamba2_scan_smem_bytes(bf16, d, ns)
    if need < 0:
        raise ValueError(f"mamba2_scan: the library refuses a head of {d} "
                         f"and a state slice of {ns}")
    if need > max_dyn:
        raise ValueError(f"mamba2_scan: {need} bytes of shared memory per "
                         f"block (head {d}, state slice {ns}), the device "
                         f"allows {max_dyn}")
    xp, bp, cp = _padded(xh, Pp), _padded(b, Np), _padded(c, Np)
    Hs = H * n_sub          # contiguous views; the decay is the one copy
    xs = xp.view(B, T, Hs, d)
    asub = a.repeat_interleave(n_sub, -1) if n_sub > 1 else a
    y = torch.empty_like(xs)
    # the chunk states (B, nc, Hs, d, Np), then the chunk decays (B, nc, Hs)
    nc = -(-T // lib.mamba2_scan_chunk(bf16))
    work = torch.empty(B * nc * Hs * (d * Np + 1), dtype=torch.float32,
                       device=xh.device)
    part = (torch.empty(S * B * T * Hs * d, dtype=torch.float32,
                        device=xh.device) if S > 1 else None)
    err = call_on(xh, getattr(lib, _ENTRY[xh.dtype]),
                  xs.data_ptr(), asub.data_ptr(), bp.data_ptr(),
                  cp.data_ptr(), y.data_ptr(), B, T, Hs, d, Np, ns,
                  work.data_ptr(), None if part is None else part.data_ptr(),
                  stream_of(xh))
    raise_on(err, "mamba2_scan launch")
    mamba2_scan_kernel.launches += 1
    y = y.view(B, T, H, Pp)
    return y if Pp == P else y[..., :P].contiguous()


mamba2_scan_kernel.launches = 0
