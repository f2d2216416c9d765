"""Wrapper of the Hopper chunkwise mLSTM kernels (``csrc/mlstm.cu``).

Counterpart of the JAX package's ``repro.kernels.mlstm``
(``mlstm_chunked_kernel``, oracle ``gla_ref``): gated linear attention with
a matrix memory ``C (K, P)`` and normaliser ``n (K)`` carried in f32 over
chunks of 64 steps.  bf16 (the model's path) runs in two launches with its
products on the tensor cores: the gated scores W = (Q K^T) o L o i of every
chunk at once, into a work buffer that the wrapper allocates with
``torch.empty`` (a record of ``mlstm_record_bytes()`` per (batch, chunk,
head): 11.3 MB at xLSTM-350M's 4 x 4,096 tokens), then the recurrence, a
block per (P slice, head, batch row) walking its chunks with its slice of C
in shared memory.  f32 runs one FFMA launch.  The kernels take a K slice
of at most 1024 columns (``MAX_K``) and any P, and the wrapper takes every
K: past ``MAX_K`` it cuts K into slices (:func:`k_slices`), since the
numerator q C and the normaliser q . n are sums over k whose rows evolve on
their own under the same gates.  Each slice's blocks write their part of
both in f32 (``torch.empty``: S B T H (P + 1) floats), and one more launch
adds the parts in slice order and only then divides by max(|q . n|, 1);
q's scale is the whole K's.  The wrapper checks device, dtype, shape,
contiguity, alignment and the kernels' shared-memory need (what it
refuses, it refuses by the device's limit, with the numbers), allocates
the output, launches on PyTorch's current stream without synchronising,
raises when a launch is refused, and adds one to
``mlstm_chunked_kernel.launches`` per call — nowhere else — however many
CUDA launches the call makes (two in bf16, three past ``MAX_K``; one and
two in f32: ``chip_smoke.py`` counts them).  The plain PyTorch version that defines the
semantics is :func:`repro_torch.kernels.ref.mlstm_chunked_ref`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensor's
device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import (call_on, check_aligned, check_same_device, check_tensor,
                     raise_on, stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "mlstm_f32", torch.bfloat16: "mlstm_bf16"}
_ARGS = [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P, _I, _I, _P, _P, _P]
#: the widest K slice the kernels take (kMaxK)
MAX_K = 1024
#: a K slice that cuts K is a multiple of the streamed contraction's slice
#: (kKs)
K_STEP = 64
#: the columns of P a bf16 recurrence block owns, widest first: the first
#: whose shared memory fits the device is taken
P_SLICES = (64, 32)


def library(device):
    """``(library, dynamic shared-memory limit)`` on the CUDA ``device``:
    built and loaded at first use.  ``library.mlstm_chunk()`` is the chunk
    length, ``mlstm_record_bytes()`` a work record's size and
    ``mlstm_smem_bytes(bf16, K, p_slice)`` a block's shared memory (-1 for
    a shape the kernels do not take)."""
    return _build.bind("mlstm", _ENTRY.values(), _ARGS, device)


def k_slices(K: int) -> list:
    """``[(k0, width), ...]``: the K slices the kernels run K as, as even as
    multiples of ``K_STEP`` allow, each at most ``MAX_K``; one slice ``(0,
    K)`` when ``K <= MAX_K``."""
    if K <= MAX_K:
        return [(0, K)]
    even = -(-K // -(-K // MAX_K))          # K over the fewest slices
    per = K_STEP * -(-even // K_STEP)
    return [(k0, min(per, K - k0)) for k0 in range(0, K, per)]


def mlstm_chunked_kernel(q, k, v, a, i) -> torch.Tensor:
    """``y`` ``(B, T, H, P)`` in ``v.dtype``: ``q``/``k`` ``(B, T, H, K)``
    and ``v`` ``(B, T, H, P)`` f32 or bf16 (one dtype), ``a``/``i``
    ``(B, T, H)`` f32; any K and P."""
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
    for t, name in ((q, "q"), (k, "k"), (v, "v")):     # 16-byte copies
        check_aligned(t, name)
    if min(B, T, H, K, P) < 1:
        raise ValueError("every dimension must be at least 1")
    slices = k_slices(K)
    ks, S = slices[0][1], len(slices)
    lib, max_dyn = library(v.device)
    bf16 = int(v.dtype == torch.bfloat16)
    need = {pt: lib.mlstm_smem_bytes(bf16, ks, pt) for pt in P_SLICES}
    pt = next((pt for pt in P_SLICES if 0 <= need[pt] <= max_dyn), None)
    if pt is None:
        raise ValueError(f"mlstm: {need} bytes of shared memory per block by "
                         f"P slice (K slice {ks} of K={K}), the device allows "
                         f"{max_dyn}")
    y = torch.empty_like(v)
    work = num = den = None
    if bf16:            # the scores' records (B, nc, H), 16-byte aligned
        nc = -(-T // lib.mlstm_chunk())
        work = torch.empty(B * nc * H * lib.mlstm_record_bytes(),
                           dtype=torch.uint8, device=v.device)
    if S > 1:           # the slices' parts of the numerator and normaliser
        num = torch.empty(S * B * T * H * P, dtype=torch.float32,
                          device=v.device)
        den = torch.empty(S * B * T * H, dtype=torch.float32,
                          device=v.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = call_on(v, getattr(lib, _ENTRY[v.dtype]),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(),
                  i.data_ptr(), y.data_ptr(), B, T, H, K, P, K ** -0.5,
                  ptr(work), pt, ks, ptr(num), ptr(den), stream_of(v))
    raise_on(err, "mlstm launch")
    mlstm_chunked_kernel.launches += 1
    return y


mlstm_chunked_kernel.launches = 0
