"""Wrapper of the Hopper paged decode-attention kernel
(``csrc/paged_attention.cu``).

Counterpart of the JAX package's ``repro.kernels.paged_attention``
(``paged_attention_kernel``): one decode step of grouped-query attention
reading K/V through a page table, one thread block per (sequence, KV head).
The wrapper checks device, dtype, shape, contiguity, alignment and the
kernel's limits, allocates the output with ``torch.empty``, launches on
PyTorch's current stream without synchronising, raises when the launch is
refused, and adds one to ``paged_attention_kernel.launches`` where it
launches — nowhere else.  The plain PyTorch version that defines the
semantics is :func:`repro_torch.kernels.ref.paged_attention_ref`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensor's
device.

Page ids are not checked against the pool (that would need a read of the
table back to the host): the caller keeps them in ``[0, n_pages)``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import (
    check_aligned, check_same_device, check_tensor, raise_on, stream_of,
)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "pa_paged_attention_f32",
          torch.bfloat16: "pa_paged_attention_bf16"}
_ARGS = [_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _P]
_LIMITS = []         # max group, max head dim, max page size, vector width


def library(device):
    """``(library, limits, shared-memory limit)`` for the CUDA ``device``:
    built and loaded at first use, the kernel's shared-memory limit
    raised once on every device it is launched on."""
    lib, max_dyn = _build.bind("paged_attention", _ENTRY.values(), _ARGS,
                               device)
    if not _LIMITS:
        lib.pa_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.pa_limits.restype = None
        limits = (ctypes.c_int * 4)()
        lib.pa_limits(limits)
        _LIMITS.extend(limits)
    return lib, tuple(_LIMITS), max_dyn


def smem_bytes(group: int, head_dim: int, page_size: int) -> int:
    """Dynamic shared memory of one block: the K and V tiles, the group's
    queries and its scores, all f32."""
    return 4 * (2 * page_size * head_dim + group * head_dim
                + group * page_size)


def paged_attention_kernel(q, k_pages, v_pages, page_table, seq_lens,
                           ) -> torch.Tensor:
    """``(B, H, dh)`` in ``q.dtype``: ``q`` ``(B, H, dh)`` f32 or bf16,
    ``k_pages``/``v_pages`` ``(n_pages, page_size, Hk, dh)`` of q's dtype,
    ``page_table`` ``(B, pages_per_seq)`` i32, ``seq_lens`` ``(B,)`` i32."""
    if q.dim() != 3 or k_pages.dim() != 4:
        raise ValueError("expected q (B, H, dh) and k_pages "
                         "(n_pages, page_size, Hk, dh)")
    B, H, dh = q.shape
    n_pages, page_size, Hk, _ = k_pages.shape
    if q.dtype not in _ENTRY:
        raise TypeError(f"q: expected float32 or bfloat16, got {q.dtype}")
    check_tensor(q, "q", q.dtype, (B, H, dh))
    check_tensor(k_pages, "k_pages", q.dtype, (n_pages, page_size, Hk, dh))
    check_tensor(v_pages, "v_pages", q.dtype, (n_pages, page_size, Hk, dh))
    if page_table.dim() != 2:
        raise ValueError("page_table: expected (B, pages_per_seq)")
    pages_per_seq = page_table.shape[1]
    check_tensor(page_table, "page_table", torch.int32, (B, pages_per_seq))
    check_tensor(seq_lens, "seq_lens", torch.int32, (B,))
    check_same_device(q, k_pages, v_pages, page_table, seq_lens)
    if min(B, H, Hk, dh, page_size, n_pages, pages_per_seq) < 1:
        raise ValueError("every dimension must be at least 1")
    if H % Hk:
        raise ValueError(f"H={H} is not a multiple of Hk={Hk}")
    lib, (max_g, max_dh, max_ps, vec), max_dyn = library(q.device)
    group = H // Hk
    if group > max_g or dh > max_dh or page_size > max_ps or dh % vec:
        raise ValueError(
            f"paged_attention: G={group}, dh={dh}, page_size={page_size}; "
            f"the kernel takes G <= {max_g}, dh <= {max_dh} and a multiple "
            f"of {vec}, page_size <= {max_ps}")
    for t, name in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        check_aligned(t, name)
    smem = smem_bytes(group, dh, page_size)
    if smem > max_dyn:
        raise ValueError(f"paged_attention: {smem} bytes of shared memory "
                         f"per block, the device allows {max_dyn}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, Hk, dh, page_size, pages_per_seq, dh ** -0.5, smem,
            stream_of(q))
    raise_on(err, "paged_attention launch")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
