"""Wrapper of the Hopper paged decode-attention kernel
(``csrc/paged_attention.cu``).

Counterpart of the JAX package's ``repro.kernels.paged_attention``
(``paged_attention_kernel``): one decode step of grouped-query attention
reading K/V through a page table, split over the page axis
(flash-decoding): one thread block per (split, sequence, KV head) writes
an f32 partial, a second kernel combines the splits.  The split plan
(:func:`split_plan`) is a function of the shapes alone; ``seq_lens`` is
never read on the host.
The wrapper checks device, dtype, shape, contiguity, alignment and the
kernel's limits, allocates the output with ``torch.empty``, launches on
PyTorch's current stream without synchronising, raises when the launch is
refused, and adds one to ``paged_attention_kernel.launches`` where it
launches (once a call, both kernels) — nowhere else.  The plain PyTorch
version that defines the semantics is
:func:`repro_torch.kernels.ref.paged_attention_ref`;
:mod:`repro_torch.kernels.ops` picks between the two by the tensor's
device.

Page ids are not checked against the pool (that would need a read of the
table back to the host): the caller keeps them in ``[0, n_pages)``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import (call_on, check_aligned, check_same_device, check_tensor,
                     raise_on, stream_of)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRY = {torch.float32: "pa_paged_attention_f32",
          torch.bfloat16: "pa_paged_attention_bf16"}
_ARGS = [_P] * 8 + [_I] * 8 + [ctypes.c_float, _I, _P]
#: max group, max head dim, max page size, vector width, max splits, token
#: rows a stage, stages
_LIMITS = []
#: blocks the split plan aims at, per SM (the split kernel keeps 3 on one)
BLOCKS_PER_SM = 3


def library(device):
    """``(library, limits, shared-memory limit)`` for the CUDA ``device``:
    built and loaded at first use, the kernel's shared-memory limit raised
    once on every device it is launched on."""
    lib, max_dyn = _build.bind("paged_attention", _ENTRY.values(), _ARGS,
                               device)
    if not _LIMITS:
        lib.pa_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.pa_limits.restype = None
        limits = (ctypes.c_int * 7)()
        lib.pa_limits(limits)
        _LIMITS.append(tuple(limits))
    return lib, _LIMITS[0], max_dyn


def split_plan(batch: int, kv_heads: int, pages_per_seq: int, n_sm: int,
               max_splits: int = 256):
    """``(n_splits, pages_per_split)``: split ``k`` covers table pages
    ``[k * pages_per_split, min((k + 1) * pages_per_split, pages_per_seq))``,
    so every page lies in exactly one split and none is empty.  Enough
    splits that ``batch * kv_heads * n_splits`` reaches about
    ``BLOCKS_PER_SM`` blocks per SM, at most one per page and at most
    ``max_splits``.  Shapes only: what a sequence's length leaves empty is
    found on the card."""
    want = -(-BLOCKS_PER_SM * n_sm // (batch * kv_heads))
    want = max(1, min(want, pages_per_seq, max_splits))
    per = -(-pages_per_seq // want)
    return -(-pages_per_seq // per), per


def smem_bytes(group: int, head_dim: int, dtype, pages_per_split: int,
               rows: int = 32, stages: int = 3) -> int:
    """Dynamic shared memory of the split kernel's block: ``stages`` K and V
    stages of ``rows`` token rows in the pages' type, the group's queries
    and one stage's scores in f32, the split's page ids in i32."""
    return stages * 2 * rows * head_dim * dtype.itemsize \
        + 4 * (group * head_dim + group * rows + pages_per_split)


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
    lib, limits, max_dyn = library(q.device)
    max_g, max_dh, max_ps, vec, max_splits, rows, stages = limits
    group = H // Hk
    if group > max_g or dh > max_dh or page_size > max_ps or dh % vec:
        raise ValueError(
            f"paged_attention: G={group}, dh={dh}, page_size={page_size}; "
            f"the kernel takes G <= {max_g}, dh <= {max_dh} and a multiple "
            f"of {vec}, page_size <= {max_ps}")
    for t, name in ((k_pages, "k_pages"), (v_pages, "v_pages")):
        check_aligned(t, name)
    n_splits, per = split_plan(B, Hk, pages_per_seq,
                               _build.sm_count(q.get_device()), max_splits)
    smem = smem_bytes(group, dh, q.dtype, per, rows, stages)
    if smem > max_dyn:
        raise ValueError(f"paged_attention: {smem} bytes of shared memory "
                         f"per block, the device allows {max_dyn}")
    out = torch.empty_like(q)
    part_acc = part_ml = 0          # scratch: the splits' partial states
    if n_splits > 1:
        n_acc = B * H * n_splits * dh
        part = torch.empty(n_acc + 2 * B * H * n_splits,
                           dtype=torch.float32, device=q.device)
        part_acc = part.data_ptr()
        part_ml = part_acc + 4 * n_acc
    args = (q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            part_ml, part_acc, B, H, Hk, dh, page_size, pages_per_seq, per,
            n_splits, dh ** -0.5, smem, stream_of(q))
    err = call_on(q, getattr(lib, _ENTRY[q.dtype]), *args)
    raise_on(err, "paged_attention launch")
    paged_attention_kernel.launches += 1
    return out


paged_attention_kernel.launches = 0
