"""The split-page arithmetic of paged decode attention (B4), on the CPU.

The CUDA kernel splits each sequence's page table over blocks and combines
the splits' partial softmax states (``csrc/paged_attention.cu``).  It
cannot run here, so this file holds what surrounds it:

* the wrapper's split plan (``paged_attention.split_plan``) is a function
  of the shapes alone, puts every page of the table in exactly one split
  and gives one split to a one-page table;
* the plain split-then-combine formulation
  (``ref.paged_attention_split_ref``) equals the plain version
  (``ref.paged_attention_ref``) at the f32 bar on every paged fuzz case,
  at the plans the wrapper would make and at one page a split;
* the combine's edge cases: a split past a sequence's last page reports
  ``m = -inf`` and weighs exactly 0, and ``seq_len = 0`` (every score
  ``-1e30``) still combines to the mean of the table's V rows.
"""

import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import cases, paged_attention, ref
from repro_torch.kernels.paged_attention import split_plan

CASES = cases.paged_cases()
BY_NAME = {c["name"]: c for c in CASES}
F32 = cases.PAGED_TOL["float32"]


def _pages(n_splits, per, pps):
    return [list(range(k * per, min((k + 1) * per, pps)))
            for k in range(n_splits)]


@pytest.mark.parametrize("batch", [1, 2, 8, 32, 300])
@pytest.mark.parametrize("kv_heads", [1, 2, 8])
@pytest.mark.parametrize("pages_per_seq", [1, 2, 13, 16, 64, 256, 1000])
def test_every_page_lands_in_exactly_one_split(batch, kv_heads,
                                               pages_per_seq):
    n_sm = 132
    n_splits, per = split_plan(batch, kv_heads, pages_per_seq, n_sm)
    splits = _pages(n_splits, per, pages_per_seq)
    assert sorted(p for s in splits for p in s) == list(range(pages_per_seq))
    assert all(splits), "a split with no page of the table"
    assert 1 <= n_splits <= min(pages_per_seq, 256)
    # at least half the blocks aimed at, where the table has the pages
    target = min(paged_attention.BLOCKS_PER_SM * n_sm,
                 batch * kv_heads * min(pages_per_seq, 256))
    assert 2 * batch * kv_heads * n_splits >= target
    if batch * kv_heads >= paged_attention.BLOCKS_PER_SM * n_sm:
        assert n_splits == 1


@pytest.mark.parametrize("batch, kv_heads", [(1, 1), (1, 2), (64, 8)])
def test_a_one_page_table_has_one_split(batch, kv_heads):
    assert split_plan(batch, kv_heads, 1, 132) == (1, 1)


def test_the_plan_reads_shapes_only():
    """``split_plan`` takes integers, and the wrapper hands it shapes and
    the SM count: nothing of ``seq_lens`` reaches the host."""
    params = inspect.signature(split_plan).parameters
    assert list(params) == ["batch", "kv_heads", "pages_per_seq", "n_sm",
                            "max_splits"]
    src = inspect.getsource(paged_attention.paged_attention_kernel)
    assert "split_plan(B, Hk, pages_per_seq" in src
    for read_back in (".item(", ".tolist(", ".cpu(", "int(seq_lens",
                      "seq_lens.max", "seq_lens.sum"):
        assert read_back not in src


def test_the_deployment_and_serve_full_plans():
    """Decode at B = 32 over 256-page tables, and serve_full's B = 1 step
    over 13 pages, on an H100's 132 SMs."""
    assert split_plan(32, 2, 256, 132) == (7, 37)
    assert split_plan(1, 2, 13, 132) == (13, 1)


def _f32(case):
    """The case's tensors as the kernel gets them, then widened to f32, so
    that both formulations are compared at the f32 bar."""
    return [t.float() if t.is_floating_point() else t
            for t in cases.paged_tensors(case, "cpu")]


def _plans(case):
    B, pps = case["page_table"].shape
    hk = case["k_pages"].shape[2]
    pers = {split_plan(B, hk, pps, n_sm)[1] for n_sm in (1, 8, 132)}
    return sorted(pers | {1})


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_split_then_combine_equals_the_plain_version(case):
    args = _f32(case)
    want = ref.paged_attention_ref(*args)
    for per in _plans(case):
        got = ref.paged_attention_split_ref(*args, pages_per_split=per)
        torch.testing.assert_close(got, want, atol=F32, rtol=F32,
                                   msg=f"pages_per_split={per}")


def test_a_split_past_the_last_page_weighs_nothing():
    case = BY_NAME["table64_empty_splits_f32"]
    args = _f32(case)
    out, (m, l, acc) = ref.paged_attention_split_ref(
        *args, pages_per_split=1, partials=True)
    ps = args[1].shape[1]
    for b, n in enumerate(case["seq_lens"]):
        read = -(-int(n) // ps)
        assert torch.isfinite(m[b, ..., :read]).all()
        assert torch.isneginf(m[b, ..., read:]).all()
        assert (l[b, ..., read:] == 0).all() and (acc[b, ..., read:, :] == 0).all()
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref.paged_attention_ref(*args),
                               atol=F32, rtol=F32)


def test_seq_len_zero_combines_to_the_mean_of_the_tables_v_rows():
    """Every split of a zero-length sequence reads its pages with every
    score at -1e30: each reports m = -1e30, all weigh 1, and the combine
    is the uniform mean over the whole table."""
    case = BY_NAME["seq_len_zero_split_table_f32"]
    q, kp, vp, pt, sl = _f32(case)
    out, (m, _l, _acc) = ref.paged_attention_split_ref(
        q, kp, vp, pt, sl, pages_per_split=3, partials=True)
    hk = kp.shape[2]
    g = q.shape[1] // hk
    for b in np.flatnonzero(case["seq_lens"] == 0):
        assert (m[b] == ref.NEG_INF).all()
        rows = vp[pt[b].long()].reshape(-1, hk, vp.shape[3]).mean(0)
        torch.testing.assert_close(out[b], rows.repeat_interleave(g, dim=0),
                                   atol=F32, rtol=F32)


def test_smem_bytes_fits_the_largest_case():
    """The split kernel's block at the kernel's limits (G = 16, dh = 256,
    f32) fits an H100's 227 KB of shared memory a block."""
    assert paged_attention.smem_bytes(16, 256, torch.float32, 64) \
        <= 232_448 - 1024
    # the deployment batch's split of 37 pages: three blocks to an SM
    assert paged_attention.smem_bytes(6, 128, torch.bfloat16, 37) < 56 * 1024
