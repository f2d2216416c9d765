"""Fuzz inputs for the port's kernels, made with numpy from a seed.

The buffer-pool kernels first; the paged-attention cases
(:func:`paged_cases`) and the model-stack cases (:func:`model_cases`:
flash attention, the Mamba2 scan, the mLSTM) are at the end.

One list of cases per kernel, shared by the CPU parity tests (plain
PyTorch version against the JAX package's oracle and interpret-mode
kernel) and by ``chip_smoke.py`` (CUDA kernel against the plain version
on the card), so both hold the same shapes: page counts that are not
multiples of anything (1, 8, 100, 128, 200, 256, 600), a lane axis of 1
and of 5 with different scalars per lane, a candidate window below the
victim count, zero budget / zero need, nothing eligible, nothing
grantable, heavy ties, integer keys around 2^24, queue keys near 2^30 and
evictable keys at the value that masks the non-evictable pages.

Sizes are whole numbers in 1..8 (0 and negative ones where a case says
so), so every byte prefix is exact in f32 as well as in f64 and any
disagreement is a fault of the logic, not of rounding.  Arrays are
``(L, P)`` / ``(L,)`` numpy; ``static`` holds the keyword arguments that
are Python ints.

The buffer-pool kernels' later cases (drawn after the others, so those
keep their numbers) cover the paths of their CUDA kernels, each with
``path``: per lane, the path it must take (``"idle"``, ``"select"``,
``"full"`` or, for the eviction kernel, ``"all"``,
:func:`repro_torch.kernels.pbm_timeline.lane_paths`): the main path's
shapes (P = 768, 3072, 8832 with the simulator's queue keys, vmax 384,
pops 6, h_cap 64; for eviction P = 3072 and 8832 with vmax 256 and
negative scores), ties across the m-th entry, a head that is the whole
queue (every page), heads of ``HEAD_CAP`` and ``HEAD_CAP + 1`` entries,
``inc`` of 0 and below 0, zero and negative sizes, a P that is not a
multiple of 4, an empty queue, and eviction keys at -0.0 / +0.0 / +inf,
around 2^24 and at the masking values on the head path.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

PAGE_COUNTS = (1, 8, 100, 128, 200, 256, 600)
LANES = (1, 5)

Case = Dict[str, object]


def _sizes(rng, L, P):
    return rng.integers(1, 9, (L, P)).astype(np.float32)


#: the CUDA queue kernels' longest head sorted alone (pbm_timeline.HEAD_CAP)
HEAD_CAP = 1024


def queue_keys(rng, fractions, P):
    """Queue keys as the simulator builds them (stamp * 32768 + tie, ~30
    bits, the stamps few so the top digits are shared), lane ``l`` wanting
    about ``fractions[l]`` of its pages; -1 = not wanted."""
    L = len(fractions)
    wanted = rng.random((L, P)) < np.asarray(fractions).reshape(L, 1)
    key = (32767 - rng.integers(0, 64, (L, P))) * 32768 \
        + rng.integers(0, 32768, (L, P))
    return np.where(wanted, key, -1)


def _wanting(rng, counts, P):
    """Random queue keys with exactly ``counts[l]`` pages wanted in lane
    ``l``."""
    key = np.full((len(counts), P), -1, np.int64)
    for lane, c in enumerate(counts):
        pages = rng.permutation(P)[:c]
        key[lane, pages] = rng.integers(0, 2**29, c)
    return key


def evict_cases(seed: int = 0) -> List[Case]:
    rng = np.random.default_rng(seed)
    out: List[Case] = []

    def add(name, key, sizes, evictable, need, vmax):
        out.append(dict(
            name=name, key=key, sizes=sizes, evictable=evictable,
            need_free=np.asarray(need, np.float32), static=dict(vmax=vmax)))

    for P in PAGE_COUNTS:
        vmax = int(rng.integers(1, P + 1))
        for L in LANES:
            for int_keys in (False, True):
                if int_keys:
                    key = rng.integers(-2**30, 2**30, (L, P)).astype(np.int32)
                else:   # integer-valued floats with deliberate ties
                    key = rng.integers(-50, 50, (L, P)).astype(np.float32)
                need = rng.integers(1, max(2, 5 * P // 2), L)
                add(f"fuzz_P{P}_L{L}_{'i32' if int_keys else 'f32'}",
                    key, _sizes(rng, L, P), rng.random((L, P)) < 0.6, need,
                    vmax)
    P, L = 128, 5
    add("vmax_below_victims", rng.integers(-50, 50, (L, P)).astype(np.float32),
        _sizes(rng, L, P), rng.random((L, P)) < 0.6, np.full(L, 1e6), 7)
    add("all_ineligible", rng.integers(-9, 9, (L, P)).astype(np.int32),
        _sizes(rng, L, P), np.zeros((L, P), bool), np.full(L, 50.0), 64)
    add("zero_and_negative_need",
        rng.integers(-9, 9, (L, P)).astype(np.float32), _sizes(rng, L, P),
        rng.random((L, P)) < 0.6, np.array([0.0, -3.0, 0.0, 5.0, 0.0]), 64)
    add("heavy_ties_f32", rng.integers(0, 3, (L, P)).astype(np.float32),
        _sizes(rng, L, P), rng.random((L, P)) < 0.8,
        rng.integers(1, 200, L), 40)
    add("heavy_ties_i32", np.zeros((L, P), np.int32), _sizes(rng, L, P),
        rng.random((L, P)) < 0.8, rng.integers(1, 200, L), 40)
    # 2^24 and 2^24 + 1 collapse to one float: index 1 must win
    add("i32_2pow24_pair", np.array([[2**24, 2**24 + 1, 0, 0]], np.int32),
        np.ones((1, 4), np.float32), np.ones((1, 4), bool), [1.0], 4)
    add("i32_dense_beyond_2pow24",
        (2**24 + rng.integers(0, 64, (L, P))).astype(np.int32),
        rng.integers(1, 4, (L, P)).astype(np.float32),
        rng.random((L, P)) < 0.8, np.full(L, 40.0), 32)
    # an evictable key AT the value that masks non-evictable pages (-inf /
    # the integer minimum) ties with them by page index and can fall
    # outside the candidate window
    at_mask = rng.random((L, P)) < 0.7
    fkey = rng.integers(-50, 50, (L, P)).astype(np.float32)
    add("f32_evictable_key_at_mask_value",
        np.where(at_mask, -np.inf, fkey).astype(np.float32),
        _sizes(rng, L, P), rng.random((L, P)) < 0.5, np.full(L, 1e6), 48)
    ikey = rng.integers(-2**30, 2**30, (L, P))
    add("i32_evictable_key_at_mask_value",
        np.where(at_mask, -2**31, ikey).astype(np.int32),
        _sizes(rng, L, P), rng.random((L, P)) < 0.5, np.full(L, 1e6), 48)

    def head(name, key, sizes, evictable, need, vmax, path):
        add(name, key, sizes, evictable, need, vmax)
        out[-1]["path"] = tuple(path)

    sel5 = ("select",) * 5
    evictable_fracs = np.array([0.05, 0.3, 0.6, 0.9, 1.0]).reshape(5, 1)
    for P in (3072, 8832):      # the simulator's vmax at most 256
        # scores as the policies give them: fractional, mostly negative
        key = (rng.normal(-200.0, 120.0, (5, P))
               * (1 + rng.integers(0, 2, (5, P)))).astype(np.float32)
        head(f"main_P{P}_negative_keys", key, _sizes(rng, 5, P),
             rng.random((5, P)) < evictable_fracs,
             [30.0, 600.0, 5000.0, 1e9, 200.0], 256, sel5)
    P = 200     # vmax >= P: the head is every page, all of them negative
    head("head_is_every_page", -rng.integers(1, 50, (5, P)).astype(np.float32),
         _sizes(rng, 5, P), rng.random((5, P)) < evictable_fracs,
         [40.0, 1e9, 0.0, 300.0, 900.0], 256,
         ("all", "all", "idle", "all", "all"))
    P = 600     # three keys, 90 % evictable: the m-th entry inside a tie run
    head("ties_straddle_head",
         -rng.integers(0, 3, (5, P)).astype(np.float32), _sizes(rng, 5, P),
         rng.random((5, P)) < 0.9, [1e9, 100.0, 250.0, 1e9, 5.0], 100, sel5)
    # -0.0 and +0.0 tie by index; +inf first; i32 keys on the head path
    key = rng.choice(np.array([-0.0, 0.0, -1.5, 1.5, np.inf], np.float32),
                     (5, 800))
    head("signed_zeros_and_inf", key, _sizes(rng, 5, 800),
         rng.random((5, 800)) < 0.7, np.full(5, 1e9), 256, sel5)
    key = (2**24 + rng.integers(-40, 40, (5, 3072))).astype(np.int32)
    key[:, ::7] = -2**31 + 2 + rng.integers(0, 3, (5, 439))
    head("i32_head_p3072_around_2pow24", key, _sizes(rng, 5, 3072),
         rng.random((5, 3072)) < 0.6, np.full(5, 1e9), 256, sel5)
    for name, P, vmax, path in (    # the head's length at HEAD_CAP's edges
            ("head_cap", 1500, HEAD_CAP, "select"),
            ("head_cap_plus_one", 1500, HEAD_CAP + 1, "full"),
            ("every_page_at_head_cap", HEAD_CAP, 2000, "all"),
            ("every_page_past_head_cap", HEAD_CAP + 1, 2000, "full")):
        head(name, rng.integers(-99, 99, (3, P)).astype(np.float32),
             _sizes(rng, 3, P), rng.random((3, P)) < 0.8,
             [1e9, 2500.0, 0.0], vmax, (path, path, "idle"))
    # the masking values on the head path (compared with the oracle only):
    # so many pages at it that the m-th entry falls inside their tie run
    P = 3072
    key = rng.normal(0.0, 10.0, (5, P)).astype(np.float32)
    key[rng.random((5, P)) < 0.95] = -np.inf
    head("f32_head_key_at_mask_value", key, _sizes(rng, 5, P),
         rng.random((5, P)) < 0.5, np.full(5, 1e9), 256, sel5)
    key = rng.integers(-2**31, 2**31 - 1, (5, P), dtype=np.int64)
    key[rng.random((5, P)) < 0.95] = -2**31
    head("i32_head_key_at_mask_value", key.astype(np.int32),
         _sizes(rng, 5, P), rng.random((5, P)) < 0.5, np.full(5, 1e9), 256,
         sel5)
    return out


def grant_cases(seed: int = 4) -> List[Case]:
    rng = np.random.default_rng(seed)
    out: List[Case] = []

    def add(name, key, sizes, budget, pops, vmax):
        out.append(dict(
            name=name, key=key.astype(np.int32), sizes=sizes,
            budget=np.asarray(budget, np.float32),
            pops=np.asarray(pops, np.int32), static=dict(vmax=vmax)))

    for P in PAGE_COUNTS:
        vmax = int(rng.integers(1, P + 1))
        for L in LANES:
            add(f"fuzz_P{P}_L{L}", rng.integers(-1, 2**29, (L, P)),
                _sizes(rng, L, P), rng.integers(1, 4 * P + 1, L),
                rng.integers(1, 33, L), vmax)
    P, L = 128, 5
    # a queue as the simulator builds it: few wanted pages, stamp * 32768 +
    # tie with ~30 significant bits
    wanted = rng.random((L, P)) < 0.3
    near = (32767 - rng.integers(0, 4, (L, P))) * 32768 \
        + rng.integers(0, 32768, (L, P))
    add("fifo_keys_near_2pow30", np.where(wanted, near, -1),
        _sizes(rng, L, P), rng.integers(20, 200, L), rng.integers(1, 40, L),
        64)
    add("zero_budget", rng.integers(-1, 2**29, (L, P)), _sizes(rng, L, P),
        np.zeros(L), np.full(L, 6), 16)
    add("none_wanted", np.full((L, P), -1), _sizes(rng, L, P),
        np.full(L, 100.0), np.full(L, 6), 16)
    add("zero_and_negative_pops", rng.integers(0, 99, (L, P)),
        _sizes(rng, L, P), np.full(L, 100.0), [0, -2, 3, 0, 1], 16)
    add("heavy_ties", rng.integers(-1, 2, (L, P)), _sizes(rng, L, P),
        rng.integers(1, 300, L), rng.integers(1, 64, L), 48)
    add("vmax_is_the_cap", rng.integers(0, 2**29, (L, P)), _sizes(rng, L, P),
        np.full(L, 1e6), np.full(L, 100), 9)

    def head(name, key, sizes, budget, pops, vmax, path):
        add(name, key, sizes, budget, pops, vmax)
        out[-1]["path"] = tuple(path)

    sel5 = ("select",) * 5
    fractions = (0.05, 0.3, 0.6, 0.9, 1.0)
    for P in (768, 3072, 8832):     # the simulator's vmax = n_rounds = 384
        head(f"main_P{P}", queue_keys(rng, fractions, P), _sizes(rng, 5, P),
             [300.0, 900.0, 1800.0, 1e9, 2500.0], [6, 384, 100, 384, 384],
             384, sel5)
    P = 600
    head("ties_straddle_head",
         np.where(rng.random((5, P)) < 0.9, rng.integers(0, 3, (5, P)), -1),
         _sizes(rng, 5, P), np.full(5, 1e6), [200, 150, 211, 6, 300], 200,
         sel5)
    P = 500     # lim = the wanted pages: the head is the whole queue
    head("head_is_the_queue", _wanting(rng, [1, 100, 384, 499, 500], P),
         _sizes(rng, 5, P), np.full(5, 1e9), np.full(5, 600), 500, sel5)
    P = 1500    # lim = 100, 1100, HEAD_CAP + 1, HEAD_CAP, 0
    head("head_cap_edges", rng.integers(0, 2**29, (5, P)), _sizes(rng, 5, P),
         np.full(5, 1e9), [100, 1100, HEAD_CAP + 1, HEAD_CAP, 0], 1100,
         ("select", "full", "full", "select", "idle"))
    P = 300
    sizes = _sizes(rng, 5, P)
    sizes[rng.random((5, P)) < 0.3] = 0.0
    head("zero_size_wanted", rng.integers(-1, 2**29, (5, P)), sizes,
         rng.integers(0, 200, 5), np.full(5, 200), 250, sel5)
    P = 771     # rows start off 16-byte boundaries
    head("unaligned_p771", queue_keys(rng, fractions, P), _sizes(rng, 5, P),
         rng.integers(50, 2000, 5), [6, 384, 100, 384, 384], 384, sel5)
    P = 768
    head("empty_queue", np.full((3, P), -1), _sizes(rng, 3, P),
         np.full(3, 1e6), np.full(3, 384), 384, ("idle",) * 3)
    P = 3072
    head("full_row_p3072", queue_keys(rng, (0.5, 0.9, 1.0), P),
         _sizes(rng, 3, P), [1e9, 3000.0, 9000.0], np.full(3, 2048), 2048,
         ("full",) * 3)
    return out


def wake_cases(seed: int = 11) -> List[Case]:
    rng = np.random.default_rng(seed)
    out: List[Case] = []

    def add(name, key, sizes, credit0, inc, pops, h_cap):
        out.append(dict(
            name=name, key=key.astype(np.int32), sizes=sizes,
            credit0=np.asarray(credit0, np.float32),
            inc=np.asarray(inc, np.float32),
            pops=np.asarray(pops, np.int32), static=dict(h_cap=h_cap)))

    for P in PAGE_COUNTS:
        h_cap = int(rng.choice([4, 16, 64]))
        for L in LANES:
            wanted = rng.random((L, P)) < 0.5
            key = np.where(wanted, rng.integers(0, 2**29, (L, P)), -1)
            add(f"fuzz_P{P}_L{L}", key, _sizes(rng, L, P),
                rng.integers(0, 9, L), rng.integers(1, 12, L),
                rng.integers(1, 7, L), h_cap)
    P, L = 128, 5
    key = rng.integers(0, 2**29, (L, P))
    # no credit ever arrives: every page carries the sentinel
    add("all_blocked_sentinel", key, _sizes(rng, L, P), np.zeros(L),
        np.zeros(L), np.full(L, 6), 16)
    add("none_wanted", np.full((L, P), -1), _sizes(rng, L, P),
        np.full(L, 10.0), np.full(L, 5.0), np.full(L, 6), 16)
    # byte-starved early steps waste their pops: the closed form
    # max(k_bytes, ceil(rank / pops)) is wrong here
    add("starved_then_pop_bound", key, np.ones((L, P), np.float32),
        np.zeros(L), [0.25, 0.5, 1.0, 2.0, 50.0], [1, 2, 3, 6, 1], 64)
    add("zero_and_negative_pops", key, _sizes(rng, L, P), np.full(L, 50.0),
        np.full(L, 9.0), [0, -1, 2, 0, 4], 16)
    add("heavy_ties", rng.integers(-1, 2, (L, P)), _sizes(rng, L, P),
        rng.integers(0, 9, L), rng.integers(1, 12, L), rng.integers(1, 7, L),
        64)
    # fractional credit cadence: credit0 + k*inc must round like a rounded
    # f32 multiply followed by a rounded f32 add
    add("fractional_cadence", key, _sizes(rng, L, P),
        rng.random(L) * 7.0, rng.random(L) * 3.0 + 0.1,
        rng.integers(1, 7, L), 64)

    def head(name, key, sizes, credit0, inc, pops, h_cap, path):
        add(name, key, sizes, credit0, inc, pops, h_cap)
        out[-1]["path"] = tuple(path)

    sel5 = ("select",) * 5
    fractions = (0.05, 0.3, 0.6, 0.9, 1.0)
    for P in (768, 3072, 8832):     # the simulator's pops 6, h_cap 64
        head(f"main_P{P}", queue_keys(rng, fractions, P), _sizes(rng, 5, P),
             rng.integers(0, 9, 5), [2.0, 9.0, 20.0, 31.0, 40.0],
             np.full(5, 6), 64, sel5)
    P = 600
    head("ties_straddle_head",
         np.where(rng.random((5, P)) < 0.9, rng.integers(0, 3, (5, P)), -1),
         _sizes(rng, 5, P), rng.integers(0, 9, 5), rng.integers(1, 40, 5),
         np.full(5, 6), 64, sel5)
    P = 500     # m = the wanted pages (384 = h_cap * pops too), or 0
    head("head_is_the_queue", _wanting(rng, [10, 200, 384, 400, 0], P),
         _sizes(rng, 5, P), rng.integers(0, 9, 5), rng.integers(1, 40, 5),
         np.full(5, 6), 64, sel5[:4] + ("idle",))
    P = 1200    # m = HEAD_CAP, 1088, 384, 1200, 0
    head("head_cap_edges", rng.integers(0, 2**29, (5, P)), _sizes(rng, 5, P),
         rng.integers(0, 9, 5), rng.integers(20, 90, 5), [16, 17, 6, 20, 0],
         64, ("select", "full", "select", "full", "idle"))
    P = 1100    # m = HEAD_CAP + 1: the wanted pages
    head("head_cap_plus_one", _wanting(rng, [HEAD_CAP + 1], P),
         _sizes(rng, 1, P), [5.0], [80.0], [17], 64, ("full",))
    P = 300
    head("inc_zero_and_negative", rng.integers(-1, 2**29, (5, P)),
         _sizes(rng, 5, P), [20.0, 50.0, 3.0, 30.0, 0.0],
         [0.0, -1.0, 2.5, -0.5, 0.0], np.full(5, 6), 64,
         ("select", "full", "select", "full", "select"))
    key = rng.integers(-1, 2**29, (5, P))
    sizes = _sizes(rng, 5, P)
    sizes[rng.random((5, P)) < 0.3] = 0.0
    first_wanted = (key >= 0).argmax(axis=1)
    for lane in (1, 3):             # a negative size on a wanted page
        sizes[lane, first_wanted[lane]] = -3.0
    head("zero_and_negative_sizes", key, sizes, rng.integers(0, 9, 5),
         rng.integers(1, 20, 5), np.full(5, 6), 64,
         ("select", "full", "select", "full", "select"))
    P = 771     # rows start off 16-byte boundaries
    head("unaligned_p771", queue_keys(rng, fractions, P), _sizes(rng, 5, P),
         rng.integers(0, 9, 5), rng.integers(1, 40, 5), np.full(5, 6), 64,
         sel5)
    P = 768
    head("empty_queue", np.full((3, P), -1), _sizes(rng, 3, P),
         np.full(3, 10.0), np.full(3, 20.0), np.full(3, 6), 64,
         ("idle",) * 3)
    return out


def paged_cases(seed: int = 21) -> List[Case]:
    """Paged decode attention.  ``q``, ``k_pages``, ``v_pages`` are f32
    numpy arrays and ``dtype`` says which type the kernel gets them in
    (``"float32"`` or ``"bfloat16"``; both frameworks round f32 to bf16
    the same way); ``page_table`` and ``seq_lens`` are i32.  Every shape
    comes in both types:

    * the four shapes of the JAX package's kernel sweep — MQA, GQA 4:1,
      MHA at dh = 256, GQA 3:1 at page_size = 32 — drawn as it draws them
      (q ~ N(0, 1), pages ~ N(0, 0.5), a permuted table, seq_lens in
      1..table);
    * ragged seq_lens: 1, a page's end, one past it, the full table and
      beyond it (every position of the table valid);
    * a table that repeats a page id, within a sequence and across them;
    * seq_len = 0 (the oracle's mean of the table's V rows);
    * the Qwen2-1.5B attention geometry, H = 12, Hk = 2, dh = 128,
      page_size = 16;
    * the kernel's limits: G = 16, dh = 256, page_size = 64;
    * the split kernel's geometry: a table of 64 pages whose lengths leave
      whole splits empty, ``seq_len = 0`` over a table long enough to be
      split, and ``serve_full``'s step (B = 1, 13 of 16 pages used).
    """
    rng = np.random.default_rng(seed)
    out: List[Case] = []

    def draw(B, H, Hk, dh, page_size, pps, n_pages=None):
        n_pages = B * pps + 4 if n_pages is None else n_pages
        q = rng.normal(0, 1.0, (B, H, dh)).astype(np.float32)
        kp = rng.normal(0, 0.5, (n_pages, page_size, Hk, dh)).astype(np.float32)
        vp = rng.normal(0, 0.5, (n_pages, page_size, Hk, dh)).astype(np.float32)
        return q, kp, vp

    def add(name, q, kp, vp, pt, sl):
        for dtype in ("float32", "bfloat16"):
            out.append(dict(
                name=f"{name}_{'f32' if dtype == 'float32' else 'bf16'}",
                dtype=dtype, q=q, k_pages=kp, v_pages=vp,
                page_table=np.asarray(pt, np.int32),
                seq_lens=np.asarray(sl, np.int32)))

    for name, (B, H, Hk, dh, ps, pps) in (
            ("mqa", (2, 4, 1, 128, 16, 2)),
            ("gqa4", (4, 8, 2, 128, 16, 4)),
            ("mha_dh256", (1, 2, 2, 256, 8, 3)),
            ("gqa3_page32", (3, 6, 2, 128, 32, 2))):
        q, kp, vp = draw(B, H, Hk, dh, ps, pps)
        n_pages = kp.shape[0]
        pt = rng.permutation(n_pages)[: B * pps].reshape(B, pps)
        add(name, q, kp, vp, pt, rng.integers(1, pps * ps + 1, B))

    B, H, Hk, dh, ps, pps = 5, 8, 2, 128, 16, 4
    q, kp, vp = draw(B, H, Hk, dh, ps, pps)
    pt = rng.permutation(kp.shape[0])[: B * pps].reshape(B, pps)
    add("ragged_seq_lens", q, kp, vp, pt,
        [1, ps, ps + 1, pps * ps, pps * ps + 7])

    B, H, Hk, dh, ps, pps = 3, 4, 2, 128, 8, 3
    q, kp, vp = draw(B, H, Hk, dh, ps, pps, n_pages=6)
    add("repeated_page_ids", q, kp, vp, [[3, 3, 5], [5, 3, 3], [0, 0, 0]],
        [pps * ps, 2 * ps - 3, pps * ps])

    B, H, Hk, dh, ps, pps = 3, 4, 1, 128, 16, 2
    q, kp, vp = draw(B, H, Hk, dh, ps, pps)
    pt = rng.permutation(kp.shape[0])[: B * pps].reshape(B, pps)
    add("seq_len_zero", q, kp, vp, pt, [0, 9, 0])

    B, H, Hk, dh, ps, pps = 4, 12, 2, 128, 16, 8
    q, kp, vp = draw(B, H, Hk, dh, ps, pps)
    pt = rng.permutation(kp.shape[0])[: B * pps].reshape(B, pps)
    add("qwen2_1_5b_geometry", q, kp, vp, pt,
        rng.integers(1, pps * ps + 1, B))

    B, H, Hk, dh, ps, pps = 2, 16, 1, 256, 64, 2
    q, kp, vp = draw(B, H, Hk, dh, ps, pps)
    pt = rng.permutation(kp.shape[0])[: B * pps].reshape(B, pps)
    add("kernel_limits_g16_dh256_page64", q, kp, vp, pt, [pps * ps, 70])

    B, H, Hk, dh, ps, pps = 2, 4, 1, 128, 16, 64
    q, kp, vp = draw(B, H, Hk, dh, ps, pps)
    pt = rng.permutation(kp.shape[0])[: B * pps].reshape(B, pps)
    add("table64_empty_splits", q, kp, vp, pt, [20, 300])

    B, H, Hk, dh, ps, pps = 2, 8, 2, 64, 8, 32
    q, kp, vp = draw(B, H, Hk, dh, ps, pps)
    pt = rng.permutation(kp.shape[0])[: B * pps].reshape(B, pps)
    add("seq_len_zero_split_table", q, kp, vp, pt, [0, 100])

    B, H, Hk, dh, ps, pps = 1, 12, 2, 128, 16, 16
    q, kp, vp = draw(B, H, Hk, dh, ps, pps)
    pt = rng.permutation(kp.shape[0])[: B * pps].reshape(B, pps)
    add("serve_full_13_of_16_pages", q, kp, vp, pt, [12 * ps + 5])
    return out


#: atol = rtol of a paged-attention comparison, by dtype: the JAX
#: package's own tolerances for this kernel (tests/test_kernels.py)
PAGED_TOL = {"float32": 3e-5, "bfloat16": 3e-2}


def paged_tensors(case: Case, device) -> list:
    """A paged-attention case as the five tensor arguments on ``device``,
    q and the pages in the case's dtype."""
    import torch
    dtype = getattr(torch, case["dtype"])
    return [torch.from_numpy(np.ascontiguousarray(case[f]))
            .to(dtype if case[f].dtype == np.float32 else torch.int32)
            .to(device)
            for f in TENSOR_FIELDS["paged_attention"]]

def model_cases(seed: int = 31) -> List[Case]:
    """Flash attention, the chunked Mamba2 scan and the chunked mLSTM.
    Each case has ``kernel``, ``name``, ``dtype`` (``"float32"`` or
    ``"bfloat16"``: the type the kernel gets the float inputs in, except
    the f32 decay and gates), f32 numpy inputs under
    ``TENSOR_FIELDS[kernel]`` and keyword arguments in ``static``.  Every
    shape comes in both types.  Drawn as the JAX package's kernel tests
    draw them, plus:

    * flash attention: GQA 2:1 and 6:1, windows, ``causal=False``, ragged
      T, dh of 8 (the smoke configs), 32, 64, 128, 160 (Zamba2's shared
      block) and 256, T < S (the oracle's offset S - T) and T > S under a
      causal mask (rows with every key masked: the oracle's mean of V),
      the Qwen2-1.5B geometry;
    * Mamba2 scan: ragged T, P = N = 16 (the smoke config) and 64 (Zamba2),
      decays down to 1e-12 (a large dt), several chunks;
    * mLSTM: ragged T, P split over blocks with a ragged last slice, K not
      a multiple of the contraction tile, xLSTM-350M's K = P = 512, input
      gates over the model's whole range exp([-10, 10]);
    * flash attention at the tensor-core kernel's tiles (drawn last, so
      the cases above keep their numbers): T = S = 1000 under GQA 6:1 at
      dh 128 and 160 (many key tiles, a ragged last query tile), a window
      of 200 that crosses tile edges, and T > S with masked rows at dh 128;
    * the Mamba2 scan's split kernel (drawn after those): 2,100 steps, so
      that the state pass crosses 17 chunks of 128 (33 of 64 in f32); the
      model's 80 heads at P = N = 64, which one block serves with one C B^T;
      a long memory (a near 1) at N = 128; ragged P = 48, N = 32;
    * the Mamba2 scan's heads wider than its tiles (drawn after those): P =
      N = 128, P = 96 at N = 64 and P = 80 at N = 32, run as sub-heads of
      64, 48 and 16;
    * the mLSTM's tensor-core kernels (drawn last): 2,100 steps (33 chunks
      of 64 through one block's chain), the model's gate range at K = P =
      512 with 4 heads over more than two chunks, a ragged T with K = 37 and
      P = 45 (no multiple of a tile, of 8 or of 2: the element-wise copies
      and stores), B = 3 with 4 heads.
    """
    rng = np.random.default_rng(seed)
    out: List[Case] = []

    def nrm(shape, sd):
        return rng.normal(0, sd, shape).astype(np.float32)

    def add(kernel, name, static=None, **arrays):
        for dtype in ("float32", "bfloat16"):
            out.append(dict(kernel=kernel, dtype=dtype, static=static or {},
                            name=f"{name}_{'f32' if dtype == 'float32' else 'bf16'}",
                            **arrays))

    for name, (B, T, S, H, Hk, dh, causal, window) in (
            ("causal_mha_dh128", (2, 128, 128, 4, 4, 128, True, None)),
            ("window64_gqa2_dh64", (2, 192, 192, 4, 2, 64, True, 64)),
            ("full_ragged_mqa_dh32", (1, 96, 96, 2, 1, 32, False, None)),
            ("ragged_window32_gqa2", (2, 130, 130, 4, 2, 128, True, 32)),
            ("zamba2_dh160", (1, 100, 100, 2, 2, 160, True, None)),
            ("t_below_s", (1, 50, 130, 4, 2, 64, True, None)),
            ("t_above_s_masked_rows", (1, 130, 70, 2, 1, 32, True, None)),
            ("smoke_dh8_gqa3", (2, 37, 37, 6, 2, 8, True, None)),
            ("full_window16_dh256", (1, 80, 80, 2, 2, 256, False, 16)),
            ("qwen2_geometry", (1, 200, 200, 12, 2, 128, True, None))):
        add("flash_attention", name, dict(causal=causal, window=window),
            q=nrm((B, T, H, dh), 0.5), k=nrm((B, S, Hk, dh), 0.5),
            v=nrm((B, S, Hk, dh), 0.5))

    for name, (B, T, H, P, N, a_lo) in (
            ("jax_sweep", (2, 128, 2, 64, 64, 0.6)),
            ("ragged", (2, 100, 2, 64, 64, 0.6)),
            ("zamba2_geometry", (1, 200, 4, 64, 64, 0.6)),
            ("smoke_p16_n16", (2, 70, 3, 16, 16, 0.6)),
            ("strong_decay", (1, 150, 2, 32, 16, 1e-12)),
            ("five_chunks", (1, 300, 2, 64, 64, 0.9))):
        add("mamba2_scan", name, xh=nrm((B, T, H, P), 0.5),
            a=rng.uniform(a_lo, 1.0, (B, T, H)).astype(np.float32),
            b=nrm((B, T, N), 0.3), c=nrm((B, T, N), 0.3))

    def gates(B, T, H, wide):
        if wide:    # the model's gates: sigmoid forget, exp(clip) input
            a = 1.0 / (1.0 + np.exp(-rng.normal(0, 2.0, (B, T, H))))
            i = np.exp(rng.uniform(-10.0, 10.0, (B, T, H)))
        else:
            a = rng.uniform(0.7, 1.0, (B, T, H))
            i = rng.uniform(0.1, 1.0, (B, T, H))
        return a.astype(np.float32), i.astype(np.float32)

    for name, (B, T, H, K, P, wide) in (
            ("jax_sweep", (2, 128, 2, 64, 64, False)),
            ("ragged", (2, 96, 2, 64, 64, False)),
            ("p_split_ragged_k72_p80", (1, 100, 2, 72, 80, False)),
            ("xlstm_geometry_k512", (1, 130, 1, 512, 512, False)),
            ("model_gate_range", (1, 100, 2, 32, 32, True)),
            ("smoke_k32", (2, 45, 4, 32, 32, False))):
        a, i = gates(B, T, H, wide)
        add("mlstm_chunked", name, q=nrm((B, T, H, K), 1.0),
            k=nrm((B, T, H, K), 0.3), v=nrm((B, T, H, P), 1.0), a=a, i=i)

    for name, (B, T, S, H, Hk, dh, causal, window) in (
            ("t1000_gqa6_dh128", (1, 1000, 1000, 6, 1, 128, True, None)),
            ("t1000_gqa6_dh160", (1, 1000, 1000, 6, 1, 160, True, None)),
            ("window200_gqa6_dh64", (1, 1000, 1000, 6, 1, 64, True, 200)),
            ("t_above_s_gqa6_dh128", (1, 300, 200, 6, 1, 128, True, None))):
        add("flash_attention", name, dict(causal=causal, window=window),
            q=nrm((B, T, H, dh), 0.5), k=nrm((B, S, Hk, dh), 0.5),
            v=nrm((B, S, Hk, dh), 0.5))

    for name, (B, T, H, P, N, a_lo) in (
            ("state_pass_17_chunks", (2, 2100, 3, 64, 64, 0.9)),
            ("zamba2_heads_h80", (1, 300, 80, 64, 64, 0.6)),
            ("long_memory_n128", (1, 1000, 2, 64, 128, 0.99)),
            ("ragged_p48_n32", (3, 333, 5, 48, 32, 0.8))):
        add("mamba2_scan", name, xh=nrm((B, T, H, P), 0.5),
            a=rng.uniform(a_lo, 1.0, (B, T, H)).astype(np.float32),
            b=nrm((B, T, N), 0.3), c=nrm((B, T, N), 0.3))

    for name, (B, T, H, P, N, a_lo) in (
            ("sub_heads_p128_n128", (1, 300, 2, 128, 128, 0.8)),
            ("sub_heads_p96_n64", (2, 200, 3, 96, 64, 0.7)),
            ("sub_heads_p80_n32", (1, 250, 2, 80, 32, 0.9))):
        add("mamba2_scan", name, xh=nrm((B, T, H, P), 0.5),
            a=rng.uniform(a_lo, 1.0, (B, T, H)).astype(np.float32),
            b=nrm((B, T, N), 0.3), c=nrm((B, T, N), 0.3))

    for name, (B, T, H, K, P, wide) in (
            ("chain_33_chunks", (2, 2100, 2, 64, 64, False)),
            ("xlstm_gate_range_k512_h4", (1, 200, 4, 512, 512, True)),
            ("ragged_k37_p45", (2, 157, 3, 37, 45, False)),
            ("batch3_h4", (3, 300, 4, 64, 96, True))):
        a, i = gates(B, T, H, wide)
        add("mlstm_chunked", name, q=nrm((B, T, H, K), 1.0),
            k=nrm((B, T, H, K), 0.3), v=nrm((B, T, H, P), 1.0), a=a, i=i)
    return out


#: flash attention's head widths past its kernels' own (off 8, past 256)
PAST_TILE_DH = (12, 100, 264, 320, 512)


def width_cases(seed: int = 37) -> List[Case]:
    """The widths past the model kernels' tiles that the JAX kernels take,
    as :func:`model_cases` draws them (both dtypes each):

    * Mamba2 scan: a state past ``MAX_N`` (N = 256 and 144: two slices),
      P below 16 and off 16 (8, 24, padded), P = 72 (padded to 80, then
      five sub-heads), and N = 256 at Zamba2's P = 64 and 8 heads over five
      chunks;
    * mLSTM: K past ``MAX_K`` (1,025, 2,048 and 4,096: two to four slices)
      at P = 64 (gates in (0.7, 1)) and 512 (the model's gate range);
    * flash attention (the 3xTF32 f32 arm): dh 64, 128, 160 and 256, each
      causal, with a window of 48, non-causal and with T < S (GQA 2:1);
      and the widths past the kernels' own, both arms: dh 12 and 100
      (zero-padded to 16 and 104), 264, 320 and 512 (the f32 kernel's
      output in slices of 256; bf16 on operands upcast to f32).
    """
    rng = np.random.default_rng(seed)
    out: List[Case] = []

    def nrm(shape, sd):
        return rng.normal(0, sd, shape).astype(np.float32)

    def add(kernel, name, static=None, **arrays):
        for dtype in ("float32", "bfloat16"):
            out.append(dict(kernel=kernel, dtype=dtype, static=static or {},
                            name=f"{name}_{'f32' if dtype == 'float32' else 'bf16'}",
                            **arrays))

    for name, (B, T, H, P, N, a_lo) in (
            ("wide_p64_n256", (1, 300, 2, 64, 256, 0.8)),
            ("off16_p24_n144", (2, 200, 3, 24, 144, 0.7)),
            ("narrow_p8_n64", (1, 150, 2, 8, 64, 0.9)),
            ("padded_p72_n128", (1, 260, 2, 72, 128, 0.8)),
            ("zamba2_p64_n256_h8", (1, 600, 8, 64, 256, 0.6))):
        add("mamba2_scan", name, xh=nrm((B, T, H, P), 0.5),
            a=rng.uniform(a_lo, 1.0, (B, T, H)).astype(np.float32),
            b=nrm((B, T, N), 0.3), c=nrm((B, T, N), 0.3))

    for K in (1025, 2048, 4096):
        for P, H, wide in ((64, 2, False), (512, 1, True)):
            B, T = 1, 150
            if wide:
                a = 1.0 / (1.0 + np.exp(-rng.normal(0, 2.0, (B, T, H))))
                i = np.exp(rng.uniform(-10.0, 10.0, (B, T, H)))
            else:
                a = rng.uniform(0.7, 1.0, (B, T, H))
                i = rng.uniform(0.1, 1.0, (B, T, H))
            add("mlstm_chunked", f"k{K}_p{P}", q=nrm((B, T, H, K), 1.0),
                k=nrm((B, T, H, K), 0.3), v=nrm((B, T, H, P), 1.0),
                a=a.astype(np.float32), i=i.astype(np.float32))

    for dh in (64, 128, 160, 256, *PAST_TILE_DH):
        for mode, (T, S, causal, window) in (
                ("causal", (200, 200, True, None)),
                ("window48", (200, 200, True, 48)),
                ("full", (150, 150, False, None)),
                ("t_below_s", (90, 200, True, None))):
            B, H, Hk = 1, 4, 2
            add("flash_attention", f"dh{dh}_{mode}",
                dict(causal=causal, window=window),
                q=nrm((B, T, H, dh), 0.5), k=nrm((B, S, Hk, dh), 0.5),
                v=nrm((B, S, Hk, dh), 0.5))
    return out


#: atol = rtol of a model-stack kernel against its plain version, by dtype:
#: the JAX package's bars (tests/test_kernels.py: 3e-5 for flash attention,
#: 2e-3 for the scans in f32; 3e-2 for flash attention in bf16, kept for the
#: scans, whose inputs and outputs round to bf16 on both sides)
MODEL_TOL = {
    "flash_attention": {"float32": 3e-5, "bfloat16": 3e-2},
    "mamba2_scan": {"float32": 2e-3, "bfloat16": 3e-2},
    "mlstm_chunked": {"float32": 2e-3, "bfloat16": 3e-2},
}
#: inputs that stay f32 whatever the case's dtype (the decay and the gates)
F32_FIELDS = ("a", "i")


def model_tensors(case: Case, device) -> list:
    """A model-stack case's tensor arguments on ``device``: the decay and
    the gates in f32, everything else in the case's dtype."""
    import torch
    dtype = getattr(torch, case["dtype"])
    return [torch.from_numpy(np.ascontiguousarray(case[f]))
            .to(torch.float32 if f in F32_FIELDS else dtype).to(device)
            for f in TENSOR_FIELDS[case["kernel"]]]


TENSOR_FIELDS = {
    "batched_evict": ("key", "sizes", "evictable", "need_free"),
    "fifo_grant": ("key", "sizes", "budget", "pops"),
    "wake_solve": ("key", "sizes", "credit0", "inc", "pops"),
    "paged_attention": ("q", "k_pages", "v_pages", "page_table", "seq_lens"),
    "flash_attention": ("q", "k", "v"),
    "mamba2_scan": ("xh", "a", "b", "c"),
    "mlstm_chunked": ("q", "k", "v", "a", "i"),
}
CASES = {
    "batched_evict": evict_cases,
    "fifo_grant": grant_cases,
    "wake_solve": wake_cases,
}


def split_cases(seed: int = 20) -> Dict[str, List[Case]]:
    """Cases of the page-split path, per kernel.  At P = 8,832 (one block
    a lane) with vmax = 2,048: B1 and B2 split into shards take the
    whole-row kernels, held to the single-stage kernel (``"shards"``).
    At P = 20,000 (beyond one block): every path of B1-B3 beyond one
    block, held to the plain version: the head from the shards'
    candidates, and B3's whole-row lanes (a head longer than HEAD_CAP,
    ``inc`` below 0 and NaN, a wanted size below 0 and one infinite)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, List[Case]] = {k: [] for k in CASES}
    for P, vmax, grant_vmax, shards in ((8832, 2048, 2048, True),
                                         (20_000, 64, 16, False)):
        L = 4
        fkey = rng.choice(np.array([-0.0, 0.0, 0.5, -1.5, 2.0], np.float32),
                          (L, P))
        fkey[1] = rng.normal(0.0, 1.0, P).astype(np.float32)
        ikey = rng.integers(2**24 - 2, 2**24 + 2, (L, P)).astype(np.int32)
        for name, key in (("f32", fkey), ("i32", ikey)):
            out["batched_evict"].append({
                "name": f"split_P{P}_{name}", "key": key,
                "sizes": rng.integers(0, 9, P).astype(np.float32),
                "evictable": rng.random((L, P)) < 0.7,
                "need_free": np.array([1e3, 0.0, 5e3, 1e9], np.float32),
                "static": {"vmax": vmax}, "shards": shards})
        out["fifo_grant"].append({
            "name": f"split_P{P}", "key": queue_keys(rng, [0.5, 0.2, 0.9, 0.6],
                                                     P).astype(np.int32),
            "sizes": _sizes(rng, L, P),
            "budget": np.array([1e9, 50.0, 1e9, 4e3], np.float32),
            "pops": np.array([5000, 100, 0, 3000], np.int32),
            "static": {"vmax": grant_vmax},
            "shards": shards})
    P = 20_000
    key = queue_keys(rng, [0.3, 0.0, 0.6, 0.4, 0.4, 0.4], P).astype(np.int32)
    sizes = _sizes(rng, 6, P)
    sizes[4, np.flatnonzero(key[4] >= 0)[3]] = -2.0
    sizes[5, np.flatnonzero(key[5] >= 0)[7]] = np.inf
    out["wake_solve"].append({
        "name": "split_P20000", "key": key, "sizes": sizes,
        "credit0": np.array([30.0, 0.0, 100.0, 10.0, 10.0, 10.0], np.float32),
        "inc": np.array([20.0, 5.0, 400.0, -1.0, np.nan, 9.0], np.float32),
        "pops": np.array([6, 3, 40, 5, 5, 5], np.int32),
        "static": {"h_cap": 64}, "shards": False,
        "path": ["split_select", "idle", "split_full", "split_full",
                 "split_full", "split_full"]})
    return out
