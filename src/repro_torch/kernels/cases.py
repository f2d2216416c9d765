"""Fuzz inputs for the three buffer-pool kernels, made with numpy from a
seed.

One list of cases per kernel, shared by the CPU parity tests (plain
PyTorch version against the JAX package's oracle and interpret-mode
kernel) and by ``chip_smoke.py`` (CUDA kernel against the plain version
on the card), so both hold the same shapes: page counts that are not
multiples of anything (1, 8, 100, 128, 200, 256, 600), a lane axis of 1
and of 5 with different scalars per lane, a candidate window below the
victim count, zero budget / zero need, nothing eligible, nothing
grantable, heavy ties, integer keys around 2^24, queue keys near 2^30 and
evictable keys at the value that masks the non-evictable pages.

Sizes are whole numbers in 1..8, so every byte prefix is exact in f32 as
well as in f64 and any disagreement is a fault of the logic, not of
rounding.  Arrays are ``(L, P)`` / ``(L,)`` numpy; ``static`` holds the
keyword arguments that are Python ints.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

PAGE_COUNTS = (1, 8, 100, 128, 200, 256, 600)
LANES = (1, 5)

Case = Dict[str, object]


def _sizes(rng, L, P):
    return rng.integers(1, 9, (L, P)).astype(np.float32)


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
    return out


TENSOR_FIELDS = {
    "batched_evict": ("key", "sizes", "evictable", "need_free"),
    "fifo_grant": ("key", "sizes", "budget", "pops"),
    "wake_solve": ("key", "sizes", "credit0", "inc", "pops"),
}
CASES = {
    "batched_evict": evict_cases,
    "fifo_grant": grant_cases,
    "wake_solve": wake_cases,
}
