"""The exactness argument of the CUDA eviction kernel's head path.

``batched_evict`` in ``csrc/pbm_timeline.cu`` selects the first m =
min(vmax, P) pages of a lane's service order and sorts only those.  Every
page takes part (a page that is not evictable sorts at the key type's
minimum), so the key field spans all 32 bits.  Checked here on the plain
versions and on numpy models of the kernel's integer keys, with seeded
inputs (L <= 5, P up to 600, heavy ties, whole sizes in 0..8):

(a) ``batched_evict_ref``'s mask is unchanged when every page outside the
    first min(vmax, P) of the masked service order is made non-evictable;
(b) the 32-bit key field (f32 with negatives, -0.0 / +0.0, +-inf and NaN;
    i32 with INT_MIN and [2^24, 2^24 + 1]), sorted by (field, index), gives
    ``ref._service_order``'s order of the masked keys, fields >= 2^31
    included; and the radix select of the kernel (8-bit digits from the
    top, ties at the picked prefix ranked by index) picks exactly the first
    m of that order;
(c) the host's ``lane_paths("batched_evict", ...)`` names each fuzz lane's
    path (select / every page / whole row), and a lane that takes every
    page holds fields >= 2^31, which the queue kernels' whole-queue
    shortcut (fields below 2^31 only) would drop.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import cases, ref
from repro_torch.kernels.pbm_timeline import HEAD_CAP, PATHS, lane_paths

SEEDS = range(12)


def _lanes(rng, int_keys):
    """(key, sizes, evictable, need): L in 1..5, P of 129 / 300 / 600,
    keys drawn from 3, 50 or 2^30 values (heavy ties to almost none),
    negative ones included, about 70 % evictable."""
    L = int(rng.integers(1, 6))
    P = int(rng.choice([129, 300, 600]))
    n_keys = int(rng.choice([3, 50, 2**30]))
    key = rng.integers(-n_keys, n_keys, (L, P))
    key = key.astype(np.int32) if int_keys else (key / 7.0).astype(np.float32)
    evictable = rng.random((L, P)) < 0.7
    sizes = rng.integers(0, 9, (L, P)).astype(np.float32)
    need = rng.choice([0.0, 30.0, 400.0, 1e9], L).astype(np.float32)
    return (torch.from_numpy(key), torch.from_numpy(sizes),
            torch.from_numpy(evictable), torch.from_numpy(need))


def _masked(key, evictable):
    low = float("-inf") if key.dtype.is_floating_point \
        else torch.iinfo(key.dtype).min
    return torch.where(evictable, key, torch.full_like(key, low))


@pytest.mark.parametrize("int_keys", [False, True], ids=["f32", "i32"])
@pytest.mark.parametrize("seed", SEEDS)
def test_evict_reads_only_the_first_min_vmax_p_positions(seed, int_keys):
    rng = np.random.default_rng(400 + seed)
    key, sizes, evictable, need = _lanes(rng, int_keys)
    L, P = key.shape
    vmax = int(rng.integers(1, P // 2))
    order = ref._service_order(_masked(key, evictable))[1]
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(P).expand(L, P).contiguous())
    past = evictable & (rank >= vmax)
    assert bool(past.any())                     # not a vacuous check
    want = ref.batched_evict_ref(key, sizes, evictable, need, vmax=vmax)
    got = ref.batched_evict_ref(key, sizes, evictable & ~past, need,
                                vmax=vmax)
    assert torch.equal(got, want)


def _field(key: np.ndarray) -> np.ndarray:
    """The kernel's key field of a (masked) key: ~ord(key), ord the
    order-preserving map of the key's bits to an unsigned integer (an i32
    with its sign bit flipped; an f32 with -0.0 read as +0.0 first, then
    every bit flipped if negative, else the sign bit set)."""
    if key.dtype == np.int32:
        u = key.view(np.uint32) ^ np.uint32(0x80000000)
    else:
        b = (key + np.float32(0.0)).view(np.uint32)      # -0.0 -> +0.0
        neg = (b & np.uint32(0x80000000)) != 0
        u = np.where(neg, ~b, b | np.uint32(0x80000000))
    return ~u.astype(np.uint32)


def _field_order(field: np.ndarray) -> np.ndarray:
    """Ascending (field, index) per lane: the sort words' order."""
    return np.stack([np.lexsort((np.arange(f.size), f)) for f in field])


F32_SPECIALS = np.array([-0.0, 0.0, np.inf, -np.inf, np.nan, -1.5, 1.5,
                         -3e38, 3e38, -1e-45, 1e-45], np.float32)
I32_SPECIALS = np.array([-2**31, 2**31 - 1, 2**24, 2**24 + 1, -2**24,
                         -2**24 - 1, 0, -1, 1], np.int32)


@pytest.mark.parametrize("int_keys", [False, True], ids=["f32", "i32"])
@pytest.mark.parametrize("seed", range(6))
def test_key_field_order_is_the_service_order(seed, int_keys):
    rng = np.random.default_rng(500 + seed)
    L, P = 4, 257
    if int_keys:
        key = np.where(rng.random((L, P)) < 0.5,
                       rng.choice(I32_SPECIALS, (L, P)),
                       rng.integers(-2**31, 2**31 - 1, (L, P))).astype(np.int32)
    else:
        key = np.where(rng.random((L, P)) < 0.5,
                       rng.choice(F32_SPECIALS, (L, P)),
                       rng.normal(0.0, 100.0, (L, P))).astype(np.float32)
    evictable = rng.random((L, P)) < 0.6
    masked = _masked(torch.from_numpy(key), torch.from_numpy(evictable))
    field = _field(masked.numpy())
    assert bool((field >= 2**31).any()) and bool((field < 2**31).any())
    want = ref._service_order(masked)[1].numpy()
    np.testing.assert_array_equal(_field_order(field), want)


def test_integer_keys_past_2pow24_keep_their_order():
    """[2^24, 2^24 + 1] round to one float; their fields stay apart, so
    index 1 leads the service order as in the plain version."""
    field = _field(np.array([[2**24, 2**24 + 1, 0, 0]], np.int32))
    assert _field_order(field)[0].tolist() == [1, 0, 2, 3]
    got = ref.batched_evict_ref(
        torch.tensor([[2**24, 2**24 + 1, 0, 0]], dtype=torch.int32),
        torch.ones(4), torch.ones(1, 4, dtype=torch.bool),
        torch.tensor([1.0]), vmax=4)
    assert got.tolist() == [[False, True, False, False]]


def _radix_head(u: np.ndarray, m: int) -> set:
    """The pages ``select_head`` and ``compact_head`` pick from one lane's
    fields ``u`` (1 <= m < P): passes of 8 bits from the top, each a
    histogram of the pages whose higher digits equal the picked prefix,
    stopping when every page of the prefix is needed; then the pages below
    the prefix and the first ``need`` pages at it, in index order."""
    u = u.astype(np.uint64)
    prefix, need, shift = 0, m, 32
    for pas in range(4):
        shift = 24 - 8 * pas
        play = (u >> np.uint64(shift + 8)) == prefix
        hist = np.bincount(((u[play] >> np.uint64(shift)) & 255).astype(int),
                           minlength=256)
        below = np.concatenate([[0], np.cumsum(hist)])
        digit = int(np.searchsorted(below, need, side="left")) - 1
        need -= int(below[digit])
        prefix = (prefix << 8) | digit
        if need == hist[digit]:
            break
    hi = u >> np.uint64(shift)
    at = np.flatnonzero(hi == prefix)[:need]
    return set(np.flatnonzero(hi < prefix).tolist()) | set(at.tolist())


@pytest.mark.parametrize("int_keys", [False, True], ids=["f32", "i32"])
@pytest.mark.parametrize("seed", range(6))
def test_radix_select_takes_the_first_m_pages_exactly(seed, int_keys):
    rng = np.random.default_rng(600 + seed)
    key, _, evictable, _ = _lanes(rng, int_keys)
    field = _field(_masked(key, evictable).numpy())
    order = _field_order(field)
    P = field.shape[1]
    for lane in range(field.shape[0]):
        for m in sorted({1, 7, int(rng.integers(1, P)), P - 1}):
            assert _radix_head(field[lane], m) == set(order[lane, :m].tolist())


EVICT_HEAD = [c for c in cases.evict_cases() if "path" in c]


@pytest.mark.parametrize("case", EVICT_HEAD, ids=[c["name"] for c in EVICT_HEAD])
def test_fuzz_case_takes_the_path_it_names(case):
    args = [torch.from_numpy(np.ascontiguousarray(case[f]))
            for f in cases.TENSOR_FIELDS["batched_evict"]]
    assert lane_paths("batched_evict", args, case["static"]) == \
        list(case["path"])


def test_the_eviction_cases_run_every_path():
    assert cases.HEAD_CAP == HEAD_CAP
    paths = {p for case in EVICT_HEAD for p in case["path"]}
    assert paths == set(PATHS["batched_evict"])


def test_every_page_lanes_hold_fields_the_queue_shortcut_would_drop():
    """On a lane with vmax >= P the head is every page.  The queue kernels'
    shortcut for m >= n_part takes the fields below 2^31 only (their other
    fields mean "not wanted"); here pages with negative keys or not
    evictable lie at or above it, and they are candidates all the same."""
    case = next(c for c in EVICT_HEAD if c["name"] == "head_is_every_page")
    key, _, evictable, need = (torch.from_numpy(case[f]) for f in
                               cases.TENSOR_FIELDS["batched_evict"])
    field = _field(_masked(key, evictable).numpy())
    busy = (need > 0).numpy()
    assert bool((field[busy] >= 2**31).all())
    got = ref.batched_evict_ref(*(torch.from_numpy(case[f]) for f in
                                  cases.TENSOR_FIELDS["batched_evict"]),
                                **case["static"])
    assert bool(got[torch.from_numpy(busy)].any())
