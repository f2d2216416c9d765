"""Numeric cores of the port's array policies against the JAX package,
on the same numpy inputs: ``time_to_bucket``, ``next_consumption``,
``target_buckets``, ``shift_timeline`` and the two wrap-around hashes
(``_u01``, PBM's tie hash).

Integer outputs must be EQUAL.  f32 outputs are held to 1e-6 relative:
``log2`` and division may differ by one ulp between the two libraries
(the hashes involve neither and must be equal bit for bit).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.array_sim import policies as jpol  # noqa: E402
from repro.core.array_sim import sim as jsim  # noqa: E402
from repro_torch.core.array_sim import policies as tpol  # noqa: E402
from repro_torch.core.array_sim import sim as tsim  # noqa: E402

RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("time_slice", [0.1, 0.0025, 1.0])
def test_time_to_bucket_equals_jax(time_slice):
    rng = np.random.default_rng(0)
    eta = np.concatenate([
        rng.random(400) * 50.0 * time_slice, rng.random(200) * 5000.0,
        [0.0, -1.0, time_slice, 4 * time_slice],
    ]).astype(np.float32)
    want = np.asarray(jpol.time_to_bucket(jnp.asarray(eta), time_slice, 10, 4))
    got = tpol.time_to_bucket(_t(eta)[None], time_slice, 10, 4)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_time_to_bucket_far_future_is_the_last_bucket():
    """``eta = inf`` (and anything beyond the integer range of the slice
    offset) maps to the last bucket, as both docstrings say.  The JAX
    function wraps around to bucket 0 there (its offset saturates at
    INT_MAX and ``g*m + idx`` overflows); the simulator never asks, since
    ``target_buckets`` masks unrequested pages first."""
    eta = torch.tensor([[1e30, float("inf"), 3e9]])
    assert tpol.time_to_bucket(eta, 0.1, 10, 4).tolist() == [[39, 39, 39]]


def _scan_case(rng, L, S, P, C):
    first = np.sort(rng.integers(0, 10_000, P)).astype(np.float32)
    return dict(
        page_first=first,
        page_last=first + rng.integers(1, 300, P).astype(np.float32),
        page_col=rng.integers(0, C, P).astype(np.int32),
        cols=rng.random((L, S, C)) < 0.6,
        cur=rng.integers(0, 9_000, (L, S)).astype(np.float32),
        end=rng.integers(5_000, 12_000, (L, S)).astype(np.float32),
        speed=(rng.random((L, S)) * 1e4 + 1.0).astype(np.float32),
        active=rng.random((L, S)) < 0.8,
        start=rng.integers(0, 5_000, (L, S)).astype(np.float32),
        eps=(1.0 + rng.random((L, S))).astype(np.float32),
    )


@pytest.mark.parametrize("with_start", [True, False])
def test_next_consumption_equals_jax_per_lane(with_start):
    rng = np.random.default_rng(1)
    L, S, P, C = 3, 4, 300, 5
    c = _scan_case(rng, L, S, P, C)
    kw = dict(scan_start=_t(c["start"]), eps=_t(c["eps"])) if with_start else {}
    got = tpol.next_consumption(
        _t(c["page_first"]), _t(c["page_last"]), _t(c["page_col"]).long(),
        _t(c["cols"]), _t(c["cur"]), _t(c["end"]), _t(c["speed"]),
        _t(c["active"]), **kw).numpy()
    for i in range(L):
        jkw = dict(scan_start=jnp.asarray(c["start"][i]),
                   eps=jnp.asarray(c["eps"][i])) if with_start else {}
        want = np.asarray(jpol.next_consumption(
            jnp.asarray(c["page_first"]), jnp.asarray(c["page_last"]),
            jnp.asarray(c["page_col"]), jnp.asarray(c["cols"][i]),
            jnp.asarray(c["cur"][i]), jnp.asarray(c["end"][i]),
            jnp.asarray(c["speed"][i]), jnp.asarray(c["active"][i]), **jkw))
        np.testing.assert_allclose(got[i], want, rtol=RTOL)
        # which pages nobody wants is a decision, not a rounding
        np.testing.assert_array_equal(got[i] >= 1e29, want >= 1e29)


def test_next_consumption_per_lane_page_subset_equals_full():
    """The within-slice update set hands ``(L, U)`` page ids: the result
    must be the full-array result gathered at those ids."""
    rng = np.random.default_rng(2)
    L, S, P, C = 3, 4, 200, 5
    c = _scan_case(rng, L, S, P, C)
    args = (_t(c["cols"]), _t(c["cur"]), _t(c["end"]), _t(c["speed"]),
            _t(c["active"]))
    kw = dict(scan_start=_t(c["start"]), eps=_t(c["eps"]))
    pf, pl, pc = _t(c["page_first"]), _t(c["page_last"]), _t(c["page_col"]).long()
    full = tpol.next_consumption(pf, pl, pc, *args, **kw)
    ids = _t(rng.integers(0, P, (L, 17)))
    sub = tpol.next_consumption(pf[ids], pl[ids], pc[ids], *args, **kw)
    assert torch.equal(sub, full.gather(1, ids))


def test_target_buckets_equals_jax():
    rng = np.random.default_rng(3)
    eta = (rng.random(500) * 30.0).astype(np.float32)
    eta[rng.random(500) < 0.3] = 1e30
    valid = rng.random(500) < 0.9
    want = np.asarray(jpol.target_buckets(
        jnp.asarray(eta), 0.1, 10, 4, jnp.asarray(valid)))
    got = tpol.target_buckets(_t(eta)[None], 0.1, 10, 4, _t(valid))[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4])
def test_shift_timeline_equals_jax(k):
    rng = np.random.default_rng(4 + k)
    nb, m, P = 40, 4, 400
    bucket = rng.integers(-1, nb + 1, P).astype(np.int32)
    target = rng.integers(0, nb + 1, P).astype(np.int32)
    for sd in (0, 7, 63):
        want = np.asarray(jpol.shift_timeline(
            jnp.asarray(bucket), jnp.asarray(target), jnp.int32(sd),
            jnp.int32(k), nb=nb, m=m))
        sdt = torch.tensor([sd], dtype=torch.int32)
        got_static = tpol.shift_timeline(
            _t(bucket)[None], _t(target)[None], sdt, k, nb=nb, m=m)
        got_lane = tpol.shift_timeline(
            _t(bucket)[None], _t(target)[None], sdt,
            torch.tensor([k], dtype=torch.int32), nb=nb, m=m, k_max=4)
        np.testing.assert_array_equal(got_static[0].numpy(), want)
        np.testing.assert_array_equal(got_lane[0].numpy(), want)


def test_shift_timeline_per_lane_counts():
    """Lanes shift by their own ``k`` inside one loop to the static
    maximum: each lane equals the JAX shift by that ``k``."""
    rng = np.random.default_rng(9)
    nb, m, P, ks = 40, 4, 256, [0, 3, 1, 4, 2]
    L = len(ks)
    bucket = rng.integers(-1, nb + 1, (L, P)).astype(np.int32)
    target = rng.integers(0, nb + 1, (L, P)).astype(np.int32)
    sd = rng.integers(0, 100, L).astype(np.int32)
    got = tpol.shift_timeline(
        _t(bucket), _t(target), _t(sd), torch.tensor(ks, dtype=torch.int32),
        nb=nb, m=m, k_max=4).numpy()
    for i, k in enumerate(ks):
        want = np.asarray(jpol.shift_timeline(
            jnp.asarray(bucket[i]), jnp.asarray(target[i]), jnp.int32(sd[i]),
            jnp.int32(k), nb=nb, m=m))
        np.testing.assert_array_equal(got[i], want)
    with pytest.raises(ValueError):
        tpol.shift_timeline(_t(bucket), _t(target), _t(sd),
                            torch.tensor(ks), nb=nb, m=m)


@pytest.mark.parametrize("t_mult,idx_mult", [
    (40503, 2654435761), (48271, 2654435761), (3266489917, 2654435761),
    (3266489917, 2246822519)])
def test_u01_hash_equals_jax_bit_for_bit(t_mult, idx_mult):
    rng = np.random.default_rng(5)
    idx = np.arange(3000, dtype=np.uint32)
    for t in (0, 1, 17, 65_535, 1_000_003, 2**31 - 1):
        want = np.asarray(jsim._u01(jnp.asarray(idx), jnp.int32(t), t_mult,
                                    idx_mult=idx_mult))
        got = tsim.u01(_t(idx.astype(np.int64)), torch.tensor(t), t_mult,
                       idx_mult=idx_mult).numpy()
        np.testing.assert_array_equal(got, want)
    # per-index salts (the per-(stream, query) draw)
    salt = rng.integers(0, 10_000, 3000).astype(np.int32)
    want = np.asarray(jsim._u01(jnp.asarray(idx), jnp.asarray(salt), t_mult,
                                idx_mult=idx_mult))
    got = tsim.u01(_t(idx.astype(np.int64)), _t(salt), t_mult,
                   idx_mult=idx_mult).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


def test_pbm_tie_hash_equals_jax_bit_for_bit():
    """The tie part of PBM's score: bucket 0 (requested) everywhere, so
    score = 0.5 * tie exactly (a power-of-two scale)."""
    P = 2048
    now = np.array([0.0, 0.000749, 1.5, 17.481945, 300000.0], np.float32)

    class Ctx:
        spec = type("S", (), {"nb": 40})()
        last_used = jnp.zeros(P, jnp.float32)

    for i, t in enumerate(now):
        Ctx.now = jnp.float32(t)
        want = np.asarray(jpol.ArrayPBM().score_victims(
            jnp.zeros(P, jnp.int32), Ctx)) * 2.0
        got = tpol.pbm_tie_hash(_t(now), P)[i].numpy()
        np.testing.assert_array_equal(got, want)
