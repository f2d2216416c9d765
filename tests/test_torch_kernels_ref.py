"""Plain PyTorch versions of the three buffer-pool kernels against the
JAX package: the oracles of ``repro.kernels.ref`` and the Pallas bodies
in interpret mode, on the same numpy inputs.

Masks and integer outputs must be EQUAL; ``granted_bytes`` too (sizes are
whole numbers in 1..8, so f32 and f64 prefixes are both exact).  The port
runs on CPU tensors, where the dispatch in ``repro_torch.kernels.ops``
takes the plain version; the CUDA kernels are held to the same cases on
the card by ``chip_smoke.py``.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.pbm_timeline import (  # noqa: E402
    batched_evict_kernel,
    fifo_grant_kernel,
    wake_solve_kernel,
)
from repro_torch.kernels import cases, ops  # noqa: E402

# an evictable key AT the value that masks non-evictable pages: the oracle
# masks with -inf / the integer minimum, the Pallas body with finite
# sentinels (-1e30, -2^31 + 1), so the two JAX functions differ there and
# the port follows the oracle
EVICT_AT_MASK = [c for c in cases.evict_cases()
                 if c["name"].endswith("_at_mask_value")]
EVICT = [c for c in cases.evict_cases()
         if not c["name"].endswith("_at_mask_value")]
GRANT = cases.grant_cases()
WAKE = cases.wake_cases()


def _torch_args(case, fields):
    return [torch.from_numpy(np.ascontiguousarray(case[f])) for f in fields]


def _lanes(case):
    return range(case["key"].shape[0])


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@functools.lru_cache(maxsize=None)
def _jitted(fn, static_items):
    # one compilation per (function, static arguments, page count): cases
    # that differ in their lane count only share it
    return jax.jit(functools.partial(fn, **dict(static_items)))


def _jax_per_lane(fn, case, fields, **static):
    """Run a per-lane JAX function on every lane; stack each output."""
    jfn = _jitted(fn, tuple(sorted(static.items())))
    outs = []
    for i in _lanes(case):
        args = [jnp.asarray(case[f][i]) for f in fields]
        outs.append([np.asarray(o) for o in _as_tuple(jfn(*args))])
    return [np.stack(col) for col in zip(*outs)]


def _check(got, want_ref, want_kernel):
    for g, r, k in zip(_as_tuple(got), want_ref, want_kernel):
        g = g.numpy()
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, k)


@pytest.mark.parametrize("case", EVICT, ids=[c["name"] for c in EVICT])
def test_batched_evict_equals_jax_oracle_and_interpret_kernel(case):
    fields = cases.TENSOR_FIELDS["batched_evict"]
    got = ops.batched_evict(*_torch_args(case, fields), **case["static"])
    assert got.dtype == torch.bool
    _check(got,
           _jax_per_lane(jref.batched_evict_ref, case, fields,
                         **case["static"]),
           _jax_per_lane(batched_evict_kernel, case, fields,
                         interpret=True, **case["static"]))


@pytest.mark.parametrize("case", EVICT_AT_MASK,
                         ids=[c["name"] for c in EVICT_AT_MASK])
def test_batched_evict_key_at_the_mask_value_follows_the_oracle(case):
    """Such a page ties with the non-evictable ones by page index, so it
    can fall outside the top ``vmax``: fewer pages are taken than are
    evictable although ``need_free`` is never reached."""
    fields = cases.TENSOR_FIELDS["batched_evict"]
    key, sizes, evictable, need = _torch_args(case, fields)
    got = ops.batched_evict(key, sizes, evictable, need, **case["static"])
    want, = _jax_per_lane(jref.batched_evict_ref, case, fields,
                          **case["static"])
    np.testing.assert_array_equal(got.numpy(), want)
    vmax = case["static"]["vmax"]
    assert bool((got.sum(1) < torch.clamp(evictable.sum(1), max=vmax)).all())


def test_batched_evict_i32_pair_beyond_2pow24_evicts_index_1():
    case = next(c for c in EVICT if c["name"] == "i32_2pow24_pair")
    got = ops.batched_evict(
        *_torch_args(case, cases.TENSOR_FIELDS["batched_evict"]), vmax=4)
    assert got.tolist() == [[False, True, False, False]]


@pytest.mark.parametrize("case", GRANT, ids=[c["name"] for c in GRANT])
def test_fifo_grant_equals_jax_oracle_and_interpret_kernel(case):
    fields = cases.TENSOR_FIELDS["fifo_grant"]
    mask, nbytes, n = ops.fifo_grant(*_torch_args(case, fields),
                                     **case["static"])
    assert (mask.dtype, nbytes.dtype, n.dtype) == (
        torch.bool, torch.float32, torch.int32)
    _check((mask, nbytes, n),
           _jax_per_lane(jref.fifo_grant_ref, case, fields,
                         **case["static"]),
           _jax_per_lane(fifo_grant_kernel, case, fields,
                         interpret=True, **case["static"]))


@pytest.mark.parametrize("case", WAKE, ids=[c["name"] for c in WAKE])
def test_wake_solve_equals_jax_oracle_and_interpret_kernel(case):
    fields = cases.TENSOR_FIELDS["wake_solve"]
    got = ops.wake_solve(*_torch_args(case, fields), **case["static"])
    assert got.dtype == torch.int32
    h_cap = case["static"]["h_cap"]
    assert int(got.min()) >= 1 and int(got.max()) <= h_cap + 1
    _check(got,
           _jax_per_lane(jref.wake_solve_ref, case, fields,
                         **case["static"]),
           _jax_per_lane(wake_solve_kernel, case, fields,
                         interpret=True, **case["static"]))


def test_wake_solve_all_blocked_is_all_sentinel():
    case = next(c for c in WAKE if c["name"] == "all_blocked_sentinel")
    got = ops.wake_solve(
        *_torch_args(case, cases.TENSOR_FIELDS["wake_solve"]), h_cap=16)
    assert bool((got == 17).all())


def test_shared_size_row_equals_per_lane_sizes():
    """``sizes`` may be one ``(P,)`` row shared by every lane (the
    simulator's page sizes are)."""
    case = dict(GRANT[3])
    L = case["key"].shape[0]
    row = case["sizes"][0]
    key, _, budget, pops = _torch_args(
        case, cases.TENSOR_FIELDS["fifo_grant"])
    shared = ops.fifo_grant(key, torch.from_numpy(row), budget, pops,
                            **case["static"])
    tiled = ops.fifo_grant(key, torch.from_numpy(np.tile(row, (L, 1))),
                           budget, pops, **case["static"])
    for a, b in zip(shared, tiled):
        assert torch.equal(a, b)


def test_cuda_tensor_never_takes_the_plain_version():
    """Dispatch is on the tensor's device alone: a tensor that is not on
    the CPU goes to the kernel wrapper, which launches or raises.  A
    ``meta`` tensor stands in for a CUDA one where there is no card: the
    wrapper refuses it instead of computing on the CPU."""
    key = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    sizes = torch.ones(8, device="meta")
    vec = torch.ones(2, device="meta")
    with pytest.raises((RuntimeError, ValueError, OSError)):
        ops.fifo_grant(key, sizes, vec, vec.to(torch.int32), vmax=4)
