"""Lock-step parity of ONE macro-step: the JAX horizon runner's own steps
are driven for n macro-steps per lane on a tiny workload, the carry
``(state, view, window, adv_lim, pend, rem, next_h)`` is carried across
with ``carry_from_numpy``, one step of the port is applied (cheap and
refresh flavours; LRU / PBM / OPT lanes in one batch; ``wake_exact`` on
and off) and every leaf of the new carry is compared with the JAX step's:
bool and integer leaves EQUAL, f32 leaves within 1e-5 relative (single
f32 operations agree; ``pow``, ``log2`` and sums over columns may differ
in the last place).  Lanes the step's mask leaves out must come back bit
for bit.
"""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import array_sim as J  # noqa: E402
from repro.core.workload import (  # noqa: E402
    make_lineitem_db, micro_accessed_bytes, micro_streams)
from repro_torch.core import array_sim as T  # noqa: E402

SCALE = 0.03
POLICIES = ("lru", "pbm", "opt")
LANES = [(p, f) for p in POLICIES for f in (0.15, 0.5)]
SNAPSHOTS = (2, 25, 90)
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _workload():
    db = make_lineitem_db(scale_tuples=int(180_000_000 * SCALE))
    streams = micro_streams(db, n_streams=3, queries_per_stream=3, seed=3)
    return J.compile_workload(db, streams), micro_accessed_bytes(db)


@functools.lru_cache(maxsize=None)
def _jax_steps(wake_exact: bool):
    spec, _ = _workload()
    dt = float(np.max(spec.page_size)) / 700e6
    kw = dict(policies=POLICIES, stepper="horizon", wake_exact=wake_exact)
    cheap = J.make_step(spec, dt, 0.1 * SCALE, refresh=False, **kw)
    full = J.make_step(spec, dt, 0.1 * SCALE, refresh=True, **kw)
    n_inner = max(1, int(round(0.1 * SCALE / dt)))
    return cheap, full, jax.jit(cheap), jax.jit(full), n_inner, dt


def _jax_init(cheap, n_inner, spec):
    state = J.init_state(spec, cheap.policies)
    view0 = cheap.query_view(state.qidx, state.pos)
    win0 = cheap.window(view0)
    return (state, view0, win0, cheap.adv_limit(win0, state.resident),
            jnp.float32(0.0), jnp.int32(n_inner), jnp.int32(1))


def _inner_cond(carry):
    return bool((carry[5] > 1) & (carry[6] < carry[5]))


@functools.lru_cache(maxsize=None)
def _snapshots(wake_exact: bool):
    """Per lane, the JAX carry after n macro-steps of the runner's own
    loop nest, for n in SNAPSHOTS, with both flavours applied to it."""
    spec, ws = _workload()
    cheap, _full, jcheap, jfull, n_inner, _dt = _jax_steps(wake_exact)
    out = []
    for pol, frac in LANES:
        cfg = J.make_config(spec, int(frac * ws), 700e6, pol)
        carry = _jax_init(cheap, n_inner, spec)
        snaps = {}
        for n in range(max(SNAPSHOTS) + 1):
            if n in SNAPSHOTS:
                snaps[n] = (carry, _inner_cond(carry),
                            jcheap(carry, cfg), jfull(carry, cfg))
            carry = (jcheap if _inner_cond(carry) else jfull)(carry, cfg)
        out.append(snaps)
    return out


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _stack(carries):
    return jax.tree.map(lambda *xs: np.stack(xs), *[_np_tree(c) for c in carries])


def _torch_steps(wake_exact: bool):
    spec, ws = _workload()
    run = T.make_runner(spec, time_slice=0.1 * SCALE, policies=POLICIES,
                        wake_exact=wake_exact, device="cpu")
    cfgs = T.stack_configs([
        T.make_config(spec, int(f * ws), 700e6, p, device="cpu")
        for p, f in LANES])
    return run, cfgs


def _leaves(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def _assert_carry_matches(got, want, lanes, what):
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys()
    for name, w in want_l.items():
        g = got_l[name][lanes]
        w = w[lanes]
        assert g.shape == w.shape, (what, name)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("n", SNAPSHOTS)
@pytest.mark.parametrize("wake_exact", [True, False],
                         ids=["wake_exact", "never_jump"])
def test_one_port_step_matches_the_jax_step_on_every_leaf(wake_exact, n):
    snaps = _snapshots(wake_exact)
    run, cfgs = _torch_steps(wake_exact)
    before = _stack([s[n][0] for s in snaps])
    inner = np.array([s[n][1] for s in snaps])
    carry = T.carry_from_numpy(before, device="cpu")
    lane_ids = np.arange(len(LANES))
    for flavour, step, pick, k in (
            ("cheap", run.cheap, inner, 2), ("refresh", run.full, ~inner, 3)):
        if not pick.any():
            continue
        want = _stack([s[n][k] for s in snaps])
        got = T.carry_to_numpy(step(carry, cfgs, torch.from_numpy(pick)))
        _assert_carry_matches(got, want, lane_ids[pick], f"{flavour}@{n}")
        # lanes outside the mask are frozen bit for bit
        if (~pick).any():
            for (name, g), (_, b) in zip(_leaves(got), _leaves(before)):
                np.testing.assert_array_equal(
                    g[~pick], b[~pick], err_msg=f"frozen {flavour} {name}")


def test_both_flavours_were_exercised():
    inner = [s[n][1] for s in _snapshots(True) for n in SNAPSHOTS]
    assert any(inner) and not all(inner)


def test_carry_round_trips_through_the_port_unchanged():
    snaps = _snapshots(True)
    before = _stack([s[SNAPSHOTS[-1]][0] for s in snaps])
    back = T.carry_to_numpy(T.carry_from_numpy(before, device="cpu"))
    for (name, g), (_, b) in zip(_leaves(back), _leaves(before)):
        assert g.dtype == b.dtype, name
        np.testing.assert_array_equal(g, b, err_msg=name)
    # a single lane without a lane axis gains one on the way in
    one = T.carry_from_numpy(_np_tree(snaps[2][SNAPSHOTS[1]][0]), device="cpu")
    assert one[0].resident.shape[0] == 1 and one[5].shape == (1,)
    solo = T.carry_to_numpy(one, drop_lane=True)
    for (name, g), (_, b) in zip(
            _leaves(solo), _leaves(_np_tree(snaps[2][SNAPSHOTS[1]][0]))):
        np.testing.assert_array_equal(g, b, err_msg=name)


def test_policy_private_state_is_carried_across():
    """PBM's bucket array and OPT's cached key arrive in the port's state
    and a step advances them like the JAX step does (checked leaf by leaf
    above); here: they are not trivially empty at the snapshot."""
    snaps = _snapshots(True)
    before = _stack([s[SNAPSHOTS[-1]][0] for s in snaps])
    state = T.carry_from_numpy(before, device="cpu")[0]
    lru, pbm, opt = state.pstate
    assert lru == ()
    assert pbm.dtype == torch.int32 and int((pbm < 40).sum()) > 0
    assert opt.dtype == torch.float32 and float(opt.max()) > 0.0
