"""Lock-step parity of the four-policy step (LRU, PBM, OPT and
array-CScan lanes in one batch): the port's step applied to the JAX
package's own carry, for the first few hundred steps of a run of every
lane, under the fixed stepper (every step a fine ``dt``) and the horizon
stepper (both flavours on every lane; the run follows each lane's own):
bool and integer leaves EQUAL, f32 leaves within 1e-6 relative.  The
carry crosses between the packages through ``convert.py``
(``CoopState`` included).

The JAX step runs compiled with XLA's algebraic simplifier off, in a
process of its own (the flag is read when JAX starts): with it on, XLA
turns some divisions by a constant into a product with the reciprocal,
and a page whose estimated next use sits on a bucket boundary (0.009 s
at a 0.003 s slice, at the start of a run) falls into the next bucket —
a rounding of the compiler, not of the function, which the port (an
IEEE division) does not take.
"""

import functools
import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import array_sim as J  # noqa: E402
from repro.core.workload import (  # noqa: E402
    make_lineitem_db, micro_accessed_bytes, micro_streams)
from repro_torch.core import array_sim as T  # noqa: E402

SCALE = 0.03
POLICIES = ("lru", "pbm", "opt", "cscan")
LANES = [(p, f) for p in POLICIES for f in (0.2, 0.4)]
STEPPERS = ("fixed", "horizon")
LOCKSTEP = 300
RTOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _workload():
    db = make_lineitem_db(scale_tuples=int(180_000_000 * SCALE))
    streams = micro_streams(db, n_streams=3, queries_per_stream=3, seed=3)
    return J.compile_workload(db, streams), micro_accessed_bytes(db)


def _torch_cfgs():
    spec, ws = _workload()
    return T.stack_configs([
        T.make_config(spec, int(f * ws), 700e6, p, device="cpu")
        for p, f in LANES])


def _jax_cfgs():
    spec, ws = _workload()
    return J.stack_configs([
        J.make_config(spec, int(f * ws), 700e6, p) for p, f in LANES])


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _leaves(tree, prefix=""):
    if hasattr(tree, "_fields"):
        for f, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{prefix}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, np.asarray(tree)


def _assert_carry_matches(got, want, what):
    got_l, want_l = dict(_leaves(got)), dict(_leaves(want))
    assert got_l.keys() == want_l.keys(), what
    for name, w in want_l.items():
        g = got_l[name]
        assert g.shape == w.shape, (what, name)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0,
                                       err_msg=f"{what} {name}")


def _select(mask, a, b):
    """Per-lane select between two stacked numpy carries."""
    return jax.tree.map(
        lambda x, y: np.where(mask.reshape((-1,) + (1,) * (x.ndim - 1)),
                              x, y), a, b)


def _lockstep(stepper):
    """Walk ``LOCKSTEP`` steps of the JAX package's run of every lane and
    apply the port's step to the JAX carry before each: every leaf of the
    port's result against the JAX step's (the horizon stepper: both
    flavours on every lane; the run follows each lane's own flavour)."""
    spec = _workload()[0]
    dt = float(np.max(spec.page_size)) / 700e6
    ts = 0.1 * SCALE
    kw = dict(policies=POLICIES, stepper=stepper)
    j_cheap = J.make_step(spec, dt, ts, refresh=False, **kw)
    j_full = J.make_step(spec, dt, ts, refresh=True, **kw)
    cfgs_j = _jax_cfgs()
    v_cheap = jax.jit(jax.vmap(j_cheap))
    v_full = jax.jit(jax.vmap(j_full))
    runner = T.make_runner(spec, time_slice=ts, policies=POLICIES,
                           stepper=stepper, device="cpu")
    cfgs_t = _torch_cfgs()
    n_inner = runner.cheap.n_inner

    def init(cfg):
        state = J.init_state(spec, j_cheap.policies)
        view = j_cheap.query_view(state.qidx, state.pos)
        if stepper == "fixed":
            return state, view
        win = j_cheap.window(view)
        return (state, view, win, j_cheap.adv_limit(win, state.resident),
                jnp.float32(0.0), jnp.int32(n_inner), jnp.int32(1))

    carry = _np_tree(jax.vmap(init)(cfgs_j))
    coop_steps = 0
    for k in range(LOCKSTEP):
        port_in = T.carry_from_numpy(carry, device="cpu")
        if stepper == "fixed":
            step_j, step_t = ((v_full, runner.full)
                              if k % n_inner == n_inner - 1
                              else (v_cheap, runner.cheap))
            want = _np_tree(step_j(carry, cfgs_j))
            got = T.carry_to_numpy(step_t(port_in, cfgs_t))
            _assert_carry_matches(got, want, f"fixed step {k}")
            carry = want
        else:
            inner = (carry[5] > 1) & (carry[6] < carry[5])
            want_c = _np_tree(v_cheap(carry, cfgs_j))
            want_f = _np_tree(v_full(carry, cfgs_j))
            for flavour, step_t, want in (("cheap", runner.cheap, want_c),
                                          ("refresh", runner.full, want_f)):
                got = T.carry_to_numpy(step_t(port_in, cfgs_t))
                _assert_carry_matches(got, want, f"{flavour} step {k}")
            carry = _select(inner, want_c, want_f)
        inflight = carry[0].pstate[POLICIES.index("cscan")].inflight
        coop_steps += int((inflight >= 0).sum())
    # the cooperative lanes loaded chunks during the checked steps
    assert coop_steps > 0
    assert int(carry[0].loads.min()) > 0
    print(f"lockstep {stepper}: {LOCKSTEP} steps, every leaf held")


@pytest.mark.parametrize("stepper", STEPPERS)
def test_port_step_on_the_jax_carry_for_hundreds_of_steps(stepper):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_disable_hlo_passes=algsimp",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH",
                                                              "")]))
    out = subprocess.run([sys.executable, __file__, stepper], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-8000:]
    assert f"lockstep {stepper}: {LOCKSTEP} steps" in out.stdout


if __name__ == "__main__":
    _lockstep(sys.argv[1])
