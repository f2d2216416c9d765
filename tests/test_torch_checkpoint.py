"""The port's ``CheckpointManager`` (``repro_torch.train.checkpoint``)
against the JAX package's: the reference's on-disk layout, so that a
checkpoint written by either package restores bit for bit in the other
(f32 and bf16 leaves, an ``OptState``, the data position in ``extra``);
the port's own round trip; async saves, ``keep`` and the atomic publish."""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.train import optimizer as JO  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JManager  # noqa
from repro_torch.models import tree_paths  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402

EXTRA = {"data": {"stream_id": 0, "shard_order": [0, 1, 2],
                  "tokens_consumed": 40_000, "epoch": 0, "shard_idx": 1,
                  "page": 0, "offset": 0}}


def _params(seed=0):
    """A port params tree: f32 leaves, one bf16 leaf, nested dicts."""
    g = torch.Generator().manual_seed(seed)
    return {"embed": {"table": torch.randn(16, 8, generator=g)},
            "layers": {"w": torch.randn(2, 8, 8, generator=g),
                       "ln": torch.randn(2, 8, generator=g)
                       .to(torch.bfloat16)},
            "ln_f": torch.randn(8, generator=g)}


def _opt(params, seed=1):
    g = torch.Generator().manual_seed(seed)
    st = O.init_opt_state(params)
    for t in O.leaves(st.mu) + O.leaves(st.nu):
        t.copy_(torch.rand(t.shape, generator=g))
    st.step.fill_(7)
    return st


def _to_jax(tree):
    """The same numbers as a JAX tree (bf16 kept as bf16)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return jnp.asarray(tree.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(tree.numpy())


def _jopt(st):
    return JO.OptState(step=jnp.asarray(int(st.step), jnp.int32),
                       mu=_to_jax(st.mu), nu=_to_jax(st.nu))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x).astype(np.float32) if x.dtype.name == "bfloat16" \
        else np.asarray(x)


def _same(got, want):
    """Bit-equal trees (one of them may be JAX's), dtypes included."""
    g, w = tree_paths(got), tree_paths(want)
    assert set(g) == set(w)
    for k in w:
        assert str(g[k].dtype).replace("torch.", "") == \
            str(w[k].dtype).replace("torch.", ""), k
        np.testing.assert_array_equal(_f32(g[k]), _f32(w[k]), err_msg=k)


def test_port_round_trip_is_bit_equal(tmp_path):
    params = _params()
    opt = _opt(params)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, params, opt, extra=EXTRA)
    step, p2, o2, extra = mgr.restore(None, _params(9), _opt(_params(9), 9))
    assert step == 3 and extra == EXTRA
    _same(p2, params)
    _same(o2.mu, opt.mu)
    _same(o2.nu, opt.nu)
    assert isinstance(o2, O.OptState) and int(o2.step) == 7
    assert o2.step.dtype == torch.int32
    assert p2["layers"]["ln"].dtype == torch.bfloat16


def test_layout_is_the_references(tmp_path):
    params = _params()
    opt = _opt(params)
    CheckpointManager(str(tmp_path / "t")).save(1, params, opt, extra=EXTRA)
    JManager(str(tmp_path / "j")).save(1, _to_jax(params), _jopt(opt),
                                       extra=EXTRA)
    t, j = tmp_path / "t" / "step_1", tmp_path / "j" / "step_1"
    assert sorted(os.listdir(t)) == sorted(os.listdir(j))
    assert json.load(open(t / "manifest.json")) == \
        json.load(open(j / "manifest.json"))
    for name in os.listdir(j):
        if name.endswith(".npy"):
            a, b = np.load(t / name), np.load(j / name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_a_jax_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    params = _params(2)
    opt = _opt(params, 3)
    JManager(str(tmp_path)).save(5, _to_jax(params), _jopt(opt),
                                 extra=EXTRA)
    step, p2, o2, extra = CheckpointManager(str(tmp_path)).restore(
        None, _params(9), _opt(_params(9), 9))
    assert step == 5 and extra == EXTRA
    _same(p2, params)
    _same(o2.mu, opt.mu)
    _same(o2.nu, opt.nu)
    assert int(o2.step) == 7


def test_a_port_checkpoint_restores_bit_equal_in_jax(tmp_path):
    params = _params(4)
    opt = _opt(params, 5)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(6, params, opt, extra=EXTRA, async_=True)
    mgr.wait()
    step, p2, o2, extra = JManager(str(tmp_path)).restore(
        None, _to_jax(_params(9)), _jopt(_opt(_params(9), 9)))
    assert step == 6 and extra == EXTRA
    _same(p2, params)
    _same(o2.mu, opt.mu)
    _same(o2.nu, opt.nu)
    assert int(o2.step) == 7


def test_async_save_keeps_keep_steps_and_no_tmp(tmp_path):
    params = _params()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 6):
        params["ln_f"].add_(1.0)            # updated in place after save
        mgr.save(s, params, extra={"s": s}, async_=True)
    want = params["ln_f"].clone()
    params["ln_f"].add_(1.0)
    mgr.wait()
    assert mgr.all_steps() == [4, 5]
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp_")]
    step, p2, _, extra = mgr.restore(None, _params(9))
    assert step == 5 and extra == {"s": 5}
    assert torch.equal(p2["ln_f"], want)    # the values at save time


def test_a_failed_async_write_is_raised_by_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    (tmp_path / "ckpt").rmdir()
    (tmp_path / "ckpt").write_text("not a directory")
    mgr.save(1, _params(), async_=True)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                                # reported once


def test_restore_without_checkpoints_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path)).restore(None, _params())
