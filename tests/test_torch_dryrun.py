"""The dry run's pieces against the JAX package's, for every arch, on the
CPU (the JAX side builds specs and abstract shapes only, no arrays):

* ``mesh_rules`` and ``logical_to_spec`` equal JAX's for every mode and
  both production meshes' axis names;
* ``param_shardings`` equals JAX's ``PartitionSpec``\\ s leaf by leaf, with
  no mesh and under the pod and multi-pod meshes' sizes;
* ``abstract_params``, ``abstract_opt_state``, ``input_specs`` and the
  cache trees have JAX's shapes and dtypes, and ``cache_shardings`` its
  specs;
* at the smoke configs, the meta dry run's operations equal
  ``FlopCounterMode`` over the same step on real CPU tensors (B5-B7 on
  the card's route, counted by their bound formula, in both).
"""

import types

import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.configs.base import logical_to_spec as j_logical_to_spec
from repro.configs.base import mesh_rules as j_mesh_rules
from repro.launch import inputs as J_inputs
from repro.models import abstract_params as j_abstract_params
from repro.models import build_model as j_build_model
from repro.models import param_shardings as j_param_shardings
from repro.train.optimizer import abstract_opt_state as j_abstract_opt_state
from repro.train.optimizer import opt_state_shardings as j_opt_shardings
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from repro_torch.configs.base import logical_to_spec, mesh_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch import inputs as T_inputs
from repro_torch.launch.mesh import (
    make_production_mesh, mesh_chip_count,
)
from repro_torch.models import (
    abstract_params, build_model, init_params, param_shardings,
)
from repro_torch.models.layers import tree_paths
from repro_torch.train.optimizer import (
    abstract_opt_state, opt_state_shardings,
)

MODES = ("train", "decode", "decode_long")
AXES = (("data", "model"), ("pod", "data", "model"))


def _fake_mesh(multi_pod: bool):
    """What JAX's ``param_shardings`` reads of a mesh: axis names and the
    device array's shape (no devices are made)."""
    m = make_production_mesh(multi_pod=multi_pod)
    return types.SimpleNamespace(axis_names=m.axis_names,
                                 devices=np.empty(m.shape, dtype=object))


def _spec_tuple(p):
    return tuple(p)


def j_tree_paths(tree, prefix=""):
    """``{"a/b": leaf}`` of a JAX nested dict of any leaves."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(j_tree_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def test_the_archs_and_shapes_are_the_jax_packages():
    assert ARCH_IDS == J_ARCH_IDS
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind) for k, s in J_SHAPES.items()}


@pytest.mark.parametrize("axes", AXES, ids=["pod", "multipod"])
@pytest.mark.parametrize("mode", MODES)
def test_mesh_rules_and_logical_to_spec_equal_jax(mode, axes):
    rules = mesh_rules(mode, axes)
    assert rules == j_mesh_rules(mode, axes)
    logicals = {spec.logical for arch in ARCH_IDS for spec in tree_paths(
        build_model(get_config(arch)).param_specs).values()}
    names = sorted(rules)
    rng = np.random.default_rng(0)
    for _ in range(200):     # random combinations, repeats included
        n = int(rng.integers(1, 6))
        logicals.add(tuple(None if rng.random() < 0.2
                           else names[int(rng.integers(len(names)))]
                           for _ in range(n)))
    for logical in sorted(logicals, key=str):
        assert logical_to_spec(logical, rules) == _spec_tuple(
            j_logical_to_spec(logical, rules)), logical


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_equal_jax_leaf_by_leaf(arch):
    tm, jm = build_model(get_config(arch)), j_build_model(j_get_config(arch))
    for mode in MODES:
        for multi in (False, True):
            mesh = _fake_mesh(multi)
            rules = mesh_rules(mode, mesh.axis_names)
            for m in (None, mesh):
                got = tree_paths(param_shardings(tm.param_specs, rules, m))
                want = j_tree_paths(j_param_shardings(jm.param_specs, rules,
                                                      mesh=m))
                assert set(got) == set(want)
                for path in want:
                    assert got[path] == _spec_tuple(want[path]), (mode, path)
            p_specs = param_shardings(tm.param_specs, rules, mesh)
            o = opt_state_shardings(p_specs)
            jo = j_opt_shardings(j_param_shardings(jm.param_specs, rules,
                                                   mesh=mesh))
            assert o.step == _spec_tuple(jo.step)
            for path, want in j_tree_paths(jo.nu).items():
                assert tree_paths(o.nu)[path] == _spec_tuple(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_trees_have_jax_shapes_and_dtypes(arch):
    import jax.numpy as jnp

    tm, jm = build_model(get_config(arch)), j_build_model(j_get_config(arch))
    got = tree_paths(abstract_params(tm.param_specs, torch.bfloat16))
    want = j_tree_paths(j_abstract_params(jm.param_specs, jnp.bfloat16))
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].device.type == "meta"
        assert tuple(got[path].shape) == tuple(w.shape), path
        assert _dtype_name(got[path]) == str(w.dtype), path
    opt = abstract_opt_state(abstract_params(tm.param_specs, torch.bfloat16))
    jopt = j_abstract_opt_state(j_abstract_params(jm.param_specs,
                                                  jnp.bfloat16))
    assert tuple(opt.step.shape) == () and _dtype_name(opt.step) == str(
        jopt.step.dtype)
    for tree, jtree in ((opt.mu, jopt.mu), (opt.nu, jopt.nu)):
        for path, w in j_tree_paths(jtree).items():
            t = tree_paths(tree)[path]
            assert tuple(t.shape) == tuple(w.shape)
            assert _dtype_name(t) == str(w.dtype) == "float32"


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_inputs_and_caches_have_jax_shapes_dtypes_and_specs(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    tm, jm = build_model(cfg), j_build_model(jcfg)
    for name, shape in SHAPES.items():
        got = T_inputs.input_specs(cfg, shape)
        want = J_inputs.input_specs(jcfg, J_SHAPES[name])
        assert set(got) == set(want), name
        for k, w in want.items():
            assert tuple(got[k].shape) == tuple(w.shape), (name, k)
            assert _dtype_name(got[k]) == str(w.dtype), (name, k)
        assert T_inputs.cell_mode(cfg, shape) == J_inputs.cell_mode(
            jcfg, J_SHAPES[name])
        for multi in (False, True):
            mesh = _fake_mesh(multi)
            rules = mesh_rules(T_inputs.cell_mode(cfg, shape),
                               mesh.axis_names)
            b = T_inputs.batch_shardings(cfg, shape, rules)
            jb = J_inputs.batch_shardings(jcfg, J_SHAPES[name], rules)
            assert {k: v for k, v in b.items()} == {
                k: _spec_tuple(v) for k, v in jb.items()}
            if shape.kind != "decode":
                continue
            cache = tm.cache_specs(shape.global_batch, shape.seq_len)
            jcache = jm.cache_specs(shape.global_batch, shape.seq_len)
            flat, jflat = tree_paths(cache), j_tree_paths(jcache)
            assert set(flat) == set(jflat), name
            for path, w in jflat.items():
                assert tuple(flat[path].shape) == tuple(w.shape), path
                assert str(flat[path].dtype).replace("torch.", "") == str(
                    w.dtype), path
            c = tree_paths(T_inputs.cache_shardings(cfg, shape, rules, cache))
            jc = j_tree_paths(J_inputs.cache_shardings(jcfg, J_SHAPES[name],
                                                       rules, jcache))
            assert {k: v for k, v in c.items()} == {
                k: _spec_tuple(v) for k, v in jc.items()}


def test_meshes():
    pod, multi = (make_production_mesh(multi_pod=m) for m in (False, True))
    assert (pod.shape, pod.axis_names) == ((16, 16), ("data", "model"))
    assert multi.axis_names == ("pod", "data", "model")
    assert (mesh_chip_count(pod), mesh_chip_count(multi)) == (256, 512)


SMOKE_SHAPES = (ShapeConfig("train", 32, 2, "train"),
                ShapeConfig("prefill", 32, 2, "prefill"),
                ShapeConfig("decode", 32, 2, "decode"))


def _real_cell(cfg, shape):
    """The cell's step on real CPU tensors: the same dtype as the dry
    run's, weights from seed 0, tokens from numpy."""
    model = build_model(cfg)
    params = init_params(model.param_specs, 0, D.PARAM_DTYPE, device="cpu")
    rng = np.random.default_rng(0)
    batch = {}
    for k, v in T_inputs.input_specs(cfg, shape).items():
        if v.dtype == torch.int32:
            batch[k] = torch.from_numpy(rng.integers(
                0, 64, tuple(v.shape)).astype(np.int32))
        else:
            batch[k] = torch.from_numpy(rng.normal(
                size=tuple(v.shape)).astype(np.float32)).to(v.dtype)
    cache = None
    if shape.kind == "decode":
        cache = {p: torch.zeros(s.shape, dtype=s.dtype) for p, s in tree_paths(
            model.cache_specs(shape.global_batch, shape.seq_len)).items()}
        from repro_torch.models.layers import unflatten
        cache = unflatten(cache)
    return params, batch, cache


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_operations_equal_a_real_cpu_step(arch):
    cfg = get_config(arch, smoke=True)
    for shape in SMOKE_SHAPES:
        rec = D.build_cell(arch, shape.name, cfg=cfg, shape=shape)
        assert rec["status"] == "ok", (shape.kind, rec)
        params, batch, cache = _real_cell(cfg, shape)
        fn, _ = D.step_of(cfg, shape, params, batch, cache)
        flops = D.count_step(fn)["flops"]  # CPU tensors, the card's route
        assert flops == rec["flops"] > 0, (shape.kind, flops, rec["flops"])


def test_every_cell_of_the_registry_is_priced_or_skipped(tmp_path):
    """The records of the small archs at every shape (the whole table is
    the chip run's: ``python -m repro_torch.launch.dryrun --all``)."""
    assert D.main(["--arch", "qwen2_1_5b", "--out", str(tmp_path)]) == 0
    import json
    recs = {p.stem: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}
    assert set(recs) == {f"qwen2_1_5b__{s}" for s in SHAPES}
    assert recs["qwen2_1_5b__long_500k"]["status"] == "skipped"
    train = recs["qwen2_1_5b__train_4k"]
    # weights and state fit; a million tokens' activations do not
    assert train["bytes"]["total"] <= D.CARD_BYTES
    assert train["bytes"]["peak"] == (
        train["bytes"]["total"] - train["bytes"]["grads"]
        + train["bytes"]["activations_peak"]) > D.CARD_BYTES
    assert train["status"] == "does_not_fit"
    assert recs["qwen2_1_5b__decode_32k"]["status"] == "does_not_fit"
    assert train["bytes"]["params"] == 2 * sum(
        int(np.prod(s.shape)) for s in tree_paths(
            build_model(get_config("qwen2_1_5b")).param_specs).values())
    assert train["bytes"]["opt_state"] == 4 * train["bytes"]["params"] + 4
    assert train["per_card"]["pod"]["chips"] == 256
    assert train["per_card"]["pod"]["params"] < train["bytes"]["params"]
    assert recs["qwen2_1_5b__decode_32k"]["bytes"]["cache"] > 0
    assert "host_reads" in recs["qwen2_1_5b__decode_32k"]
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        rec = recs[f"qwen2_1_5b__{name}"]
        assert rec["counted"] == "whole_step"
        assert rec["bytes_accessed"] > 0 and rec["bytes"]["peak"] > 0
        for mesh in ("pod", "multipod"):
            coll = rec["per_card"][mesh]["collective_bytes"]
            assert set(coll) == {"all-gather", "all-reduce",
                                 "reduce-scatter", "all-to-all",
                                 "collective-permute"}
            assert rec["per_card"][mesh]["collective_total"] == sum(
                coll.values()) > 0
    assert train["per_card"]["pod"]["collective_bytes"]["all-gather"] > 0
