"""The port stands alone: importing ``repro_torch`` and every submodule
pulls in neither ``jax`` nor the JAX package ``repro``; its entry points
default to the GPU and refuse to carry on on the CPU when there is none;
a tensor that is not on the CPU never takes a plain version."""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import policy_registry
from repro_torch.core.array_sim import (
    compile_workload, init_state, make_config, make_runner, resolve_device,
    resolve_policies, run_sweep, spec_to_torch,
)
from repro_torch.core.workload import make_lineitem_db, micro_streams
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import build_model, init_params, load_jax_params
from repro_torch.serving.model import PagedTinyLM, TinyConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))


def _spec():
    db = make_lineitem_db(scale_tuples=2_000_000)
    return compile_workload(db, micro_streams(db, 2, 2, seed=1))


def test_every_submodule_is_listed():
    for want in ("repro_torch.core.array_sim.sim",
                 "repro_torch.core.array_sim.convert",
                 "repro_torch.core.array_sim.coop",
                 "repro_torch.core.policy_registry",
                 "repro_torch.kernels.ops", "repro_torch.kernels.ref",
                 "repro_torch.kernels.pbm_timeline",
                 "repro_torch.kernels._build", "repro_torch.kernels.cases",
                 "repro_torch.kernels.paged_attention",
                 "repro_torch.serving", "repro_torch.serving.kv_cache",
                 "repro_torch.serving.policy_driver",
                 "repro_torch.serving.engine", "repro_torch.serving.model",
                 "repro_torch.launch", "repro_torch.launch.serve",
                 "repro_torch.configs", "repro_torch.configs.base",
                 "repro_torch.configs.qwen2_1_5b",
                 "repro_torch.configs.zamba2_2_7b",
                 "repro_torch.configs.xlstm_350m",
                 "repro_torch.models", "repro_torch.models.layers",
                 "repro_torch.models.attention", "repro_torch.models.ssm",
                 "repro_torch.models.xlstm", "repro_torch.models.transformer",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.mamba2_scan",
                 "repro_torch.kernels.mlstm",
                 "repro_torch.core.engine", "repro_torch.core.stats",
                 "repro_torch.core.scans", "repro_torch.core.policies",
                 "repro_torch.core.policies.base",
                 "repro_torch.core.policies.lru",
                 "repro_torch.core.policies.pbm",
                 "repro_torch.core.policies.opt",
                 "repro_torch.core.policies.cscan",
                 "repro_torch.core.array_sim.validate"):
        assert want in MODULES


def test_importing_the_port_pulls_in_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"mods = {MODULES!r}\n"
        "import repro_torch\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'jaxlib' or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert 'triton' not in sys.modules\n"
        "print('clean', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


def test_chip_smoke_imports_neither_jax_nor_repro():
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert "jax" not in s.split(), s
            assert not s.startswith(("import repro.", "from repro.",
                                     "import repro ", "from repro ")), s




def _no_gpu():
    return not torch.cuda.is_available()


@pytest.mark.parametrize("call", [
    lambda spec: make_runner(spec),
    lambda spec: init_state(spec),
    lambda spec: make_config(spec, 1e6),
    lambda spec: spec_to_torch(spec),
    lambda spec: resolve_device(),
    lambda spec: run_sweep(spec, make_config(spec, 1e6, device="cpu")),
    lambda spec: PagedTinyLM(TinyConfig()),
    lambda spec: serve.main([]),
    lambda spec: init_params(
        build_model(get_config("qwen2_1_5b", smoke=True)).param_specs, 0,
        torch.float32),
    lambda spec: load_jax_params({"w": np.zeros((2, 2), np.float32)}),
], ids=["make_runner", "init_state", "make_config", "spec_to_torch",
        "resolve_device", "run_sweep", "PagedTinyLM", "launch.serve",
        "models.init_params", "models.load_jax_params"])
def test_entry_points_default_to_cuda_and_raise_without_a_gpu(call):
    if not _no_gpu():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(_spec())


def test_cpu_runs_only_when_asked_for():
    spec = _spec()
    runner = make_runner(spec, device="cpu", time_slice=0.002,
                         policies=("lru",), max_slices=2000)
    assert runner.device.type == "cpu"
    pool = 0.5 * float(spec.page_size.sum())
    state = runner(make_config(spec, pool, policy="lru", device="cpu"))
    assert state.t.device.type == "cpu"
    assert bool((state.stream_done_t >= 0).all())


def test_registry_names_and_stable_ids():
    assert policy_registry.names(backend="array") == [
        "lru", "cscan", "pbm", "opt"]
    assert policy_registry.array_ids() == {
        "lru": 0, "pbm": 1, "cscan": 2, "opt": 3}
    assert policy_registry.array_name(3) == "opt"
    assert policy_registry.array_name(9) is None
    assert [p.name for p in resolve_policies()] == [
        "lru", "cscan", "pbm", "opt"]
    assert policy_registry.names(backend="event") == [
        "lru", "cscan", "pbm", "opt"]
    with pytest.raises(KeyError, match="registered policies"):
        policy_registry.get("mru")


def test_cscan_is_registered_but_not_ported():
    """Since array-CScan's substrate is ported, ``cscan`` resolves on
    every backend; what stays refused is a second cooperative policy in
    one step, and the event engine runs the ABM itself."""
    assert policy_registry.get("cscan").array_id == 2
    pol = policy_registry.array_policy("cscan")
    assert pol.name == "cscan" and pol.cooperative
    assert [p.name for p in resolve_policies(("lru", "cscan"))] == [
        "lru", "cscan"]
    with pytest.raises(ValueError, match="at most one cooperative"):
        resolve_policies(("cscan", policy_registry.array_policy("cscan")))
    assert policy_registry.event_policy("cscan", None) == (None, True)


def test_unported_options_are_refused_not_ignored():
    spec = _spec()
    with pytest.raises(ValueError, match="fixed | horizon"):
        make_runner(spec, stepper="event", device="cpu")
    for opt in ("mesh", "sanitize", "telemetry", "page_axis"):
        with pytest.raises(TypeError):
            make_runner(spec, device="cpu", **{opt: True})
