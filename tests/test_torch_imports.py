"""The port stands alone: importing ``repro_torch`` and every submodule
pulls in neither ``jax`` nor the JAX package ``repro``; its entry points
default to the GPU and refuse to carry on on the CPU when there is none;
a tensor that is not on the CPU never takes a plain version."""

import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import repro_torch
from repro_torch.core import policy_registry
from repro_torch.core.array_sim import (
    compile_workload, init_state, make_config, make_runner, resolve_device,
    resolve_policies, run_sweep, spec_to_torch,
)
from repro_torch.core.workload import make_lineitem_db, micro_streams

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
                 "repro_torch.kernels._build", "repro_torch.kernels.cases"):
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
], ids=["make_runner", "init_state", "make_config", "spec_to_torch",
        "resolve_device", "run_sweep"])
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
    assert [p.name for p in resolve_policies()] == ["lru", "pbm", "opt"]
    with pytest.raises(KeyError, match="registered policies"):
        policy_registry.get("mru")


def test_cscan_is_registered_but_not_ported():
    assert policy_registry.get("cscan").array_id == 2
    with pytest.raises(NotImplementedError, match="not ported yet"):
        policy_registry.array_policy("cscan")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        resolve_policies(("lru", "cscan"))


def test_unported_options_are_refused_not_ignored():
    spec = _spec()
    with pytest.raises(NotImplementedError, match="horizon"):
        make_runner(spec, stepper="fixed", device="cpu")
    for opt in ("mesh", "sanitize", "telemetry", "page_axis"):
        with pytest.raises(TypeError):
            make_runner(spec, device="cpu", **{opt: True})
