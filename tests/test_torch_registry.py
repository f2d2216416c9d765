"""The port's policy registry against the JAX package's: the same
entries in the same order on every backend (the event-only ``mru``,
``pbm_lru`` and ``attach`` included), with the same summaries, paper
flags and stable array ids; and its completeness check — every entry
resolves on each backend it declares, the serving ones serving a small
oversubscribed workload through the port's ``ServingEngine`` — passes,
as a function and as ``python -m repro_torch.core.policy_registry
--check``."""

import os
import subprocess
import sys

import pytest

from repro.core import policy_registry as J
from repro_torch.core import policy_registry as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("backend", [None, "event", "array", "serving"])
def test_names_equal_the_jax_registry(backend):
    assert T.names(backend=backend) == J.names(backend=backend)
    assert T.names(backend=backend, paper_only=True) == \
        J.names(backend=backend, paper_only=True)


@pytest.mark.parametrize("name", J.names())
def test_entry_equals_the_jax_entry(name):
    got, want = T.get(name), J.get(name)
    assert got.summary == want.summary
    assert got.paper == want.paper and got.cooperative == want.cooperative
    assert got.backends == want.backends
    assert got.array_id == want.array_id


def test_array_ids_are_unchanged():
    assert T.array_ids() == J.array_ids() == {
        "lru": 0, "pbm": 1, "cscan": 2, "opt": 3}


@pytest.mark.parametrize("name", ["mru", "pbm_lru", "attach"])
def test_event_only_entries_refuse_the_other_backends(name):
    pol, coop = T.event_policy(name, _engine_config())
    assert pol.name == name and coop is False
    with pytest.raises(KeyError, match="event-engine-only"):
        T.array_policy(name)
    with pytest.raises(KeyError, match="no serving realisation"):
        T.serving_policy(name)


def _engine_config():
    from repro_torch.core.engine import EngineConfig
    return EngineConfig()


def test_check_passes():
    assert T._check(verbose=False) == 0


def test_check_cli_exits_0():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.policy_registry", "--check"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "policy registry OK: 7 policies" in out.stdout
    for name in J.names():
        assert f"  {name}" in out.stdout
