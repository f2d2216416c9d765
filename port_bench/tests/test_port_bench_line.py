"""The run's result line, and what a run refuses to do."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
from conftest import BENCH, DATA, REPO, add_cell

from portbench import harness

TOP = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_has_the_contract_keys(checkout, traced):
    root, here = checkout
    add_cell(root, here, "micro_tiny.mixed", DATA / "micro_tiny.json", "mixed")
    out = harness.execute(root, "micro_tiny.mixed", 2**31 + 5, 0.2, traced,
                          time.time(), device="cpu", here=here)
    keys = list(out)
    assert keys[:5] == TOP and keys[-1] == "checks"
    assert set(keys) == set(TOP) | {"checks"} | ({"breakdown"} if traced else set())
    assert isinstance(out["correct"], bool)
    assert out["attempted"] == 24 * (out["attempted"] // 24) > 0
    dev = out["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        names = {"macro_steps_per_sim_s", "step_ms"}   # no device trace on the CPU
    else:
        names = {"lane_sim_s_per_s", "setup_s"}
    assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(out)


def test_no_result_without_a_card():
    """Here there is no CUDA device: the run exits non-zero and prints
    nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                        "micro_sf30.mixed", "--seed", "7", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_no_result_outside_a_checkout(tmp_path):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        "micro_sf30.mixed", "--seed", "7", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_the_program_comes_from_the_checkout_only(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files but no
    program gives no result."""
    with pytest.raises(ImportError):
        harness._import_program(tmp_path)


def test_an_unknown_cell_is_refused(checkout):
    root, here = checkout
    with pytest.raises(KeyError):
        harness.execute(root, "no.such_cell", 1, 1.0, False, time.time(),
                        device="cpu", here=here)
