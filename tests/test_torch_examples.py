"""The port's four examples run on the CPU at their smallest flags
(``--device cpu``), each in a process of its own, and print what their
JAX namesakes print.  On the card ``chip_smoke.py``'s ``examples`` phase
runs them at their defaults' device."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXAMPLES = {
    "torch_quickstart.py": (["--device", "cpu"],
                            ["=== 1. Concurrent scans", "=== 2. Train",
                             "=== 3. Paged-KV serving", "step 9 loss"]),
    "torch_concurrent_scans_demo.py": (
        ["--scale", "0.01", "--streams", "2"],
        ["pbm ", "<- the paper's contribution", "opt(trace)",
         "sharing potential"]),
    "torch_serve_paged.py": (["--device", "cpu"],
                             ["served 6 requests",
                              "tokens identical under a different eviction "
                              "policy: True"]),
    "torch_train_lm.py": (["--steps", "3", "--device", "cpu"],
                          ["repro_torch.launch.train", "device=cpu",
                           "done: loss"]),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, tmp_path):
    args, expect = EXAMPLES[name]
    if name == "torch_train_lm.py":
        args = args + ["--checkpoint-dir", str(tmp_path / "ckpt")]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", name),
                          *args], env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for text in expect:
        assert text in out.stdout, (text, out.stdout[-3000:])


@pytest.mark.parametrize("name", ["torch_quickstart.py",
                                  "torch_serve_paged.py",
                                  "torch_train_lm.py"])
def test_example_refuses_to_run_without_a_gpu_unless_asked(name, tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    args = ["--steps", "1", "--checkpoint-dir", str(tmp_path / "c")] \
        if name == "torch_train_lm.py" else []
    out = subprocess.run([sys.executable, os.path.join(ROOT, "examples", name),
                          *args], env=env, cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
