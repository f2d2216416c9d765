"""End-to-end training driver example on the PyTorch / CUDA port (the
port's counterpart of ``examples/train_lm.py``).

Demo on the card (qwen2's smoke configuration, a few hundred steps,
PBM-cached data pipeline, checkpoint + exact resume):

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200
  PYTHONPATH=src python examples/torch_train_lm.py --steps 20 --device cpu

This wraps ``repro_torch.launch.train`` (its flags pass through, its
``--device`` defaults to ``cuda`` and refuses to run without a GPU).
``--preset 100m`` is the documented target configuration: qwen2_1_5b's
full width, a ~100M-param depth's worth of work a step on one card; the
default preset is the smoke configuration so the example completes in
minutes.  Checkpoints go under the system's temporary directory unless
``--checkpoint-dir`` says otherwise.
"""

import os
import subprocess
import sys
import tempfile

PRESETS = {
    "cpu": ["--arch", "qwen2_1_5b", "--smoke", "--batch", "8", "--seq", "256"],
    # qwen2 full width: runnable on one accelerator
    "100m": ["--arch", "qwen2_1_5b", "--batch", "32", "--seq", "1024",
             "--microbatches", "4"],
}


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    preset = "cpu"
    if "--preset" in args:
        i = args.index("--preset")
        preset = args[i + 1]
        args = args[:i] + args[i + 2:]
    if "--steps" not in args:
        args += ["--steps", "200"]
    if "--checkpoint-dir" not in args:
        args += ["--checkpoint-dir",
                 os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")]
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] \
        + PRESETS[preset] + args
    print("+", " ".join(cmd), flush=True)
    return subprocess.call(cmd, env={**os.environ, "PYTHONPATH": src})


if __name__ == "__main__":
    raise SystemExit(main())
