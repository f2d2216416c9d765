"""Quickstart on the PyTorch / CUDA port: the paper's result in 30 seconds,
then the framework around it (the port's counterpart of
``examples/quickstart.py``, the same three demos).

  PYTHONPATH=src python examples/torch_quickstart.py               # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The scans and the serving engine are pure Python on the host; the
training demo runs on ``--device`` (default ``cuda``, refused without a
GPU), its attention through the flash-attention kernel there.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import EngineConfig, run_workload  # noqa: E402
from repro_torch.core.workload import (  # noqa: E402
    make_lineitem_db, micro_accessed_bytes, micro_streams,
)


def demo_concurrent_scans():
    print("=== 1. Concurrent scans: LRU vs CScans vs PBM vs OPT (paper) ===")
    db = make_lineitem_db(scale_tuples=18_000_000, page_bytes=64 << 10)
    ws = micro_accessed_bytes(db)
    streams = micro_streams(db, n_streams=8, queries_per_stream=8, seed=3)
    print(f"working set {ws/1e6:.0f}MB, buffer 40%, 700MB/s, 8 streams x 8 queries")
    for pol in ("lru", "cscan", "pbm", "opt"):
        cfg = EngineConfig(bandwidth=700e6, buffer_bytes=int(0.4 * ws),
                           pbm_time_slice=0.01)
        r = run_workload(db, streams, pol, cfg)
        print(f"  {pol:6s} avg stream {r.avg_stream_time:6.2f}s   "
              f"I/O {r.io_gb:5.2f}GB")


def demo_train(device):
    print(f"\n=== 2. Train a small LM through the framework ({device}) ===")
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, init_params
    from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.train.train_step import make_train_step

    cfg = get_config("qwen2_1_5b", smoke=True)
    model = build_model(cfg)
    params = init_params(model.param_specs, 0, torch.float32, device=device)
    opt = init_opt_state(params)
    step = make_train_step(model, OptimizerConfig(
        learning_rate=3e-3, warmup_steps=2, total_steps=20))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 128, (4, 65)).astype(np.int32)).to(device)
    ops.reset_launch_counts()
    for i in range(10):
        params, opt, m = step(params, opt, {"tokens": toks[:, :-1]})
        if i % 3 == 0:
            print(f"  step {i} loss {float(m['loss']):.4f}")
    if torch.device(device).type == "cuda":
        print(f"  flash attention kernel launches: "
              f"{ops.launch_counts()['flash_attention']}")


def demo_serving():
    print("\n=== 3. Paged-KV serving with PBM preemption ===")
    from repro_torch.serving import PagePool, Request, ServingEngine

    pool = PagePool(n_pages=40, page_size=16, page_bytes=32 << 10)
    eng = ServingEngine(pool, lambda reqs: [42] * len(reqs), policy="pbm")
    common = list(range(32))  # shared system prompt
    for i in range(10):
        eng.submit(Request(prompt=common + [100 + i], max_new_tokens=24))
    st = eng.run_to_completion()
    print(f"  {len(eng.finished)} requests in {st.steps} steps; "
          f"{st.shared_prefix_pages} prefix pages shared; "
          f"{st.preemptions} preemptions; "
          f"swap {(st.swap_out_bytes + st.swap_in_bytes)/1e6:.1f}MB")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the training demo runs (default cuda)")
    args = ap.parse_args(argv)
    from repro_torch.core.array_sim.convert import resolve_device
    device = resolve_device(args.device)
    demo_concurrent_scans()
    demo_train(device)
    demo_serving()
    print("\nSee examples/torch_concurrent_scans_demo.py, "
          "examples/torch_train_lm.py, examples/torch_serve_paged.py for the "
          "full drivers.")


if __name__ == "__main__":
    main()
