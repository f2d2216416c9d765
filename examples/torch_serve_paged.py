"""Serving through the full paged stack of the PyTorch / CUDA port: real
attention over policy-managed KV pages (the port's counterpart of
``examples/serve_paged.py``).

PagedTinyLM computes every decode step with ``kernels.ops.paged_attention``
(the hand-written paged-attention kernel on the card, its plain PyTorch
version on the CPU) reading K/V through the page tables that the
ServingEngine + PagePool manage: prefix sharing, PBM preemption, host
spill — the kernel never sees a contiguous cache.

  PYTHONPATH=src python examples/torch_serve_paged.py               # on the card
  PYTHONPATH=src python examples/torch_serve_paged.py --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import PagePool, Request, ServingEngine  # noqa: E402
from repro_torch.serving.model import PagedTinyLM, TinyConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="where the model decodes (default cuda)")
    args = ap.parse_args(argv)
    cfg = TinyConfig(n_pages=96, page_size=16)
    ops.reset_launch_counts()
    lm = PagedTinyLM(cfg, seed=0, device=args.device)
    pool = PagePool(n_pages=cfg.n_pages, page_size=cfg.page_size,
                    page_bytes=cfg.page_size * cfg.n_kv_heads * cfg.head_dim * 2 * 2)
    eng = ServingEngine(pool, lm.step_fn, policy="pbm", max_batch=4)

    rng = np.random.default_rng(0)
    system_prompt = list(rng.integers(0, cfg.vocab, 32))  # 2 shared pages
    for _ in range(6):
        eng.submit(Request(
            prompt=system_prompt + list(rng.integers(0, cfg.vocab, 4)),
            max_new_tokens=8,
        ))
    st = eng.run_to_completion(max_steps=500)
    print(f"served {len(eng.finished)} requests in {st.steps} engine steps")
    print(f"prefix pages shared: {st.shared_prefix_pages}  "
          f"preemptions: {st.preemptions}")
    for r in eng.finished[:3]:
        print(f"  req {r.rid}: generated {r.generated}")
    # determinism check: same prompts, same tokens
    lm2 = PagedTinyLM(cfg, seed=0, device=args.device)
    pool2 = PagePool(n_pages=cfg.n_pages, page_size=cfg.page_size,
                     page_bytes=pool.page_bytes)
    eng2 = ServingEngine(pool2, lm2.step_fn, policy="opt", max_batch=4)
    rng = np.random.default_rng(0)
    system_prompt = list(rng.integers(0, cfg.vocab, 32))
    for _ in range(6):
        eng2.submit(Request(
            prompt=system_prompt + list(rng.integers(0, cfg.vocab, 4)),
            max_new_tokens=8,
        ))
    eng2.run_to_completion(max_steps=500)
    same = all(
        a.generated == b.generated
        for a, b in zip(
            sorted(eng.finished, key=lambda r: r.rid),
            sorted(eng2.finished, key=lambda r: r.rid),
        )
    )
    print(f"tokens identical under a different eviction policy: {same} "
          f"(paging must never change results)")
    if lm.device.type == "cuda":
        print(f"paged attention kernel launches: "
              f"{ops.launch_counts()['paged_attention']}")


if __name__ == "__main__":
    main()
