"""Serving driver: batched requests through the paged-KV engine.

  python -m repro_torch.launch.serve --requests 16 --policy pbm
  python -m repro_torch.launch.serve --real-model --device cpu

The port of ``repro.launch.serve``: runs the continuous-batching engine
over an oversubscribed page pool with a shared system prompt, with the
same arguments and the same prints.  ``--real-model`` decodes through
``PagedTinyLM`` and the paged-attention kernel (its plain version on the
CPU) instead of the fast stub.  The device defaults to ``cuda`` and the
driver raises without a GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import policy_registry
from repro_torch.core.array_sim.convert import resolve_device
from repro_torch.serving import PagePool, Request, ServingEngine
from repro_torch.serving.model import PagedTinyLM, TinyConfig


def page_bytes(page_size: int, cfg: Optional[TinyConfig] = None) -> int:
    """Bytes one page moves on a swap, as ``repro.launch.serve`` counts
    them: K and V of ``page_size`` tokens in 2-byte elements, over the
    model's KV heads (the stub's: 8 heads of 128)."""
    hk, dh = (8, 128) if cfg is None else (cfg.n_kv_heads, cfg.head_dim)
    return page_size * hk * dh * 2 * 2


def stub_step_fn(reqs: Sequence[Request]) -> List[int]:
    """Token generation without a model (``repro.launch.serve``'s stub)."""
    return [int((r.kv.length * 0x9E3779B1) % 50000) for r in reqs]


def make_engine(policy: str, pool_pages: int, page_size: int, max_batch: int,
                step_fn: Callable, cfg: Optional[TinyConfig] = None,
                ) -> ServingEngine:
    """The engine :func:`main` runs: a pool of ``pool_pages`` pages and
    ``step_fn`` (the stub, or a ``PagedTinyLM``'s whose config is
    ``cfg``)."""
    pool = PagePool(pool_pages, page_size, page_bytes(page_size, cfg))
    return ServingEngine(pool, step_fn, policy=policy, max_batch=max_batch)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=48)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--policy", default="pbm",
                    choices=policy_registry.names(backend="serving"))
    ap.add_argument("--prefix-len", type=int, default=64)
    ap.add_argument("--real-model", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # full-f32 matrix products on the card (PyTorch's default, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(args.seed)
    cfg = None
    step_fn = stub_step_fn
    if args.real_model:
        cfg = TinyConfig(n_pages=args.pool_pages, page_size=args.page_size)
        step_fn = PagedTinyLM(cfg, seed=args.seed, device=device).step_fn

    eng = make_engine(args.policy, args.pool_pages, args.page_size,
                      args.max_batch, step_fn, cfg)
    prefix = list(rng.integers(0, 100, args.prefix_len))
    for _ in range(args.requests):
        eng.submit(Request(
            prompt=prefix + list(rng.integers(0, 100, 8)),
            max_new_tokens=int(rng.integers(16, 96)),
        ))
    st = eng.run_to_completion(max_steps=50_000)
    print(f"policy={args.policy} served={len(eng.finished)} steps={st.steps} "
          f"tokens={st.tokens_generated} tok/step={st.tokens_generated/max(1,st.steps):.2f}")
    print(f"prefix_shared_pages={st.shared_prefix_pages} "
          f"preemptions={st.preemptions} "
          f"swap={(st.swap_out_bytes + st.swap_in_bytes)/1e6:.2f}MB")


if __name__ == "__main__":
    main()
