"""End-to-end training driver on one card (port of ``repro.launch.train``).

  python -m repro_torch.launch.train --arch qwen2_1_5b --seq 1024 \\
      --batch 8 --microbatches 4
  python -m repro_torch.launch.train --arch qwen2_1_5b --smoke --steps 50 \\
      --batch 8 --seq 256 --device cpu

Wires the PBM-cached multi-stream data pipeline (``repro_torch.data``),
the train step (``train.make_train_step``: gradient accumulation, remat
per config, AdamW in place), checkpoint save / restore with the exact
data-position resume, on one device.  The flags are the reference's, plus
``--device`` (default ``cuda``; the driver raises without a GPU unless
``--device cpu`` is given).  :func:`run` is the driver as a function: it
returns each step's loss, gradient norm and seconds, the cache's counters
and the final state, for the smoke script and the tests.

Weights are drawn by ``models.init_params`` from ``--seed`` (another
generator than the reference's).  The reference builds a device mesh
(``launch.mesh.make_local_mesh``) and its input shardings
(``launch.inputs.cell_shardings``); the port has both (the dry run prices
cells with them), and this driver runs on one card, which needs neither.
The reference's driver builds its mesh only to print its shape, so no
multi-card training driver is ported; the one mesh across processes the
port runs is the simulator's (``core.array_sim.init_mesh``, a
``torch.distributed`` DeviceMesh).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..core.array_sim.convert import resolve_device
from ..data import DataStream, DatasetSpec, HostPageCache, MultiStreamLoader
from ..models import build_model, init_params
from ..train.checkpoint import CheckpointManager
from ..train.optimizer import OptimizerConfig, init_opt_state
from ..train.train_step import make_train_step


def run(arch: str = "qwen2_1_5b", smoke: bool = False, steps: int = 50,
        batch: int = 8, seq: int = 256, lr: float = 3e-4,
        microbatches: int = 1, checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 25, resume: bool = False,
        cache_policy: str = "pbm", seed: int = 0, log_every: int = 10,
        device="cuda", log: Optional[Callable[[str], None]] = print) -> dict:
    """Train ``arch`` for ``steps`` steps (from the checkpoint's step with
    ``resume``): ``{"losses", "grad_norms", "step_s", "step0", "cache":
    {"hits", "misses", "miss_bytes"}, "data", "params", "opt_state"}``.
    ``step_s`` is each step's wall time: its batch from the pipeline and
    the train step, the device synchronised at both ends."""
    dev = resolve_device(device)
    say = log or (lambda _msg: None)
    cfg = get_config(arch, smoke=smoke)
    if cfg.family in ("vlm", "audio"):
        say(f"note: {arch} uses a stub frontend; training on text side")
    model = build_model(cfg)
    say(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M device={dev}")

    # ---- data pipeline (PBM host cache) -----------------------------------
    spec = DatasetSpec(n_shards=8, pages_per_shard=32,
                       vocab_size=cfg.vocab_size)
    cache = HostPageCache(spec, capacity_pages=64, policy=cache_policy)
    loader = MultiStreamLoader(cache)
    train_stream = DataStream(cache, list(range(spec.n_shards)), batch,
                              seq + 1, name="train")
    loader.add_stream(train_stream)

    # ---- params / optimizer ------------------------------------------------
    params = init_params(model.param_specs, seed, torch.float32, dev)
    opt_cfg = OptimizerConfig(learning_rate=lr, warmup_steps=20,
                              total_steps=steps)
    opt_state = init_opt_state(params)
    step0 = 0

    ckpt = CheckpointManager(checkpoint_dir) if checkpoint_dir else None
    if ckpt and resume and ckpt.latest_step() is not None:
        step0, params, opt_state, extra = ckpt.restore(None, params,
                                                       opt_state)
        if "data" in extra:
            train_stream.load_state_dict(extra["data"])
        say(f"resumed from step {step0}")

    train_step = make_train_step(model, opt_cfg, microbatches=microbatches)

    # ---- loop --------------------------------------------------------------
    losses, gnorms, step_s = [], [], []
    t_start = time.time()
    for step in range(step0, steps):
        _sync(dev)
        t0 = time.perf_counter()
        toks = loader.next_round()["train"]
        params, opt_state, metrics = train_step(
            params, opt_state, _make_batch(cfg, toks, seq, dev))
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        _sync(dev)
        step_s.append(time.perf_counter() - t0)
        if step % log_every == 0 or step == steps - 1:
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {gnorms[-1]:.3f} "
                f"cache miss/hit {cache.miss_pages}/{cache.hit_pages} "
                f"({time.time() - t_start:.1f}s)")
        if ckpt and (step + 1) % checkpoint_every == 0:
            ckpt.save(step + 1, params, opt_state,
                      extra={"data": train_stream.state_dict()}, async_=True)
    if ckpt:
        ckpt.wait()
    if losses:
        first, last = losses[0], float(np.mean(losses[-5:]))
        say(f"done: loss {first:.4f} -> {last:.4f} "
            f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return {"losses": losses, "grad_norms": gnorms, "step_s": step_s,
            "step0": step0,
            "cache": {"hits": cache.hit_pages, "misses": cache.miss_pages,
                      "miss_bytes": cache.miss_bytes},
            "data": train_stream.state_dict(), "params": params,
            "opt_state": opt_state}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _make_batch(cfg, toks: np.ndarray, seq: int, device):
    """The model's batch from a ``(B, seq + 1)`` block of the stream: the
    first ``seq`` tokens (modulo the padded vocabulary); the vision stub's
    zero patch embeddings before ``max(8, seq - patches)`` of them, the
    encoder-decoder's zero frame embeddings (``seq`` of them) beside
    them."""
    tokens = torch.from_numpy(
        (toks[:, : seq + 1][:, :-1] % cfg.padded_vocab).astype(np.int32)
    ).to(device)
    b = tokens.shape[0]
    if cfg.family == "vlm":
        p = cfg.frontend_tokens
        return {
            "tokens": tokens[:, : max(8, seq - p)],
            "patch_embeds": torch.zeros((b, p, cfg.d_model),
                                        dtype=torch.float32, device=device),
        }
    if cfg.is_encdec:
        return {
            "src_embeds": torch.zeros((b, seq, cfg.d_model),
                                      dtype=torch.float32, device=device),
            "tgt_tokens": tokens,
        }
    return {"tokens": tokens}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen2_1_5b")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--cache-policy", choices=["lru", "pbm", "opt"],
                    default="pbm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(arch=args.arch, smoke=args.smoke, steps=args.steps,
               batch=args.batch, seq=args.seq, lr=args.lr,
               microbatches=args.microbatches,
               checkpoint_dir=args.checkpoint_dir,
               checkpoint_every=args.checkpoint_every, resume=args.resume,
               cache_policy=args.cache_policy, seed=args.seed,
               log_every=args.log_every, device=args.device)


if __name__ == "__main__":
    main()
