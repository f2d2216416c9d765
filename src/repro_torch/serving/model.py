"""PagedTinyLM: a small decoder LM that decodes *through* the page pool.

The port of ``repro.serving.model``: integration glue between the three
layers of the serving stack — ``kernels.ops.paged_attention`` (compute) <-
page tables from ``kv_cache`` (policy-managed pool) <- scheduled by
``engine`` (continuous batching).

The block is the JAX model's, line for line: embedding, then per layer
``x += paged_attention(x Wq; K/V pages) Wo`` and
``x += gelu(x W1) W2``, logits ``x embed^T``.  No RoPE, no norms, no
biases; the GELU is the tanh approximation (``jax.nn.gelu``'s default).
One request at a time, one token at a time, B = 1 per kernel launch, as
the reference does.

* Weights keep the JAX layout ``(in, out)``, so ``x @ W`` reads the same,
  and are drawn from ``np.random.default_rng(seed).normal(0, 0.05, ...)``
  in the JAX model's order, so the same seed gives the same weights in
  both packages; :meth:`PagedTinyLM.load_jax_params` carries a JAX
  model's ``params`` across as numpy arrays.
* K/V pools are one ``(n_pages, page_size, Hk, dh)`` f32 tensor per layer
  on the model's device; a token's K/V is written in place.
* Float32 matrix products on the card must run in full f32
  (``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default);
  the entry point ``repro_torch.launch.serve`` sets it so.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.array_sim.convert import resolve_device
from ..kernels import ops
from .engine import Request

#: per-layer weight names, in the order the JAX model draws them
LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w1", "w2")


@dataclass
class TinyConfig:
    vocab: int = 512
    d_model: int = 64
    n_layers: int = 2
    n_heads: int = 2
    n_kv_heads: int = 1
    head_dim: int = 128
    page_size: int = 16
    n_pages: int = 128

    def layer_shapes(self) -> Dict[str, tuple]:
        d, h, hk, dh = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        return {"wq": (d, h * dh), "wk": (d, hk * dh), "wv": (d, hk * dh),
                "wo": (h * dh, d), "w1": (d, 4 * d), "w2": (4 * d, d)}


class _Layer(nn.Module):
    def __init__(self, weights: Dict[str, torch.Tensor]):
        super().__init__()
        for name in LAYER_WEIGHTS:
            setattr(self, name, nn.Parameter(weights[name],
                                             requires_grad=False))


class PagedTinyLM(nn.Module):
    def __init__(self, cfg: TinyConfig, seed: int = 0, device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        shapes = cfg.layer_shapes()

        def s(*sh):
            return self._tensor(rng.normal(0, 0.05, sh))

        self.embed = nn.Parameter(s(cfg.vocab, cfg.d_model),
                                  requires_grad=False)
        self.layers = nn.ModuleList([
            _Layer({name: s(*shapes[name]) for name in LAYER_WEIGHTS})
            for _ in range(cfg.n_layers)
        ])
        # the physical page pool tensors, one per layer
        pool = (cfg.n_pages, cfg.page_size, cfg.n_kv_heads, cfg.head_dim)
        self.k_pages = [torch.zeros(pool, device=self.device)
                        for _ in range(cfg.n_layers)]
        self.v_pages = [torch.zeros(pool, device=self.device)
                        for _ in range(cfg.n_layers)]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(a, np.float32)).to(self.device)

    def load_jax_params(self, params: Dict) -> None:
        """Carry a JAX ``PagedTinyLM``'s weights across: ``params`` as
        numpy arrays, ``{"embed", "layers": [{"wq", "wk", "wv", "wo",
        "w1", "w2"}, ...]}``, in the same ``(in, out)`` layout."""
        if len(params["layers"]) != len(self.layers):
            raise ValueError(f"{len(params['layers'])} layers given, the "
                             f"model has {len(self.layers)}")
        with torch.no_grad():
            self.embed.copy_(self._tensor(params["embed"]))
            for layer, lp in zip(self.layers, params["layers"]):
                for name in LAYER_WEIGHTS:
                    getattr(layer, name).copy_(self._tensor(lp[name]))

    # ------------------------------------------------------------- helpers
    def _write_kv(self, layer: int, page_id: int, slot: int, k, v) -> None:
        self.k_pages[layer][page_id, slot] = k
        self.v_pages[layer][page_id, slot] = v

    @torch.no_grad()
    def _forward_token(
        self, token: int, kv_pages: List[int], pos: int, write: bool = True
    ) -> torch.Tensor:
        cfg = self.cfg
        if min(kv_pages) < 0 or max(kv_pages) >= cfg.n_pages:
            raise ValueError(f"page ids {kv_pages} outside the model's pool "
                             f"of {cfg.n_pages} pages")
        x = self.embed[token][None]                     # (1, d)
        page = kv_pages[pos // cfg.page_size]
        slot = pos % cfg.page_size
        pt = torch.tensor([kv_pages], dtype=torch.int32, device=self.device)
        sl = torch.tensor([pos + 1], dtype=torch.int32, device=self.device)
        for li, lp in enumerate(self.layers):
            q = (x @ lp.wq).reshape(cfg.n_heads, cfg.head_dim)
            k = (x @ lp.wk).reshape(cfg.n_kv_heads, cfg.head_dim)
            v = (x @ lp.wv).reshape(cfg.n_kv_heads, cfg.head_dim)
            if write:
                self._write_kv(li, page, slot, k, v)
            att = ops.paged_attention(
                q[None], self.k_pages[li], self.v_pages[li], pt, sl
            )[0]                                        # (H, dh)
            x = x + att.reshape(1, -1) @ lp.wo
            x = x + F.gelu(x @ lp.w1, approximate="tanh") @ lp.w2
        logits = x @ self.embed.T
        return logits[0]

    # ------------------------------------------------------- engine step_fn
    def prefill(self, req: Request) -> None:
        for i, tok in enumerate(req.prompt):
            self._forward_token(int(tok), req.kv.pages, i)

    def step_fn(self, reqs: Sequence[Request]) -> List[int]:
        out = []
        for req in reqs:
            if req.last_decode_step < 0:
                self.prefill(req)
                last_tok = req.prompt[-1]
            else:
                last_tok = req.generated[-1]
            pos = req.kv.length - 1   # slot already reserved by the engine
            logits = self._forward_token(int(last_tok), req.kv.pages, pos)
            out.append(int(torch.argmax(logits)))
        return out
