"""Train-step factory: loss -> grads -> (compression) -> clip -> AdamW, with
optional microbatch gradient accumulation (port of
``repro.train.train_step``).

Gradients come from ``torch.autograd.grad`` of ``model.train_loss`` with
respect to every leaf of the params tree.  With ``microbatches > 1`` the
batch's leading axis is split into that many equal parts and each part's
gradient is added as ``g / microbatches`` in f32, in order, as the
reference's ``lax.scan`` does; the reported loss is the mean of the parts'
losses, accumulated the same way.  The gradients then pass
``models.shardctx.sync_grads`` (on one card, the identity; the dry run
reads it as the step's gradient synchronisation).

The step updates ``params`` and ``opt_state`` **in place** (under
``torch.no_grad()``) and returns the same trees: the counterpart of the
reference driver's ``jax.jit(train_step, donate_argnums=(0, 1))``, and the
convention of the port's ``serve_step``.  The loss is taken on detached
views of the parameters, so the caller's tensors need not require grad.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from ..models import shardctx
from ..models.transformer import Model
from .compression import compress_decompress
from .optimizer import (
    OptimizerConfig, OptState, adamw_update, from_leaves, leaves, tree_map,
)


def _split(batch: Dict[str, torch.Tensor], n: int) -> List[Dict]:
    """``n`` microbatches of the leading axis of every batch tensor."""
    for x in batch.values():
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                             f"into {n} microbatches")
    parts = {k: torch.chunk(v, n, dim=0) for k, v in batch.items()}
    return [{k: parts[k][i] for k in batch} for i in range(n)]


def make_train_step(
    model: Model,
    opt_cfg: OptimizerConfig,
    microbatches: int = 1,
    compress_grads: bool = False,
) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``metrics`` holds ``loss`` (and the model's other metrics
    without accumulation), ``grad_norm`` and ``lr`` as 0-d tensors."""

    def grads_of(params, batch) -> Tuple[torch.Tensor, Dict, List]:
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        flat = leaves(live)
        loss, metrics = model.train_loss(live, batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def accumulate(params, batch):
        if microbatches <= 1:
            return grads_of(params, batch)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves(params)]
        loss_acc = torch.zeros((), dtype=torch.float32,
                               device=acc[0].device)
        for mbatch in _split(batch, microbatches):
            loss, _, grads = grads_of(params, mbatch)
            for a, g in zip(acc, grads):
                a.add_(g.float() / microbatches)
            loss_acc = loss_acc + loss / microbatches
        return loss_acc, {"loss": loss_acc}, acc

    def train_step(params, opt_state: OptState, batch):
        loss, metrics, flat_grads = accumulate(params, batch)
        flat_grads = shardctx.sync_grads(leaves(params), flat_grads)
        grads = from_leaves(params, flat_grads)
        if compress_grads:
            grads = compress_decompress(grads)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, params, grads, opt_state)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step
