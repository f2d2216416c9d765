"""AdamW with global-norm clipping and a warmup-cosine schedule (port of
``repro.train.optimizer``).

Moments are kept in f32 whatever the parameter dtype, as in the reference;
every scalar of the update (the learning rate, ``b1 ** step``, the cosine,
the clip scale) is an f32 tensor, computed in the reference's order.
:func:`adamw_update` updates ``params`` and the state **in place** under
``torch.no_grad()`` and returns the same trees: the counterpart of the
reference's ``jax.jit(..., donate_argnums=(0, 1))`` in
``launch/train.py``, and the convention of the port's ``serve_step``.

Trees are nested dicts of tensors, walked with ``models.layers.tree_paths``
/ ``unflatten``.  :func:`leaves` takes them in the order
``jax.tree.leaves`` does (dict keys sorted), so :func:`global_norm` sums
its f32 squares in the reference's order.  For the dry run,
:func:`abstract_opt_state` gives the state as ``meta`` tensors and
:func:`opt_state_shardings` its spec tree, as the reference's do.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..models.layers import tree_paths, unflatten

@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor    # () int32
    mu: Any               # f32 tree like params
    nu: Any               # f32 tree like params


def abstract_opt_state(params: Any) -> OptState:
    """The state of ``params`` (a tree of tensors, ``meta`` ones included)
    as ``meta`` tensors: a () int32 step and f32 moments."""
    def z(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    flat = tree_paths(params)
    return OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=unflatten({k: z(p) for k, p in flat.items()}),
        nu=unflatten({k: z(p) for k, p in flat.items()}))


def opt_state_shardings(param_specs_tree: Any) -> OptState:
    """The spec tree of :class:`OptState` given the params' spec tree."""
    return OptState(step=(), mu=param_specs_tree,
                    nu=unflatten(dict(tree_paths(param_specs_tree))))


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict in ``jax.tree.leaves`` order: sorted
    paths are sorted keys level by level, since ``/`` sorts below every
    character of the port's keys (letters, digits, ``_``)."""
    return [v for _, v in sorted(tree_paths(tree).items())]


def from_leaves(template: Any, flat: List[torch.Tensor]) -> Any:
    """The tree shaped like ``template`` whose leaves, in :func:`leaves`
    order, are ``flat``."""
    return unflatten(dict(zip(sorted(tree_paths(template)), flat)))


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and of the trees ``rest`` of the
    same structure), keeping its dicts."""
    others = [tree_paths(r) for r in rest]
    return unflatten({path: fn(x, *(o[path] for o in others))
                      for path, x in tree_paths(tree).items()})


def init_opt_state(params: Any) -> OptState:
    def zeros():
        return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
    dev = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros(), nu=zeros())


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d tensor), in f32."""
    dev = step.device
    step_f = step.float()
    warm = cfg.learning_rate * torch.minimum(
        _f32(1.0, dev), (step_f + 1) / max(1, cfg.warmup_steps))
    frac = torch.clamp(
        (step_f - cfg.warmup_steps) / max(1, cfg.total_steps
                                          - cfg.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(_f32(math.pi, dev) * frac))
    return torch.where(step_f < cfg.warmup_steps, warm,
                       cfg.learning_rate * cos)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares, summed in
    ``jax.tree.leaves`` order."""
    total = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: OptState
                 ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One clipped AdamW step, in place: ``(params, state, {"grad_norm",
    "lr"})`` with the same trees and tensors as given."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.minimum(_f32(1.0, dev), cfg.clip_norm
                          / torch.clamp(gnorm, min=1e-9))
    lr = lr_at(cfg, state.step)
    state.step.add_(1)
    step_f = state.step.float()
    b1c = 1.0 - torch.pow(_f32(cfg.b1, dev), step_f)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, dev), step_f)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.mu),
                          leaves(state.nu)):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
    return params, state, {"grad_norm": gnorm, "lr": lr}
