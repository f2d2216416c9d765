"""Autograd for the model-stack kernels B5-B7: the hand-written kernel in
the forward, the plain version's VJP, recomputed from the saved inputs, in
the backward.

None of the JAX package's Pallas kernels has a backward: its models train
by differentiating their jnp paths, and ``jax.checkpoint`` (``_remat``)
trades memory for a second forward.  The port keeps its kernels on the
training path the same way.  :class:`RecomputeVJP` runs ``forward`` (the
kernel's wrapper on the card) on the inputs and saves them; its backward
runs ``plain`` (``ref.flash_attention_ref``, ``ref.mamba2_scan_ref``,
``ref.mlstm_chunked_ref``) again under ``torch.enable_grad()`` on detached
copies of the inputs and returns ``torch.autograd.grad(out, inputs,
grad_out)``.  The gradient is the plain version's at the same inputs; the
forward's value is the kernel's, held to the plain version's within the
kernel's tolerance on the card.  Static arguments (causal, window,
offset) get no gradient.  Backward kernels are later work.

Every backward adds one to :data:`RECOMPUTES` under the kernel's name
(``ops.recompute_counts``) and runs inside a ``torch.profiler`` range
``recompute_vjp/<name>``, so a trace tells the backward's device time.
``forward`` is an argument, so the tests run the same Function on the CPU
with the plain version as its forward.
:mod:`.ops` sends a CUDA call through here only when grad mode is on and
an input requires grad; a CPU call takes the plain version, which autograd
differentiates directly.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
from torch.autograd.function import once_differentiable

#: backward recomputes of each kernel's plain version since the last reset
RECOMPUTES: Dict[str, int] = {"flash_attention": 0, "mamba2_scan": 0,
                              "mlstm_chunked": 0}


class RecomputeVJP(torch.autograd.Function):
    """``forward(*inputs, **static)`` in the forward; the VJP of
    ``plain(*inputs, **static)``, recomputed, in the backward."""

    @staticmethod
    def forward(ctx, name: str, forward: Callable, plain: Callable,
                static: dict, *inputs):
        ctx.name, ctx.plain, ctx.static = name, plain, static
        ctx.save_for_backward(*inputs)
        return forward(*inputs, **static)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        need = ctx.needs_input_grad[4:]
        RECOMPUTES[ctx.name] += 1
        with torch.profiler.record_function(f"recompute_vjp/{ctx.name}"), \
                torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*xs, **ctx.static)
            got = iter(torch.autograd.grad(
                out, [x for x, n in zip(xs, need) if n], grad_out))
        return (None, None, None, None,
                *(next(got) if n else None for n in need))


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record a call on ``tensors``."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def recompute_vjp(name: str, forward: Callable, plain: Callable,
                  inputs: Sequence[torch.Tensor], static: dict):
    """``forward(*inputs, **static)``, differentiated as ``plain``'s VJP
    recomputed (:class:`RecomputeVJP`); ``name`` keys :data:`RECOMPUTES`."""
    return RecomputeVJP.apply(name, forward, plain, static, *inputs)
