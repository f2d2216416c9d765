"""Gradient compression for a slow all-reduce (port of
``repro.train.compression``).

int8 per-tensor-scaled quantisation with optional error feedback.
``compress_decompress`` is the stateless variant (quantisation noise acts
like gradient noise); ``ef_compress`` carries the quantisation residual to
the next step (error feedback — unbiased in the long run).  On one card
there is no collective to shrink: ``make_train_step(compress_grads=True)``
applies the round trip to the gradients before the optimizer, as the
reference does, so a run on one card sees the same numbers.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from .optimizer import tree_map


def _q8(g: torch.Tensor) -> torch.Tensor:
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q.float() * scale


def compress_decompress(grads: Any) -> Any:
    """Simulate int8-on-the-wire: quantise and dequantise every leaf."""
    return tree_map(_q8, grads)


def ef_compress(grads: Any, residual: Optional[Any]) -> Tuple[Any, Any]:
    """Error-feedback int8: ``(compressed grads, new residual)``."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)
    corrected = tree_map(lambda g, r: g.float() + r, grads, residual)
    q = tree_map(_q8, corrected)
    return q, tree_map(lambda c, x: c - x, corrected, q)
