"""B5-B7 counted, not run: the shape-only route of the dry run.

``launch/dryrun.py`` builds a cell's real step on the ``meta`` device
under ``torch.utils.flop_counter.FlopCounterMode``.  A meta tensor is
neither a CPU tensor (the plain version) nor a CUDA one (the kernel).
Inside :func:`card_route`, :mod:`.ops` sends it down the card's route with
the kernel replaced by a custom operator of this module: its meta
implementation only shapes the output, and the flop counter counts it
once, by the kernel's bound formula (:func:`work`, the formula of
``PERF.md`` §6), never by the plain version's arithmetic; the dry run's
``launch.counting.StepCounter`` counts its bytes the same way
(:func:`call_work`).  Under autograd
the card's route differentiates the plain version's VJP, recomputed
(``kernels.autograd``): those operators run on the card, and the counter
counts them as they are.  Outside :func:`card_route` a meta tensor stands
in for a CUDA one, as before: the kernel's wrapper refuses it.

Each stand-in returns a contiguous output, as the kernels do (their
fake implementations too, so the dry run's views and copies downstream
are the card's).  Inside :func:`card_route`, CPU tensors take the same
route, with the plain version as the operator's CPU implementation (what it computes is
not counted: a dispatch mode does not see the operators of a call it is
handling), so a step on real CPU tensors and the same step on meta count
the same operations.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

import torch

__all__ = ["KERNELS", "call_work", "card_route", "op", "takes_card_route",
           "work"]

#: the kernels on a model's path, each with a stand-in operator
KERNELS = ("flash_attention", "mamba2_scan", "mlstm_chunked")

_CARD_ROUTE = contextvars.ContextVar("repro_torch_card_route", default=False)
_OPS: Dict[str, object] = {}
#: each stand-in's argument names, the tensors first, and their count
_SIGNATURES: Dict[str, Tuple[Tuple[str, ...], int]] = {}


@contextlib.contextmanager
def card_route():
    """Meta and CPU tensors take the card's route of B5-B7, the kernel
    replaced by its counted stand-in (the dry run, and its test)."""
    token = _CARD_ROUTE.set(True)
    try:
        yield
    finally:
        _CARD_ROUTE.reset(token)


def takes_card_route(t: torch.Tensor) -> bool:
    """A meta or CPU tensor inside :func:`card_route`."""
    return t.device.type in ("meta", "cpu") and _CARD_ROUTE.get()


# analysis: host -- shape arithmetic, for the dry run and the bounds
def work(kernel: str, args, static) -> tuple:
    """``(operations, bytes)`` the least a call of ``kernel`` must do:
    every input read and the output written once; flash attention 4 B H dh
    flops per attended (query, key) pair (the causal half, the window),
    the scans 4 flops per (step, head, state element) of their recurrences
    (one multiply-add to update the element, one to read it out).  Only
    shapes and ``static`` are read, so meta tensors do."""
    nbytes = sum(t.numel() * t.element_size() for t in args)
    if kernel == "flash_attention":
        q, k, _v = args
        B, T, H, dh = q.shape
        S = k.shape[1]
        off = S - T if static.get("offset") is None else static["offset"]
        t = torch.arange(T, dtype=torch.int64)
        hi = (t + off + 1).clamp(0, S) if static.get("causal", True) \
            else torch.full_like(t, S)
        lo = torch.zeros_like(t)
        if static.get("window") is not None:
            lo = (t + off - static["window"] + 1).clamp(0, S)
        pairs = int((hi - lo).clamp(min=0).sum())
        ops = 4.0 * B * H * dh * pairs
        nbytes += q.numel() * q.element_size()
    elif kernel == "mamba2_scan":
        xh, _a, b, _c = args
        B, T, H, P = xh.shape
        ops = 4.0 * B * T * H * P * b.shape[-1]
        nbytes += xh.numel() * xh.element_size()
    elif kernel == "mlstm_chunked":
        q, _k, v, _a, _i = args
        B, T, H, K = q.shape
        ops = 4.0 * B * T * H * K * (v.shape[-1] + 1)
        nbytes += v.numel() * v.element_size()
    else:
        raise ValueError(f"work: no formula for {kernel!r}")
    return ops, nbytes


# analysis: host -- shape arithmetic, for the dry run's counters
def call_work(kernel: str, args, kwargs) -> tuple:
    """:func:`work` of one call of ``kernel``'s stand-in operator, from the
    arguments the operator was called with."""
    names, n_tensors = _SIGNATURES[kernel]
    bound = dict(zip(names, args))
    bound.update(kwargs)
    tensors = [bound[n] for n in names[:n_tensors]]
    static = {n: bound[n] for n in names[n_tensors:] if n in bound}
    return work(kernel, tensors, static)


def _define(kernel: str):
    from torch.utils.flop_counter import register_flop_formula

    from . import ref

    lib = f"repro_torch::{kernel}"
    if kernel == "flash_attention":
        @torch.library.custom_op(lib, mutates_args=())
        def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True, window: Optional[int] = None,
               offset: Optional[int] = None) -> torch.Tensor:
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           window=window,
                                           offset=offset).contiguous()

        @fn.register_fake
        def _(q, k, v, causal=True, window=None, offset=None):
            return q.new_empty(q.shape)
        names = ("q", "k", "v", "causal", "window", "offset")
    elif kernel == "mamba2_scan":
        @torch.library.custom_op(lib, mutates_args=())
        def fn(xh: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
            return ref.mamba2_scan_ref(xh, a, b, c).contiguous()

        @fn.register_fake
        def _(xh, a, b, c):
            return xh.new_empty(xh.shape)
        names = ("xh", "a", "b", "c")
    elif kernel == "mlstm_chunked":
        @torch.library.custom_op(lib, mutates_args=())
        def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
            return ref.mlstm_chunked_ref(q, k, v, a, i).contiguous()

        @fn.register_fake
        def _(q, k, v, a, i):
            return v.new_empty(v.shape)
        names = ("q", "k", "v", "a", "i")
    else:
        raise ValueError(f"accounting: {kernel!r} is not on a model's path")
    _SIGNATURES[kernel] = names, sum(
        1 for n in names if n in ("q", "k", "v", "xh", "a", "b", "c", "i"))

    @register_flop_formula(getattr(torch.ops.repro_torch, kernel),
                           get_raw=True)
    def _flops(*args, out_val=None, **kwargs):  # analysis: host -- counting
        return int(call_work(kernel, args, kwargs)[0])

    return fn


def op(kernel: str):
    """The custom operator that stands in for ``kernel`` on the card's
    route (defined at first use).  A ``FlopCounterMode`` reads the
    formulas registered when it is made: define every operator
    (``for k in KERNELS: op(k)``) before entering one."""
    fn = _OPS.get(kernel)
    if fn is None:
        fn = _OPS[kernel] = _define(kernel)
    return fn
