"""State carried across: numpy <-> the port's device tensors.

* :func:`resolve_device` — the one place an entry point's ``device``
  argument is checked: ``"cuda"`` (the default everywhere) raises when
  there is no GPU; the CPU is used only when the caller asks for it.
* :func:`spec_to_torch` — the numpy fields of a :class:`SimSpec` as
  device tensors (indices as int64, the rest in their own width).
* :func:`carry_from_numpy` / :func:`carry_to_numpy` (and the ``state_*``
  pair for a bare :class:`SimState`) — turn a runner's carry of the JAX
  package (the horizon stepper's ``(state, view, win, adv_lim, pend, rem,
  next_h)`` or the fixed stepper's ``(state, view)``), given as numpy
  arrays with or without a leading lane axis, into the port's
  ``(L, ...)`` carry and back, policy-private state included (PBM's
  bucket array, OPT's cached key, array-CScan's ``CoopState``).  Any
  object with the same field names works; nothing of the JAX package is
  imported.  The parity tests use this to start both packages from the
  same mid-run state.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .spec import SimSpec

#: leaves the port keeps as int64 because it indexes with them; the JAX
#: package keeps them as int32
_INDEX_FIELDS = frozenset({"qidx", "frontier", "fpidx", "cur_chunk",
                           "inflight"})


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there:
    an entry point called without ``device`` on a machine without a GPU
    raises instead of carrying on on the CPU."""
    dev = device if isinstance(device, torch.device) else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type == "cuda" and dev.index is None:
        # name the card, so that devices compare equal to a tensor's
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class TorchSpec(NamedTuple):
    """The array fields of a :class:`SimSpec` on a device."""

    page_size: torch.Tensor    # (P,) f32
    page_first: torch.Tensor   # (P,) f32
    page_last: torch.Tensor    # (P,) f32
    page_col: torch.Tensor     # (P,) i64
    page_valid: torch.Tensor   # (P,) bool
    col_start: torch.Tensor    # (C,) i64
    col_npages: torch.Tensor   # (C,) i64
    col_tpp: torch.Tensor      # (C,) f32
    q_start: torch.Tensor      # (S, Q) f32
    q_len: torch.Tensor        # (S, Q) f32
    q_rate: torch.Tensor       # (S, Q) f32
    q_cols: torch.Tensor       # (S, Q, C) bool
    n_q: torch.Tensor          # (S,) i64


def spec_to_torch(spec: SimSpec, device="cuda") -> TorchSpec:
    dev = resolve_device(device)

    def to(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=dev, dtype=dtype)

    f32, i64 = torch.float32, torch.int64
    return TorchSpec(
        page_size=to(spec.page_size, f32),
        page_first=to(spec.page_first, f32),
        page_last=to(spec.page_last, f32),
        page_col=to(spec.page_col, i64),
        page_valid=to(spec.page_valid, torch.bool),
        col_start=to(spec.col_start, i64),
        col_npages=to(spec.col_npages, i64),
        col_tpp=to(spec.col_tpp, f32),
        q_start=to(spec.q_start, f32),
        q_len=to(spec.q_len, f32),
        q_rate=to(spec.q_rate, f32),
        q_cols=to(spec.q_cols, torch.bool),
        n_q=to(spec.n_q, i64),
    )


def _leaf_in(x, device, add_lane: bool, index: bool = False) -> torch.Tensor:
    a = np.array(x, order="C")      # a writable copy; keeps 0-d arrays 0-d
    if a.dtype.kind == "b":
        dtype = torch.bool
    elif a.dtype.kind in "iu":
        dtype = torch.int64 if index else torch.int32
    else:
        dtype = torch.float32
    t = torch.as_tensor(a).to(dtype)
    if add_lane:
        t = t.unsqueeze(0)
    return t.contiguous().to(device)


def _leaf_out(t: torch.Tensor, drop_lane: bool) -> np.ndarray:
    a = t.detach().cpu().numpy()
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    return a[0] if drop_lane else a


def _tree_in(x, device, add_lane, index=False):
    if type(x).__name__ == "CoopState":    # array-CScan's policy state
        from .coop import CoopState
        return _fields_in(CoopState, x, device, add_lane)
    if isinstance(x, (tuple, list)):
        return tuple(_tree_in(v, device, add_lane, index) for v in x)
    return _leaf_in(x, device, add_lane, index)


def _tree_out(x, drop_lane):
    if hasattr(x, "_fields"):
        return type(x)(*(_tree_out(v, drop_lane) for v in x))
    if isinstance(x, tuple):
        return tuple(_tree_out(v, drop_lane) for v in x)
    return _leaf_out(x, drop_lane)


def _fields_in(cls, obj, device, add_lane):
    return cls(*(
        _tree_in(getattr(obj, f), device, add_lane, f in _INDEX_FIELDS)
        for f in cls._fields
    ))


def state_from_numpy(state, device="cuda"):
    """A ``SimState`` of numpy arrays (the JAX package's field names; one
    lane without a lane axis, or ``(L, ...)`` leaves) as the port's
    :class:`~repro_torch.core.array_sim.sim.SimState`."""
    from .sim import SimState

    dev = resolve_device(device)
    add_lane = np.asarray(state.t).ndim == 0
    return _fields_in(SimState, state, dev, add_lane)


def state_to_numpy(state, drop_lane: bool = False):
    """The port's state as a ``SimState`` of numpy arrays in the JAX
    package's dtypes (index leaves back to int32)."""
    return type(state)(*(_tree_out(v, drop_lane) for v in state))


def carry_from_numpy(carry, device="cuda"):
    """A carry of numpy arrays as the port's carry: the horizon
    stepper's ``(state, view, win, adv_lim, pend, rem, next_h)`` or the
    fixed stepper's ``(state, view)``."""
    from .sim import _View

    dev = resolve_device(device)
    state, view, *rest = carry
    add_lane = np.asarray(state.t).ndim == 0
    head = (state_from_numpy(state, dev),
            _fields_in(_View, view, dev, add_lane))
    if not rest:
        return head
    win, adv_lim, pend, rem, next_h = rest
    w_pidx, w_trig, w_need, w_dist = win
    return (
        *head,
        (_leaf_in(w_pidx, dev, add_lane, index=True),
         _leaf_in(w_trig, dev, add_lane),
         _leaf_in(w_need, dev, add_lane),
         _leaf_in(w_dist, dev, add_lane)),
        _leaf_in(adv_lim, dev, add_lane),
        _leaf_in(pend, dev, add_lane),
        _leaf_in(rem, dev, add_lane),
        _leaf_in(next_h, dev, add_lane),
    )


def carry_to_numpy(carry, drop_lane: bool = False):
    """The port's carry as nested tuples of numpy arrays (NamedTuples
    kept), index leaves back to int32."""
    state, view, *rest = carry
    return (
        state_to_numpy(state, drop_lane),
        type(view)(*(_leaf_out(v, drop_lane) for v in view)),
        *(_tree_out(v, drop_lane) for v in rest),
    )
