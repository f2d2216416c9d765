"""The dry run on the ``meta`` device: every (arch x shape) cell priced for
one card, without a card (port of ``repro.launch.dryrun``).

For each cell of ``configs.SHAPES`` x ``ARCH_IDS`` that ``cell_is_skipped``
keeps, this builds the cell's *real* step on the meta device — the train
step (``train.make_train_step``: ``train_loss`` forward and backward and
AdamW's update) for train shapes, the prefill forward for prefill shapes,
``serve_step`` against a full-length cache for decode shapes — and runs it
under ``torch.utils.flop_counter.FlopCounterMode`` and the dry run's
counter (``launch.counting``).  No parameter, state or cache is
allocated, no process group is made and no card is needed.  It records:

* ``flops``: the operations of the step.  B5-B7 are counted once each, by
  the kernel's bound formula (``kernels.accounting``: flash attention 4 H
  dh flops per attended pair, the scans 4 flops per state element a
  step), never by their plain versions' arithmetic; under autograd the
  plain version's VJP, which the card recomputes in the backward, is
  counted as the operators it runs;
* ``bytes``: parameters (bf16, as the JAX package's dry run), gradients,
  optimizer state (f32 moments), cache and inputs, their sum (``total``);
  ``activations_peak``, the most bytes the step holds at once beyond the
  params, optimizer state, cache and inputs (its gradients included:
  the step makes them), and ``peak``, those plus ``activations_peak``;
  the cell's ``status`` is ``ok``, ``skipped`` or ``does_not_fit``
  (``peak`` above the card's 80 GB);
* ``bytes_accessed``: every operator's inputs read and output written
  once (B5-B7 by ``accounting.work``'s bytes), eager PyTorch's traffic;
* ``per_card``: under the reference's pod (16 x 16) and multi-pod
  (2 x 16 x 16) meshes' sharding rules, the bytes per card as arithmetic
  (each leaf divided by the product of the mesh axes its spec names), the
  step's ``collective_bytes`` per card by kind (all-gather, all-reduce,
  reduce-scatter, all-to-all, collective-permute: each collective's
  result bytes, the JAX dry run's convention) and their
  ``collective_total``, the per-card ``activations`` (the counterpart of
  JAX's ``memory.temp_size``) and ``peak``;
* ``counted``: ``"whole_step"``: every layer, microbatch and recompute
  is counted as it runs, so no loop body is counted once and no probe is
  needed.

The three counts come from the step itself: ``launch.counting.StepCounter``
(a ``TorchDispatchMode``, its rules in its docstring) runs beside
``FlopCounterMode`` and reads the models' resharding hooks
(``models.shardctx``).

One place of the models reads data on the host, and is named here, not
worked around with a real tensor (``DATA_DEPENDENT``): ``serve_step``
reads the decode position (``models.transformer._pos``:
``int(batch["pos"])``), so a decode cell passes ``pos`` as the Python int
``seq_len - 1`` beside the meta stand-in of ``launch.inputs``.  Nothing
else in the ten archs' steps (the MoE dispatch included) needs data on
meta.

Records go to ``experiments/dryrun_torch/<arch>__<shape>.json`` (ignored
by git); the JAX package's ``experiments/dryrun/`` is not touched.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_1_5b \\
      --shape train_4k
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Iterable, List, Optional, Sequence

import torch

from ..configs import ARCH_IDS, SHAPES, ShapeConfig, cell_is_skipped, get_config
from ..configs.base import mesh_rules
from ..kernels import accounting
from ..models import abstract_params, build_model
from ..models import shardctx
from ..models.layers import (
    mesh_sizes, param_shardings, tree_paths, unflatten,
)
from ..train.optimizer import (
    OptimizerConfig, abstract_opt_state, init_opt_state, opt_state_shardings,
)
from ..train.train_step import make_train_step
from .inputs import (
    batch_shardings, cache_shardings, cell_mode, input_specs,
)
from .counting import MeshPlan, StepCounter
from .mesh import MeshShape, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")
#: one H100's device memory
CARD_BYTES = 80e9
#: the places of the models that read data on the host, by cell kind
DATA_DEPENDENT = {
    "decode": "models.transformer._pos: int(batch['pos']) — the decode "
              "position is a host int (passed as seq_len - 1)",
}
PARAM_DTYPE = torch.bfloat16
#: the meshes each cell is priced under: the reference's pod and multi-pod
MESHES = {"pod": make_production_mesh(),
          "multipod": make_production_mesh(multi_pod=True)}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_paths(tree).values() if torch.is_tensor(t))


def _per_card(tree, specs, sizes: Dict[str, int]) -> float:
    """Bytes per card of ``tree`` sharded by ``specs`` over a mesh of
    ``sizes``: each leaf over the product of the axes its spec names."""
    specs = tree_paths(specs)
    total = 0.0
    for path, t in tree_paths(tree).items():
        ways = 1
        for axis in specs.get(path, ()) or ():
            if axis is None:
                continue
            for a in ((axis,) if isinstance(axis, str) else axis):
                ways *= sizes.get(a, 1)
        total += t.numel() * t.element_size() / ways
    return total


def _meta_cache(model, shape: ShapeConfig):
    specs = model.cache_specs(shape.global_batch, shape.seq_len)
    return unflatten({path: torch.empty(s.shape, dtype=s.dtype,
                                        device="meta")
                      for path, s in tree_paths(specs).items()})


def step_of(cfg, shape: ShapeConfig, params, batch, cache=None,
            microbatches: int = 1):
    """The cell's step as a function of no arguments, and what it holds
    beside the params: ``(fn, {"grads": ..., "opt_state": ...})``.  The
    tensors may be meta or real (the test runs the same step on CPU
    tensors)."""
    model = build_model(cfg)
    extra: Dict[str, Any] = {}
    if shape.kind == "train":
        meta = next(iter(tree_paths(params).values())).device.type == "meta"
        opt_state = (abstract_opt_state if meta else init_opt_state)(params)
        extra["opt_state"] = opt_state
        extra["grads"] = params            # the same shapes and dtypes
        step = make_train_step(model, OptimizerConfig(), microbatches)

        def fn():
            return step(params, opt_state, batch)
    elif shape.kind == "prefill":
        def fn():
            with torch.no_grad():
                return model.prefill_logits(params, batch)
    else:
        extra["cache"] = cache
        host = dict(batch, pos=shape.seq_len - 1)

        def fn():
            with torch.no_grad():
                return model.serve_step(params, cache, host)
    return fn, extra


def count_step(fn, plans: Sequence[MeshPlan] = (),
               baseline: Iterable[torch.Tensor] = ()) -> Dict[str, Any]:
    """One run of ``fn()`` under ``FlopCounterMode`` and
    ``counting.StepCounter`` together, B5-B7 on the card's route, the
    ``models.shardctx`` hooks observed: ``{"flops", "activations_peak",
    "bytes_accessed", "counted", "meshes": {plan name: collectives}}``."""
    from torch.utils.flop_counter import FlopCounterMode

    for kernel in accounting.KERNELS:     # formulas before the counter
        accounting.op(kernel)
    counter = StepCounter(plans, baseline)
    with accounting.card_route(), FlopCounterMode(display=False) as flops, \
            counter, shardctx.observe(counter):
        fn()
    return {"flops": int(flops.get_total_flops()), **counter.results()}


def mesh_plans(cfg, shape: ShapeConfig, model, params, cache=None,
               meshes: Optional[Dict[str, MeshShape]] = None
               ) -> List[MeshPlan]:
    """A :class:`counting.MeshPlan` for each mesh (default: the pod and
    multi-pod meshes): the cell's rules and its params' (and cache's)
    specs on it."""
    mode = cell_mode(cfg, shape)
    plans = []
    for name, mesh in (MESHES if meshes is None else meshes).items():
        rules = mesh_rules(mode, mesh.axis_names)
        p_specs = param_shardings(model.param_specs, rules, mesh=mesh)
        c = None if cache is None else (cache, cache_shardings(
            cfg, shape, rules, cache))
        plans.append(MeshPlan(name, mesh, rules, (params, p_specs), c))
    return plans


def state_of(params, batch, extra) -> List[torch.Tensor]:
    """The tensors that exist before the step: params, optimizer state,
    cache and inputs (not the gradients, which the step makes)."""
    trees = [params, batch, extra.get("cache") or {}]
    if "opt_state" in extra:
        o = extra["opt_state"]
        trees += [o.mu, o.nu, {"step": o.step}]
    return [t for tree in trees for t in tree_paths(tree).values()
            if torch.is_tensor(t)]


def build_cell(arch: str, shape_name: str, cfg=None,
               shape: Optional[ShapeConfig] = None,
               param_dtype: torch.dtype = PARAM_DTYPE,
               microbatches: int = 1,
               meshes: Optional[Dict[str, MeshShape]] = None
               ) -> Dict[str, Any]:
    """One cell's record.  ``cfg`` / ``shape`` override the registry's
    (the tests' smoke configs; ``chip_smoke.py``'s training cell, with its
    ``param_dtype`` and ``microbatches``); ``meshes`` the pod and
    multi-pod meshes (the tests' small ones)."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = SHAPES[shape_name] if shape is None else shape
    meshes = MESHES if meshes is None else meshes
    skip = cell_is_skipped(cfg, shape)
    if skip:
        return {"status": "skipped", "reason": skip}
    mode = cell_mode(cfg, shape)
    model = build_model(cfg)
    params = abstract_params(model.param_specs, param_dtype)
    batch = input_specs(cfg, shape)
    cache = _meta_cache(model, shape) if shape.kind == "decode" else None
    t0 = time.time()
    fn, extra = step_of(cfg, shape, params, batch, cache, microbatches)
    counts = count_step(fn, mesh_plans(cfg, shape, model, params, cache,
                                       meshes),
                        state_of(params, batch, extra))
    seconds = time.time() - t0
    parts = {"params": _nbytes(params),
             "grads": _nbytes(extra.get("grads", {})),
             "opt_state": (_nbytes(extra["opt_state"].mu)
                           + _nbytes(extra["opt_state"].nu) + 4
                           if "opt_state" in extra else 0),
             "cache": _nbytes(cache) if cache is not None else 0,
             "inputs": _nbytes(batch)}
    total = sum(parts.values())
    act = counts["activations_peak"]
    peak = total - parts["grads"] + act
    per_card = {}
    for mesh_name, mesh in meshes.items():
        rules = mesh_rules(mode, mesh.axis_names)
        sizes = mesh_sizes(mesh)
        p_specs = param_shardings(model.param_specs, rules, mesh=mesh)
        row = {"chips": math.prod(mesh.shape),
               "params": _per_card(params, p_specs, sizes),
               "inputs": _per_card(batch, batch_shardings(cfg, shape, rules),
                                   sizes)}
        if "grads" in extra:
            o_specs = opt_state_shardings(p_specs)
            row["grads"] = row["params"]
            row["opt_state"] = (_per_card(extra["opt_state"].mu, o_specs.mu,
                                          sizes)
                                + _per_card(extra["opt_state"].nu, o_specs.nu,
                                            sizes))
        if cache is not None:
            row["cache"] = _per_card(cache, cache_shardings(
                cfg, shape, rules, cache), sizes)
        row["total"] = sum(v for k, v in row.items() if k != "chips")
        coll = counts["meshes"][mesh_name]
        row.update(coll)
        row["peak"] = row["total"] - row.get("grads", 0) + row["activations"]
        per_card[mesh_name] = row
    rec = {"status": "ok" if peak <= CARD_BYTES else "does_not_fit",
           "mode": mode, "kind": shape.kind, "n_layers": cfg.n_layers,
           "batch": shape.global_batch, "seq_len": shape.seq_len,
           "flops": counts["flops"],
           "bytes_accessed": counts["bytes_accessed"],
           "counted": counts["counted"], "seconds": round(seconds, 3),
           "bytes": {**parts, "total": total, "activations_peak": act,
                     "peak": peak},
           "card_bytes": CARD_BYTES, "per_card": per_card,
           "param_count": cfg.param_count(),
           "active_param_count": cfg.active_param_count()}
    if shape.kind in DATA_DEPENDENT:
        rec["host_reads"] = DATA_DEPENDENT[shape.kind]
    return rec


def run_cell(arch: str, shape_name: str) -> Dict[str, Any]:
    """:func:`build_cell` with the cell's batch axes set, an error
    recorded instead of raised."""
    cfg = get_config(arch)
    shardctx.set_batch_axes(
        mesh_rules(cell_mode(cfg, SHAPES[shape_name]),
                   make_production_mesh().axis_names)["batch"])
    try:
        res = build_cell(arch, shape_name)
        res["batch_axes"] = shardctx.batch_axes()
    except Exception as e:  # noqa: BLE001 — record and continue
        res = {"status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    finally:
        shardctx.set_batch_axes(None)
    res["arch"], res["shape"] = arch, shape_name
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = ARCH_IDS if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    failures = 0
    for arch in archs:
        for shape_name in shapes:
            res = run_cell(arch, shape_name)
            failures += res["status"] == "error"
            path = os.path.join(args.out, f"{arch}__{shape_name}.json")
            with open(path, "w") as f:
                json.dump(res, f, indent=2)
            extra = (f" flops={res['flops']:.3e} "
                     f"state={res['bytes']['total'] / 1e9:.2f} GB "
                     f"peak={res['bytes']['peak'] / 1e9:.2f} GB "
                     f"pod_collectives="
                     f"{res['per_card']['pod']['collective_total'] / 1e9:.3f}"
                     f" GB"
                     if res["status"] in ("ok", "does_not_fit") else
                     " " + res.get("reason", res.get("error", ""))[:120])
            print(f"[{arch}__{shape_name}] {res['status']}{extra}",
                  flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
