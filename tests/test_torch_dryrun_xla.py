"""The dry run's collective bytes against XLA's, at smoke widths on small
host meshes.

One child process (this file run as a script, with eight host devices)
compiles the JAX package's step for every cell as ``repro.launch.dryrun``
lowers it (its mesh rules' batch axes set in ``shardctx``, f32 weights)
and counts each collective kind's result bytes with
``benchmarks.hlo_analysis.HloModule``, which multiplies a loop body's
collectives by its trip count.  The port counts the same cell on the meta
device (``launch.dryrun.build_cell`` with the same mesh).  The bars:

* the all-gather within 10 % of XLA's in the dense and hybrid train cells;
* an all-to-all in every MoE cell;
* the total over kinds within 2x of XLA's in every cell.

Each (cell, kind) is printed with both numbers (``-s``).  The pairs in
:data:`DIFFERENCES` are where XLA's program is not the one the port
counts; each names why, and ``PERF.md`` lists them.  At (2, 2, 2) the
batch is 4: the batch spreads over ("pod", "data"), which 2 does not
divide.  At T = 8 the JAX Mamba2 and mLSTM pad the sequence to their
256-step chunk; the cells at T = 256 pad nothing.  There zamba2 runs its
shared block at every layer (``attn_every`` 1): ``HloModule`` counts a
``lax.cond``'s branch at every layer, so only then is its count the
step's.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the JAX Mamba2's and mLSTM's chunk: a sequence of it is not padded
CHUNK = 256
#: every layer runs zamba2's shared block, so that ``HloModule``'s count of
#: its ``lax.cond`` (the branch at every layer) is the step's
EVERY_LAYER = ("attn_every", 1)
#: (arch, kind, mesh shape, batch, seq, config overrides...)
CELLS = (
    ("qwen2_1_5b", "train", (2, 2), 2, 8),
    ("qwen2_1_5b", "train", (2, 2, 2), 4, 8),
    ("qwen2_1_5b", "train", (2, 2), 2, 64),
    ("granite_moe_1b_a400m", "train", (2, 2), 2, 8),
    ("granite_moe_1b_a400m", "train", (2, 2, 2), 4, 8),
    ("zamba2_2_7b", "train", (2, 2), 2, 8),
    ("zamba2_2_7b", "train", (2, 2, 2), 4, 8),
    ("zamba2_2_7b", "train", (2, 2), 2, CHUNK, EVERY_LAYER),
    ("zamba2_2_7b", "train", (2, 2, 2), 4, CHUNK, EVERY_LAYER),
    ("xlstm_350m", "train", (2, 2), 2, CHUNK),
    ("qwen2_1_5b", "decode", (2, 2), 2, 8),
)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
_ATTN = ("XLA gathers activations, not weights: at 16 tokens the (2, 8, 48) "
         "activation is smaller than a weight, so GSPMD gathers it for wq "
         "and the MLP (the T = 64 cell, where it is not, is equal)")
_SSD = ("the JAX Mamba2 pads T = 8 to its 256-step chunk and GSPMD reshards "
        "the (256, 256) chunk matrices of every head (all-gathers, "
        "all-to-alls, permutes, tens of MB); HloModule also counts the "
        "shared block's lax.cond branch at all 4 layers where it runs at 2. "
        "The port's SSD is one B6 call a layer, heads kept on their card")
_WHOLE = ("XLA gathers the shared block's and the Mamba2 projections' "
          "weights whole, over ('data', 'model'), and gathers the (256, 128) "
          "activations; the port keeps 'model' (Megatron) and gathers the "
          "weights over the batch axes only")
#: (arch, mesh, seq, kind or "total") -> why XLA's program differs
DIFFERENCES = {
    ("qwen2_1_5b", (2, 2), 8, "all-gather"): _ATTN,
    ("zamba2_2_7b", (2, 2), 8, "all-gather"): _SSD,
    ("zamba2_2_7b", (2, 2), 8, "total"): _SSD,
    ("zamba2_2_7b", (2, 2, 2), 8, "all-gather"): _SSD,
    ("zamba2_2_7b", (2, 2, 2), 8, "total"): _SSD,
    ("zamba2_2_7b", (2, 2, 2), CHUNK, "all-gather"): _WHOLE,
}
FAMILY = {"qwen2_1_5b": "dense", "granite_moe_1b_a400m": "moe",
          "zamba2_2_7b": "hybrid", "xlstm_350m": "ssm"}


def _xla_counts(cells):
    """In the child: the trip-aware collective bytes of each cell."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding

    from benchmarks.hlo_analysis import HloModule
    from repro.configs import SHAPES, get_config
    from repro.configs.base import mesh_rules
    from repro.launch.inputs import cell_mode, cell_shardings, input_specs
    from repro.models import abstract_params, build_model, shardctx
    from repro.train.optimizer import (
        OptimizerConfig, abstract_opt_state, opt_state_shardings,
    )
    from repro.train.train_step import make_train_step

    base = {"train": "train_4k", "decode": "decode_32k"}
    out = []
    for arch, kind, mshape, batch, seq, *over in cells:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  **dict(over))
        shape = dataclasses.replace(SHAPES[base[kind]], seq_len=seq,
                                    global_batch=batch)
        axes = ("data", "model") if len(mshape) == 2 else (
            "pod", "data", "model")
        devices = np.array(jax.devices()[:int(np.prod(mshape))])
        mesh = Mesh(devices.reshape(mshape), axes)
        shardctx.set_batch_axes(mesh_rules(cell_mode(cfg, shape),
                                           axes)["batch"])
        model = build_model(cfg)
        params = abstract_params(model.param_specs, jnp.float32)
        inputs = input_specs(cfg, shape)

        def named(specs):
            return jax.tree.map(lambda s: NamedSharding(mesh, s), specs)

        with mesh:
            if kind == "train":
                p, b, _ = cell_shardings(cfg, shape, model, mesh)
                step = jax.jit(make_train_step(model, OptimizerConfig()),
                               in_shardings=(named(p),
                                             named(opt_state_shardings(p)),
                                             named(b)),
                               donate_argnums=(0, 1))
                lowered = step.lower(params, abstract_opt_state(params),
                                     inputs)
            else:
                cache = model.cache_specs(batch, seq)
                p, b, c = cell_shardings(cfg, shape, model, mesh,
                                         cache_tree=cache)
                step = jax.jit(model.serve_step,
                               in_shardings=(named(p), named(c), named(b)),
                               donate_argnums=(1,))
                lowered = step.lower(params, cache, inputs)
        shardctx.set_batch_axes(None)
        totals = HloModule(lowered.compile().as_text()).totals()
        out.append({k: float(v) for k, v in
                    totals["collective_bytes"].items()})
    return out


@pytest.fixture(scope="module")
def counts():
    """Every cell's counts: XLA's from the child, the port's counted here
    while the child compiles."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), ROOT,
                    os.environ.get("PYTHONPATH", "")]))
    child = subprocess.Popen([sys.executable, __file__], env=env, cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
    try:
        port = [_port_counts(*cell) for cell in CELLS]
        out, err = child.communicate(timeout=300)
    finally:
        child.kill()
    assert child.returncode == 0, out[-4000:] + err[-8000:]
    return json.loads(out.strip().splitlines()[-1]), port


def _port_counts(arch, kind, mshape, batch, seq, *over):
    import dataclasses

    import torch

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.configs.base import mesh_rules
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.inputs import cell_mode
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import shardctx

    cfg = dataclasses.replace(get_config(arch, smoke=True), **dict(over))
    shape = ShapeConfig(kind, seq, batch, kind)
    mesh = MeshShape(mshape, ("data", "model") if len(mshape) == 2
                     else ("pod", "data", "model"))
    shardctx.set_batch_axes(mesh_rules(cell_mode(cfg, shape),
                                       mesh.axis_names)["batch"])
    try:
        rec = D.build_cell(arch, kind, cfg=cfg, shape=shape,
                           param_dtype=torch.float32, meshes={"m": mesh})
    finally:
        shardctx.set_batch_axes(None)
    return rec["per_card"]["m"]["collective_bytes"]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: "-".join(
    str(x) if not isinstance(x, tuple) or not isinstance(x[0], str)
    else "=".join(map(str, x)) for x in c))
def test_collective_bytes_against_xla(cell, counts):
    arch, kind, mshape, batch, seq, *_ = cell
    want, got = (c[CELLS.index(cell)] for c in counts)
    rows = []
    for k in KINDS:
        if got.get(k, 0) or want.get(k, 0):
            rows.append(f"  {k:18s} port {got.get(k, 0):>12,.0f}   "
                        f"XLA {want.get(k, 0):>12,.0f}")
    total, xtotal = sum(got.values()), sum(want.values())
    print(f"\n{arch} {kind} {mshape} B={batch} T={seq}: total port "
          f"{total:,.0f} XLA {xtotal:,.0f}\n" + "\n".join(rows))

    def checked(what):
        reason = DIFFERENCES.get((arch, mshape, seq, what))
        if reason:
            print(f"  ({what}: not held to its bar: {reason})")
        return reason is None

    if kind == "train" and FAMILY[arch] in ("dense", "hybrid") \
            and checked("all-gather"):
        assert abs(got["all-gather"] - want["all-gather"]) \
            <= 0.10 * want["all-gather"], (got, want)
    if FAMILY[arch] == "moe":
        assert got["all-to-all"] > 0 and want.get("all-to-all", 0) > 0
    if checked("total"):
        assert xtotal / 2 <= total <= 2 * xtotal, (got, want)


if __name__ == "__main__":
    print(json.dumps(_xla_counts(json.loads(sys.argv[1]) if sys.argv[1:]
                                 else CELLS)))
