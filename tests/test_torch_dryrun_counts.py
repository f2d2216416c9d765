"""The dry run's counts of a step beyond its operations
(``launch.counting.StepCounter``), on the CPU, without the JAX package:

* a toy step (two linears and a norm, hand-written specs) whose
  collectives, live activation bytes and bytes accessed are counted by
  hand here and matched exactly, on one card's tensors and on meta;
* at the smoke configurations of four families, for train, prefill and
  decode, every new count of the meta run equals the same count over the
  same step on real CPU tensors (as ``test_torch_dryrun`` holds the
  operations), under a (1, 1), a (2, 2) and a (2, 2, 2) mesh;
* a (1, 1) mesh counts zero collectives; two microbatches double the
  weights' all-gather and leave the gradient synchronisation alone;
  ``remat="full"`` adds one forward's gathers (less the last product's,
  which checkpoint's early stop does not recompute).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import inputs as T_inputs
from repro_torch.launch.counting import KINDS, MeshPlan, StepCounter
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import abstract_params, build_model, init_params
from repro_torch.models import shardctx
from repro_torch.models.layers import tree_paths, unflatten

ONE = MeshShape((1, 1), ("data", "model"))
POD = MeshShape((2, 2), ("data", "model"))
MULTI = MeshShape((2, 2, 2), ("pod", "data", "model"))
MESHES = {"1x1": ONE, "2x2": POD, "2x2x2": MULTI}
ARCHS = ("qwen2_1_5b", "granite_moe_1b_a400m", "zamba2_2_7b", "xlstm_350m")
#: the shapes of ``test_torch_dryrun.SMOKE_SHAPES``
SMOKE_SHAPES = (ShapeConfig("train", 32, 2, "train"),
                ShapeConfig("prefill", 32, 2, "prefill"),
                ShapeConfig("decode", 32, 2, "decode"))

# ------------------------------------------------------------ the toy --

N, DM, FF = 8, 4, 16        # tokens, width, hidden: f32, 4 bytes each
#: bytes accessed, operator by operator (each tensor argument read once,
#: the output written once): mm (x, w1 -> h), relu, mm (r, w2 -> y),
#: y * y (y read twice), mean, rsqrt, y * rs, (y * rs) * g
TOY_BYTES = (4 * (N * DM + DM * FF + N * FF), 4 * (2 * N * FF),
             4 * (N * FF + FF * DM + N * DM), 4 * 3 * N * DM,
             4 * (N * DM + N), 4 * 2 * N, 4 * (2 * N * DM + N),
             4 * (2 * N * DM + DM))
#: the live set after each allocation and free, in bytes: h; relu's r
#: beside h (the peak), h freed; y beside r, r freed; y * y, its mean,
#: y * y freed; rsqrt, y * rs, rsqrt freed, (y * rs) * g, y * rs freed
TOY_LIVE = (4 * N * FF, 8 * N * FF, 4 * N * FF, 4 * (N * FF + N * DM),
            4 * N * DM, 8 * N * DM, 8 * N * DM + 4 * N, 4 * N * DM + 4 * N)
#: per mesh: collectives (result bytes on one card) and the live peak on
#: one card (h and r are (N, FF) over the batch ways and "model"'s two)
TOY = {
    "2x2": {
        # w1 and w2 gathered over "data" (kept over "model"): 4 D F / 2
        # each; y = r @ w2 contracts the marked FF: all-reduce 4 N D / 2;
        # w1's and w2's gradients reduce-scatter to 4 D F / 4 each, g's
        # (replicated) all-reduces over "data": 4 D
        "all-gather": 2 * 4 * DM * FF // 2,
        "all-reduce": 4 * N * DM // 2 + 4 * DM,
        "reduce-scatter": 2 * 4 * DM * FF // 4,
        "live_peak": 2 * 4 * N * FF // 4},
    "2x2x2": {
        # the batch over ("pod", "data"): y's all-reduce 4 N D / 4; w1 and
        # w2 reduce-scatter over "data" (in their spec) and all-reduce
        # over "pod" (not in it), both to 4 D F / 4
        "all-gather": 2 * 4 * DM * FF // 2,
        "all-reduce": 4 * N * DM // 4 + 2 * 4 * DM * FF // 4 + 4 * DM,
        "reduce-scatter": 2 * 4 * DM * FF // 4,
        "live_peak": 2 * 4 * N * FF // 8},
}


def _toy_counts(mesh: MeshShape, device: str):
    x = torch.ones(N, DM, device=device)
    w1 = torch.full((DM, FF), 0.5, device=device)
    w2 = torch.full((FF, DM), 0.25, device=device)
    g = torch.ones(DM, device=device)
    grads = [torch.ones_like(w) for w in (w1, w2, g)]
    specs = {"w1": (None, ("model", "data")), "w2": (("model", "data"), None),
             "g": (None,)}
    rules = {"batch": ("pod", "data") if "pod" in mesh.axis_names
             else ("data",)}
    plan = MeshPlan("toy", mesh, rules, ({"w1": w1, "w2": w2, "g": g}, specs))
    counter = StepCounter([plan], [x, w1, w2, g] + grads)
    with counter, shardctx.observe(counter):
        h = torch.mm(x, w1)
        r = torch.relu(h)
        del h
        y = torch.mm(r, w2)
        del r
        s = torch.mean(y * y, dim=-1, keepdim=True)
        out = torch.mul(torch.mul(y, torch.rsqrt(s)), g)
        shardctx.sync_grads([w1, w2, g], grads)
    del out
    return counter.results(), plan


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("mesh", ["2x2", "2x2x2"])
def test_a_hand_counted_toy_step_matches_exactly(mesh, device):
    res, plan = _toy_counts(MESHES[mesh], device)
    want = TOY[mesh]
    coll = res["meshes"]["toy"]
    assert coll["collective_bytes"] == {
        k: want.get(k, 0) for k in KINDS}, coll
    assert coll["collective_total"] == sum(want[k] for k in KINDS
                                           if k in want)
    assert res["bytes_accessed"] == sum(TOY_BYTES) == 3984
    assert res["activations_peak"] == max(TOY_LIVE) == 1024
    assert plan.peak == want["live_peak"]
    # the per-card activations add the widest gathered weight
    assert coll["activations"] == want["live_peak"] + 4 * DM * FF // 2
    assert res["counted"] == "whole_step"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_views_and_products_along_a_marked_dim(device):
    """``h = x @ w`` is (8, 16), its columns over "model" (2 ways), its
    rows over "data" (the batch).  Split into heads, merged with the rows,
    selected and transposed, its columns stay where they are; cut, each
    piece moves (a collective-permute of its shard) or, when its length is
    odd, is gathered; split into an odd number of parts, it is gathered;
    contracted against a weight whose columns are over "model" too, it is
    gathered first.  f32, bytes on one card."""
    x = torch.ones(N, DM, device=device)
    w = torch.ones(DM, 16, device=device)
    w3 = torch.ones(DM, 6, device=device)
    w4 = torch.ones(16, 16, device=device)
    plan = MeshPlan("toy", POD, {"batch": ("data",)},
                    ({"w": w, "w3": w3, "w4": w4},
                     {"w": (None, "model"), "w3": (None, "model"),
                      "w4": (None, "model")}))
    counter = StepCounter([plan], [x, w, w3, w4])
    model = ("model",)
    with counter:
        h = torch.mm(x, w)
        heads = h.view(N, 4, 4)
        assert plan.marks_of(heads) == {1: model}
        # rows over "data", then each card's 4 rows whole, then the heads
        assert plan.marks_of(heads.reshape(N * 4, 4)) == {
            0: ("data", 4) + model}
        assert plan.per_card(heads.reshape(N * 4, 4), {
            0: ("data", 4) + model}) == 4 * N * 16 / 4
        assert plan.marks_of(heads.reshape(N, 16)) == {1: model}
        assert plan.marks_of(h[0]) == {0: model}
        assert plan.marks_of(h.t()) == {0: model}
        assert plan.bytes["collective-permute"] == plan.bytes[
            "all-gather"] == 0
        a, b = h.chunk(2, dim=1)          # (8, 8) each: 8 * 8 * 4 / 4
        assert plan.marks_of(a) == plan.marks_of(b) == {1: model}
        assert plan.bytes["collective-permute"] == 2 * 64
        c = h[:, :3]                      # odd: gathered, 8 * 3 * 4 / 2
        assert plan.marks_of(c) == {} and plan.bytes["all-gather"] == 48
        h3 = torch.mm(x, w3).view(N, 3, 2)   # 3 parts: gathered, 8 * 6 * 4 / 2
        assert plan.marks_of(h3) == {}
        # h's columns and w4's columns are both over "model": h cannot be
        # contracted where it lies, so it is gathered (8 * 16 * 4 / 2)
        # and the product is whole on each card, no all-reduce
        y = torch.mm(h, w4)
        assert plan.marks_of(y) == {1: model}
    assert plan.bytes == {"all-gather": 48 + 96 + 256, "all-reduce": 0,
                          "reduce-scatter": 0, "all-to-all": 0,
                          "collective-permute": 128}
    del a, b, c, heads, h3, y


# ------------------------------------------- meta against real tensors --

def _real_cell(cfg, shape, dtype):
    """The cell's step on real CPU tensors: weights from seed 0, tokens
    from numpy."""
    model = build_model(cfg)
    params = init_params(model.param_specs, 0, dtype, device="cpu")
    rng = np.random.default_rng(0)
    batch = {}
    for k, v in T_inputs.input_specs(cfg, shape).items():
        if v.dtype == torch.int32:
            batch[k] = torch.from_numpy(rng.integers(
                0, 64, tuple(v.shape)).astype(np.int32))
        else:
            batch[k] = torch.from_numpy(rng.normal(
                size=tuple(v.shape)).astype(np.float32)).to(v.dtype)
    cache = None
    if shape.kind == "decode":
        cache = unflatten({p: torch.zeros(s.shape, dtype=s.dtype)
                           for p, s in tree_paths(model.cache_specs(
                               shape.global_batch, shape.seq_len)).items()})
    return model, params, batch, cache


def _meta_cell(cfg, shape, dtype):
    model = build_model(cfg)
    return (model, abstract_params(model.param_specs, dtype),
            T_inputs.input_specs(cfg, shape),
            D._meta_cache(model, shape) if shape.kind == "decode" else None)


def _counts(cfg, shape, cell, meshes=MESHES, microbatches=1):
    model, params, batch, cache = cell
    fn, extra = D.step_of(cfg, shape, params, batch, cache, microbatches)
    return D.count_step(fn, D.mesh_plans(cfg, shape, model, params, cache,
                                         meshes),
                        D.state_of(params, batch, extra))


@pytest.mark.parametrize("kind", [s.kind for s in SMOKE_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_new_counts_on_meta_equal_a_real_cpu_step(arch, kind):
    cfg = get_config(arch, smoke=True)
    shape = next(s for s in SMOKE_SHAPES if s.kind == kind)
    meta = _counts(cfg, shape, _meta_cell(cfg, shape, D.PARAM_DTYPE))
    real = _counts(cfg, shape, _real_cell(cfg, shape, D.PARAM_DTYPE))
    assert meta == real
    assert meta["activations_peak"] > 0 and meta["bytes_accessed"] > 0
    assert meta["meshes"]["2x2"]["collective_total"] > 0
    if kind == "train":
        assert meta["meshes"]["2x2"]["collective_bytes"]["all-gather"] > 0
        assert meta["meshes"]["2x2"]["collective_bytes"][
            "reduce-scatter"] > 0


def _smoke_train(arch="qwen2_1_5b", batch=4, **over):
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    return cfg, ShapeConfig("train", 32, batch, "train")


@pytest.mark.parametrize("kind", [s.kind for s in SMOKE_SHAPES])
def test_a_one_by_one_mesh_counts_zero_collectives(kind):
    cfg = get_config("granite_moe_1b_a400m", smoke=True)
    shape = next(s for s in SMOKE_SHAPES if s.kind == kind)
    rec = D.build_cell("granite_moe_1b_a400m", kind, cfg=cfg, shape=shape,
                       meshes={"one": ONE, "pod": POD})
    one = rec["per_card"]["one"]
    assert one["collective_bytes"] == {k: 0 for k in KINDS}
    assert one["collective_total"] == 0
    assert rec["per_card"]["pod"]["collective_total"] > 0
    # one card holds everything: its activations are the whole step's
    assert one["activations"] == rec["bytes"]["activations_peak"]


def test_microbatches_double_the_gather_and_leave_the_sync():
    """f32 weights, so the gradients are f32 with and without the f32
    accumulation of microbatches.  A batch of 8, so that each microbatch's
    rows divide the (2, 2, 2) mesh's four batch ways: a microbatch that
    does not is not sharded over the batch, and its (B, H) merges gather."""
    cfg, shape = _smoke_train(batch=8)
    one, two = (_counts(cfg, shape, _meta_cell(cfg, shape, torch.float32),
                        {"2x2": POD, "2x2x2": MULTI}, microbatches=m)
                for m in (1, 2))
    for mesh in ("2x2", "2x2x2"):
        a, b = (c["meshes"][mesh]["collective_bytes"] for c in (one, two))
        assert b["all-gather"] == 2 * a["all-gather"] > 0
        assert b["reduce-scatter"] == a["reduce-scatter"] > 0


def test_the_slstm_time_loop_gathers_nothing():
    """xLSTM's sLSTM steps a Python loop over time.  Its recurrent weight
    ``r`` is replicated, so no step gathers it, and each step's gate
    pieces (the column-sharded input projection cut in four) move as
    collective-permutes, four in the forward and four in the backward of
    each of the two sLSTM layers: from 8 steps to 16, the number of
    all-gathers and all-reduces stays, the permutes grow by 16 a step."""
    import collections

    cfg = get_config("xlstm_350m", smoke=True)
    calls = []
    for seq in (8, 16):
        shape = ShapeConfig("train", seq, 2, "train")
        model, params, batch, cache = _meta_cell(cfg, shape, torch.float32)
        fn, extra = D.step_of(cfg, shape, params, batch, cache)
        plan, = D.mesh_plans(cfg, shape, model, params, cache, {"2x2": POD})
        count, add = collections.Counter(), plan.add

        def counted(kind, nbytes, count=count, add=add):
            count[kind] += 1
            add(kind, nbytes)
        plan.add = counted
        D.count_step(fn, [plan], D.state_of(params, batch, extra))
        calls.append(count)
    short, long = calls
    assert long["all-gather"] == short["all-gather"] > 0
    assert long["all-reduce"] == short["all-reduce"] > 0
    assert long["collective-permute"] - short["collective-permute"] == 8 * 16


def test_full_remat_adds_one_gather_pass():
    """Checkpointing every layer runs each layer's forward again in the
    backward: the gathers grow by one forward's, which is the prefill's
    (the same weights under the same rules; its head gathers nothing).
    ``torch.utils.checkpoint`` stops a recompute once the backward has
    every tensor it saved (early stop, the default, and what the card
    runs), so the layer's last product (``w_down``) is not recomputed and
    its gather is not repeated; with early stop off the whole forward
    is."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    cfg, shape = _smoke_train(remat="none")
    full, _ = _smoke_train(remat="full")
    prefill = ShapeConfig("prefill", 32, 4, "prefill")

    def gathers(c, s):
        counts = _counts(c, s, _meta_cell(c, s, torch.float32),
                         {"2x2": POD})
        return counts["meshes"]["2x2"]["collective_bytes"]["all-gather"]

    none, forward = gathers(cfg, shape), gathers(cfg, prefill)
    with set_checkpoint_early_stop(False):
        assert gathers(full, shape) == none + forward
    w_down = 4 * cfg.d_ff * cfg.d_model // 2          # f32 over "data"
    assert gathers(full, shape) == none + forward - cfg.n_layers * w_down
    assert forward > 0
