"""B5-B7 under autograd (``repro_torch.kernels.autograd``).

On the card a call whose inputs require grad runs the kernel forward and
the plain version's VJP, recomputed, backward.  Here, with no card:

* each Function runs with the plain version injected as its forward: its
  gradients equal direct autograd through the plain version, input by
  input, and the backward is counted once a call;
* ``gradcheck`` in f64 of the Function's plumbing (argument order, the
  static arguments' missing gradients, a subset of inputs requiring
  grad), with f64 oracles of the three functions as forward and plain
  (the plain versions compute in f32 inside, too coarse for finite
  differences);
* the dispatch of ``kernels.ops``: a CPU tensor takes the plain version
  and never builds the Function; a tensor off the CPU (``meta`` here, a
  stand-in whose kernel is replaced) goes through the Function only when
  grad mode is on and an input requires grad, and otherwise calls the
  kernel exactly as before; nothing counts a recompute without a
  backward;
* on the card (``gpu``-marked, skipped here): every leaf of a smoke model
  of each family gets a finite gradient, equal to the CPU's within 1e-3
  normwise, with B5-B7 launched and recomputed; at the reference's own
  draw, seamless's card gradients miss the CPU's by no more than a
  one-ulp move of the weights moves the CPU's, and B5's forward holds.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import autograd as AG
from repro_torch.kernels import ops, ref

SEED = 0


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    # the suite runs one file per worker, several workers at once: intra-op
    # threads would only contend for the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counts():
    ops.reset_recompute_counts()
    yield
    ops.reset_recompute_counts()


def _rand(g, *shape, dtype=torch.float32, lo=None):
    x = torch.randn(*shape, generator=g, dtype=dtype)
    return x if lo is None else lo + (1 - lo) * torch.rand(
        *shape, generator=g, dtype=dtype)


def _inputs(kernel, dtype=torch.float32, seed=SEED):
    """Small inputs of each kernel, f32 unless asked: (tensors, static)."""
    g = torch.Generator().manual_seed(seed)
    if kernel == "flash_attention":
        return [_rand(g, 2, 9, 4, 8, dtype=dtype),
                _rand(g, 2, 11, 2, 8, dtype=dtype),
                _rand(g, 2, 11, 2, 8, dtype=dtype)], \
            dict(causal=True, window=5, offset=2)
    if kernel == "mamba2_scan":
        return [_rand(g, 2, 10, 3, 4, dtype=dtype),
                _rand(g, 2, 10, 3, dtype=dtype, lo=0.3),
                _rand(g, 2, 10, 5, dtype=dtype),
                _rand(g, 2, 10, 5, dtype=dtype)], {}
    return [_rand(g, 2, 10, 3, 4, dtype=dtype),
            _rand(g, 2, 10, 3, 4, dtype=dtype),
            _rand(g, 2, 10, 3, 6, dtype=dtype),
            _rand(g, 2, 10, 3, dtype=dtype, lo=0.3),
            torch.exp(0.5 * _rand(g, 2, 10, 3, dtype=dtype))], {}


PLAIN = {"flash_attention": ref.flash_attention_ref,
         "mamba2_scan": ref.mamba2_scan_ref,
         "mlstm_chunked": ref.mlstm_chunked_ref}
KERNELS = tuple(PLAIN)


def _function(kernel, forward, plain):
    """The Function of ``kernel`` with ``forward`` and ``plain`` given."""
    def call(*args, **static):
        return AG.recompute_vjp(kernel, forward, plain, args, static)
    return call


def _grads(fn, args, static, seed=1):
    leaves = [a.detach().requires_grad_(True) for a in args]
    out = fn(*leaves, **static)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed),
                    dtype=out.dtype)
    return out, torch.autograd.grad((out * w).sum(), leaves)


@pytest.mark.parametrize("kernel", KERNELS)
def test_function_equals_direct_autograd_through_the_plain_version(kernel):
    args, static = _inputs(kernel)
    want_out, want = _grads(PLAIN[kernel], args, static)
    got_out, got = _grads(_function(kernel, PLAIN[kernel], PLAIN[kernel]),
                          args, static)
    assert torch.equal(got_out, want_out)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
        assert bool((w != 0).any())
    assert ops.recompute_counts()[kernel] == 1


# ---- f64 oracles for gradcheck (the plain versions compute in f32) ----

def _attention64(q, k, v, causal=True, window=None, offset=None):
    b, t, h, dh = q.shape
    s = k.shape[1]
    off = s - t if offset is None else offset
    kf = torch.repeat_interleave(k, h // k.shape[2], dim=2)
    vf = torch.repeat_interleave(v, h // k.shape[2], dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, kf) * dh ** -0.5
    rel = (torch.arange(t)[:, None] - torch.arange(s)[None, :] + off)
    mask = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    probs = torch.softmax(scores.masked_fill(~mask, -1e30), dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs, vf)


def _ssd64(xh, a, b, c):
    B, T, H, P = xh.shape
    h = torch.zeros(B, H, P, b.shape[-1], dtype=xh.dtype)
    ys = []
    for t in range(T):
        h = h * a[:, t, :, None, None] + torch.einsum(
            "bn,bhp->bhpn", b[:, t], xh[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t], h))
    return torch.stack(ys, dim=1)


def _mlstm64(q, k, v, a, i):
    B, T, H, K = q.shape
    C = torch.zeros(B, H, K, v.shape[-1], dtype=q.dtype)
    n = torch.zeros(B, H, K, dtype=q.dtype)
    ys = []
    for t in range(T):
        C = C * a[:, t, :, None, None] + i[:, t, :, None, None] \
            * torch.einsum("bhk,bhp->bhkp", k[:, t], v[:, t])
        n = n * a[:, t, :, None] + i[:, t, :, None] * k[:, t]
        qs = q[:, t] * K ** -0.5
        num = torch.einsum("bhk,bhkp->bhp", qs, C)
        den = torch.clamp(torch.einsum("bhk,bhk->bh", qs, n).abs(), min=1.0)
        ys.append(num / den[..., None])
    return torch.stack(ys, dim=1)


ORACLE64 = {"flash_attention": _attention64, "mamba2_scan": _ssd64,
            "mlstm_chunked": _mlstm64}


@pytest.mark.parametrize("kernel", KERNELS)
def test_the_f64_oracles_are_the_plain_versions(kernel):
    args, static = _inputs(kernel, torch.float64)
    want = PLAIN[kernel](*[a.float() for a in args], **static)
    got = ORACLE64[kernel](*args, **static)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("which", ["all", "last"])
def test_gradcheck_in_f64(kernel, which):
    args, static = _inputs(kernel, torch.float64, seed=2)
    args = [a[:1, :6] for a in args]           # tiny: gradcheck is O(n^2)
    need = [which == "all" or j == len(args) - 1 for j in range(len(args))]
    args = [a.detach().requires_grad_(n) for a, n in zip(args, need)]
    fn = _function(kernel, ORACLE64[kernel], ORACLE64[kernel])
    assert torch.autograd.gradcheck(lambda *a: fn(*a, **static), args)


# ---- dispatch ----

CALL = {"flash_attention": ops.flash_attention, "mamba2_scan": ops.mamba2_scan,
        "mlstm_chunked": ops.mlstm_chunked}
KERNEL_ATTR = {"flash_attention": "flash_attention_kernel",
               "mamba2_scan": "mamba2_scan_kernel",
               "mlstm_chunked": "mlstm_chunked_kernel"}


@pytest.mark.parametrize("kernel", KERNELS)
def test_a_cpu_tensor_never_builds_the_function(kernel, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the Function was built for a CPU tensor")
    monkeypatch.setattr(AG.RecomputeVJP, "apply", refuse)
    args, static = _inputs(kernel)
    _, got = _grads(CALL[kernel], args, static)
    _, want = _grads(PLAIN[kernel], args, static)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert ops.recompute_counts() == {k: 0 for k in KERNELS}


@pytest.mark.parametrize("kernel", KERNELS)
def test_off_the_cpu_the_function_runs_only_under_grad(kernel, monkeypatch):
    """``meta`` tensors take the card's branch of the dispatch; the
    kernel is replaced by a counting stand-in (the plain version, which
    runs on meta tensors)."""
    calls, recomputed = [], []

    def kernel_fn(*a, **s):
        calls.append(torch.is_grad_enabled())
        return PLAIN[kernel](*a, **s)

    def plain_fn(*a, **s):
        recomputed.append(([x.shape for x in a], s))
        return PLAIN[kernel](*a, **s)
    monkeypatch.setattr(ops, KERNEL_ATTR[kernel], kernel_fn)
    monkeypatch.setattr(ref, PLAIN[kernel].__name__, plain_fn)
    args, static = _inputs(kernel)
    meta = [a.to("meta") for a in args]

    CALL[kernel](*meta, **static)                 # no input requires grad
    with torch.no_grad():
        CALL[kernel](*[m.requires_grad_(True) for m in meta], **static)
    assert calls == [True, False]                 # both called the kernel
    assert ops.recompute_counts()[kernel] == 0    # and built no Function

    leaves = [a.to("meta").requires_grad_(True) for a in args]
    out = CALL[kernel](*leaves, **static)
    assert out.grad_fn is not None and "RecomputeVJP" in type(
        out.grad_fn).__name__
    assert calls[-1] is False                     # inside Function.forward
    assert ops.recompute_counts()[kernel] == 0    # no backward yet
    assert not recomputed                         # the forward ran no plain
    grads = torch.autograd.grad(out.sum(), leaves)
    assert [g.shape for g in grads] == [a.shape for a in args]
    # the backward recomputed the kernel's own plain version, its inputs in
    # the signature's order, the static arguments as given
    assert recomputed == [([a.shape for a in args], static)]
    assert ops.recompute_counts() == {k: int(k == kernel) for k in KERNELS}


def test_wants_grad():
    x = torch.zeros(2, requires_grad=True)
    y = torch.zeros(2)
    assert AG.wants_grad(y, x) and not AG.wants_grad(y, y)
    with torch.no_grad():
        assert not AG.wants_grad(x)


# ---- on the card ----

GPU_FAMILIES = ("qwen2_1_5b", "zamba2_2_7b", "xlstm_350m",
                "granite_moe_1b_a400m", "gemma3_12b", "internvl2_26b",
                "seamless_m4t_large_v2")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: "
                    "pytest -m gpu tests/test_torch_autograd_kernels.py)")


def _smoke(arch, rescale: bool):
    """``(model, f32 params on the CPU, batch)`` of the family's smoke
    configuration: weights from seed 0, each stacked matrix at its own
    fan-in when ``rescale`` (``models.layers.fan_in_rescale``), 2 x 32
    tokens (and 8 patches, or 32 frames) from numpy's seed 1."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, init_params
    from repro_torch.models.layers import fan_in_rescale
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = init_params(model.param_specs, 0, torch.float32, "cpu")
    if rescale:
        params = fan_in_rescale(model.param_specs, params)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))
                            .astype(np.int32))
    if cfg.is_encdec:
        batch = {"src_embeds": torch.from_numpy(rng.standard_normal(
            (2, 32, cfg.d_model)).astype(np.float32)), "tgt_tokens": toks}
    elif cfg.frontend == "vision":
        batch = {"tokens": toks, "patch_embeds": torch.from_numpy(
            rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32))}
    else:
        batch = {"tokens": toks}
    return model, params, batch


def _model_grads(model, params, batch, dev):
    """``{path: gradient of the loss or None}`` with ``params`` and
    ``batch`` copied to ``dev``."""
    from repro_torch.models import tree_paths
    from repro_torch.models.layers import unflatten
    live = {k: v.detach().to(dev, copy=True).requires_grad_(True)
            for k, v in tree_paths(params).items()}
    loss, _ = model.train_loss(
        unflatten(live), {k: v.to(dev) for k, v in batch.items()})
    return dict(zip(live, torch.autograd.grad(loss, list(live.values()),
                                              allow_unused=True)))


def _normwise(got, want) -> float:
    return float((got.cpu().double() - want.double()).norm()
                 / want.double().norm())


@pytest.mark.gpu
@pytest.mark.parametrize("arch", GPU_FAMILIES)
def test_cuda_every_leaf_of_a_smoke_model_gets_a_gradient(arch):
    _need_card()
    # each stacked matrix at its own fan-in, as chip_smoke.py's train phase
    # draws them: at the reference's draw seamless's gradients move by 6e-4
    # normwise between f32 and f64 weights (test_torch_train_grads.py) and
    # by as much for a one-ulp move of the weights (the test below)
    model, params, batch = _smoke(arch, rescale=True)
    want = _model_grads(model, params, batch, "cpu")
    ops.reset_launch_counts()
    ops.reset_recompute_counts()
    got = _model_grads(model, params, batch, "cuda")
    torch.cuda.synchronize()
    launched = {k for k, v in ops.launch_counts().items() if v}
    recomputed = {k for k, v in ops.recompute_counts().items() if v}
    assert launched & set(KERNELS) and recomputed == launched & set(KERNELS)
    for path, w in want.items():
        g = got[path]
        assert g is not None, path
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any()), path
        rel = _normwise(g, w)
        assert rel <= 1e-3, (path, rel)


#: how far the card's gradient may be from the CPU's, normwise, in units
#: of the CPU's own spread when every weight moves by one f32 ulp (the
#: largest over the moves drawn from ``ULP_SEEDS``)
CONDITIONING_FACTOR = 10.0
ULP_SEEDS = (2, 3, 4)


@pytest.mark.gpu
def test_cuda_seamless_at_the_reference_draw_misses_only_by_conditioning():
    """At the reference's own draw (no fan-in rescale) seamless's card
    gradients missed the CPU's by more than 1e-3 normwise.  Two witnesses
    that this is the gradient's conditioning and not the kernel path
    (non-causal B5, cross-attention with T != S): B5's forward on every
    input the card's run handed it is within its f32 tolerance of the
    plain version; and moving every weight by one f32 ulp in a random
    direction moves the CPU's own gradient about as far, so the card's
    largest miss over the leaves is within ``CONDITIONING_FACTOR`` times
    the CPU's largest such move (three moves).  Both spreads are
    printed (``-s``)."""
    import json
    from repro_torch.kernels import cases
    from repro_torch.models import tree_paths
    from repro_torch.models.layers import unflatten
    _need_card()
    model, params, batch = _smoke("seamless_m4t_large_v2", rescale=False)
    want = _model_grads(model, params, batch, "cpu")
    cpu = {k: 0.0 for k in want}
    for seed in ULP_SEEDS:
        g = torch.Generator().manual_seed(seed)
        moved = unflatten({k: torch.nextafter(v, torch.where(
            torch.rand(v.shape, generator=g) < 0.5, -torch.inf, torch.inf))
            for k, v in tree_paths(params).items()})
        spread = _model_grads(model, moved, batch, "cpu")
        cpu = {k: max(cpu[k], _normwise(spread[k], w))
               for k, w in want.items()}

    seen = []
    kernel = ops.flash_attention

    def recording(*args, **static):
        seen.append(([a.detach().clone() for a in args], dict(static)))
        return kernel(*args, **static)
    ops.flash_attention = recording
    try:
        got = _model_grads(model, params, batch, "cuda")
    finally:
        ops.flash_attention = kernel
    torch.cuda.synchronize()

    tol = cases.MODEL_TOL["flash_attention"]["float32"]
    forward = []
    for args, static in seen:
        with torch.no_grad():
            out = ops.flash_attention(*args, **static)
        plain = ref.flash_attention_ref(*args, **static)
        diff = (out - plain).abs()
        forward.append(int((~(diff <= tol + tol * plain.abs())).sum()))
    card = {k: _normwise(got[k], w) for k, w in want.items()}
    worst_card, worst_cpu = max(card, key=card.get), max(cpu, key=cpu.get)
    print(json.dumps({
        "seamless_reference_draw": {
            "card_vs_cpu_normwise_max": card[worst_card],
            "card_worst_leaf": worst_card,
            "cpu_one_ulp_spread_normwise_max": cpu[worst_cpu],
            "cpu_worst_leaf": worst_cpu,
            "card_vs_cpu_worst_leaf_spread": cpu[worst_card],
            "b5_inputs_held": len(forward),
            "b5_outside_f32_tolerance": sum(forward)}}))
    assert seen and sum(forward) == 0, forward
    assert card[worst_card] <= CONDITIONING_FACTOR * cpu[worst_cpu], \
        (card[worst_card], cpu[worst_cpu])
