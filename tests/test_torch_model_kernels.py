"""The model stack's kernels: flash attention (B5), the chunked Mamba2 scan
(B6) and the chunked mLSTM (B7).

On the fuzz cases of ``repro_torch.kernels.cases.model_cases`` the port's
plain versions (``ref.flash_attention_ref``, ``ref.mamba2_scan_ref``,
``ref.mlstm_chunked_ref``, which follow the JAX models' chunked
formulations) are held, on the same numpy inputs, to

* the JAX package's oracles (``flash_attention_ref`` with KV expanded,
  ``mamba2_scan_ref``, ``gla_ref``), on every case in f32 and bf16;
* its interpret-mode Pallas kernels, as ``tests/test_kernels.py`` runs
  them, on a few cases (flash attention only at T = S: the Pallas body and
  the oracle place the queries differently when T != S, ROADMAP §C);
* the JAX models' chunked paths (``blocked_attention``, ``ssd_chunked``,
  ``gla_chunked``) in f32,

at ``cases.MODEL_TOL`` (the JAX package's bars).  The CUDA kernels are
held to the plain versions on the card by ``chip_smoke.py`` (phase
``model_fuzz``) and by the ``gpu`` test below, which skips on a machine
without one and needs no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_model_kernels.py
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import cases, ops, ref

try:    # the machine with the card has no JAX: only the gpu test runs there
    import jax
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_kernel
    from repro.kernels.mamba2_scan import mamba2_scan_kernel
    from repro.kernels.mlstm import mlstm_chunked_kernel
    from repro.models.attention import blocked_attention
    from repro.models.ssm import ssd_chunked
    from repro.models.xlstm import gla_chunked
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

CASES = cases.model_cases()
IDS = [f"{c['kernel']}-{c['name']}" for c in CASES]
BY_ID = dict(zip(IDS, CASES))
#: small cases for the interpret-mode Pallas kernels (slow on the CPU)
INTERPRET_IDS = [
    f"{k}-{n}_{t}" for k, n in (
        ("flash_attention", "causal_mha_dh128"),
        ("flash_attention", "ragged_window32_gqa2"),
        ("flash_attention", "full_ragged_mqa_dh32"),
        ("mamba2_scan", "ragged"), ("mamba2_scan", "strong_decay"),
        ("mlstm_chunked", "ragged"), ("mlstm_chunked", "p_split_ragged_k72_p80"))
    for t in ("f32", "bf16")]
F32_IDS = [i for i in IDS if i.endswith("_f32")]

@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    # the suite runs one file per worker, several workers at once: intra-op
    # threads would only contend for the CPU
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PORT = {"flash_attention": ref.flash_attention_ref,
        "mamba2_scan": ref.mamba2_scan_ref,
        "mlstm_chunked": ref.mlstm_chunked_ref}


def _jax_args(case):
    dtype = jnp.dtype(case["dtype"])
    return [jnp.asarray(case[f], jnp.float32 if f in cases.F32_FIELDS
                        else dtype)
            for f in cases.TENSOR_FIELDS[case["kernel"]]]


def _expand(case, args):
    """Flash attention's K/V expanded to H heads, as the JAX oracle and
    Pallas kernel take them."""
    if case["kernel"] != "flash_attention":
        return args
    q, k, v = args
    g = q.shape[2] // k.shape[2]
    return [q, jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2)]


def _close(got, want, case):
    tol = cases.MODEL_TOL[case["kernel"]][case["dtype"]]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _port(case):
    out = PORT[case["kernel"]](*cases.model_tensors(case, "cpu"),
                               **case["static"])
    assert out.dtype == getattr(torch, case["dtype"])
    return out.float().numpy()


@functools.lru_cache(maxsize=None)
def _jitted(kernel, what, static):
    kw = dict(static)
    if what == "oracle":
        fn = {"flash_attention": jref.flash_attention_ref,
              "mamba2_scan": lambda *a: jref.mamba2_scan_ref(*a)[0],
              "mlstm_chunked": jref.gla_ref}[kernel]
    else:       # the Pallas kernel in interpret mode, small tiles
        fn = {"flash_attention": functools.partial(
                  flash_attention_kernel, block_q=64, block_kv=64),
              "mamba2_scan": functools.partial(mamba2_scan_kernel, chunk=64),
              "mlstm_chunked": functools.partial(mlstm_chunked_kernel,
                                                 chunk=64)}[kernel]
        fn = functools.partial(fn, interpret=True)
    return jax.jit(functools.partial(fn, **kw))


@needs_jax
@pytest.mark.parametrize("cid", IDS)
def test_plain_version_equals_jax_oracle(cid):
    case = BY_ID[cid]
    want = _jitted(case["kernel"], "oracle",
                   tuple(sorted(case["static"].items())))(
        *_expand(case, _jax_args(case)))
    _close(_port(case), want, case)


@needs_jax
@pytest.mark.parametrize("cid", INTERPRET_IDS)
def test_plain_version_equals_interpret_mode_pallas_kernel(cid):
    case = BY_ID[cid]
    args = _expand(case, _jax_args(case))
    if case["kernel"] == "flash_attention":
        assert args[0].shape[1] == args[1].shape[1]     # T = S only
    want = _jitted(case["kernel"], "interpret",
                   tuple(sorted(case["static"].items())))(*args)
    _close(_port(case), want, case)


@needs_jax
@pytest.mark.parametrize("cid", F32_IDS)
def test_plain_version_equals_the_jax_models_chunked_path(cid):
    """``blocked_attention`` places query t at t + q_offset (0 here), so
    the port's ``blocked_attention`` (offset 0) is compared with it; the
    scans return the chunked paths' ``y``."""
    case = BY_ID[cid]
    args = _jax_args(case)
    targs = cases.model_tensors(case, "cpu")
    kernel = case["kernel"]
    if kernel == "flash_attention":
        from repro_torch.models.attention import blocked_attention as port_ba
        want = blocked_attention(*args, block=64, **case["static"])
        got = port_ba(*targs, block=64, **case["static"])
    elif kernel == "mamba2_scan":
        want = ssd_chunked(*args, chunk=64)[0]
        got = ops.mamba2_scan(*targs)
    else:
        want = gla_chunked(*args, chunk=64)[0]
        got = ops.mlstm_chunked(*targs)
    _close(got, want, case)


def test_fully_masked_rows_are_the_mean_of_v():
    """T > S under a causal mask: the first T - S queries see no key; the
    oracle's softmax over all -1e30 scores is uniform (the Pallas body
    returns 0 there)."""
    case = BY_ID["flash_attention-t_above_s_masked_rows_f32"]
    q, k, v = cases.model_tensors(case, "cpu")
    out = ops.flash_attention(q, k, v, causal=True)
    n_masked = q.shape[1] - k.shape[1]
    g = q.shape[2] // k.shape[2]
    want = v.mean(dim=1).repeat_interleave(g, dim=1)       # (B, H, dh)
    for t in (0, n_masked - 1):
        torch.testing.assert_close(out[:, t], want, atol=3e-5, rtol=3e-5)
    assert not torch.allclose(out[:, n_masked], want, atol=1e-3)


def test_ragged_tail_is_padding_free():
    """The output's first T0 steps do not depend on what follows them."""
    case = BY_ID["mlstm_chunked-ragged_f32"]
    args = cases.model_tensors(case, "cpu")
    full = ops.mlstm_chunked(*args)
    cut = ops.mlstm_chunked(*[a[:, :50].contiguous() for a in args])
    torch.testing.assert_close(full[:, :50], cut, atol=2e-5, rtol=2e-5)
    case = BY_ID["mamba2_scan-ragged_f32"]
    args = cases.model_tensors(case, "cpu")
    full = ops.mamba2_scan(*args)
    cut = ops.mamba2_scan(*[a[:, :50].contiguous() for a in args])
    torch.testing.assert_close(full[:, :50], cut, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kernel", sorted(PORT))
def test_cpu_tensors_take_the_plain_version(kernel):
    case = next(c for c in CASES if c["kernel"] == kernel
                and c["dtype"] == "float32")
    args = cases.model_tensors(case, "cpu")
    ops.reset_launch_counts()
    got = getattr(ops, kernel)(*args, **case["static"])
    assert torch.equal(got, PORT[kernel](*args, **case["static"]))
    assert ops.launch_counts()[kernel] == 0


@pytest.mark.parametrize("kernel", sorted(PORT))
def test_a_cuda_tensor_never_takes_the_plain_version(kernel):
    """A ``meta`` tensor stands in for a CUDA one where there is no card:
    the wrapper refuses it instead of computing on the CPU."""
    case = next(c for c in CASES if c["kernel"] == kernel
                and c["dtype"] == "float32")
    args = [t.to("meta") for t in cases.model_tensors(case, "cpu")]
    before = ops.launch_counts()[kernel]
    with pytest.raises((RuntimeError, ValueError, OSError)):
        getattr(ops, kernel)(*args, **case["static"])
    assert ops.launch_counts()[kernel] == before


def _scan_args(P, N, dtype, device, B=1, T=40, H=3):
    g = torch.Generator().manual_seed(P * 1000 + N)
    return [(0.5 * torch.randn(B, T, H, P, generator=g)).to(dtype).to(device),
            (0.9 + 0.1 * torch.rand(B, T, H, generator=g)).to(device),
            (0.3 * torch.randn(B, T, N, generator=g)).to(dtype).to(device),
            (0.3 * torch.randn(B, T, N, generator=g)).to(dtype).to(device)]


#: widths the kernels' tiles do not take: narrower than 16, not a multiple
#: of 16, or a state wider than MAX_N.  The wrapper refused them until it
#: padded the off-16 widths and cut the state into slices
#: (``mamba2_scan.plan``): now they reach the device check
TILE_WIDTHS = [(8, 64), (24, 64), (40, 64), (64, 256), (64, 8), (64, 144)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P,N", TILE_WIDTHS)
def test_mamba2_scan_refuses_widths_its_kernels_do_not_take(P, N, dtype):
    """The widths the kernels' tiles do not take are refused no more: a
    ``meta`` tensor, standing in for a CUDA one, is refused by the device
    check alone, before any launch."""
    args = [t.to("meta") for t in _scan_args(P, N, getattr(torch, dtype),
                                             "cpu")]
    before = ops.launch_counts()["mamba2_scan"]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.mamba2_scan(*args)
    assert ops.launch_counts()["mamba2_scan"] == before


def test_mamba2_scan_width_limits_are_the_librarys():
    """The wrapper's MAX_P / MAX_N are the CUDA source's kMaxP / kMaxN."""
    import pathlib
    import re

    from repro_torch.kernels import mamba2_scan as m2
    src = (pathlib.Path(m2.__file__).parent / "csrc" /
           "mamba2_scan.cu").read_text()
    limits = {k: int(v) for k, v in
              re.findall(r"constexpr int (kMax[PN]) = (\d+);", src)}
    assert limits == {"kMaxP": m2.MAX_P, "kMaxN": m2.MAX_N}


def test_mamba2_scan_widths_within_the_limits_reach_the_device_check():
    args = [t.to("meta") for t in _scan_args(48, 128, torch.bfloat16, "cpu")]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.mamba2_scan(*args)


@pytest.mark.parametrize("P,N", [(128, 128), (96, 64), (80, 32), (256, 16)])
def test_mamba2_scan_wide_heads_reach_the_device_check(P, N):
    """Heads wider than the tiles are taken (as sub-heads): the widths the
    first port took, P = N = 128 among them."""
    args = [t.to("meta") for t in _scan_args(P, N, torch.bfloat16, "cpu")]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.mamba2_scan(*args)


@pytest.mark.parametrize("P,d", [(16, 16), (64, 64), (80, 16), (96, 48),
                                 (128, 64), (144, 48), (192, 64)])
def test_mamba2_scan_sub_heads_are_the_widest_tile_that_divides(P, d):
    from repro_torch.kernels import mamba2_scan as m2
    assert m2.sub_heads(P) == (d, P // d)
    assert d <= m2.MAX_P and d % 16 == 0 and P % d == 0


def _sub_head_run(P, N):
    """The plain version on (B, T, H, P) and on its view as H P / d heads
    of width d with the decay repeated, as the wrapper launches it."""
    from repro_torch.kernels import mamba2_scan as m2
    xh, a, b, c = _scan_args(P, N, torch.float32, "cpu", B=2, T=150, H=3)
    B, T, H, _ = xh.shape
    d, n = m2.sub_heads(P)
    split = ref.mamba2_scan_ref(xh.view(B, T, H * n, d),
                                a.repeat_interleave(n, -1), b, c)
    return (xh, a, b, c), ref.mamba2_scan_ref(xh, a, b, c), \
        split.reshape(B, T, H, P)


@pytest.mark.parametrize("P,N", [(128, 128), (96, 64), (80, 32)])
def test_mamba2_scan_sub_heads_equal_the_whole_head(P, N):
    _, whole, split = _sub_head_run(P, N)
    torch.testing.assert_close(split, whole, atol=1e-5, rtol=1e-5)


@needs_jax
@pytest.mark.parametrize("P,N", [(128, 128), (96, 64), (80, 32)])
def test_mamba2_scan_sub_heads_equal_the_jax_oracle(P, N):
    args, _, split = _sub_head_run(P, N)
    want = jref.mamba2_scan_ref(*(jnp.asarray(t.numpy()) for t in args))[0]
    np.testing.assert_allclose(split.numpy(), np.asarray(want), atol=2e-3,
                               rtol=2e-3)


def _mlstm_args(K, P, dtype=torch.bfloat16, B=1, T=70, H=2):
    g = torch.Generator().manual_seed(K * 1000 + P)
    return [torch.randn(B, T, H, K, generator=g).to(dtype),
            (0.3 * torch.randn(B, T, H, K, generator=g)).to(dtype),
            torch.randn(B, T, H, P, generator=g).to(dtype),
            0.7 + 0.3 * torch.rand(B, T, H, generator=g),
            0.1 + 0.9 * torch.rand(B, T, H, generator=g)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [1025, 2048])
def test_mlstm_refuses_widths_its_kernels_do_not_take(K, dtype):
    """K > MAX_K, which the wrapper refused until it cut K into slices
    (``mlstm.k_slices``), is refused no more: a ``meta`` tensor, standing
    in for a CUDA one, is refused by the device check alone."""
    args = [t.to("meta") for t in _mlstm_args(K, 64, getattr(torch, dtype))]
    before = ops.launch_counts()["mlstm_chunked"]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.mlstm_chunked(*args)
    assert ops.launch_counts()["mlstm_chunked"] == before


@pytest.mark.parametrize("K,P", [(1024, 1024), (512, 512), (72, 80),
                                 (37, 45), (1, 1), (1024, 3000)])
def test_mlstm_widths_the_first_port_took_reach_the_device_check(K, P):
    args = [t.to("meta") for t in _mlstm_args(K, P)]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.mlstm_chunked(*args)


def test_mlstm_width_limit_is_the_librarys():
    """The wrapper's MAX_K is the CUDA source's kMaxK."""
    import pathlib
    import re

    from repro_torch.kernels import mlstm
    src = (pathlib.Path(mlstm.__file__).parent / "csrc" /
           "mlstm.cu").read_text()
    assert re.findall(r"constexpr int kMaxK = (\d+);", src) == [
        str(mlstm.MAX_K)]
    assert re.findall(r"constexpr int kKs = (\d+);", src) == [
        str(mlstm.K_STEP)]


@pytest.mark.gpu
def test_cuda_mamba2_scan_refuses_widths_its_kernels_do_not_take():
    """On the card those widths run (padded, the state in slices) and
    agree with the plain version, as the wide mLSTM and every case of
    ``cases.width_cases`` do."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 3e-2)):
        for P, N in TILE_WIDTHS:
            args = _scan_args(P, N, dtype, "cuda")
            got = ops.mamba2_scan(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got.float(), ref.mamba2_scan_ref(*args).float(), atol=tol,
                rtol=tol, msg=f"P={P}, N={N}, {dtype}")
        for K in (1025, 2048):
            args = [t.cuda() for t in _mlstm_args(K, 64, dtype)]
            got = ops.mlstm_chunked(*args)
            torch.cuda.synchronize()
            torch.testing.assert_close(
                got.float(), ref.mlstm_chunked_ref(*args).float(), atol=tol,
                rtol=tol, msg=f"K={K}, {dtype}")
    for case in cases.width_cases():
        args = cases.model_tensors(case, "cuda")
        got = getattr(ops, case["kernel"])(*args, **case["static"])
        torch.cuda.synchronize()
        want = PORT[case["kernel"]](*args, **case["static"])
        tol = cases.MODEL_TOL[case["kernel"]][case["dtype"]]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=case["name"])


@pytest.mark.gpu
def test_cuda_kernels_equal_plain_versions_on_every_case():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: "
                    "python3 chip_smoke.py --phases env,build,model_fuzz)")
    ops.reset_launch_counts()
    for case in CASES:
        args = cases.model_tensors(case, "cuda")
        got = getattr(ops, case["kernel"])(*args, **case["static"])
        torch.cuda.synchronize()
        want = PORT[case["kernel"]](*args, **case["static"])
        tol = cases.MODEL_TOL[case["kernel"]][case["dtype"]]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=case["name"])
    for kernel in PORT:
        assert ops.launch_counts()[kernel] == sum(
            c["kernel"] == kernel for c in CASES)


def _attention_p_in_bf16(q, k, v):
    """Causal attention as the tensor-core kernel rounds it: f32 scores and
    softmax statistics, the unnormalised probabilities rounded to bf16
    before P V (f32 accumulation), the f32 sum of the unrounded ones as the
    denominator, the output rounded to bf16."""
    B, T, H, dh = q.shape
    g = H // k.shape[2]
    kf = k.float().repeat_interleave(g, dim=2)
    vf = v.float().repeat_interleave(g, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), kf) * dh ** -0.5
    keep = torch.ones(T, k.shape[1], dtype=torch.bool).tril(k.shape[1] - T)
    s = s.masked_fill(~keep, ref.NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhts,bshd->bthd", p.bfloat16().float(), vf)
    return (o / p.sum(dim=-1).transpose(1, 2)[..., None]).bfloat16()


def _normwise_max_block(x, want, rows=128):
    """Largest normwise relative error over (batch, ``rows``-query tile,
    head) blocks of a (B, T, H, dh) output: one CTA's part of it."""
    B, T, H, dh = want.shape
    d = (x.double() - want.double()).square().view(B, T // rows, rows, H, dh)
    w = want.double().square().view(B, T // rows, rows, H, dh)
    return float((d.sum((2, 4)) / w.sum((2, 4))).sqrt().max())


@pytest.mark.parametrize("dh", [128, 160])
def test_the_bf16_normwise_bar_can_be_met(dh):
    """``chip_smoke.py`` holds flash attention's bf16 kernel to the plain
    version on the same inputs cast to f32 at a normwise relative error of
    1e-2, over the whole output and over each CTA's (batch, 128-query tile,
    head) block.  Rounding P to bf16 before P V and the output to bf16 —
    what the tensor-core kernel does — stays well under it at T = S = 512,
    GQA 6:1; a dropped key tile does not, nor does one confined to one
    block, which the global norm dilutes."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (1, 512, h, dh))
                                .astype(np.float32)).bfloat16()
               for h in (6, 1, 1))
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    got = _attention_p_in_bf16(q, k, v)

    def normwise(x):
        return float((x.double() - want.double()).norm() / want.double().norm())
    assert normwise(got) < 1e-2
    assert _normwise_max_block(got, want) < 1e-2
    assert normwise(want.bfloat16()) < 5e-3        # output rounding alone
    k_cut, v_cut = k.clone(), v.clone()
    k_cut[:, 128:256] = 0.0                        # one key tile dropped
    v_cut[:, 128:256] = 0.0
    cut = _attention_p_in_bf16(q, k_cut, v_cut)
    assert normwise(cut) > 1e-2
    one_block = got.clone()                        # ... in one block only
    one_block[:, 384:512, 5] = cut[:, 384:512, 5]
    assert _normwise_max_block(one_block, want) > 1e-2
    assert _normwise_max_block(one_block, want) > 2 * normwise(one_block)


@pytest.mark.gpu
@pytest.mark.parametrize("dh", cases.PAST_TILE_DH)
def test_cuda_flash_attention_past_its_kernels_widths(dh):
    """On the card, every ``cases.width_cases`` case of B5 at a width past
    its kernels' own (dh off 8: padded; past 256: the f32 kernel's output
    slices, bf16 upcast to it) against the plain version on the same
    inputs: f32 within 3e-5, bf16 within 3e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: "
                    "python3 chip_smoke.py --phases env,build,model_fuzz)")
    picked = [c for c in cases.width_cases() if c["kernel"] ==
              "flash_attention" and c["name"].startswith(f"dh{dh}_")]
    assert len(picked) == 8
    for case in picked:
        args = cases.model_tensors(case, "cuda")
        got = ops.flash_attention(*args, **case["static"])
        want = ref.flash_attention_ref(*args, **case["static"])
        assert got.dtype == want.dtype and got.shape == want.shape
        tol = cases.MODEL_TOL["flash_attention"][case["dtype"]]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=case["name"])
