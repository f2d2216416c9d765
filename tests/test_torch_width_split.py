"""The model kernels past their tiles' widths, and B5's f32 arithmetic.

B6 (the Mamba2 scan) and B7 (the mLSTM) take every width their JAX kernels
take.  The CUDA kernels' tiles take a head P <= 64 and a state slice N <=
128 (B6) and a K slice <= 1,024 (B7); the wrappers reach every other width
by identities of the arithmetic, which these tests hold on the CPU with the
wrappers' own plan (``mamba2_scan.plan``, ``mlstm.k_slices``) and the
plain versions standing in for the launches, against the JAX oracles:

* B6: zero columns of x, B and C add exact zeros (off-16 widths padded), y
  is a sum over the state's columns, each evolving on its own (the state
  cut into slices whose shares of y add up);
* B7: the numerator q C and the normaliser q . n are sums over k (the
  slices' parts add up, then one division by max(|q . n|, 1)), q scaled by
  the whole K's K**-0.5.

B5's f32 arm runs P V on the tensor cores as 3xTF32: each operand split into
hi = tf32(x) and lo = tf32(x - hi), three products a pair.  Emulated here
(TF32 = f32 with the low 13 mantissa bits rounded off, to nearest with ties
away, as ``cvt.rna``), three products meet the f32 bar of 3e-5 against the
plain version in f64 where one does not.  Its scores S = Q K^T are FFMA, d
in order, as the plain version's f32 product rounds them: on inputs whose
scores are large (the training path's, at the reference's draw), 3xTF32
scores leave elements outside 3e-5 of the plain version, the plain
version's own scores with 3xTF32 P V none.

The plain versions themselves are held to the JAX oracles on every case of
``cases.width_cases`` (the cases ``chip_smoke.py`` holds the CUDA kernels
to them on, phase ``model_fuzz``).
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import cases, mamba2_scan, mlstm, ref

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

WIDTH_CASES = cases.width_cases()
WIDTH_IDS = [f"{c['kernel']}-{c['name']}" for c in WIDTH_CASES]
PLAIN = {"flash_attention": ref.flash_attention_ref,
         "mamba2_scan": ref.mamba2_scan_ref,
         "mlstm_chunked": ref.mlstm_chunked_ref}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _oracle(kernel, static):
    fn = {"flash_attention": jref.flash_attention_ref,
          "mamba2_scan": lambda *a: jref.mamba2_scan_ref(*a)[0],
          "mlstm_chunked": jref.gla_ref}[kernel]
    return jax.jit(functools.partial(fn, **dict(static)))


def _jax(case):
    dtype = jnp.dtype(case["dtype"])
    args = [jnp.asarray(case[f], jnp.float32 if f in cases.F32_FIELDS
                        else dtype)
            for f in cases.TENSOR_FIELDS[case["kernel"]]]
    if case["kernel"] == "flash_attention":      # the oracle takes H KV heads
        g = args[0].shape[2] // args[1].shape[2]
        args[1:] = [jnp.repeat(x, g, axis=2) for x in args[1:]]
    return np.asarray(_oracle(case["kernel"],
                              tuple(sorted(case["static"].items())))(*args),
                      np.float32)


@pytest.mark.parametrize("cid", WIDTH_IDS)
def test_plain_version_equals_jax_oracle_past_the_tiles(cid):
    case = WIDTH_CASES[WIDTH_IDS.index(cid)]
    got = PLAIN[case["kernel"]](*cases.model_tensors(case, "cpu"),
                                **case["static"])
    assert got.dtype == getattr(torch, case["dtype"])
    tol = cases.MODEL_TOL[case["kernel"]][case["dtype"]]
    np.testing.assert_allclose(got.float().numpy(), _jax(case), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------- B6 ----

def _scan_inputs(P, N, B=1, T=300, H=2, seed=0):
    rng = np.random.default_rng(seed + 7 * P + N)
    return (rng.normal(0, 0.5, (B, T, H, P)).astype(np.float32),
            rng.uniform(0.7, 1.0, (B, T, H)).astype(np.float32),
            rng.normal(0, 0.3, (B, T, N)).astype(np.float32),
            rng.normal(0, 0.3, (B, T, N)).astype(np.float32))


def _pad(x, width):
    out = torch.zeros(*x.shape[:-1], width)
    out[..., :x.shape[-1]] = x
    return out


def _scan_as_launched(xh, a, b, c):
    """The wrapper's plan on the CPU: x, B and C zero-padded, the head cut
    into sub-heads, the state into slices, each slice's share of y from the
    plain version (the launches' stand-in) added in slice order in f32, the
    padded columns cut off."""
    B, T, H, P = xh.shape
    pl = mamba2_scan.plan(P, b.shape[-1])
    d, n_sub = pl["d"], pl["n_sub"]
    xs = _pad(xh, pl["P_pad"]).view(B, T, H * n_sub, d)
    asub = a.repeat_interleave(n_sub, -1)
    bp, cp = _pad(b, pl["N_pad"]), _pad(c, pl["N_pad"])
    y = None
    for n0, w in pl["slices"]:
        share = ref.mamba2_scan_ref(xs, asub, bp[..., n0:n0 + w].contiguous(),
                                    cp[..., n0:n0 + w].contiguous())
        y = share if y is None else y + share
    return y.reshape(B, T, H, pl["P_pad"])[..., :P], pl


@pytest.mark.parametrize("P,N", [(64, 256), (24, 144), (8, 64), (72, 128)])
def test_mamba2_scan_slices_and_padding_equal_the_jax_oracle(P, N):
    arrays = _scan_inputs(P, N)
    got, pl = _scan_as_launched(*(torch.from_numpy(x) for x in arrays))
    assert all(w <= mamba2_scan.MAX_N and w % 16 == 0
               for _, w in pl["slices"])
    assert sum(w for _, w in pl["slices"]) == pl["N_pad"]
    assert pl["d"] <= mamba2_scan.MAX_P and pl["d"] % 16 == 0
    want = np.asarray(jref.mamba2_scan_ref(*map(jnp.asarray, arrays))[0])
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    whole = ref.mamba2_scan_ref(*(torch.from_numpy(x) for x in arrays))
    torch.testing.assert_close(got, whole, atol=1e-5, rtol=1e-5)


def test_mamba2_scan_plan_keeps_the_widths_the_tiles_take():
    """Widths the kernels' tiles take run as they did: one slice, no
    padding, zamba2's P = N = 64 one head a head."""
    for P, N in ((64, 64), (16, 16), (48, 32), (64, 128), (128, 128)):
        pl = mamba2_scan.plan(P, N)
        assert (pl["P_pad"], pl["N_pad"]) == (P, N)
        assert pl["slices"] == [(0, N)]
        assert (pl["d"], pl["n_sub"]) == mamba2_scan.sub_heads(P)
    assert mamba2_scan.plan(64, 1040)["slices"][-1] == (1024, 16)


# ---------------------------------------------------------------- B7 ----

def _mlstm_inputs(K, P, B=1, T=150, H=2, seed=0):
    rng = np.random.default_rng(seed + K + 3 * P)
    return (rng.normal(0, 1.0, (B, T, H, K)).astype(np.float32),
            rng.normal(0, 0.3, (B, T, H, K)).astype(np.float32),
            rng.normal(0, 1.0, (B, T, H, P)).astype(np.float32),
            rng.uniform(0.7, 1.0, (B, T, H)).astype(np.float32),
            rng.uniform(0.1, 1.0, (B, T, H)).astype(np.float32))


def _mlstm_parts(q, k, v, a, i, scale: float):
    """The chunked mLSTM's numerator ``(B, T, H, P)`` and normaliser ``(B,
    T, H)`` before the division, q scaled by ``scale``: the part of one K
    slice (q and k cut to its columns, ``scale`` the whole K's), what the
    CUDA kernels write per slice past ``mlstm.MAX_K``.  The plain version's
    own chunks (``ref._gla_parts``, which scales q by its width's
    ``w**-0.5``) on q rescaled to ``scale``."""
    B, T, H, w = q.shape
    y, nrm, _, _ = ref._gla_parts(q * (scale * w ** 0.5), k, v, a, i, 256)
    nc = y.shape[1]
    return (y.reshape(B, nc * 256, H, -1)[:, :T],
            nrm.reshape(B, nc * 256, H)[:, :T])


@pytest.mark.parametrize("K", [1025, 2048])
def test_mlstm_k_slices_then_one_division_equal_the_jax_oracle(K):
    """Each slice's numerator and normaliser from the plain version (the
    launches' stand-in) with q scaled by the whole K's K**-0.5, added in
    slice order, then one division by max(|q . n|, 1)."""
    arrays = _mlstm_inputs(K, 64)
    q, k, v, a, i = (torch.from_numpy(x) for x in arrays)
    slices = mlstm.k_slices(K)
    assert len(slices) == 2 and sum(w for _, w in slices) == K
    assert all(w <= mlstm.MAX_K for _, w in slices)
    assert all(w % mlstm.K_STEP == 0 for _, w in slices[:-1])
    num = den = None
    for k0, w in slices:
        n_, d_ = _mlstm_parts(q[..., k0:k0 + w], k[..., k0:k0 + w], v, a,
                              i, scale=K ** -0.5)
        num = n_ if num is None else num + n_
        den = d_ if den is None else den + d_
    got = num / den.abs().clamp(min=1.0)[..., None]
    want = np.asarray(jref.gla_ref(*map(jnp.asarray, arrays)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3, rtol=2e-3)
    torch.testing.assert_close(got, ref.mlstm_chunked_ref(q, k, v, a, i),
                               atol=1e-5, rtol=1e-5)
    # a slice's own scale (its width's) is another function
    n_, d_ = _mlstm_parts(q[..., :slices[0][1]], k[..., :slices[0][1]],
                          v, a, i, scale=slices[0][1] ** -0.5)
    assert not torch.allclose(n_, _mlstm_parts(
        q[..., :slices[0][1]], k[..., :slices[0][1]], v, a, i,
        scale=K ** -0.5)[0], atol=1e-3)


def test_mlstm_k_slices_keep_k_up_to_max_k_whole():
    for K in (1, 37, 512, 1024):
        assert mlstm.k_slices(K) == [(0, K)]
    for K in (1025, 1500, 4096, 20_000):
        sl = mlstm.k_slices(K)
        assert [k0 for k0, _ in sl] == list(range(0, K, sl[0][1]))
        assert sum(w for _, w in sl) == K and max(w for _, w in sl) <= 1024


# ------------------------------------------------------- B5: 3xTF32 ----

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32: the low 13 mantissa bits rounded off to
    nearest, ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm(a, b, passes: int):
    """a @ b (f32) as the tensor cores take it: one TF32 product, or three
    on the split pairs (a_lo b_hi + a_hi b_lo + a_hi b_hi); the TF32
    products are exact in f64, accumulated there and rounded to f32."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        al, bl = _tf32(a - ah), _tf32(b - bh)
        out = al.double() @ bh.double() + ah.double() @ bl.double() + out
    return out.float()


def _attention(q, k, v, causal, window, mm):
    """Attention with the kernel's masks (keys at rel = t - s + S - T, -1e30
    where masked), the scores scaled after the dot and softmax statistics
    in the inputs' type; ``mm`` forms both products."""
    B, T, H, dh = q.shape
    S, g = k.shape[1], H // k.shape[2]
    kf = k.repeat_interleave(g, 2).permute(0, 2, 3, 1)
    vf = v.repeat_interleave(g, 2).permute(0, 2, 1, 3)
    s = mm(q.permute(0, 2, 1, 3), kf) * dh ** -0.5
    rel = torch.arange(T)[:, None] - torch.arange(S)[None, :] + (S - T)
    keep = torch.ones_like(rel, dtype=torch.bool)
    if causal:
        keep &= rel >= 0
    if window is not None:
        keep &= rel < window
    s = s.masked_fill(~keep, ref.NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return (mm(p, vf) / p.sum(-1, keepdim=True)).permute(0, 2, 1, 3)


#: B5's f32 contract shapes (``analysis.kernels.CONTRACTS``), with GQA
B5_SHAPES = [(1, 256, 256, 2, 2, 128, True, None),
             (1, 200, 200, 4, 2, 64, True, 48),
             (1, 150, 150, 4, 2, 160, False, None),
             (1, 90, 200, 4, 2, 256, True, None)]


@pytest.mark.parametrize("B,T,S,H,Hk,dh,causal,window", B5_SHAPES)
def test_three_tf32_products_meet_the_f32_bar_and_one_does_not(
        B, T, S, H, Hk, dh, causal, window):
    rng = np.random.default_rng(dh + T)
    q, k, v = (torch.from_numpy(rng.normal(0, 1.0, (B, L, h, dh))
                                .astype(np.float32))
               for L, h in ((T, H), (S, Hk), (S, Hk)))
    want = _attention(q.double(), k.double(), v.double(), causal, window,
                      torch.matmul)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(plain.double(), want, atol=3e-5, rtol=3e-5)

    def outside(got):
        return int((~torch.isclose(got.double(), want, atol=3e-5,
                                   rtol=3e-5)).sum())
    three = _attention(q, k, v, causal, window,
                       functools.partial(_mm, passes=3))
    one = _attention(q, k, v, causal, window,
                     functools.partial(_mm, passes=1))
    assert outside(three) == 0
    assert float((three.double() - want).abs().max()) < 3e-6
    assert outside(one) > 0.01 * want.numel()


def _plain_scores(q, k):
    """The scores as ``ref.flash_attention_ref`` forms them for T <= its
    block (its f32 product, then the scale)."""
    b, t, h, dh = q.shape
    hk = k.shape[2]
    qi = q.reshape(b, t, hk, h // hk, dh).permute(0, 2, 3, 1, 4).reshape(
        b, hk, h // hk * t, dh)
    s = (qi @ k.permute(0, 2, 3, 1)).view(b, hk, h // hk, t, -1) * dh ** -0.5
    return s.reshape(b, h, t, -1)


def test_large_scores_need_the_plain_versions_rounding_of_s():
    """At the training path's scale (q, k, v of rms ~7.4, dh 128: scores of
    std ~55) a score's rounding, amplified by the exponent, moves the
    output past the f32 bar: S as 3xTF32 leaves elements outside 3e-5 of
    the plain version, S rounded as the plain version rounds it with P V as
    3xTF32 none (why the f32 kernel forms S by in-order FFMA)."""
    rng = np.random.default_rng(5)
    B, T, H, Hk, dh = 1, 256, 4, 2, 128
    q, k, v = (torch.from_numpy(rng.normal(0, 7.4, (B, T, h, dh))
                                .astype(np.float32))
               for h in (H, Hk, Hk))
    want = ref.flash_attention_ref(q, k, v)
    keep = torch.ones(T, T, dtype=torch.bool).tril()
    vf = v.repeat_interleave(H // Hk, 2).permute(0, 2, 1, 3)

    def attention(s):
        s = s.masked_fill(~keep, ref.NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True))
        return (_mm(p, vf, 3) / p.sum(-1, keepdim=True)).permute(0, 2, 1, 3)

    def outside(got):
        return int((~torch.isclose(got, want, atol=3e-5, rtol=3e-5)).sum())
    kf = k.repeat_interleave(H // Hk, 2).permute(0, 2, 3, 1)
    tf32_s = _mm(q.permute(0, 2, 1, 3), kf, 3) * dh ** -0.5
    assert outside(attention(tf32_s)) > 0
    assert outside(attention(_plain_scores(q, k))) == 0


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                       # representable in TF32
    half = 2.0 ** -11                            # half a TF32 unit at 1
    x = torch.tensor([1.0 + half, -(1.0 + half), one + half,
                      1.0 + half - 2.0 ** -23, 3.0], dtype=torch.float32)
    want = torch.tensor([one, -one, one + 2.0 ** -10, 1.0, 3.0])
    assert torch.equal(_tf32(x), want)


# ------------------------------------------------- B5 past its widths ----

#: the T = S cases of B5's new widths (the Pallas body and the oracle place
#: the queries differently when T != S, ROADMAP §C)
PAST_TILE_INTERPRET = [f"flash_attention-dh{dh}_{mode}_{t}"
                       for dh in (12, 100, 320)
                       for mode in ("causal", "window48", "full")
                       for t in ("f32", "bf16")]


@functools.lru_cache(maxsize=None)
def _interpret(static):
    from repro.kernels.flash_attention import flash_attention_kernel
    return jax.jit(functools.partial(flash_attention_kernel, block_q=64,
                                     block_kv=64, interpret=True,
                                     **dict(static)))


@pytest.mark.parametrize("cid", PAST_TILE_INTERPRET)
def test_plain_version_equals_interpret_mode_kernel_past_the_widths(cid):
    """dh off 8 and past 256: the plain version (which the wrapper's
    padded and sliced launches are held to on the card) against the JAX
    package's Pallas kernel in interpret mode, at MODEL_TOL."""
    case = WIDTH_CASES[WIDTH_IDS.index(cid)]
    dtype = jnp.dtype(case["dtype"])
    q, k, v = (jnp.asarray(case[f], dtype) for f in ("q", "k", "v"))
    g = q.shape[2] // k.shape[2]
    want = _interpret(tuple(sorted(case["static"].items())))(
        q, jnp.repeat(k, g, axis=2), jnp.repeat(v, g, axis=2))
    got = ref.flash_attention_ref(*cases.model_tensors(case, "cpu"),
                                  **case["static"])
    tol = cases.MODEL_TOL["flash_attention"][case["dtype"]]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("dh", [12, 100, 20])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_zero_columns_leave_the_attention_as_it_was(dh, causal, window):
    """The wrapper's plan for a dh off 8 (``flash_attention.launch_plan``):
    q, k and v zero-padded to the next multiple of 8, scores scaled by the
    true dh, the output cut back.  On the CPU's plain version (the scale
    carried into q, as the kernel applies it after the dot) the padded
    columns change no score and no kept output column."""
    from repro_torch.kernels import flash_attention as fa
    dhp, dtype = fa.launch_plan(dh, torch.float32)
    assert dhp % fa.VEC == 0 and dh < dhp < dh + fa.VEC
    assert dtype == torch.float32
    rng = np.random.default_rng(dh)
    q, k, v = (torch.from_numpy(rng.normal(0, 0.5, (1, 150, h, dh))
                                .astype(np.float32)) for h in (4, 2, 2))
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    pad = [_pad(x, dhp) for x in (q, k, v)]
    pad[0] = pad[0] * ((dh ** -0.5) / (dhp ** -0.5))
    got = ref.flash_attention_ref(*pad, causal=causal, window=window)
    assert torch.equal(got[..., dh:], torch.zeros_like(got[..., dh:]))
    torch.testing.assert_close(got[..., :dh], want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dh,dtype,plan", [
    (12, torch.float32, (16, torch.float32)),
    (100, torch.bfloat16, (104, torch.bfloat16)),
    (256, torch.bfloat16, (256, torch.bfloat16)),
    (264, torch.bfloat16, (264, torch.float32)),
    (510, torch.float32, (512, torch.float32)),
    (512, torch.bfloat16, (512, torch.float32))])
def test_launch_plan_pads_to_8_and_takes_bf16_past_256_to_the_f32_arm(
        dh, dtype, plan):
    from repro_torch.kernels import flash_attention as fa
    assert fa.launch_plan(dh, dtype) == plan


def test_shared_memory_takes_dh_512_and_refuses_by_the_numbers():
    """Past 256 a block holds Q and two stages of K at the whole dh and two
    of V at one slice (key tiles of 8): dh 512 takes 181,760 bytes, within
    an H100's 227 KB; the first width past the opt-in is refused by the
    shared-memory check alone."""
    from repro_torch.kernels import flash_attention as fa
    optin = 227 * 1024
    assert fa.smem_bytes(512, torch.float32) == 181_760
    assert fa.smem_bytes(256, torch.float32) == fa.smem_bytes(256) < optin
    widest = max(d for d in range(264, 2048, 8)
                 if fa.smem_bytes(d, torch.float32) <= optin)
    assert 512 <= widest < 2048
    assert fa.smem_bytes(widest + 8, torch.float32) > optin


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", cases.PAST_TILE_DH)
def test_flash_attention_widths_past_the_kernels_reach_the_device_check(
        dh, dtype):
    """No width is refused before the device check: a ``meta`` tensor,
    standing in for a CUDA one, is refused there and nothing launches."""
    from repro_torch.kernels import ops
    dt = getattr(torch, dtype)
    q = torch.zeros(1, 40, 4, dh, dtype=dt, device="meta")
    kv = torch.zeros(1, 40, 2, dh, dtype=dt, device="meta")
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.flash_attention(q, kv, kv, causal=True)
    assert ops.launch_counts()["flash_attention"] == before

