"""The two passes that the CUDA mLSTM (``csrc/mlstm.cu``) runs in bf16.

The kernel computes the chunkwise mLSTM in two launches: per (chunk, head)
in parallel the gated scores W = (Q K^T) o L o i with K^-0.5 applied to the
f32 products, their row sums, exp(cum) and dte = exp(total - cum) i; then
per (P slice, head), chunk by chunk with C (K x P) and n (K) in f32,
y = (W V + exp(cum) (q C_{c-1})) / max(|rowsum W + exp(cum) q . n_{c-1}|, 1)
and C_c = C_{c-1} exp(total) + (K o dte)^T V.  A plain model of those
passes, in that order, is held here, on the CPU with seeded numpy inputs,
to the JAX package's sequential oracle ``gla_ref`` and to its Pallas kernel
in interpret mode:

* in f32 at the kernel's chunk length (64), with a ragged T, the model's
  gate range (sigmoid forget gates, input gates up to e^10), K = 72 and P =
  80 (no tile multiple), and xLSTM-350M's K = P = 512 at a short T, within
  the JAX package's 2e-3;
* on bf16 inputs with the operands the kernel makes rounded as it rounds
  them — W, C_{c-1} and K o dte, each as a pair hi + lo of bf16 — within
  the 1e-2 normwise bar (over the output and over each 128-step chunk of one
  head), and within 3e-2 of the plain version elementwise once rounded to
  bf16;
* and, for the record of why the kernel carries pairs: with each of those
  operands rounded once to bf16 the products err by ~80x more (1.8e-3
  normwise at the model's gate range, more than the bf16 output's own
  rounding, 1.5e-3), where the pairs leave 2.2e-5; the elementwise bar on a
  33-million-element output (xLSTM's captured prefill) has less room than
  these shapes.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mlstm import mlstm_chunked_kernel  # noqa: E402

CHUNK = 64                                # the kernel's chunk length
NORMWISE_TOL, BLOCK_T = 1e-2, 128


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _round(v: torch.Tensor, how: str) -> torch.Tensor:
    """``v`` as a product's operand: exact (``"f32"``), one bf16
    (``"bf16"``) or the pair bf16(v) + bf16(v - bf16(v)) (``"pair"``)."""
    if how == "f32":
        return v
    hi = v.bfloat16().float()
    return hi if how == "bf16" else hi + (v - hi).bfloat16().float()


def mlstm_split(q, k, v, a, i, Q: int = CHUNK, how: str = "f32"):
    """The kernel's two passes in plain PyTorch, f32 throughout except for
    the operands ``_round`` rounds; returns y (B, T, H, P) in f32."""
    B, T, H, K = q.shape
    P = v.shape[-1]
    nc = -(-T // Q)
    pad = nc * Q - T

    def chunks(x, value=0.0):
        x = torch.nn.functional.pad(
            x.float(), (0, 0) * (x.dim() - 2) + (0, pad), value=value)
        return x.view(B, nc, Q, *x.shape[2:])
    qc, kc, vc = chunks(q), chunks(k), chunks(v)            # (B,nc,Q,H,.)
    ac, ic = chunks(a, 1.0), chunks(i)                      # (B,nc,Q,H)
    scale = K ** -0.5
    # 1. the scores, every chunk at once
    cum = torch.cumsum(torch.log(ac.clamp(min=1e-20)), 2)
    total = cum[:, :, -1]                                   # (B, nc, H)
    qk = torch.einsum("bcqhk,bcshk->bchqs", qc, kc)
    diff = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).permute(
        0, 1, 4, 2, 3)                                      # (B,nc,H,q,s)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()
    W = torch.where(causal, qk * scale * torch.exp(diff.clamp(max=0.0))
                    * ic.permute(0, 1, 3, 2)[:, :, :, None, :], 0.0)
    nrm_intra = W.sum(-1)                                   # (B,nc,H,Q)
    ecum = torch.exp(cum).permute(0, 1, 3, 2)               # (B,nc,H,Q)
    dte = torch.exp(total[:, :, None] - cum) * ic           # (B,nc,Q,H)
    # 2. the recurrence, chunk by chunk
    C = torch.zeros(B, H, K, P)
    n = torch.zeros(B, H, K)
    ys = []
    for c in range(nc):
        y_inter = torch.einsum("bqhk,bhkp->bhqp", qc[:, c], _round(C, how))
        qn = torch.einsum("bqhk,bhk->bhq", qc[:, c], n)
        den = (nrm_intra[:, c] + ecum[:, c] * scale * qn).abs().clamp(min=1.0)
        y_intra = torch.einsum("bhqs,bshp->bhqp", _round(W[:, c], how),
                               vc[:, c])
        y = (y_intra + ecum[:, c, :, :, None] * scale * y_inter) \
            / den[..., None]
        ys.append(y.permute(0, 2, 1, 3))                    # (B, Q, H, P)
        kd = kc[:, c] * dte[:, c, :, :, None]               # (B, Q, H, K)
        decay = torch.exp(total[:, c])                      # (B, H)
        n = n * decay[..., None] + kd.sum(1)
        C = C * decay[..., None, None] + torch.einsum(
            "bshk,bshp->bhkp", _round(kd, how), vc[:, c])
    return torch.cat(ys, 1)[:, :T]


SHAPES = {   # (B, T, H, K, P, the model's gate range)
    "ragged_three_chunks": (2, 150, 2, 64, 64, False),
    "model_gate_range": (1, 200, 2, 32, 32, True),
    "k72_p80_ragged": (1, 100, 2, 72, 80, False),
    "xlstm_k512_p512": (1, 70, 1, 512, 512, True),
}


def _inputs(seed, B, T, H, K, P, wide):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1.0, (B, T, H, K)).astype(np.float32)
    k = rng.normal(0, 0.3, (B, T, H, K)).astype(np.float32)
    v = rng.normal(0, 1.0, (B, T, H, P)).astype(np.float32)
    if wide:    # the model's gates: sigmoid forget, exp(clip) input
        a = 1.0 / (1.0 + np.exp(-rng.normal(0, 2.0, (B, T, H))))
        i = np.exp(rng.uniform(-10.0, 10.0, (B, T, H)))
    else:
        a = rng.uniform(0.7, 1.0, (B, T, H))
        i = rng.uniform(0.1, 1.0, (B, T, H))
    return q, k, v, a.astype(np.float32), i.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jitted(what):
    if what == "oracle":
        return jax.jit(jref.gla_ref)
    return jax.jit(functools.partial(mlstm_chunked_kernel, chunk=CHUNK,
                                     interpret=True))


def _jax(what, arrays) -> np.ndarray:
    return np.asarray(_jitted(what)(*(jnp.asarray(x) for x in arrays)),
                      np.float32)


@pytest.mark.parametrize("what", ["oracle", "interpret"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_two_passes_in_f32_equal_the_jax_package(shape, what):
    arrays = _inputs(7, *SHAPES[shape])
    got = mlstm_split(*(torch.from_numpy(x) for x in arrays)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _jax(what, arrays), atol=2e-3, rtol=2e-3)


def _normwise(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _normwise_max_block(got, want) -> float:
    """Largest normwise error over (batch, 128-step chunk, head) tiles."""
    B, T, H, P = want.shape
    pad = -T % BLOCK_T
    d = np.pad((got - want) ** 2, ((0, 0), (0, pad), (0, 0), (0, 0)))
    w = np.pad(want ** 2, ((0, 0), (0, pad), (0, 0), (0, 0)))
    d = d.reshape(B, -1, BLOCK_T, H, P).sum((2, 4))
    w = w.reshape(B, -1, BLOCK_T, H, P).sum((2, 4))
    return float(np.sqrt(d / w).max())


def _bf16_inputs(shape, seed):
    """q, k and v rounded to bf16 (the gates stay f32), as torch tensors,
    and the f32 arrays of the same values for the JAX package."""
    q, k, v, a, i = _inputs(seed, *SHAPES[shape])
    t = [torch.from_numpy(x).bfloat16() for x in (q, k, v)]
    args = t + [torch.from_numpy(a), torch.from_numpy(i)]
    return args, [x.float().numpy() for x in args]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_pairs_meet_the_normwise_bar(shape):
    args, arrays32 = _bf16_inputs(shape, 11)
    want = _jax("oracle", arrays32)
    got = mlstm_split(*args, how="pair").numpy()
    assert _normwise(got, want) <= 1e-4
    out = torch.from_numpy(got).bfloat16().float().numpy()   # y is bf16
    assert _normwise(out, want) <= NORMWISE_TOL
    assert _normwise_max_block(out, want) <= NORMWISE_TOL


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_pairs_hold_the_elementwise_bar(shape):
    """Rounded to bf16, the split's output is within atol = rtol = 3e-2 of
    the plain version on the same bf16 inputs, with no element outside."""
    args, _ = _bf16_inputs(shape, 13)
    want = ref.mlstm_chunked_ref(*args).float()
    got = mlstm_split(*args, how="pair").bfloat16().float()
    assert torch.isclose(got, want, atol=3e-2, rtol=3e-2).all()


def test_one_bf16_rounding_a_product_costs_far_more_than_pairs():
    """Before the output is rounded, at the model's gate range: pairs err
    by 2.2e-5 normwise, one rounding per operand by 1.8e-3, ~80x that and
    more than the bf16 output's own rounding (1.5e-3)."""
    args, arrays32 = _bf16_inputs("model_gate_range", 17)
    want = _jax("oracle", arrays32)
    pairs = _normwise(mlstm_split(*args, how="pair").numpy(), want)
    once = _normwise(mlstm_split(*args, how="bf16").numpy(), want)
    out = _normwise(torch.from_numpy(want.copy()).bfloat16().float().numpy(),
                    want)
    assert once > 10 * pairs
    assert once > out
    assert once < NORMWISE_TOL
