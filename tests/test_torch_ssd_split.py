"""The SSD split that the CUDA Mamba2 scan (``csrc/mamba2_scan.cu``) runs.

The kernel computes the scan in three passes, parallel over (batch, chunk,
head): per chunk of Q steps the chunk state S_c = (X o exp(total - cum))^T
B; per (batch, head) the recurrence h_c = h_{c-1} exp(total_c) + S_c with
explicit f32 states; per chunk y = ((C B^T) o L) X + exp(cum) (C h_{c-1}^T).
A plain model of those passes is held here, on the CPU with seeded numpy
inputs, to the JAX package's sequential oracle ``mamba2_scan_ref``:

* in f32 at the kernel's chunk lengths (128 for bf16, 64 for f32), with a
  ragged T, several chunks and a decay of 1e-12, within the JAX package's
  2e-3;
* on bf16 inputs with the operands the kernel makes rounded as it rounds
  them — W = (C B^T) o L, X o exp(total - cum) and h_{c-1}, each as a pair
  hi + lo of bf16 — within the 1e-2 normwise bar (over the output and over
  each block's tile: a chunk of 128 steps of one head), and within 3e-2 of
  the plain version elementwise once rounded to bf16;
* and, for the record of why the kernel carries pairs: with each of those
  operands rounded once to bf16 the products alone err by about as much
  as the bf16 output's own rounding (~2e-3 normwise), where the pairs
  leave ~3e-6; the elementwise bar on a 21-million-element output with an
  rms of 2.5 (zamba2's captured inputs) has less room than these shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402

BF16_CHUNK, F32_CHUNK = 128, 64          # the kernel's chunk lengths
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


def ssd_split(xh, a, b, c, Q: int, how: str = "f32") -> torch.Tensor:
    """The kernel's three passes in plain PyTorch, f32 throughout except
    for the operands ``_round`` rounds; returns y (B, T, H, P) in f32."""
    B, T, H, P = xh.shape
    N = b.shape[-1]
    nc = -(-T // Q)
    pad = nc * Q - T
    x = torch.nn.functional.pad(xh.float(), (0, 0, 0, 0, 0, pad))
    av = torch.nn.functional.pad(a.float(), (0, 0, 0, pad), value=1.0)
    bv = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
    cv = torch.nn.functional.pad(c.float(), (0, 0, 0, pad))
    x = x.view(B, nc, Q, H, P)
    bv, cv = bv.view(B, nc, Q, N), cv.view(B, nc, Q, N)
    cum = torch.cumsum(torch.log(av.clamp(min=1e-20)).view(B, nc, Q, H), 2)
    total = cum[:, :, -1]                                   # (B, nc, H)
    # 1. chunk states
    xw = _round(x * torch.exp(total[:, :, None] - cum)[..., None], how)
    S = torch.einsum("bcshp,bcsn->bchpn", xw, bv)
    # 2. state passing, explicit f32 states
    h = torch.zeros(B, H, P, N)
    h_prev = []
    for ci in range(nc):
        h_prev.append(h)
        h = h * torch.exp(total[:, ci])[..., None, None] + S[:, ci]
    h_prev = _round(torch.stack(h_prev, 1), how)           # (B, nc, H, P, N)
    # 3. chunk scan
    G = torch.einsum("bcqn,bcsn->bcqs", cv, bv)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,q,s,H)
    causal = torch.ones(Q, Q, dtype=torch.bool).tril()[None, None, :, :, None]
    L = torch.where(causal, torch.exp(diff.clamp(max=0.0)), 0.0)
    W = _round(G[..., None] * L, how)
    y = torch.einsum("bcqsh,bcshp->bcqhp", W, x)
    y = y + torch.einsum("bcqn,bchpn->bcqhp", cv, h_prev) \
        * torch.exp(cum)[..., None]
    return y.reshape(B, nc * Q, H, P)[:, :T]


def _inputs(seed, B, T, H, P, N, a_lo):
    rng = np.random.default_rng(seed)
    xh = rng.normal(0, 0.5, (B, T, H, P)).astype(np.float32)
    a = rng.uniform(a_lo, 1.0, (B, T, H)).astype(np.float32)
    b = rng.normal(0, 0.3, (B, T, N)).astype(np.float32)
    c = rng.normal(0, 0.3, (B, T, N)).astype(np.float32)
    return xh, a, b, c


def _oracle(xh, a, b, c) -> np.ndarray:
    """The JAX package's sequential scan, in f32."""
    y, _ = jax.jit(jref.mamba2_scan_ref)(*(jnp.asarray(v) for v in
                                            (xh, a, b, c)))
    return np.asarray(y, np.float32)


SHAPES = {   # (B, T, H, P, N, smallest decay)
    "ragged_three_chunks": (2, 300, 2, 64, 64, 0.6),
    "strong_decay": (1, 150, 2, 32, 16, 1e-12),
    "long_memory_n128": (1, 400, 2, 64, 128, 0.99),
    "one_short_chunk": (2, 37, 3, 16, 16, 0.8),
}


@pytest.mark.parametrize("Q", [BF16_CHUNK, F32_CHUNK])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_three_passes_in_f32_equal_the_oracle(shape, Q):
    arrays = _inputs(7, *SHAPES[shape])
    got = ssd_split(*(torch.from_numpy(v) for v in arrays), Q).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _oracle(*arrays), atol=2e-3, rtol=2e-3)


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
    """Inputs rounded to bf16 (the decay stays f32), as torch tensors, and
    the f32 arrays of the same values for the oracle."""
    xh, a, b, c = _inputs(seed, *SHAPES[shape])
    t = [torch.from_numpy(v).bfloat16() for v in (xh, b, c)]
    args = [t[0], torch.from_numpy(a), t[1], t[2]]
    return args, [v.float().numpy() for v in args]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_pairs_meet_the_normwise_bar(shape):
    args, arrays32 = _bf16_inputs(shape, 11)
    want = _oracle(*arrays32)
    got = ssd_split(*args, BF16_CHUNK, how="pair").numpy()
    assert _normwise(got, want) <= 1e-4
    out = torch.from_numpy(got).bfloat16().float().numpy()   # y is bf16
    assert _normwise(out, want) <= NORMWISE_TOL
    assert _normwise_max_block(out, want) <= NORMWISE_TOL


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bf16_pairs_hold_the_elementwise_bar(shape):
    """Rounded to bf16, the split's output is within atol = rtol = 3e-2 of
    the plain version on the same bf16 inputs, with no element outside."""
    args, _ = _bf16_inputs(shape, 13)
    want = ref.mamba2_scan_ref(*args).float()
    got = ssd_split(*args, BF16_CHUNK, how="pair").bfloat16().float()
    assert torch.isclose(got, want, atol=3e-2, rtol=3e-2).all()


def test_one_bf16_rounding_a_product_costs_far_more_than_pairs():
    """Before the output is rounded: pairs err by ~3e-6 normwise, one
    rounding per operand by ~2e-3, still inside the normwise bar."""
    args, arrays32 = _bf16_inputs("long_memory_n128", 17)
    want = _oracle(*arrays32)
    pairs = _normwise(ssd_split(*args, BF16_CHUNK, how="pair").numpy(), want)
    once = _normwise(ssd_split(*args, BF16_CHUNK, how="bf16").numpy(), want)
    assert once > 10 * pairs
    assert 2.0**-12 < once < NORMWISE_TOL
