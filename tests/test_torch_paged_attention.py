"""Paged decode attention: the port's plain PyTorch version against the
JAX package's oracle (``repro.kernels.ref.paged_attention_ref``) and its
Pallas body in interpret mode, on the same numpy inputs
(``repro_torch.kernels.cases.paged_cases``), at the JAX package's own
tolerances for this kernel: atol = rtol = 3e-5 in f32, 3e-2 in bf16.

The CUDA kernel is held to the plain version on the card by
``chip_smoke.py`` (phase ``paged_fuzz``) and by the ``gpu`` test below,
which skips on a machine without one and needs no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_paged_attention.py
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
    from repro.kernels.paged_attention import paged_attention_kernel
except ImportError:
    jax = None
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX package")

CASES = cases.paged_cases()
BY_NAME = {c["name"]: c for c in CASES}
#: the four shapes of the JAX package's own sweep, in both types
SWEEP = [c for c in CASES
         if c["name"].rsplit("_", 1)[0] in ("mqa", "gqa4", "mha_dh256",
                                           "gqa3_page32")]
if jax is not None:
    # one compilation per shape instead of one per primitive
    ORACLE = jax.jit(jref.paged_attention_ref)
    INTERPRET = jax.jit(functools.partial(paged_attention_kernel,
                                          interpret=True))


def _jax_args(case):
    dtype = jnp.dtype(case["dtype"])
    return [jnp.asarray(case[f], dtype if case[f].dtype == np.float32
                        else jnp.int32)
            for f in cases.TENSOR_FIELDS["paged_attention"]]


def _close(got, want, case):
    tol = cases.PAGED_TOL[case["dtype"]]
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _port(case):
    out = ref.paged_attention_ref(*cases.paged_tensors(case, "cpu"))
    assert out.dtype == getattr(torch, case["dtype"])
    return out.float().numpy()


@needs_jax
@pytest.mark.parametrize("case", SWEEP, ids=[c["name"] for c in SWEEP])
def test_plain_version_equals_jax_oracle_and_interpret_kernel(case):
    got = _port(case)
    args = _jax_args(case)
    _close(got, ORACLE(*args), case)
    _close(got, INTERPRET(*args), case)


@needs_jax
@pytest.mark.parametrize(
    "case", [c for c in CASES if c not in SWEEP],
    ids=[c["name"] for c in CASES if c not in SWEEP])
def test_plain_version_equals_jax_oracle_on_the_other_cases(case):
    """Ragged lengths, repeated page ids, seq_len = 0, the Qwen2-1.5B
    geometry and the kernel's limits, against the oracle."""
    _close(_port(case), ORACLE(*_jax_args(case)), case)


@needs_jax
def test_seq_len_zero_is_the_mean_of_the_tables_v_rows():
    """Every score is -1e30, so the softmax is uniform over the table (the
    oracle's answer; the Pallas body returns 0)."""
    case = BY_NAME["seq_len_zero_f32"]
    q, kp, vp, pt, sl = cases.paged_tensors(case, "cpu")
    got = ops.paged_attention(q, kp, vp, pt, sl)
    hk = kp.shape[2]
    g = q.shape[1] // hk
    for b in np.flatnonzero(case["seq_lens"] == 0):
        rows = vp[pt[b].long()].reshape(-1, hk, vp.shape[3]).mean(0)
        want = rows.repeat_interleave(g, dim=0)
        torch.testing.assert_close(got[b], want, atol=3e-5, rtol=3e-5)
        assert float(got[b].abs().max()) > 0.0
    pallas = np.asarray(INTERPRET(*_jax_args(case)))
    assert not np.any(pallas[case["seq_lens"] == 0])


def test_repeated_page_ids_read_the_same_page_twice():
    case = BY_NAME["repeated_page_ids_f32"]
    q, kp, vp, pt, sl = cases.paged_tensors(case, "cpu")
    got = ops.paged_attention(q, kp, vp, pt, sl)
    # sequence 2 reads page 0 three times: the same as page 0 once over a
    # third of the length, since each position repeats three times
    ps = kp.shape[1]
    once = ops.paged_attention(q[2:], kp, vp, pt[2:, :1],
                               torch.tensor([ps], dtype=torch.int32))
    torch.testing.assert_close(got[2:], once, atol=3e-5, rtol=3e-5)


def test_cpu_tensors_take_the_plain_version():
    case = BY_NAME["gqa4_f32"]
    args = cases.paged_tensors(case, "cpu")
    ops.reset_launch_counts()
    got = ops.paged_attention(*args)
    assert torch.equal(got, ref.paged_attention_ref(*args))
    assert ops.launch_counts()["paged_attention"] == 0


def test_a_cuda_tensor_never_takes_the_plain_version():
    """A ``meta`` tensor stands in for a CUDA one where there is no card:
    the wrapper refuses it instead of computing on the CPU."""
    q = torch.zeros((1, 4, 128), device="meta")
    kp = torch.zeros((4, 16, 1, 128), device="meta")
    pt = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    sl = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises((RuntimeError, ValueError, OSError)):
        ops.paged_attention(q, kp, kp, pt, sl)


@pytest.mark.gpu
def test_cuda_kernel_equals_plain_version_on_every_case():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc (run on the card: "
                    "python3 chip_smoke.py --phases env,build,paged_fuzz)")
    ops.reset_launch_counts()
    for case in CASES:
        args = cases.paged_tensors(case, "cuda")
        got = ops.paged_attention(*args)
        torch.cuda.synchronize()
        want = ref.paged_attention_ref(*args)
        tol = cases.PAGED_TOL[case["dtype"]]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=case["name"])
    assert ops.launch_counts()["paged_attention"] == len(CASES)
