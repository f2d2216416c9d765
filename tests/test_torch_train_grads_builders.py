"""The port's gradients of ``Model.train_loss`` against ``jax.grad`` for the
encoder-decoder (seamless), the Mamba2 hybrid (zamba2) and xLSTM: the
check, its weights and its bar are ``test_torch_train_grads.py``'s."""

import pytest

pytest.importorskip("jax")
import torch  # noqa: E402

from test_torch_train_grads import check_gradients  # noqa: E402

FAMILIES = ("seamless_m4t_large_v2", "zamba2_2_7b", "xlstm_350m")


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_equal_jax_grad(arch):
    check_gradients(arch)
