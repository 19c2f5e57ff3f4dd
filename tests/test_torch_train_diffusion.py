"""PyTorch port: the train step of the diffusion branches against the JAX
trainer: the denoising loss with eps and with x0 prediction, and the
sampler-aware loss through the 2-step DDIM ``restore`` with autograd on,
one and three steps, with each step's JAX draws injected. The inputs, the
narrow models and the bars are in tests/torch_train_parity.py."""

import pytest
import torch

from torch_train_parity import check_train_steps, narrow_families

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def families():
    with narrow_families():
        yield


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("branch", ["diffusion_eps", "diffusion_x0", "sampler_aware"])
def test_train_steps_match_jax(branch, steps):
    check_train_steps(branch, steps)
