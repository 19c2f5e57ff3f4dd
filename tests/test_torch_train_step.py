"""PyTorch port: the train step of the restore and SR branches against the
JAX trainer (the restore branch with the identity weight and the
compression-only anchor; SR with the limiter off), one and three steps.
The inputs, the narrow models and the bars are in tests/torch_train_parity.py."""

import pytest
import torch

from torch_train_parity import check_train_steps, narrow_families, train_config
from image_restoration_platform_tpu_torch.models import registry as treg
from image_restoration_platform_tpu_torch.train import trainer as T

torch.set_num_threads(2)


@pytest.fixture(scope="module", autouse=True)
def families():
    with narrow_families():
        yield


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("branch", ["restore_anchor", "sr"])
def test_train_steps_match_jax(branch, steps):
    check_train_steps(branch, steps)


def test_schedule_and_branch_dispatch():
    """The SR branch trains with the limiter off, over serving's parameters."""
    ts, init = T.make_train_step(train_config("sr", T), "cpu")
    state = init()
    assert state.model.config.limit_pool == 0 and ts.model_cfg.limit_pool == 32
    assert set(state.model.state_dict()) == set(treg.get_family("sr-x2-narrow").build().state_dict())
    assert ts.is_sr and not ts.is_diffusion
    assert T.make_train_step(train_config("sampler_aware", T), "cpu")[0].is_diffusion


def test_a_family_the_trainer_has_no_loss_for_is_refused_by_name():
    """SwinIR has no training branch: building its step refuses it, naming
    it, before any model is built."""
    with pytest.raises(ValueError, match="swinir-m-x2"):
        T.make_train_step(T.TrainConfig(family="swinir-m-x2"), "cpu")
