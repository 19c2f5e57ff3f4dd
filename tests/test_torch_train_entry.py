"""PyTorch port: the trainer's weights export, checkpoints, entry point and
device rules.

- ``save_params`` writes what the JAX package's ``save_params`` writes for
  the same parameters (same keys, fp16 arrays of two or more dimensions,
  f32 otherwise), the JAX package's ``load_params`` reads it, and its
  ``apply`` on those weights equals the port's forward (f32, atol 1e-5);
- a checkpoint saved after 2 steps and resumed for 2 more equals 4 straight
  steps (parameters, Adam moments, step and data stream), on the CPU;
- ``main(device="cpu")`` trains, logs "training done" and writes the npz;
- ``Trainer()`` without ``device="cpu"`` raises without a card;
- ``remat=True`` gives the gradients of the plain forward."""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.models import registry as jreg
from image_restoration_platform_tpu.models import unet as junet
from image_restoration_platform_tpu.models import weights as JW
from image_restoration_platform_tpu_torch.models import get_family
from image_restoration_platform_tpu_torch.models import weights as W
from image_restoration_platform_tpu_torch.train import Trainer, TrainConfig
from image_restoration_platform_tpu_torch.train import __main__ as train_main
from image_restoration_platform_tpu_torch.train import trainer as T

torch.set_num_threads(2)
SMALL = "restore-unet-small"


def _trained_small_state(seed=0):
    """restore-unet-small with random weights everywhere (the head too)."""
    model = get_family(SMALL).build().init_(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.head.w.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(seed + 1))
    return model.state_dict()


def test_export_is_the_jax_layout_and_serves_in_jax(tmp_path):
    state = _trained_small_state()
    W.save_params(state, str(tmp_path / "f32.npz"), half_precision=False)
    W.save_params(state, str(tmp_path / "half.npz"))
    assert sorted(os.listdir(tmp_path)) == ["f32.npz", "half.npz"]  # no .tmp left behind

    jfam = jreg.get_family(SMALL)
    template = jax.jit(lambda k: jfam.init(k, jfam.config))(jax.random.PRNGKey(0))
    jparams = JW.load_params(template, str(tmp_path / "f32.npz"))
    # the JAX package's own export of the same parameters is the same file content
    JW.save_params(jparams, str(tmp_path / "jax_half.npz"))
    ours, theirs = W.load_npz(str(tmp_path / "half.npz")), W.load_npz(str(tmp_path / "jax_half.npz"))
    assert set(ours) == set(theirs) == set(W.flatten_params(template))
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype and ours[key].shape == theirs[key].shape, key
        np.testing.assert_array_equal(ours[key], theirs[key], err_msg=key)
    assert ours["stem/w"].dtype == np.float16 and ours["stem/b"].dtype == np.float32

    rng = np.random.default_rng(1)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    cond = rng.random((2, 28)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = junet.apply(jparams, jnp.asarray(x), jnp.asarray(cond), config=jfam.config)
    model = get_family(SMALL).build()
    model.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    # and the port reads its own fp16 export back within fp16's storage error
    back = W.load_state_dict(str(tmp_path / "half.npz"))
    for key, value in state.items():
        np.testing.assert_allclose(back[key].numpy(), value.numpy(), rtol=1e-3, atol=1e-6, err_msg=key)


def test_save_params_replaces_an_existing_file(tmp_path):
    path = str(tmp_path / "w" / "restore-unet-small.npz")
    W.save_params(_trained_small_state(0), path)
    W.save_params(_trained_small_state(5), path)
    assert os.listdir(tmp_path / "w") == ["restore-unet-small.npz"]
    np.testing.assert_allclose(W.load_state_dict(path)["stem.b"].numpy(),
                               _trained_small_state(5)["stem.b"].numpy(), atol=1e-6)


def _small_cfg(**kw):
    return TrainConfig(family=SMALL, batch_size=2, image_size=32, total_steps=20, warmup_steps=2,
                       learning_rate=1e-3, compute_dtype=torch.float32, data_photo=True, data_deconv=True,
                       data_mix_mild=0.5, data_mix_rich=0.2, anchor_comp=0.5, seed=7, **kw)


def _with_random_head(trainer):
    with torch.no_grad():
        trainer.state.model.head.w.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(3))
    return trainer


def test_checkpoint_resume_equals_straight_steps(tmp_path):
    straight = _with_random_head(Trainer(_small_cfg(), device="cpu"))
    straight.run(4, log_every=100)

    first = _with_random_head(Trainer(_small_cfg(), device="cpu", checkpoint_dir=str(tmp_path)))
    first.run(2, log_every=100)
    path = first.save_checkpoint()
    assert path == os.path.join(str(tmp_path), "step_2.pt")
    resumed = Trainer(_small_cfg(), device="cpu")
    resumed.resume_checkpoint(path)
    assert resumed.state.step == 2
    resumed.run(2, log_every=100)

    assert resumed.state.step == straight.state.step == 4
    for (name, a), b in zip(straight.state.model.state_dict().items(), resumed.state.model.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=name)
    moved = straight.state.model.head.w.detach() - first.load_params(path)["head.w"]
    assert float(moved.abs().max()) > 0.0
    sa, sb = straight.state.optimizer.state_dict()["state"], resumed.state.optimizer.state_dict()["state"]
    for i in sa:
        for key in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(sb[i][key], sa[i][key], rtol=0, atol=0)


def test_main_trains_logs_and_exports(tmp_path, monkeypatch):
    for key, value in {"TRAIN_FAMILY": SMALL, "TRAIN_STEPS": "2", "TRAIN_SIZE": "32", "TRAIN_BATCH": "2",
                       "TRAIN_EXPORT_EVERY": "1", "TRAIN_CKPT_DIR": str(tmp_path / "ckpt"),
                       "IRP_WEIGHTS_DIR": str(tmp_path / "weights")}.items():
        monkeypatch.setenv(key, value)
    records = []
    handler = logging.Handler()
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("irp.train-main")
    logger.addHandler(handler)
    try:
        train_main.main(device="cpu")
    finally:
        logger.removeHandler(handler)
    said = " ".join(records)
    for line in ("pre-train eval", "interim export", "training done", "post-train eval", "no-harm eval",
                 "weights exported"):
        assert line in said, line
    path = tmp_path / "weights" / f"{SMALL}.npz"
    state = W.load_state_dict(str(path))
    get_family(SMALL).build().load_state_dict(state, strict=True)
    assert os.listdir(tmp_path / "ckpt") == ["step_2.pt"]


def test_config_from_env_reads_the_reference_variables(monkeypatch):
    env = {"TRAIN_FAMILY": "restore-unet", "TRAIN_BATCH": "32", "TRAIN_SIZE": "128", "TRAIN_LR": "2e-5",
           "TRAIN_IDENTITY_WEIGHT": "6.0", "TRAIN_DATA_PHOTO": "1", "TRAIN_DATA_DECONV": "1",
           "TRAIN_DATA_GRAIN": "1", "TRAIN_DATA_SMOOTH": "1", "TRAIN_DATA_MIX_MILD": "0.5",
           "TRAIN_DATA_MIX_RICH": "0.2", "TRAIN_DATA_COMP_SOLO": "0.3", "TRAIN_DATA_LOWLIGHT_SOLO": "0.18",
           "TRAIN_ANCHOR_COMP": "0.5", "TRAIN_SEED": "601", "TRAIN_DIFFUSION_SAMPLER_STEPS": "0"}
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    cfg = train_main.config_from_env(4000)
    assert cfg == TrainConfig(family="restore-unet", batch_size=32, image_size=128, learning_rate=2e-5,
                              total_steps=4000, identity_weight=6.0, data_photo=True, data_deconv=True,
                              data_grain=True, data_smooth=True, data_mix_mild=0.5, data_mix_rich=0.2,
                              data_compression_solo=0.3, data_lowlight_solo=0.18, anchor_comp=0.5, seed=601)


def test_trainer_needs_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_small_cfg())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main.main()
    assert Trainer(_small_cfg(), device="cpu").state.model.stem.w.device.type == "cpu"


def test_remat_gives_the_plain_gradients():
    batch = tuple(t[:2] for t in (torch.rand(2, 32, 32, 3), torch.rand(2, 32, 32, 3), torch.rand(2, 28),
                                  torch.tensor([1.0, 0.0])))
    grads = []
    for remat in (False, True):
        ts, init = T.make_train_step(_small_cfg(remat=remat), "cpu")
        model = init().model
        with torch.no_grad():
            model.head.w.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(3))
        loss = ts.loss(model, *batch)
        grads.append([g.clone() for g in torch.autograd.grad(loss, list(model.parameters()))])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-7)
