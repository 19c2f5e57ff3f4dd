"""PyTorch port: the trainer's executable tier (train/exec.py, ``Trainer``'s
``ExecCache``) on the CPU, and graph replay against eager steps on the card.

Counterpart of the reference's two jits outside serving: ``jax.jit`` of the
train step and ``synthetic_batch`` jitted once per ``DataConfig``. On the
CPU nothing is captured: the executables run the same step and draw
eagerly under the same keys, so these tests hold the keys and
``compile_count``, that the tier changed no arithmetic (bit for bit against
direct ``TrainStep`` calls on ``synthetic_batch`` draws), the in-place
resume into a trainer whose executables exist, the per-device constants of
the data path against constants made at every call, and the optimizer the
trainer drives (fused AdamW, ``capturable=True``) through the trainer
against the reference's train step. The ``cuda``-marked test replays the
graphs against ``Trainer(eager=True)`` on the card (``chip_smoke.py``
phase 6 does so at full width)."""

import dataclasses

import pytest
import torch

from image_restoration_platform_tpu_torch.train import DataConfig, Trainer, TrainConfig, synthetic_batch
from image_restoration_platform_tpu_torch.train import data as D

torch.set_num_threads(2)

SMALL = "restore-unet-small"
# the r5-anchor recipe (scripts/queues/r5_anchor.json) at 32 px, batch 2:
# three distributions (deconv photo, mild photo 0.5, rich 0.2)
R5 = dict(family=SMALL, batch_size=2, image_size=32, total_steps=40, warmup_steps=2, learning_rate=1e-3,
          compute_dtype=torch.float32, identity_weight=6.0, data_photo=True, data_deconv=True, data_grain=True,
          data_smooth=True, data_mix_mild=0.5, data_mix_rich=0.2, data_compression_solo=0.3,
          data_lowlight_solo=0.18, anchor_comp=0.5, seed=601)


def _trainer(**kw) -> Trainer:
    """A CPU trainer on the small recipe, its zero output head given random
    weights so that every parameter moves from the first step."""
    trainer = Trainer(TrainConfig(**{**R5, **kw}), device="cpu")
    with torch.no_grad():
        trainer.state.model.head.w.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(3))
    return trainer


def _params(trainer) -> list[torch.Tensor]:
    return [p.detach().clone() for p in trainer.state.model.parameters()]


def test_trainer_executables_equal_direct_eager_steps():
    """``Trainer.run`` through the executables gives the losses and the
    parameters of ``TrainStep`` called on ``synthetic_batch`` draws of the
    same stream, bit for bit."""
    steps = 6
    tiered = _trainer()
    losses = tiered.run(steps, log_every=1)
    direct = _trainer()
    want = []
    for _ in range(steps):
        batch = synthetic_batch(direct._data_gen, direct.cfg.batch_size, direct._next_data_config(), with_masks=True)
        want.append(float(direct.step_fn(direct.state, *batch)))
    assert losses == want
    assert tiered.state.step == direct.state.step == steps
    for a, b in zip(_params(tiered), _params(direct)):
        assert torch.equal(a, b)
    assert torch.equal(tiered._data_gen.get_state(), direct._data_gen.get_state())


def test_compile_count_is_one_step_and_one_per_distribution():
    """The r5-anchor mix: one step executable and one data executable per
    DataConfig after warm-up (the rich distribution first comes at step
    5), and none built after; nothing is captured on the CPU."""
    trainer = _trainer()
    trainer.run(6, log_every=100)
    assert trainer.compile_count == 1 + 3
    assert trainer.exec_stats() == {"compile_count": 4, "executables": 4, "graphs": 0}
    trainer.run(10, log_every=100)
    assert trainer.compile_count == 4


def test_resume_into_built_executables_continues_the_uninterrupted_run(tmp_path):
    """A checkpoint resumed into a trainer that already built its
    executables (and stepped its optimizer) continues the losses and
    parameters of a run that was never interrupted, bit for bit, without a
    build: the state is copied into the live tensors."""
    straight = _trainer()
    losses = straight.run(5, log_every=1)
    first = _trainer()
    first.run(2, log_every=100)
    path = first.save_checkpoint(str(tmp_path))
    resumed = _trainer(seed=R5["seed"] + 1)  # another run: other weights, batches and moments
    resumed.run(5, log_every=100)  # every executable of the mix built
    builds = resumed.compile_count
    moments = [resumed.state.optimizer.state[p]["exp_avg"] for p in resumed.state.model.parameters()]
    resumed.resume_checkpoint(path)
    assert resumed.state.step == 2
    assert all(resumed.state.optimizer.state[p]["exp_avg"] is m for p, m in zip(resumed.state.model.parameters(),
                                                                                  moments))
    assert resumed.run(3, log_every=1) == losses[2:]
    assert resumed.compile_count == builds
    for a, b in zip(_params(straight), _params(resumed)):
        assert torch.equal(a, b)


def test_optimizer_is_fused_capturable_with_a_device_lr():
    """The optimizer a CUDA graph can hold: fused AdamW with
    ``capturable=True``, its learning rate and step counts tensors on the
    parameters' device, the lr filled from the schedule before each step."""
    trainer = _trainer()
    group = trainer.state.optimizer.param_groups[0]
    assert group["fused"] and group["capturable"]
    assert isinstance(group["lr"], torch.Tensor) and group["lr"].device.type == "cpu"
    lr = group["lr"]
    trainer.run(3, log_every=100)
    assert group["lr"] is lr and float(lr) == pytest.approx(trainer.step_fn.schedule(2))
    steps = {float(trainer.state.optimizer.state[p]["step"]) for p in trainer.state.model.parameters()}
    assert steps == {3.0}


@pytest.mark.parametrize("branch", ["restore_anchor", "sr"])
def test_trainer_steps_match_the_reference_train_step(branch):
    """Three steps through ``Trainer.train_step`` (the executable tier,
    fused capturable AdamW) against the reference's ``make_train_step``
    (its own ``loss_fn`` and optax optimizer) on the narrow families, held
    to tests/torch_train_parity.py's bars (loss rtol 1e-5; parameters within
    1e-5 of each tensor's largest plus Adam's per-element lr allowance)."""
    import torch_train_parity as P  # imports jax: kept out of the card's collection

    with P.narrow_families():
        P.check_train_steps(branch, 3, through_trainer=True)


@pytest.mark.parametrize("config", [
    DataConfig(size=32),
    DataConfig(size=32, photo=True, deconv=True, grain=True, smooth=True, compression_solo=0.3, lowlight_solo=0.18),
    DataConfig(size=32, photo=True, grain=True, smooth=True, compression_solo=0.3, lowlight_solo=0.18),
    DataConfig(size=32, photo=False, clean_fraction=0.15),
], ids=["default", "r5_deconv", "r5_mild", "r5_rich"])
def test_synthetic_batch_with_device_constants_equals_per_call_constants(config, monkeypatch):
    """``synthetic_batch`` with its constants made once per device gives
    the draws it gave when it made them at every call, bit for bit, over
    three draws (the cached constants are read, never written)."""
    def draws():
        gen = torch.Generator().manual_seed(11)
        return [synthetic_batch(gen, 3, config, with_masks=True) for _ in range(3)]

    D._constants(torch.device("cpu"))  # made before, as a captured draw finds them
    cached = draws()
    monkeypatch.setattr(D, "_constants", D._make_constants)
    per_call = draws()
    for a, b in zip(cached, per_call):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_trainer_keys_the_step_by_its_structure():
    """The step's key holds its structure (here: remat); an eager trainer
    on the CPU builds one executable per key as the default one does."""
    trainer = _trainer()
    batch = trainer.next_batch()
    first = trainer._step_executable(batch)
    assert trainer._step_executable(batch) is first
    trainer.cfg = dataclasses.replace(trainer.cfg, remat=True)
    assert trainer._step_executable(batch) is not first
    eager = Trainer(TrainConfig(**R5), device="cpu", eager=True)
    eager.run(2, log_every=100)
    assert eager.compile_count == 1 + 2 and eager.exec_stats()["graphs"] == 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", [SMALL, "diffusion-restore"])
def test_graph_trainer_replays_equal_eager_steps(card, family):
    """On the card, with cuDNN's deterministic algorithms on both sides: the
    captured step and data draws give ``Trainer(eager=True)``'s batches,
    losses and parameters bit for bit over the r5-anchor mix's three
    distributions (the diffusion branch: its registered noise generator),
    with one step graph and one graph per distribution built, none after."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        kw = dict(R5, family=family, batch_size=4, image_size=64)
        graph = Trainer(TrainConfig(**kw), device=card)
        eager = Trainer(TrainConfig(**kw), device=card, eager=True)
        for _ in range(8):
            a, b = graph.next_batch(), eager.next_batch()
            assert all(torch.equal(x, y) for x, y in zip(a, b))
            assert torch.equal(graph.train_step(a), eager.train_step(b))
        assert graph.exec_stats() == {"compile_count": 4, "executables": 4, "graphs": 4}
        assert all(torch.equal(p, q) for p, q in zip(graph.state.model.parameters(), eager.state.model.parameters()))
    finally:
        torch.backends.cudnn.deterministic = deterministic

