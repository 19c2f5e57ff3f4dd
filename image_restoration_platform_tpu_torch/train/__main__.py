"""Training entry point: ``python -m image_restoration_platform_tpu_torch.train``.

Counterpart of ``python -m image_restoration_platform_tpu.train``, with the
same environment variables: TRAIN_FAMILY, TRAIN_STEPS, TRAIN_BATCH,
TRAIN_SIZE, TRAIN_LR, TRAIN_SEED, TRAIN_RESUME (warm start from the family's
npz), TRAIN_CKPT_DIR (``torch.save`` checkpoints), TRAIN_EXPORT_EVERY
(interim npz exports), the TRAIN_DATA_* distribution knobs,
TRAIN_IDENTITY_WEIGHT, TRAIN_ANCHOR_COMP, TRAIN_DIFFUSION_SAMPLER_STEPS, and
IRP_WEIGHTS_DIR (where ``weights/<family>.npz`` is written, in the layout
the JAX package reads). Trains on synthetic degradations (train/data.py) on
the card, and logs a PSNR report (degraded vs restored) on a held-out batch
before and after.
"""

import os
import time

import numpy as np
import torch

from ..classify.fused import batch_classify_and_condition
from ..models import diffusion as diff_mod
from ..models import get_family
from ..models import weights as weights_mod
from ..ops.cuda.attention import flash_kernel
from ..utils.logging import get_logger
from .data import DataConfig, _random_clean_rich, synthetic_batch
from .trainer import Trainer, TrainConfig


def psnr(a, b):
    mse = float(torch.mean((a.float() - b.float()) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-10))


def _serving_model(family_name: str, state: dict, device) -> torch.nn.Module:
    """The family's serving module (the SR limiter on) over ``state``."""
    model = get_family(family_name).build().to(device)
    model.load_state_dict(state, strict=True)
    return model.eval()


@torch.no_grad()
def evaluate(state, family_name, seed, n=16, size=128, photo=False, device="cuda"):
    """(PSNR of the degraded batch, PSNR of the model's output) against the
    clean batch drawn from ``seed``; the model runs in bf16 as it serves."""
    family = get_family(family_name)
    model = _serving_model(family_name, state, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    degraded, clean, cond = synthetic_batch(gen, n, DataConfig(size=size, photo=photo))
    if family_name == "diffusion-restore":
        restored = diff_mod.restore(model, degraded, cond, gen, family.config)
        return psnr(degraded, clean), psnr(restored, clean)
    if family_name.startswith("sr-"):
        scale = family.config.scale
        b, h, w, c = degraded.shape
        lr = degraded.reshape(b, h // scale, scale, w // scale, scale, c).mean(dim=(2, 4))
        pred = torch.clamp(model(lr.to(torch.bfloat16)).float(), 0.0, 1.0)
        baseline = lr.repeat_interleave(scale, dim=1).repeat_interleave(scale, dim=2)
        return psnr(baseline, clean), psnr(pred, clean)
    pred = torch.clamp(model(degraded.to(torch.bfloat16), cond.to(torch.bfloat16)).float(), 0.0, 1.0)
    return psnr(degraded, clean), psnr(pred, clean)


@torch.no_grad()
def no_harm_eval(state, family_name, seed, n=16, size=128, device="cuda"):
    """Clean-input bounded-harm gate: the output on a near-clean input must
    stay within imperceptible distance of the clean image (>= 42 dB).
    Conditioning comes from the serving classifier on the near-clean input,
    as in production."""
    model = _serving_model(family_name, state, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    clean = _random_clean_rich(gen, n, size, 3)
    near_clean = torch.clamp(clean + torch.randn(clean.shape, generator=gen, device=gen.device) * 0.004, 0.0, 1.0)
    valid = torch.full((n, 2), size, dtype=torch.int32, device=gen.device)
    _scores, cond = batch_classify_and_condition(near_clean * 255.0, valid, torch.ones((n,), device=gen.device))
    pred = torch.clamp(model(near_clean.to(torch.bfloat16), cond.to(torch.bfloat16)).float(), 0.0, 1.0)
    return psnr(near_clean, clean), psnr(pred, clean)


def config_from_env(steps: int) -> TrainConfig:
    env = os.environ.get
    return TrainConfig(
        family=env("TRAIN_FAMILY", "restore-unet"),
        batch_size=int(env("TRAIN_BATCH", 32)),
        image_size=int(env("TRAIN_SIZE", 128)),
        learning_rate=float(env("TRAIN_LR", 2e-4)),
        total_steps=steps,
        diffusion_sampler_steps=int(env("TRAIN_DIFFUSION_SAMPLER_STEPS", 0)),
        identity_weight=float(env("TRAIN_IDENTITY_WEIGHT", 3.0)),
        data_photo=env("TRAIN_DATA_PHOTO", "1") == "1",
        data_mix_rich=float(env("TRAIN_DATA_MIX_RICH", 0.0)),
        data_deconv=env("TRAIN_DATA_DECONV", "0") == "1",
        data_mix_mild=float(env("TRAIN_DATA_MIX_MILD", 0.0)),
        data_grain=env("TRAIN_DATA_GRAIN", "0") == "1",
        data_smooth=env("TRAIN_DATA_SMOOTH", "0") == "1",
        data_smooth_share=float(env("TRAIN_DATA_SMOOTH_SHARE", 0.10)),
        data_clean_fraction=float(env("TRAIN_DATA_CLEAN_FRACTION", 0.15)),
        data_compression_solo=float(env("TRAIN_DATA_COMP_SOLO", 0.0)),
        data_lowlight_solo=float(env("TRAIN_DATA_LOWLIGHT_SOLO", 0.0)),
        anchor_comp=float(env("TRAIN_ANCHOR_COMP", 0.0)),
        # chunked schedules must vary the seed per chunk or every run
        # replays the same batches
        seed=int(env("TRAIN_SEED", 0)),
    )


def main(device: str = "cuda") -> None:
    log = get_logger("train-main")
    steps = int(os.environ.get("TRAIN_STEPS", 2000))
    cfg = config_from_env(steps)
    family = cfg.family
    ckpt_dir = os.environ.get("TRAIN_CKPT_DIR")
    warm_start = os.environ.get("TRAIN_RESUME", "0") == "1"
    trainer = Trainer(cfg, device=device, checkpoint_dir=ckpt_dir, warm_start=warm_start)
    model = trainer.state.model

    eval_seed = 999
    base_psnr, init_psnr = evaluate(model.state_dict(), family, eval_seed, size=cfg.image_size,
                                    photo=cfg.data_photo, device=trainer.device)
    log.info("pre-train eval", {"degradedPsnr": round(base_psnr, 2), "modelPsnr": round(init_psnr, 2)})

    t0 = time.time()
    # TRAIN_EXPORT_EVERY chunks the schedule and exports the npz between
    # chunks, so a kill mid-run loses at most one chunk of progress
    export_every = int(os.environ.get("TRAIN_EXPORT_EVERY", 0))
    if export_every > 0:
        done = 0
        while done < steps:
            n = min(export_every, steps - done)
            trainer.run(n, log_every=max(1, steps // 40))
            done += n
            if done < steps:
                weights_mod.save_params(model.state_dict(), weights_mod.weights_path(family))
                log.info("interim export", {"stepsDone": done})
    else:
        trainer.run(steps, log_every=max(1, steps // 40))
    # the attention kernel's launches in this process so far (0 on the CPU,
    # where the plain version runs), so a caller that runs this entry point
    # as a subprocess can read from its log that the kernel ran
    log.info("training done", {"steps": steps, "seconds": round(time.time() - t0, 1),
                               "attentionLaunches": flash_kernel.launches})

    _, final_psnr = evaluate(model.state_dict(), family, eval_seed, size=cfg.image_size, photo=cfg.data_photo,
                             device=trainer.device)
    log.info(
        "post-train eval",
        {"degradedPsnr": round(base_psnr, 2), "restoredPsnr": round(final_psnr, 2),
         "gainDb": round(final_psnr - base_psnr, 2)},
    )
    if family in ("restore-unet", "restore-unet-small"):
        in_psnr, out_psnr = no_harm_eval(model.state_dict(), family, 555, size=cfg.image_size,
                                         device=trainer.device)
        log.info(
            "no-harm eval (near-clean inputs)",
            {"inputPsnr": round(in_psnr, 2), "outputPsnr": round(out_psnr, 2),
             "boundedHarm": bool(out_psnr >= 42.0), "strictNoHarm": bool(out_psnr >= in_psnr)},
        )

    if ckpt_dir:
        trainer.save_checkpoint()
    out_path = weights_mod.weights_path(family)
    weights_mod.save_params(model.state_dict(), out_path)
    log.info("weights exported", {"path": out_path})


if __name__ == "__main__":
    main()
