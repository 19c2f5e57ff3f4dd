"""Held-out dB over diffusion sample step counts (1, 2, 4, 8): serving at
<= 2 steps should match the 8-step sampler's quality.

Port of scripts/eval_diffusion_steps.py on the port's own draws (16 images
at 128 px, generator seed 4242), with ``--device`` and ``--dtype``; each
count's warm time is the second call's, synchronised on the card:

    python -m image_restoration_platform_tpu_torch.eval.diffusion_steps [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..models import diffusion, get_family
from ..serve.engine import resolve_device
from ..train.data import DataConfig, synthetic_batch
from .common import DTYPES, device_args, load_model, psnr


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--steps", default="1,2,4,8")
    device_args(ap)
    args = ap.parse_args(argv)
    device, dtype = resolve_device(args.device), DTYPES[args.dtype]
    family = get_family("diffusion-restore")
    model = load_model("diffusion-restore", device, dtype)
    gen = torch.Generator().manual_seed(4242)
    degraded, clean, cond = (t.to(device) for t in synthetic_batch(gen, args.n, DataConfig(size=args.size)))
    print(f"degraded PSNR: {psnr(degraded, clean):.2f} dB")

    def sample(cfg, seed):
        noise = torch.randn(tuple(degraded.shape), generator=torch.Generator().manual_seed(seed)).to(device, dtype)
        with torch.inference_mode():
            out = diffusion.restore(model, degraded.to(dtype), cond.to(dtype), noise, cfg).float()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    for steps in (int(s) for s in args.steps.split(",")):
        cfg = dataclasses.replace(family.config, sample_steps=steps)
        out = sample(cfg, 7)
        t0 = time.time()
        sample(cfg, 8)
        warm = time.time() - t0
        print(f"steps={steps}: {psnr(out, clean):.2f} dB  (warm {warm * 1000:.0f} ms/b{args.n})")


if __name__ == "__main__":
    main()
