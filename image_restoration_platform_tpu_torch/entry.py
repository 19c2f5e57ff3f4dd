"""Entry points of the port: the flagship's fused step, and a dry run
of every mesh surface on CPU slots.

Port of the repository's root __graft_entry__.py.

``entry()`` returns ``(fn, args)``: ``fn`` is the flagship's fused serving
step as a torch callable, the engine's own restore program with its stages
off (masked classification -> conditioning -> the restore-unet forward in
bf16 -> u8), and ``args`` its model (random weights from seed 0) and a
256 px batch of one on the card (``device="cpu"`` for the CPU).
``dryrun_multichip(n)`` runs, in a fresh interpreter, the reference's checks
on slot meshes of n CPU slots (``make_mesh([cpu] * n, ...)``, as the
reference runs on n virtual CPU devices), each against the unsharded port
with the reference's bars: a sharded ``Trainer`` step (data x tensor), the
spatial halo (a row-sharded stencil equal to the whole-image one), both
pipelines (SRNet on pipe=n, the UNet on data x pipe), data-axis serving with
one ``MicroBatcher`` round trip, data x tensor serving, and tiled SR on data
x spatial.

    python -m image_restoration_platform_tpu_torch.entry [--device cpu] [--n 8]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device: str | torch.device = "cuda"):
    """(fn, args) of the flagship restore-unet fused step at 256 px, batch 1:
    the engine's restore program with its stages off, on RGB IO."""
    from .models import get_family
    from .models.nn import cast_for_compute
    from .serve.engine import resolve_device
    from .serve.programs import build_restore_program

    device = resolve_device(device)
    model = get_family("restore-unet").build().init_(torch.Generator().manual_seed(0))
    model = cast_for_compute(model, torch.bfloat16, channels_last=device.type == "cuda").to(device).eval()
    fused_step = build_restore_program(
        "restore-unet", dtype=torch.bfloat16, use_s2d_io=False, use_deblur=False, use_deblock=False
    )
    canvas = torch.zeros((1, 256, 256, 3), dtype=torch.uint8, device=device)
    valid_hw = torch.tensor([[256, 256]], dtype=torch.int32, device=device)
    is_jpeg = torch.ones((1,), dtype=torch.float32, device=device)
    return fused_step, (model, canvas, valid_hw, is_jpeg)


def dryrun_multichip(n_devices: int) -> None:
    """The mesh checks on n CPU slots, in a fresh interpreter (as the
    reference re-executes its dry run); raises if any check fails."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    code = f"from image_restoration_platform_tpu_torch.entry import _dryrun_multichip_impl; _dryrun_multichip_impl({n_devices})"
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=1800)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"dryrun_multichip subprocess failed rc={proc.returncode}:\n" + (proc.stderr or proc.stdout)[-2000:]
        )


def _perturbed(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """``model`` with seeded noise on every parameter, so the zero-initialised
    FiLM and head carry signal and a pipeline that dropped a stage would show."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.03)
    return model.eval()


def _check(cond: bool, message: str) -> None:
    """A dry-run bar (raised, not asserted: it must hold under ``python -O``)."""
    if not cond:
        raise RuntimeError(message)


def _mad(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(a.astype(int) - b.astype(int))))


def _dryrun_multichip_impl(n_devices: int) -> None:
    from .config import ServingConfig
    from .models.srnet import SRNet, SRNetConfig
    from .models.unet import RestorationUNet, UNetConfig
    from .ops.stencil import K_LAPLACIAN8, conv3x3_clamped_u8
    from .parallel import make_mesh, spatial_shard_apply
    from .parallel.pipeline import srnet_pipeline_apply, unet_pipeline_apply
    from .serve import MicroBatcher, RestorationEngine
    from .train import TrainConfig, Trainer

    torch.manual_seed(0)
    devices = [torch.device("cpu")] * n_devices

    # data x tensor mesh: one full sharded training step
    tensor = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(devices, data=n_devices // tensor, tensor=tensor)
    cfg = TrainConfig(family="restore-unet-small", batch_size=max(4, n_devices), image_size=32, total_steps=10)
    losses = Trainer(cfg, mesh=mesh).run(1, log_every=1)
    _check(np.isfinite(losses[0]), "training step produced non-finite loss")

    # spatial axis: a row-sharded stencil with the halo exchanged, exact
    sp_mesh = make_mesh(devices, data=1, spatial=n_devices)
    img = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (1, n_devices * 16, 32, 1)).astype(np.float32)
    )
    sharded = spatial_shard_apply(lambda ext: conv3x3_clamped_u8(ext[..., 0], K_LAPLACIAN8)[..., None], sp_mesh, 1)
    np.testing.assert_allclose(sharded(img)[..., 0].numpy(), conv3x3_clamped_u8(img[..., 0], K_LAPLACIAN8).numpy(),
                               atol=0.0)

    # pipe axis: the SRNet's block chain over n stages, against the forward
    pp_mesh = make_mesh(devices, data=1, pipe=n_devices)
    net = _perturbed(SRNet(SRNetConfig(scale=2, channels=16, num_blocks=n_devices)).init_(
        torch.Generator().manual_seed(3)), 3)
    px = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (4, 16, 16, 3)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(srnet_pipeline_apply(net, px, pp_mesh, n_micro=4).numpy(), net(px).numpy(),
                                   atol=1e-5)

    # the flagship-shaped UNet over pipe x data, against the forward
    u_pipe = 4 if n_devices % 4 == 0 else n_devices
    u_mesh = make_mesh(devices, data=n_devices // u_pipe, pipe=u_pipe)
    unet = _perturbed(RestorationUNet(UNetConfig(base_channels=32, norm_groups=8, blocks_per_level=1, emb_dim=64))
                      .init_(torch.Generator().manual_seed(4)), 4)
    ux = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (8, 16, 16, 3)).astype(np.float32))
    ucond = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (8, 28)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(unet_pipeline_apply(unet, ux, ucond, u_mesh, n_micro=4).numpy(),
                                   unet(ux, ucond).numpy(), atol=2e-5, rtol=1e-5)

    # serving on data=n: the fused restore program split over the data slots,
    # and one MicroBatcher round trip, against the unsharded engine
    scfg = ServingConfig(size_buckets=(32,), max_batch=n_devices, max_wait_ms=2.0)
    mesh_engine = RestorationEngine(mesh=make_mesh(devices, data=n_devices), serving_config=scfg)
    canvas = np.random.default_rng(9).integers(0, 256, (n_devices, 32, 32, 3), dtype=np.uint8)
    jpeg_flags = np.ones((n_devices,), np.float32)
    out_mesh, scores_mesh, _ = mesh_engine.restore_batch(canvas, is_jpeg=jpeg_flags, family_name="restore-unet-small")
    _check(out_mesh.shape == canvas.shape and scores_mesh.shape == (n_devices, 7), f"mesh shapes {out_mesh.shape}")
    single = RestorationEngine(device="cpu", serving_config=scfg)
    out_single, scores_single, _ = single.restore_batch(canvas, is_jpeg=jpeg_flags, family_name="restore-unet-small")
    np.testing.assert_allclose(scores_mesh, scores_single, atol=1e-4)
    serve_mad = _mad(out_mesh, out_single)
    _check(serve_mad < 1.0, f"mesh serving diverged from single-device: mad={serve_mad}")
    batcher = MicroBatcher(mesh_engine, scfg, device="cpu")
    try:
        b_out, _, _ = batcher.submit(canvas[0], (32, 32), True, "restore-unet-small")
        b_mad = _mad(b_out, out_mesh[0])
        _check(b_mad < 1.0, f"batcher round-trip diverged: mad={b_mad}")
    finally:
        batcher.shutdown()

    # data x tensor serving: column-parallel backbone layers on each data row
    dptp_engine = RestorationEngine(mesh=make_mesh(devices, data=n_devices // tensor, tensor=tensor),
                                    serving_config=scfg)
    out_dptp, scores_dptp, _ = dptp_engine.restore_batch(canvas, is_jpeg=jpeg_flags, family_name="restore-unet-small")
    np.testing.assert_allclose(scores_dptp, scores_single, atol=1e-4)
    dptp_mad = _mad(out_dptp, out_single)
    _check(dptp_mad < 1.0, f"dp x tp serving diverged: mad={dptp_mad}")

    # tiled SR with its tiles over data x spatial
    sr_canvas = np.random.default_rng(11).integers(0, 256, (96, 96, 3), dtype=np.uint8)
    sr_mesh_engine = RestorationEngine(mesh=make_mesh(devices, data=n_devices // 2, spatial=2), serving_config=scfg)
    up_mesh, _ = sr_mesh_engine.sr_tiled(sr_canvas, "sr-x2", tile=32, overlap=8, tile_batch=2)
    up_single, _ = single.sr_tiled(sr_canvas, "sr-x2", tile=32, overlap=8, tile_batch=2)
    sr_mad = _mad(up_mesh, up_single)
    _check(sr_mad < 1.0, f"mesh tiled SR diverged: mad={sr_mad}")

    print(
        f"dryrun_multichip ok: mesh(data={n_devices // tensor}, tensor={tensor}) train step loss={losses[0]:.4f}; "
        f"spatial halo exchange exact; {n_devices}-stage SRNet pipeline exact; UNet {u_pipe}-stage x "
        f"data={n_devices // u_pipe} pipeline exact; serving: restore_batch + MicroBatcher round trip on "
        f"data={n_devices}, parity with the unsharded engine (scores atol 1e-4, byte mad {serve_mad:.3f}, "
        f"batcher {b_mad:.3f}); data={n_devices // tensor} x tensor={tensor} serving (byte mad {dptp_mad:.3f}); "
        f"tiled SR on data={n_devices // 2} x spatial=2 (byte mad {sr_mad:.3f})",
        flush=True,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the fused step once, then the mesh dry run on CPU slots.")
    ap.add_argument("--device", default="cuda", help="where entry()'s step runs: cuda (default) or cpu")
    ap.add_argument("--n", type=int, default=8, help="CPU slots of the dry run's meshes")
    args = ap.parse_args(argv)
    fn, fn_args = entry(args.device)
    out, scores = fn(*fn_args)
    print("entry ok:", tuple(out.shape), tuple(scores.shape), flush=True)
    dryrun_multichip(args.n)
    return 0


if __name__ == "__main__":
    sys.exit(main())
