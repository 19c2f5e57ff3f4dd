"""PyTorch port: the unit gates of the SRNet residual spectral limiter.

The port's copy of tests/test_sr_gate.py, on the port's own functions
(models/srnet.py ``upsample_tent`` / ``local_detail`` / ``residual_limit``)
with the reference's thresholds unchanged: the low-frequency part of the
network's correction passes a soft-shrink deadband, the high-frequency part
is clamped to a bound that opens on texture, edges and noise and floors at
~1 level on smooth content."""

import dataclasses

import numpy as np
import torch

from image_restoration_platform_tpu_torch.models import srnet

torch.set_num_threads(2)


def _ramp(lo, hi, n, shape):
    return torch.linspace(lo, hi, n)[None, :, None, None].expand(*shape).contiguous()


class TestTentUpsample:
    def test_exact_linear_interpolation_on_ramp_x2(self):
        up = srnet.upsample_tent(_ramp(0.0, 1.0, 16, (1, 16, 8, 3)), 2)
        steps = np.diff(up[0, :, 4, 0].numpy()[2:-2])
        assert np.allclose(steps, steps[0], atol=1e-6), "interior not linear"
        assert np.allclose(steps[0], (1.0 / 15.0) / 2.0, atol=1e-6)

    def test_partition_of_unity_on_constant(self):
        for scale in (2, 4):
            up = srnet.upsample_tent(torch.full((1, 6, 6, 3), 0.37), scale)
            assert tuple(up.shape) == (1, 6 * scale, 6 * scale, 3)
            np.testing.assert_allclose(up.numpy(), 0.37, atol=1e-6)

    def test_box_downsample_roundtrip_beats_nearest_on_smooth(self):
        yy, xx = np.mgrid[0:64, 0:64].astype(np.float32) / 64.0
        hr = (0.4 + 0.2 * np.cos(2 * np.pi * (2 * xx + 1.3 * yy)))[None, ..., None]
        hr = torch.from_numpy(np.repeat(hr, 3, axis=-1))
        lr = hr.reshape(1, 32, 2, 32, 2, 3).mean(dim=(2, 4))
        near = lr.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        tent = srnet.upsample_tent(lr, 2)
        mse = lambda a: float(torch.mean((a - hr) ** 2))  # noqa: E731
        assert mse(tent) < 0.5 * mse(near)


class TestLocalDetail:
    def test_zero_on_flat_and_slow_gradient(self):
        assert float(srnet.local_detail(torch.full((1, 16, 16, 3), 0.5)).max()) == 0.0
        d = srnet.local_detail(_ramp(0.3, 0.5, 32, (1, 32, 32, 3)))
        # the interior of a linear ramp has zero Laplacian; only the
        # replicate-padded border rows carry the first-difference step
        assert float(d[:, 4:-4, 4:-4].max()) * 255.0 < 1e-3
        assert float(d.max()) * 255.0 < 3.0

    def test_large_on_texture_and_noise(self):
        cb = torch.tensor([[0.0, 1.0], [1.0, 0.0]]).repeat(8, 8)
        cb = cb[None, :, :, None] * torch.ones((1, 1, 1, 3))
        assert float(srnet.local_detail(cb).min()) * 255.0 > 100.0
        noise = torch.from_numpy(
            (0.5 + 0.05 * np.random.default_rng(0).standard_normal((1, 16, 16, 3))).astype(np.float32)
        )
        assert float(srnet.local_detail(noise).mean()) * 255.0 > 10.0


class TestResidualLimit:
    def _cfg(self, **kw):
        return srnet.SRNetConfig(scale=2, num_blocks=2, **kw)

    def test_disabled_is_identity(self):
        x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 32, 32, 3)).astype(np.float32))
        out = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32))
        assert torch.equal(srnet.residual_limit(x, out, self._cfg(limit_pool=0)), out)

    def test_large_global_correction_passes_minus_deadband(self):
        """A constant +40 levels is pure low frequency: it loses only the
        deadband and is not clamped to the ~1-level high-frequency floor."""
        cfg = self._cfg()
        x = torch.full((1, 32, 32, 3), 0.3)
        net = torch.full((1, 64, 64, 3), 0.3 + 40.0 / 255.0)
        got_levels = float(torch.mean(srnet.residual_limit(x, net, cfg) - 0.3)) * 255.0
        assert abs(got_levels - (40.0 - cfg.limit_deadband)) < 0.5, got_levels

    def test_hallucinated_texture_on_smooth_is_clipped(self):
        cfg = self._cfg()
        hall = 0.04 * np.random.default_rng(4).standard_normal((1, 64, 64, 3)).astype(np.float32)  # ~10 levels
        hall -= hall.mean()
        out = srnet.residual_limit(torch.full((1, 32, 32, 3), 0.5), torch.from_numpy(0.5 + hall), cfg)
        resid = (out - 0.5).abs().numpy() * 255.0
        assert resid.max() <= cfg.limit_floor + 0.6, resid.max()

    def test_denoise_correction_on_noisy_input_survives(self):
        """On a noisy input the detail statistic opens the bound: a
        correction that removes the noise passes nearly unchanged."""
        cfg = self._cfg()
        rng = np.random.default_rng(5)
        clean = 0.5 + 0.1 * np.cos(np.linspace(0, 3, 32)[None, :, None, None] * np.ones((1, 32, 32, 3))).astype(
            np.float32
        )
        noisy = np.clip(clean + 0.06 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)
        x = torch.from_numpy(noisy)
        net = srnet.upsample_tent(torch.from_numpy(clean), 2)  # the ideal output: full denoise
        out = srnet.residual_limit(x, net, cfg)
        err_limited = float(torch.mean(torch.abs(out - net)))
        err_baseline = float(torch.mean(torch.abs(srnet.upsample_tent(x, 2) - net)))
        assert err_limited < 0.35 * err_baseline, (err_limited, err_baseline)

    def test_apply_equals_manual_limit_of_raw_apply(self):
        """The in-model limiter equals ``residual_limit`` of the unlimited
        body: what a later row-sharded program relies on."""
        cfg = self._cfg()
        gen = torch.Generator().manual_seed(7)
        model = srnet.SRNet(cfg).init_(gen).eval()
        with torch.no_grad():
            model.up.w.copy_(0.05 * torch.randn(model.up.w.shape, generator=gen))
        raw_model = srnet.SRNet(dataclasses.replace(cfg, limit_pool=0)).eval()
        raw_model.load_state_dict(model.state_dict())
        x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32))
        with torch.inference_mode():
            limited, raw = model(x), raw_model(x)
        assert float((limited - raw).abs().max()) > 1e-3  # the limiter acts here
        np.testing.assert_allclose(limited.numpy(), srnet.residual_limit(x, raw, cfg).numpy(), atol=1e-6)
