"""PyTorch port: the synthetic training data against the JAX ``train/data.py``.

The deterministic pieces (PSF banks, JPEG tables and DCT matrix, PSF blur,
vignette, block-DCT quantization, the JPEG analog, the sensor-noise model
given its normal draw, the linear upsample against ``jax.image.resize``) at
atol 1e-5, and ``_degrade`` itself with the reference's own draws injected
(its keys, split and folded as it does) at atol 1e-5 on [0, 1] images; the
JAX side runs at ``precision=HIGHEST``. Then the structural properties of
tests/test_data_distribution.py, on the port's generators, and the
``comp_only`` mask and the determinism of a batch given its seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.train import data as J
from image_restoration_platform_tpu_torch.classify.fused import batch_classify_and_condition
from image_restoration_platform_tpu_torch.train import data as D

torch.set_num_threads(2)
ATOL = 1e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_tables_and_banks_equal_the_reference():
    for ours, ref in ((D._PSF_BANK, J._PSF_BANK), (D._PSF_BANK_RICH, J._PSF_BANK_RICH), (D._DCT8, J._DCT8),
                      (D._JPEG_LUMA, J._JPEG_LUMA), (D._JPEG_CHROMA, J._JPEG_CHROMA)):
        np.testing.assert_array_equal(ours, np.asarray(ref))
    assert D._PSF_BANK_RICH.shape == (45, 15, 15) and D._PSF_BANK.shape == (15, 15, 15)
    np.testing.assert_allclose(D._PSF_BANK_RICH.sum(axis=(1, 2)), 1.0, atol=1e-5)


@pytest.mark.parametrize("rich", [False, True], ids=["bank15", "bank45"])
def test_psf_blur_matches_jax(rich):
    x = _rand((6, 32, 32, 3), 0)
    bank = J._PSF_BANK_RICH if rich else J._PSF_BANK
    idx = np.random.default_rng(1).integers(0, bank.shape[0], 6)
    strength = np.asarray([0.0, 0.3, 0.6, 1.0, 0.8, 0.1], np.float32)
    with jax.default_matmul_precision("highest"):
        ref = J._psf_blur(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(strength), bank=bank)
    got = D._psf_blur(_t(x), _t(idx), _t(strength), D._psf_bank(rich, torch.device("cpu")))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_vignette_and_signal_noise_match_jax():
    x = _rand((4, 32, 32, 3), 2)
    s = np.asarray([0.0, 0.2, 0.7, 1.0], np.float32)
    np.testing.assert_allclose(D._vignette_dark(_t(x), _t(s)).numpy(),
                               np.asarray(J._vignette_dark(jnp.asarray(x), jnp.asarray(s))), rtol=0, atol=ATOL)
    key = jax.random.PRNGKey(5)
    ref = J._signal_noise(key, jnp.asarray(x), jnp.asarray(s))
    normal = jax.random.normal(key, x.shape)
    got = D._signal_noise(_t(x), _t(s), _t(normal))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def test_quant_channel_and_jpeg_analog_match_jax():
    x = _rand((4, 32, 32, 3), 3)
    s = np.asarray([0.05, 0.4, 0.8, 1.0], np.float32)
    qscale = np.asarray([0.3, 1.0, 2.0, 4.0], np.float32)
    v = x[..., 0] * 255.0 - 128.0
    with jax.default_matmul_precision("highest"):
        ref_q = J._quant_channel(jnp.asarray(v), J._JPEG_LUMA, jnp.asarray(qscale))
        ref_j = J._jpeg_analog(jnp.asarray(x), jnp.asarray(s))
    luma = D._constants(torch.device("cpu"))["jpeg_luma"]  # D._JPEG_LUMA, made once per device
    np.testing.assert_allclose(D._quant_channel(_t(v), luma, _t(qscale)).numpy(), np.asarray(ref_q),
                               rtol=0, atol=1e-3)  # byte-range values: 1e-5 of 255
    np.testing.assert_allclose(D._jpeg_analog(_t(x), _t(s)).numpy(), np.asarray(ref_j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("src,size", [(4, 32), (8, 64), (4, 33), (16, 32)])
def test_upsample_linear_matches_jax_image_resize(src, size):
    g = np.random.default_rng(src + size).normal(size=(3, src, src, 2)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(g), (3, size, size, 2), "linear")
    np.testing.assert_allclose(D.upsample_linear(_t(g), size).numpy(), np.asarray(ref), rtol=0, atol=ATOL)


def _jax_degrade_draws(key, n, size, cfg):
    """The draws of the reference's ``_degrade``, made with its own keys."""
    keys = jax.random.split(key, 10)
    shape = (n, size, size, 3)
    bern = jax.random.bernoulli
    d = {
        "active": bern(keys[0], 0.5, (n, 7)),
        "keep_clean": bern(keys[6], cfg.clean_fraction, (n, 1)),
        "near_clean": bern(jax.random.fold_in(key, 13), 0.15, (n, 1)),
        "strength": jax.random.uniform(keys[1], (n, 7)),
        "noise": jax.random.normal(keys[2], shape),
        "pos": jax.random.uniform(keys[3], (n, 2)),
        "slope": jax.random.uniform(keys[4], (n,), minval=-0.3, maxval=0.3),
        "shift": jax.random.uniform(keys[5], (n, 3), minval=-1.0, maxval=1.0),
    }
    if cfg.compression_solo > 0.0:
        d["solo"] = bern(jax.random.fold_in(key, 41), cfg.compression_solo, (n, 1))
    if cfg.lowlight_solo > 0.0:
        d["lowlight"] = bern(jax.random.fold_in(key, 43), cfg.lowlight_solo, (n, 1))
    if cfg.deconv:
        kd1, kd2 = jax.random.split(jax.random.fold_in(key, 31))
        d["hard"] = bern(kd1, 0.4, (n, 7))
        d["tail"] = jax.random.uniform(kd2, (n, 7), minval=0.7, maxval=1.0)
    if cfg.photo:
        kb1, kb2 = jax.random.split(jax.random.fold_in(key, 21))
        bank = J._PSF_BANK_RICH if cfg.deconv else J._PSF_BANK
        d["use_psf"] = bern(kb1, 0.5, (n, 1, 1, 1))
        d["psf_idx"] = jax.random.randint(kb2, (n,), 0, bank.shape[0])
        kn1, kn2 = jax.random.split(jax.random.fold_in(key, 22))
        d["use_sig"] = bern(kn1, 0.5, (n, 1, 1, 1))
        d["sig_noise"] = jax.random.normal(kn2, shape)
        d["use_vig"] = bern(jax.random.fold_in(key, 23), 0.5, (n, 1, 1, 1))
        d["dark_noise"] = jax.random.normal(jax.random.fold_in(key, 25), shape)
        d["use_dct"] = bern(jax.random.fold_in(key, 24), 0.75 if cfg.deconv else 0.5, (n, 1, 1, 1))
    return {k: _t(v).long() if k == "psf_idx" else _t(v) for k, v in d.items()}


DEGRADE_CONFIGS = {
    "plain": dict(size=32),
    "photo_r5": dict(size=32, photo=True, deconv=True, compression_solo=0.3, lowlight_solo=0.18, clean_fraction=0.0),
    "photo_mild": dict(size=32, photo=True),
}


@pytest.mark.parametrize("name", list(DEGRADE_CONFIGS))
def test_degrade_with_the_reference_draws_matches_jax(name):
    n = 8
    kw = DEGRADE_CONFIGS[name]
    jcfg, tcfg = J.DataConfig(**kw), D.DataConfig(**kw)
    clean = _rand((n, 32, 32, 3), 7)
    protect = (np.arange(n) % 3 == 0).astype(np.float32)[:, None] if kw.get("photo") else None
    key = jax.random.PRNGKey(11)
    with jax.default_matmul_precision("highest"):
        fn = jax.jit(lambda k, c, p: J._degrade(k, c, jcfg, protect=p))
        ref_x, ref_s = fn(key, jnp.asarray(clean), None if protect is None else jnp.asarray(protect))
    draws = _jax_degrade_draws(key, n, 32, jcfg)
    got_x, got_s = D._apply_degradations(_t(clean), tcfg, draws, None if protect is None else _t(protect))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(ref_s), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(ref_x), rtol=0, atol=ATOL)
    assert set(draws) == set(D._degrade_draws(torch.Generator().manual_seed(0), n, 32, 3, tcfg))


# --------------------------------------------- the distribution's structure


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_protected_images_skip_ambiguous_degradations():
    cfg = D.DataConfig(size=64, photo=True, clean_fraction=0.0)
    clean = torch.full((16, 64, 64, 3), 0.5)
    _, s = D._degrade(_gen(0), clean, cfg, protect=torch.ones((16, 1)))
    s = s.numpy()
    assert np.all(s[:, [2, 5, 6]] == 0.0), "lowLight, fade and colorShift must be gated off graded cleans"
    assert s[:, [0, 1, 3, 4]].max() > 0.1


def test_unprotected_images_keep_full_menu():
    cfg = D.DataConfig(size=64, photo=True, clean_fraction=0.0)
    _, s = D._degrade(_gen(1), torch.full((32, 64, 64, 3), 0.5), cfg, protect=torch.zeros((32, 1)))
    for col in range(7):
        assert s[:, col].max() > 0.1, f"degradation {col} never fired"


def test_creative_exposure_preserves_highlights():
    img, aug = D._clean_photo_mix(_gen(3), 256, 32, 3)
    img, aug = img.numpy(), aug.numpy()[:, 0] > 0.5
    assert aug.any() and (~aug).any()
    p999 = np.quantile(img[aug].reshape(aug.sum(), -1), 0.999, axis=1)
    assert np.median(p999) > 0.6, float(np.median(p999))


def test_dark_damage_carries_shot_noise():
    cfg = D.DataConfig(size=64, photo=True, clean_fraction=0.0)
    n = 32
    deg, s = D._degrade(_gen(7), torch.full((n, 64, 64, 3), 0.6), cfg, protect=torch.zeros((n, 1)))
    s, d = s.numpy(), deg.numpy()
    hf = np.abs(np.diff(d, axis=2)).mean(axis=(1, 2, 3))
    dark = s[:, 2] > 0.4
    calm = (s[:, 2] < 0.05) & (s[:, 1] < 0.05) & (s[:, 0] < 0.05)
    assert dark.any() and calm.any()
    assert hf[dark].mean() > hf[calm].mean(), "underexposure damage must carry shot noise"


def test_deconv_emphasis_strong_tail():
    cfg_off = D.DataConfig(size=32, photo=True, clean_fraction=0.0)
    cfg_on = D.DataConfig(size=32, photo=True, clean_fraction=0.0, deconv=True)
    clean = torch.full((256, 32, 32, 3), 0.5)
    protect = torch.zeros((256, 1))
    _, s_off = D._degrade(_gen(7), clean, cfg_off, protect=protect)
    _, s_on = D._degrade(_gen(7), clean, cfg_on, protect=protect)
    s_off, s_on = s_off.numpy(), s_on.numpy()
    for col, name in ((0, "blur"), (3, "compression")):
        on, off = s_on[:, col][s_on[:, col] > 0], s_off[:, col][s_off[:, col] > 0]
        assert (on >= 0.7).mean() > (off >= 0.7).mean() + 0.15, name
    # the emphasis draws come last: the other channels keep their draws
    np.testing.assert_array_equal(s_on[:, 1], s_off[:, 1])


def test_grain_texture_matches_real_photo_classifier_regime():
    g = D._grain_texture(_gen(11), 16, 64, 3)
    valid = torch.full((16, 2), 64, dtype=torch.int32)
    scores, _ = batch_classify_and_condition(g * 255.0, valid, torch.ones((16,)))
    assert scores[:, 1].mean() > 0.6, f"noise score {scores[:, 1].mean():.2f} too low"
    g = g.numpy()
    hf = g - g.mean(axis=(1, 2), keepdims=True)
    corr = np.corrcoef(hf[:, :-1, :, 0].ravel(), hf[:, 1:, :, 0].ravel())[0, 1]
    assert corr > 0.5, f"grain not spatially correlated: {corr:.2f}"


def test_grain_mix_share():
    img_off, aug_off = D._clean_photo_mix(_gen(17), 64, 32, 3, grain=False)
    img_on, aug_on = D._clean_photo_mix(_gen(17), 64, 32, 3, grain=True)
    changed = np.mean(np.any((img_off != img_on).numpy(), axis=(1, 2, 3)))
    assert 0.05 < changed < 0.30, f"grain share {changed:.2f} out of range"
    np.testing.assert_array_equal(aug_off.numpy(), aug_on.numpy())


def test_grain_texture_odd_size():
    g = D._grain_texture(_gen(2), 4, 33, 3)
    assert g.shape == (4, 33, 33, 3) and bool(torch.isfinite(g).all())


def test_smooth_share_scales():
    img_off, _ = D._clean_photo_mix(_gen(23), 128, 32, 3, smooth=False)

    def frac_changed(share):
        img_on, _ = D._clean_photo_mix(_gen(23), 128, 32, 3, smooth=True, smooth_share=share)
        return np.mean(np.any((img_off != img_on).numpy(), axis=(1, 2, 3)))

    f10, f25 = frac_changed(0.10), frac_changed(0.25)
    assert 0.04 < f10 < 0.18 and 0.17 < f25 < 0.35 and f25 > f10, (f10, f25)
    assert abs(frac_changed(0.50) - frac_changed(0.28)) < 1e-9


def test_mix_mild_interleave_fractions(monkeypatch):
    from image_restoration_platform_tpu_torch.train import trainer as trainer_mod

    cfg = trainer_mod.TrainConfig(family="restore-unet-small", batch_size=1, image_size=32, data_photo=True,
                                  data_deconv=True, data_mix_rich=0.2, data_mix_mild=0.4)
    t = trainer_mod.Trainer(cfg, device="cpu")
    seen = []

    def fake_synth(gen, n, dcfg, with_masks=False):
        seen.append(dcfg)
        z = torch.zeros((n, 32, 32, 3))
        return z, z, torch.zeros((n, 28)), torch.zeros((n,))

    t.step_fn = lambda state, *b: torch.zeros(())
    monkeypatch.setattr(trainer_mod, "synthetic_batch", fake_synth)
    t.run(40, log_every=1000)
    n_rich = sum(1 for c in seen if not c.photo)
    n_mild = sum(1 for c in seen if c.photo and not c.deconv)
    n_deconv = sum(1 for c in seen if c.photo and c.deconv)
    assert n_rich == 8 and 15 <= n_mild <= 16 and n_deconv == 40 - n_rich - n_mild, (n_rich, n_mild, n_deconv)


def _only(s, col):
    others = [c for c in range(7) if c != col]
    return (s[:, col] > 0) & (np.abs(s[:, others]).max(axis=1) == 0)


def test_compression_solo_emphasis():
    clean, protect = torch.full((512, 32, 32, 3), 0.5), torch.zeros((512, 1))
    cfg = D.DataConfig(size=32, photo=True, clean_fraction=0.0, compression_solo=0.4)
    _, s = D._degrade(_gen(11), clean, cfg, protect=protect)
    assert _only(s.numpy(), 3).mean() > 0.20
    _, s_off = D._degrade(_gen(11), clean, D.DataConfig(size=32, photo=True, clean_fraction=0.0), protect=protect)
    assert _only(s_off.numpy(), 3).mean() < 0.05


def test_lowlight_solo_counterweight():
    cfg = D.DataConfig(size=32, photo=True, clean_fraction=0.0, compression_solo=0.3, lowlight_solo=0.25)
    _, s = D._degrade(_gen(11), torch.full((512, 32, 32, 3), 0.5), cfg, protect=torch.zeros((512, 1)))
    s = s.numpy()
    assert _only(s, 2).mean() > 0.10 and _only(s, 3).mean() > 0.15


@pytest.mark.parametrize("field,col", [("compression_solo", 3), ("lowlight_solo", 2)])
def test_solo_emphasis_changes_only_its_rows(field, col):
    """An emphasis draws after everything else: switching it on turns some
    rows into single-channel rows and leaves every other row as it was; at 0
    it draws nothing and the batch is the default's."""
    base = dict(size=32, photo=True, clean_fraction=0.0)
    clean, protect = torch.full((64, 32, 32, 3), 0.5), torch.zeros((64, 1))
    x_off, s_off = D._degrade(_gen(3), clean, D.DataConfig(**base), protect=protect)
    x_zero, s_zero = D._degrade(_gen(3), clean, D.DataConfig(**base, **{field: 0.0}), protect=protect)
    np.testing.assert_array_equal(x_off.numpy(), x_zero.numpy())
    np.testing.assert_array_equal(s_off.numpy(), s_zero.numpy())
    _, s_on = D._degrade(_gen(3), clean, D.DataConfig(**base, **{field: 0.4}), protect=protect)
    s_on, s_off = s_on.numpy(), s_off.numpy()
    changed = np.any(s_on != s_off, axis=1)
    assert 0 < changed.sum() < 64
    others = [c for c in range(7) if c != col]
    assert np.all(s_on[changed][:, others] == 0.0)


def test_comp_only_mask_and_determinism():
    """``comp_only`` marks exactly the rows whose only applied degradation is
    compression; a batch is a function of its generator's seed."""
    cfg = D.DataConfig(size=32, photo=True, deconv=True, compression_solo=0.3, lowlight_solo=0.18)
    a = D.synthetic_batch(_gen(5), 32, cfg, with_masks=True)
    b = D.synthetic_batch(_gen(5), 32, cfg, with_masks=True)
    c = D.synthetic_batch(_gen(6), 32, cfg, with_masks=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[0], c[0])
    # the mask against the strengths _degrade applied, drawn again from the same stream
    gen = _gen(5)
    clean, aug = D._clean_photo_mix(gen, 32, 32, 3, grain=False, smooth=False)
    _, s = D._degrade(gen, clean, cfg, protect=aug)
    want = _only(s.numpy(), 3).astype(np.float32)
    np.testing.assert_array_equal(a[3].numpy(), want)
    assert 0.1 < want.mean() < 0.6
    degraded, clean_b, cond, mask = a
    assert degraded.shape == clean_b.shape == (32, 32, 32, 3) and cond.shape == (32, 28) and mask.shape == (32,)
    assert 0.0 <= float(degraded.min()) and float(degraded.max()) <= 1.0
