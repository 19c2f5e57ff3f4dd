"""PyTorch port: the W-fold serving layout (models/folded.py) against the JAX
package's ``models/folded.py``, and folded against unfolded serving.

Each case of tests/test_folded.py, on the same numpy inputs through both
packages: the fold/unfold round trip, the folded convs at stride 1 and 2, the
1x1 conv, GroupNorm, the folded upsample, ``upconv2d_folded``,
``_res_block_up``, the UNet forward on the flagship and the small config
(rtol and atol 2e-4, f32, JAX at ``precision=HIGHEST``), the diffusion
sampler (the noise drawn with the reference's key and handed to the port),
SRNet; and the weight carry-across: folding a port state dict gives the
reference's folded tree, converted, bit for bit.

Then the engines on the CPU, at the reference's own bars: SR folded against
unfolded (f32: at most 1 level, under 25 % of the pixels; bf16: at most 2,
under 1 % above 1, under 25 % above 0), fusion (at most 2 levels), restore
and diffusion in f32 (at most 1 level, under 2 % of the pixels); the
executable key over deblur x deblock x fold; no space-to-depth IO for a
folded family; ``compile_count`` flat after ``warmup_serving`` with the
fold on; and the folded mesh restore on data=4 x tensor=2 CPU slots against
the single-device folded engine."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.config import ServingConfig as JServingConfig
from image_restoration_platform_tpu.models import diffusion as jdiff
from image_restoration_platform_tpu.models import folded as jfolded
from image_restoration_platform_tpu.models import nn as jnn
from image_restoration_platform_tpu.models import srnet as jsrnet
from image_restoration_platform_tpu.models import unet as junet
from image_restoration_platform_tpu_torch import bench
from image_restoration_platform_tpu_torch.config import ServingConfig
from image_restoration_platform_tpu_torch.models import diffusion as D
from image_restoration_platform_tpu_torch.models import folded
from image_restoration_platform_tpu_torch.models import nn as L
from image_restoration_platform_tpu_torch.models import weights as W
from image_restoration_platform_tpu_torch.models.srnet import SRNet, SRNetConfig
from image_restoration_platform_tpu_torch.models.unet import ResBlock, UNetConfig
from image_restoration_platform_tpu_torch.parallel import make_mesh
from image_restoration_platform_tpu_torch.parallel.sharding import ShardedConv, shard_params
from image_restoration_platform_tpu_torch.serve import RestorationEngine
from image_restoration_platform_tpu_torch.serve.engine import uses_s2d_io

torch.set_num_threads(2)

UNET_CASES = [
    (dict(input_scale=2, residual_shrink=0.01), 64),  # the flagship's shape
    (dict(base_channels=32, channel_mults=(1, 2), blocks_per_level=1, attn_heads=2), 32),
]


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _oihw(w) -> torch.Tensor:
    return _t(np.asarray(w).transpose(3, 2, 0, 1))


def _state(params) -> dict:
    return W.params_from_jax(W.flatten_params(params))


def _perturbed(params, seed):
    """Non-trivial weights everywhere (head and FiLM initialise at zero),
    from numpy, leaf by leaf in the tree's order."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + jnp.asarray(0.02 * rng.standard_normal(p.shape), jnp.float32), params)


# ------------------------------------------------------------ the pieces


def test_fold_unfold_roundtrip():
    x = _normal((2, 8, 16, 5), 0)
    f = folded.fold_w(_t(x))
    np.testing.assert_array_equal(folded.unfold_w(f).numpy(), x)
    np.testing.assert_array_equal(f.numpy(), np.asarray(jfolded.fold_w(jnp.asarray(x))))
    # folded channel 2c+p is column parity p of channel c
    np.testing.assert_array_equal(f[:, :, 3, 2 * 2 + 1].numpy(), x[:, :, 7, 2])
    with pytest.raises(ValueError, match="even width"):
        folded.fold_w(_t(x[:, :, :15]))


@pytest.mark.parametrize("stride", [1, 2])
def test_folded_conv_matches(stride):
    x = _normal((2, 16, 24, 6), 1)
    p = jnn.conv_init(jax.random.PRNGKey(1), 6, 10)
    p = {"w": p["w"], "b": jnp.asarray(_normal((10,), 2, 0.1))}
    jf = jfolded._fold_conv(p, stride=stride)
    wf = folded._fold_conv(_oihw(p["w"]), stride)
    np.testing.assert_array_equal(wf.numpy(), np.asarray(jf["w"]).transpose(3, 2, 0, 1))
    got = folded.unfold_w(L.conv2d(folded.fold_w(_t(x)), wf, _t(jf["b"]), stride))
    ref = np.asarray(jfolded.unfold_w(jnn.conv2d(jf, jfolded.fold_w(jnp.asarray(x)), stride=stride)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    plain = L.conv2d(_t(x), _oihw(p["w"]), _t(p["b"]), stride)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-5, atol=1e-5)


def test_folded_conv1x1_matches():
    x = _normal((2, 8, 12, 6), 3)
    p = jnn.conv_init(jax.random.PRNGKey(2), 6, 4, kernel=1)
    wf = folded._fold_conv(_oihw(p["w"]))
    np.testing.assert_array_equal(wf.numpy(), np.asarray(jfolded._fold_conv(p)["w"]).transpose(3, 2, 0, 1))
    got = folded.unfold_w(L.conv2d(folded.fold_w(_t(x)), wf, folded._fold_gn(_t(p["b"]))))
    ref = np.asarray(jnn.conv2d(p, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_folded_group_norm_matches():
    x = _normal((2, 8, 16, 64), 4)
    scale, bias = np.linspace(0.5, 1.5, 64, dtype=np.float32), np.linspace(-0.2, 0.2, 64, dtype=np.float32)
    got = folded.unfold_w(L.group_norm(folded.fold_w(_t(x)), folded._fold_gn(_t(scale)),
                                       folded._fold_gn(_t(bias)), groups=32))
    ref = np.asarray(jnn.group_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x), groups=32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    # a width whose group count changes when doubled is refused
    with pytest.raises(ValueError, match="not fold-safe"):
        folded._assert_gn_foldable({"norm.scale": torch.ones(48)}, 32)  # 24 groups, 32 folded


def test_folded_upsample_matches():
    x = _normal((2, 4, 8, 6), 5)
    got = folded.unfold_w(folded._upsample_nearest_folded(folded.fold_w(_t(x))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnn.upsample_nearest(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(got.numpy(), L.upsample_nearest(_t(x), 2).numpy())


@pytest.mark.parametrize("kernel", [3, 1])
def test_fold_upconv_matches(kernel):
    """Four phase convs and the row/column interleave equal
    conv(nearest_up2(x)), SAME borders included (odd folded extents)."""
    x = _normal((2, 5, 7, 10), 6)  # folded input: W' = 7, 2C = 10
    p = jnn.conv_init(jax.random.PRNGKey(11), 5, 7, kernel=kernel)
    kern = folded._fold_upconv(_oihw(p["w"]))
    np.testing.assert_array_equal(kern.numpy(), np.asarray(jfolded._fold_upconv(p["w"])).transpose(0, 1, 5, 4, 2, 3))
    got = folded.unfold_w(folded.upconv2d_folded(kern, _t(x))) + _t(p["b"])
    ref = np.asarray(jnn.conv2d(p, jnn.upsample_nearest(jfolded.unfold_w(jnp.asarray(x)), 2)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


def test_res_block_up_matches():
    """The fused up-block equals the block on up2(x) with the skip
    concatenated: the 4x weight of the low-resolution part in GroupNorm's
    moments and both fused conv paths."""
    in_ch, out_ch, emb_dim, groups = 8, 8, 16, 4
    bp = _perturbed(junet._res_block_init(jax.random.PRNGKey(12), in_ch + out_ch, out_ch, emb_dim), 13)
    x = _normal((2, 4, 6, in_ch), 14)  # low resolution (folded W' = 3)
    skip = _normal((2, 8, 12, out_ch), 15)  # the level's resolution
    emb = _normal((2, emb_dim), 16, 0.3)
    ci_x = bp["conv1"]["w"].shape[2] - bp["conv1"]["w"].shape[3]
    jup = {"conv1_up": jfolded._fold_upconv(bp["conv1"]["w"][:, :, :ci_x, :]),
           "skip_up": jfolded._fold_upconv(bp["skip"]["w"][:, :, :ci_x, :])}
    ref = np.asarray(jfolded.unfold_w(jfolded._res_block_up(
        jfolded._fold_res_block(bp), jup, jfolded.fold_w(jnp.asarray(x)), jfolded.fold_w(jnp.asarray(skip)),
        jnp.asarray(emb), groups)))

    state = _state(bp)
    block = ResBlock(2 * (in_ch + out_ch), 2 * out_ch, emb_dim)
    block.load_state_dict(folded._fold_res_block(state, ""), strict=True)
    up0 = folded.PhaseKernels(2 * in_ch, 2 * out_ch)
    up0.load_state_dict({"conv1_up": folded._fold_upconv(state["conv1.w"][:, :ci_x]),
                         "skip_up": folded._fold_upconv(state["skip.w"][:, :ci_x])})
    with torch.no_grad():
        got = folded.unfold_w(folded._res_block_up(block, up0, folded.fold_w(_t(x)), folded.fold_w(_t(skip)),
                                                   _t(emb), groups))
        plain = ResBlock(in_ch + out_ch, out_ch, emb_dim)
        plain.load_state_dict(state, strict=True)
        want = plain(L.upsample_nearest(_t(x), 2), _t(emb), groups, cat=_t(skip))
    np.testing.assert_allclose(got.numpy(), ref, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=3e-5, atol=3e-5)


# ----------------------------------------------------------- the forwards


@pytest.mark.parametrize("fields,size", UNET_CASES, ids=["flagship-64", "small-32"])
def test_apply_folded_matches_jax(fields, size):
    jcfg, cfg = junet.UNetConfig(**fields), UNetConfig(**fields)
    params = _perturbed(junet.init(jax.random.PRNGKey(5), jcfg), 17)
    x = np.random.default_rng(18).random((2, size, size, 3)).astype(np.float32)
    cond = _normal((2, 28), 19, 0.3)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jfolded.apply(jfolded.fold_params(params, jcfg), jnp.asarray(x), jnp.asarray(cond),
                                       config=jcfg))
    model = folded.folded_model(cfg, _state(params)).eval()
    assert isinstance(model, folded.FoldedUNet) and folded.is_folded(model)
    with torch.inference_mode():
        got = model(_t(x), _t(cond))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="s2d_io"):
        model(_t(x), _t(cond), s2d_io=True)


def test_diffusion_folded_matches_jax():
    jcfg = jdiff.DiffusionConfig(sample_steps=2)
    params = _perturbed(jdiff.init(jax.random.PRNGKey(6), jcfg), 20)
    x = np.random.default_rng(21).random((1, 32, 32, 3)).astype(np.float32)
    cond = _normal((1, 28), 22, 0.3)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, x.shape, dtype=jnp.float32))  # what restore draws from this key
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jdiff.restore(jfolded.fold_params(params, jcfg.unet), jnp.asarray(x), jnp.asarray(cond),
                                       key, jcfg, apply_fn=jfolded.apply))
    cfg = D.DiffusionConfig(sample_steps=2)
    model = folded.folded_model(cfg, _state(params)).eval()
    with torch.inference_mode():
        got = D.restore(model, _t(x), _t(cond), _t(noise), cfg)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_srnet_folded_matches_jax():
    jcfg, cfg = jsrnet.SRNetConfig(scale=2, num_blocks=3), SRNetConfig(scale=2, num_blocks=3)
    params = _perturbed(jsrnet.init(jax.random.PRNGKey(8), jcfg), 23)
    x = np.random.default_rng(24).random((2, 24, 32, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jfolded.apply_srnet(jfolded.fold_params_srnet(params), jnp.asarray(x), jcfg))
    model = folded.folded_model(cfg, _state(params)).eval()
    assert isinstance(model, folded.FoldedSRNet)
    with torch.inference_mode():
        got = model(_t(x))
        plain = SRNet(cfg)
        plain.load_state_dict(_state(params), strict=True)
        want = plain(_t(x))
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("family", ["flagship", "small", "diffusion", "srnet"])
def test_folded_weights_carry_across_bit_for_bit(family):
    """fold_state(params_from_jax(flatten(tree))) is
    params_from_jax(flatten(fold_params(tree))), key for key, bit for bit."""
    key = jax.random.PRNGKey(9)
    if family == "srnet":
        params = jsrnet.init(key, jsrnet.SRNetConfig())
        want, got = jfolded.fold_params_srnet(params), folded.fold_state_srnet(_state(params))
    else:
        if family == "diffusion":
            jcfg, cfg = jdiff.DiffusionConfig().unet, D.DiffusionConfig().unet
        else:
            fields = UNET_CASES[0 if family == "flagship" else 1][0]
            jcfg, cfg = junet.UNetConfig(**fields), UNetConfig(**fields)
        params = _perturbed(junet.init(key, jcfg), 25)
        want, got = jfolded.fold_params(params, jcfg), folded.fold_state(_state(params), cfg)
    want = _state(want)
    assert set(got) == set(want)
    for name, value in want.items():
        assert got[name].dtype == value.dtype and torch.equal(got[name], value), name


# ---------------------------------------------------- folded serving (CPU)


def _engine(dtype=torch.float32, **fields):
    return RestorationEngine(device="cpu", dtype=dtype, serving_config=ServingConfig(**fields))


def _assert_levels(got, want, max_level, above0, above1=None):
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= max_level, diff.max()
    assert (diff > 0).mean() < above0, (diff > 0).mean()
    if above1 is not None:
        assert (diff > 1).mean() < above1, (diff > 1).mean()


def test_fold_config_defaults_and_environment(monkeypatch):
    """The port's defaults are the card's (config.py): the restore UNets
    folded, SR not, the reference's the other way round; the variables
    parse as the reference's do."""
    assert (ServingConfig().fold_w, ServingConfig().fold_w_sr) == (True, False)
    assert (JServingConfig().fold_w, JServingConfig().fold_w_sr) == (False, True)
    for fold_w, fold_w_sr in (("0", "1"), ("1", "0"), ("0", "0")):
        monkeypatch.setenv("SERVE_FOLD_W", fold_w)
        monkeypatch.setenv("SERVE_FOLD_W_SR", fold_w_sr)
        port, ref = ServingConfig(), JServingConfig()
        assert (port.fold_w, port.fold_w_sr) == (ref.fold_w, ref.fold_w_sr) == (fold_w == "1", fold_w_sr == "1")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_engine_sr_folded_matches_unfolded(dtype):
    """f32: the transform itself, within one level (ties at .5). bf16: the
    folded conv sums the same products in another order, one bf16 ulp per
    conv, compounding to two levels at most."""
    imgs = np.random.default_rng(1).integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)
    on = _engine(dtype, size_buckets=(32,), max_batch=2, fold_w_sr=True)
    off = _engine(dtype, size_buckets=(32,), max_batch=2, fold_w_sr=False)
    out_on, _ = on.sr_batch(imgs, "sr-x2")
    out_off, _ = off.sr_batch(imgs, "sr-x2")
    assert isinstance(on.model("sr-x2"), folded.FoldedSRNet) and isinstance(off.model("sr-x2"), SRNet)
    if dtype == torch.float32:
        _assert_levels(out_on, out_off, 1, 0.25)
    else:
        _assert_levels(out_on, out_off, 2, 0.25, 0.01)


def test_engine_sr_tiled_folded_matches_unfolded():
    """The tiled 2K -> 4K program's shape at 64 px: the folded SRNet over
    every tile, one blend."""
    canvas = np.random.default_rng(3).integers(0, 255, (64, 64, 3)).astype(np.uint8)
    outs = {}
    for fold in (True, False):
        engine = _engine(size_buckets=(64,), max_batch=2, fold_w_sr=fold)
        outs[fold], _ = engine.sr_tiled(canvas, "sr-x2", tile=32, overlap=8, tile_batch=4)
    assert outs[True].shape == (128, 128, 3)
    _assert_levels(outs[True], outs[False], 1, 0.25)


def test_engine_fusion_folded_matches_unfolded():
    rng = np.random.default_rng(2)
    canvas = rng.integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)
    valid = np.asarray([[32, 32], [32, 32]], np.int32)
    jf = np.asarray([1.0, 1.0], np.float32)
    runs = {}
    for fold in (True, False):
        engine = _engine(torch.bfloat16, size_buckets=(32,), max_batch=2, fold_w=fold)
        runs[fold] = engine.fuse_batch(canvas, valid, jf, "restore-unet-small")
    np.testing.assert_allclose(runs[True][1], runs[False][1], rtol=1e-4, atol=1e-4)
    # the composite blends K restored images: two rounding flips at most
    assert np.abs(runs[True][0].astype(np.int16) - runs[False][0].astype(np.int16)).max() <= 2


def test_engine_restore_folded_matches_unfolded():
    """The whole restore program with the fold on (RGB IO) against the
    default engine (space-to-depth IO), in f32."""
    rng = np.random.default_rng(0)
    canvas = rng.integers(0, 255, (2, 64, 64, 3)).astype(np.uint8)
    valid = np.asarray([[64, 64], [48, 56]], np.int32)
    jf = np.asarray([1.0, 0.0], np.float32)
    on = _engine(size_buckets=(64,), max_batch=2, fold_w=True)
    off = _engine(size_buckets=(64,), max_batch=2, fold_w=False)
    out_on, scores_on, _ = on.restore_batch(canvas, valid, jf, "restore-unet")
    out_off, scores_off, _ = off.restore_batch(canvas, valid, jf, "restore-unet")
    assert isinstance(on.model("restore-unet"), folded.FoldedUNet)
    np.testing.assert_allclose(scores_on, scores_off, rtol=1e-4, atol=1e-4)
    _assert_levels(out_on, out_off, 1, 0.02)
    planes_on, _, _ = on.restore_batch(canvas, valid, jf, "restore-unet", egress="yuv420")
    planes_off, _, _ = off.restore_batch(canvas, valid, jf, "restore-unet", egress="yuv420")
    for a, b in zip(planes_on, planes_off):
        _assert_levels(a, b, 1, 0.02)


def test_engine_diffusion_folded_matches_unfolded():
    """The sampler's two folded forwards against the unfolded ones on the
    same noise (both engines' generators from seed 0), in f32."""
    canvas = np.random.default_rng(4).integers(0, 255, (1, 32, 32, 3)).astype(np.uint8)
    outs = {}
    for fold in (True, False):
        engine = _engine(size_buckets=(32,), max_batch=1, fold_w=fold)
        outs[fold], _, _ = engine.restore_batch(canvas, family_name="diffusion-restore")
    _assert_levels(outs[True], outs[False], 1, 0.02)


def test_exec_key_distinguishes_stages_and_fold():
    args = (torch.zeros((2, 32, 32, 3), dtype=torch.uint8),)
    keys = set()
    for deblur in (False, True):
        for deblock in (False, True):
            for fold in (False, True):
                engine = _engine(size_buckets=(32,), max_batch=2, deblur=deblur, deblock=deblock, fold_w=fold)
                keys.add(engine._exec_key("restore-unet", args))
    assert len(keys) == 8
    sr = _engine(size_buckets=(32,), max_batch=2, fold_w=False, fold_w_sr=True)
    assert ("fold_w", True) in sr._exec_key(("sr", "sr-x2"), args)
    assert ("fold_w", False) in sr._exec_key(("sr", "restore-unet"), args)
    assert ("fold_w", False) in _engine(fold_w_sr=False)._exec_key(("sr", "sr-x2"), args)


def test_s2d_io_inactive_for_folded():
    cfg = ServingConfig(fold_w=True)
    assert uses_s2d_io("restore-unet", ServingConfig(fold_w=False))
    assert not uses_s2d_io("restore-unet", cfg)
    engine = RestorationEngine(device="cpu", serving_config=cfg)
    assert not engine._uses_s2d_io("restore-unet") and engine._uses_folded("restore-unet")
    assert not RestorationEngine(device="cpu", serving_config=ServingConfig(fold_w_sr=False))._uses_folded("sr-x2")


def test_folded_surfaces_warm_under_their_own_keys():
    """warmup_serving builds every folded surface; serving them afterwards
    builds nothing, and each key carries the fold."""
    engine = _engine(size_buckets=(32,), max_batch=2, fold_w=True, fold_w_sr=True)
    engine.warmup_serving(families=("restore-unet-small", "sr-x2", "fusion"), sr_tiled_canvas=64)
    built = engine.compile_count
    keys = list(engine._exec_cache._built)
    assert built == len(keys) > 0
    assert all(("fold_w", True) in key for key in keys)
    img = np.random.default_rng(5).integers(0, 255, (2, 32, 32, 3)).astype(np.uint8)
    engine.restore_batch(img, family_name="restore-unet-small")
    engine.restore_batch(img[:1], family_name="restore-unet-small")
    engine.sr_batch(img[:1], "sr-x2")
    engine.sr_tiled(np.zeros((64, 64, 3), np.uint8), "sr-x2", tile=64, output="yuv420")  # as warmed
    engine.fuse_batch(np.repeat(img[:1], 3, axis=0), np.tile([[32, 32]], (3, 1)), np.zeros(3, np.float32),
                      "restore-unet")
    assert engine.compile_count == built


def test_mesh_restore_folded_matches_single_device():
    """The folded layout on data=4 x tensor=2 CPU slots: column-parallel
    layers that keep each channel pair on one slot, the phase kernels
    replicated; the same result as the single-device folded engine."""
    cfg = ServingConfig(size_buckets=(32,), max_batch=8, fold_w=True)
    mesh = make_mesh([torch.device("cpu")] * 8, data=4, tensor=2)
    canvas = np.random.default_rng(5).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    mesh_engine = RestorationEngine(mesh=mesh, serving_config=cfg)
    out_m, scores_m, _ = mesh_engine.restore_batch(canvas, family_name="restore-unet-small")
    out_s, scores_s, _ = RestorationEngine(device="cpu", serving_config=cfg).restore_batch(
        canvas, family_name="restore-unet-small")
    np.testing.assert_allclose(scores_m, scores_s, atol=1e-4)
    assert np.mean(np.abs(out_m.astype(int) - out_s.astype(int))) < 1.0
    assert np.abs(out_m.astype(int) - out_s.astype(int)).max() <= 1  # f32 on the CPU
    replica = mesh_engine._data_replicas("restore-unet-small")[0]
    sharded = [m for m in replica.modules() if isinstance(m, ShardedConv)]
    assert sharded and all(w.shape[0] % 2 == 0 for m in sharded for w in m.w)
    assert all(not isinstance(m, ShardedConv) for m in replica.dec[1].up0.modules())


def test_folded_split_keeps_channel_pairs():
    """A tensor size that would give a slot an odd number of a folded
    layer's channels keeps that layer whole; the output is unchanged."""
    cfg = SRNetConfig(channels=36, num_blocks=1, limit_pool=0)  # folded: 72 channels
    plain = SRNet(cfg).init_(torch.Generator().manual_seed(0))
    model = folded.folded_model(cfg, plain.state_dict()).eval()
    mesh = make_mesh([torch.device("cpu")] * 8, data=1, tensor=8)  # 72 / 8 = 9 channels a slot
    sharded = shard_params(model, mesh).eval()
    assert not any(isinstance(m, ShardedConv) for m in sharded.modules())
    unfolded = shard_params(SRNet(dataclasses.replace(cfg, channels=72)), mesh)
    assert any(isinstance(m, ShardedConv) for m in unfolded.modules())  # 9 a slot is fine unfolded
    x = torch.rand(1, 16, 16, 3)
    with torch.inference_mode():
        torch.testing.assert_close(sharded(x), model(x), rtol=0, atol=0)


def test_pipelines_refuse_a_folded_model():
    from image_restoration_platform_tpu_torch.parallel import srnet_pipeline_apply, unet_pipeline_apply

    cfg = SRNetConfig(channels=8, num_blocks=2, limit_pool=0)
    model = folded.folded_model(cfg, SRNet(cfg).state_dict())
    mesh = make_mesh([torch.device("cpu")] * 2, pipe=2)
    with pytest.raises(ValueError, match="unfolded"):
        srnet_pipeline_apply(model, torch.rand(2, 8, 8, 3), mesh, n_micro=2)
    unet = folded.folded_model(UNetConfig(**UNET_CASES[1][0]), _state(junet.init(jax.random.PRNGKey(0), junet.UNetConfig(
        **UNET_CASES[1][0]))))
    with pytest.raises(ValueError, match="unfolded"):
        unet_pipeline_apply(unet, torch.rand(2, 32, 32, 3), torch.rand(2, 28), mesh, n_micro=2)


def test_model_flops_count_the_unfolded_program():
    """A folded engine's mfu counts the unfolded program's FLOPs, not the
    zero halves of its kernels."""
    canvas = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (1, 64, 64, 3), dtype=np.uint8))
    valid, jpeg = torch.tensor([[64, 64]], dtype=torch.int32), torch.ones(1)
    counts = [bench.model_flops(_engine(size_buckets=(64,), max_batch=1, fold_w=fold), canvas, valid, jpeg)
              for fold in (True, False)]
    assert counts[0] == counts[1] and counts[0][0] > 0
