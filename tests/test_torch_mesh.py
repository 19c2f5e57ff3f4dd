"""PyTorch port: ``parallel/`` (mesh, sharding, halo exchange, pipelines).

The port's meshes here are in-process slot meshes of CPU slots (a slot may
repeat a device), the counterpart of the reference's eight virtual CPU
devices (tests/conftest.py). The pipeline cases mirror
tests/test_pipeline.py with its bars: f32 within 1e-5 of the unpipelined
forward (2e-5 for the UNet), bf16 within 0.05. One case per module of the
halo and pipeline code is held against the JAX function on the same inputs
(the JAX side on the conftest's eight virtual devices, at
``precision=HIGHEST``): f32 within 1e-5, the halo exchange exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from image_restoration_platform_tpu.models import srnet as jsrnet
from image_restoration_platform_tpu.parallel import halo as jhalo
from image_restoration_platform_tpu.parallel import make_mesh as jmake_mesh
from image_restoration_platform_tpu.parallel.pipeline import srnet_pipeline_apply as jsrnet_pipeline_apply
from image_restoration_platform_tpu_torch.models import RestorationUNet, SRNet, SRNetConfig, UNetConfig
from image_restoration_platform_tpu_torch.models import nn as L
from image_restoration_platform_tpu_torch.models import srnet as S
from image_restoration_platform_tpu_torch.models import weights as W
from image_restoration_platform_tpu_torch.parallel import (
    halo_exchange_rows,
    make_mesh,
    maybe_initialize_distributed,
    pipeline_bubble_fraction,
    shard_params,
    spatial_shard_apply,
    split_rows,
    srnet_pipeline_apply,
    unet_pipeline_apply,
)
from image_restoration_platform_tpu_torch.parallel.halo import conv2d_rowsharded
from image_restoration_platform_tpu_torch.parallel.sharding import (
    ShardedConv,
    ShardedDense,
    ShardedFilm,
    gather_state,
    scatter_state_,
)

torch.set_num_threads(2)
CPU = torch.device("cpu")


def cpu_mesh(**axes):
    n = 1
    for size in axes.values():
        n *= size
    return make_mesh([CPU] * n, **axes)


# ---------------------------------------------------------------- the mesh


def test_make_mesh_layout_and_refusals(monkeypatch):
    mesh = make_mesh([CPU] * 8, data=-1, tensor=2)
    assert mesh.shape == {"data": 4, "tensor": 2, "spatial": 1, "pipe": 1}
    assert mesh.devices.shape == (4, 2, 1, 1) and mesh.size == 8 and mesh.primary == CPU
    assert mesh.slots("data") == [CPU] * 4 and mesh.tensor_slots(3) == [CPU] * 2
    with pytest.raises(ValueError, match="not divisible"):
        make_mesh([CPU] * 8, tensor=3)
    with pytest.raises(ValueError, match="!= device count"):
        make_mesh([CPU] * 8, data=3, tensor=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh()  # the default is every card, never the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_mesh([torch.device("cuda:0")] * 4, data=4)
    monkeypatch.delenv("JAX_COORDINATOR", raising=False)
    assert maybe_initialize_distributed() is False  # no coordinator, no group


# ------------------------------------------------------ tensor parallelism


def test_shard_params_splits_wide_layers_and_keeps_the_function():
    """Layers with >= 64 output channels divisible by the tensor size are
    column-parallel (conv: dim 0 of OIHW; dense and FiLM: dim 1); the
    forward is the unsharded one, and the parameters gather back exactly."""
    cfg = UNetConfig(base_channels=32, channel_mults=(1, 2), blocks_per_level=1, attn_heads=2, emb_dim=64)
    model = RestorationUNet(cfg).init_(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    sharded = shard_params(model, cpu_mesh(data=2, tensor=2), data_index=1)
    assert isinstance(sharded.enc[1].blocks[0].conv1, ShardedConv)  # 64 out
    assert not isinstance(sharded.enc[0].blocks[0].conv1, ShardedConv)  # 32 out: replicated
    assert isinstance(sharded.mid.attn.qkv, ShardedDense) and isinstance(sharded.enc[1].blocks[0].film, ShardedFilm)
    assert sharded.enc[1].blocks[0].conv1.w[0].shape == (32, 32, 3, 3)
    x = torch.rand(2, 32, 32, 3, generator=gen)
    cond = torch.rand(2, 28, generator=gen)
    with torch.no_grad():
        np.testing.assert_allclose(sharded(x, cond).numpy(), model(x, cond).numpy(), rtol=0, atol=1e-5)
    state = gather_state(sharded, CPU)
    assert state.keys() == model.state_dict().keys()
    for name, value in model.state_dict().items():
        assert torch.equal(state[name], value), name
    zeroed = {k: torch.zeros_like(v) for k, v in state.items()}
    scatter_state_(sharded, zeroed)
    assert all(float(p.detach().abs().sum()) == 0.0 for p in sharded.parameters())


# ------------------------------------------------------------ halo exchange


def _block_rows(x: np.ndarray, shards: int) -> list[np.ndarray]:
    return np.split(x, shards, axis=0)


@pytest.mark.parametrize("boundary", ["edge", "zero"])
def test_halo_exchange_rows_matches_jax(boundary):
    x = np.random.default_rng(0).uniform(size=(8 * 4, 6, 3)).astype(np.float32)
    jmesh = jmake_mesh(data=1, tensor=1, spatial=8)
    ref = jax.jit(jax.shard_map(
        lambda b: jhalo.halo_exchange_rows(b, 2, boundary=boundary),
        mesh=jmesh, in_specs=P("spatial"), out_specs=P("spatial"), check_vma=False,
    ))(jnp.asarray(x))
    got = halo_exchange_rows(split_rows(torch.from_numpy(x)[None], [CPU] * 8), 2, boundary=boundary)
    for g, r in zip(got, _block_rows(np.asarray(ref), 8)):
        np.testing.assert_array_equal(g[0].numpy(), r)


def test_conv2d_rowsharded_matches_jax_and_the_whole_conv():
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(8 * 3, 10, 4)).astype(np.float32)
    w = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)  # HWIO
    b = rng.normal(size=(5,)).astype(np.float32)
    jmesh = jmake_mesh(data=1, tensor=1, spatial=8)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.shard_map(
            lambda blk: jhalo.conv2d_rowsharded({"w": jnp.asarray(w), "b": jnp.asarray(b)}, blk),
            mesh=jmesh, in_specs=P("spatial"), out_specs=P("spatial"), check_vma=False,
        ))(jnp.asarray(x))
    layer = L.Conv(4, 5)
    with torch.no_grad():
        layer.w.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        layer.b.copy_(torch.from_numpy(b))
    blocks = split_rows(torch.from_numpy(x)[None], [CPU] * 8)
    with torch.no_grad():
        got = torch.cat(conv2d_rowsharded([layer] * 8, blocks), dim=1)[0].numpy()
        whole = layer(torch.from_numpy(x)[None])[0].numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5)


def test_spatial_shard_apply_is_the_whole_image_stencil():
    """A 5-tap vertical box filter with edge clamping, run on 4 row shards
    with a halo of 2, equals the filter of the whole edge-padded image."""
    x = torch.from_numpy(np.random.default_rng(2).uniform(size=(1, 32, 7, 3)).astype(np.float32))

    def box(ext):
        return sum(ext[:, i : ext.shape[1] - 4 + i] for i in range(5)) / 5.0

    fn = spatial_shard_apply(lambda e: torch.nn.functional.pad(box(e), (0, 0, 0, 0, 2, 2)), cpu_mesh(spatial=4), 2)
    padded = torch.cat([x[:, :1]] * 2 + [x] + [x[:, -1:]] * 2, dim=1)
    np.testing.assert_allclose(fn(x).numpy(), box(padded).numpy(), rtol=0, atol=1e-6)


def test_apply_rowsharded_stitched_matches_jax():
    """The unlimited SRNet on 8 row blocks, one halo row exchanged at every
    convolution, against the reference's ``apply_rowsharded`` in shard_map
    and against the port's own unlimited forward of the whole image."""
    jcfg = jsrnet.SRNetConfig(scale=2, channels=16, num_blocks=2)
    params = jsrnet.init(jax.random.PRNGKey(5), jcfg)
    params["up"] = jax.tree_util.tree_map(lambda a: a + 0.05, params["up"])  # a head that is not zero
    x = np.random.default_rng(3).uniform(size=(8 * 4, 16, 3)).astype(np.float32)
    jmesh = jmake_mesh(data=1, tensor=1, spatial=8)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.shard_map(
            lambda p, blk: jsrnet.apply_rowsharded(p, blk, jcfg),
            mesh=jmesh, in_specs=(P(), P("spatial")), out_specs=P("spatial"), check_vma=False,
        ))(params, jnp.asarray(x))
    net = SRNet(SRNetConfig(scale=2, channels=16, num_blocks=2, limit_pool=0))
    net.load_state_dict(W.params_from_jax(W.flatten_params(params)), strict=True)
    with torch.no_grad():
        blocks = split_rows(torch.from_numpy(x)[None], [CPU] * 8)
        got = torch.cat(S.apply_rowsharded([net] * 8, blocks), dim=1)[0].numpy()
        whole = net(torch.from_numpy(x)[None])[0].numpy()
    assert got.shape == (64, 32, 3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- pipelines


@pytest.fixture(scope="module")
def sr_setup():
    cfg = SRNetConfig(scale=2, channels=32, num_blocks=8)
    net = SRNet(cfg).init_(torch.Generator().manual_seed(0))
    with torch.no_grad():
        net.up.w.normal_(0.0, 0.05, generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (8, 32, 32, 3)).astype(np.float32))
    return net, x


@pytest.mark.parametrize("pipe,n_micro", [(4, 4), (8, 8), (2, 4), (4, 2)])
def test_pipeline_matches_unpipelined(sr_setup, pipe, n_micro):
    net, x = sr_setup
    with torch.no_grad():
        ref = net(x)
        got = srnet_pipeline_apply(net, x, cpu_mesh(data=8 // pipe, pipe=pipe), n_micro=n_micro)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


def test_pipeline_bf16(sr_setup):
    net, x = sr_setup
    with torch.no_grad():
        ref = net(x.bfloat16()).float()
        got = srnet_pipeline_apply(net, x.bfloat16(), cpu_mesh(data=2, pipe=4), n_micro=4).float()
    assert float((got - ref).abs().max()) <= 0.05


def test_pipeline_geometry_validation(sr_setup):
    net, x = sr_setup
    mesh = cpu_mesh(pipe=8)
    with pytest.raises(ValueError):
        srnet_pipeline_apply(net, x, mesh, n_micro=3)  # 8 % 3 != 0
    net5 = SRNet(SRNetConfig(scale=2, channels=32, num_blocks=5)).init_(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError):
        srnet_pipeline_apply(net5, x, mesh, n_micro=4)  # 5 blocks % 8


def test_srnet_pipeline_matches_jax():
    jcfg = jsrnet.SRNetConfig(scale=2, channels=16, num_blocks=4)
    params = jsrnet.init(jax.random.PRNGKey(7), jcfg)
    params["up"] = jax.tree_util.tree_map(lambda a: a + 0.05, params["up"])
    x = np.random.default_rng(4).uniform(size=(4, 24, 24, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda p, v: jsrnet_pipeline_apply(p, v, jcfg, jmake_mesh(data=2, pipe=4), n_micro=4))(
            params, jnp.asarray(x))
    net = SRNet(SRNetConfig(scale=2, channels=16, num_blocks=4))
    net.load_state_dict(W.params_from_jax(W.flatten_params(params)), strict=True)
    with torch.no_grad():
        got = srnet_pipeline_apply(net, torch.from_numpy(x), cpu_mesh(data=2, pipe=4), n_micro=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def unet_setup():
    cfg = UNetConfig(base_channels=32, norm_groups=8, blocks_per_level=1, emb_dim=64)
    model = RestorationUNet(cfg).init_(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():  # FiLM and head start at zero: move them off it
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.uniform(0, 1, (8, 16, 16, 3)).astype(np.float32))
    cond = torch.from_numpy(rng.uniform(0, 1, (8, 28)).astype(np.float32))
    return model, x, cond


def test_unet_pipeline_matches_apply(unet_setup):
    """pipe=4 composed with data=2 reproduces the forward."""
    model, x, cond = unet_setup
    with torch.no_grad():
        ref = model(x, cond)
        got = unet_pipeline_apply(model, x, cond, cpu_mesh(data=2, pipe=4), n_micro=4)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=1e-5)


def test_unet_pipeline_full_pipe_axis(unet_setup):
    """All 8 slots on the pipe axis (one segment each)."""
    model, x, cond = unet_setup
    with torch.no_grad():
        ref = model(x, cond)
        got = unet_pipeline_apply(model, x, cond, cpu_mesh(pipe=8), n_micro=4)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="exceeds"):
        unet_pipeline_apply(model, x, cond, make_mesh([CPU] * 16, pipe=16), n_micro=4)


def test_unet_pipeline_bubble_fraction():
    assert pipeline_bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert pipeline_bubble_fraction(16, 4) == pytest.approx(3 / 19)
    # deep microbatching drives the bubble toward zero
    assert pipeline_bubble_fraction(64, 8) < 0.1
