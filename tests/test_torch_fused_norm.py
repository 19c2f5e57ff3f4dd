"""PyTorch port: the fused GroupNorm (ops/cuda/group_norm.py) against the
JAX package's GroupNorm, FiLM and SiLU.

On the CPU the port's ``gn_moments``, ``gn_film_moments`` and
``gn_affine_silu`` take their plain versions (the CUDA kernels run only on
the card). Held here, with the JAX package run eagerly on the CPU:

- the model functions that route through them (``film_group_norm_silu``,
  ``group_norm_silu``, ``group_norm``, ``group_norm_cat``) against the
  reference's ``film`` -> ``group_norm`` -> ``silu``, ``group_norm_cat`` and
  the head's ``group_norm`` + ``silu``: f32 with JAX at ``precision=HIGHEST``
  to rtol/atol 2e-5; bf16 within one bf16 ulp of the reference's largest
  output;
- the folded decoder up-block (``models/folded.py:_res_block_up``) against
  the reference's folded function, and ``RestorationUNet`` and
  ``FoldedUNet`` forwards at a narrow width, f32, rtol/atol 2e-5 and 2e-4;
- each autograd Function on its plain path: its gradient equals autograd
  through the plain composition, bit for bit;
- the moments kernel's launch plan: every pixel in exactly one split, the
  card filled at the main path's shapes, and a plain emulation of the
  kernel's summation order.

The ``cuda``-marked tests hold each kernel against its plain version on the
card (``pytest -m cuda --noconftest``: the card's machine has no JAX, so the
CPU tests import it inside)."""

import importlib
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu_torch.models import nn as L
from image_restoration_platform_tpu_torch.ops.cuda import build
from image_restoration_platform_tpu_torch.ops.cuda import group_norm as G

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 2e-5
NARROW = dict(base_channels=16, channel_mults=(1, 2), blocks_per_level=1, attn_heads=2, norm_groups=8)


def _smoke_module():
    """chip_smoke.py as a module (it imports nothing but the standard
    library until it runs): its GroupNorm shapes are the main path's."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _smoke_module()


def _jax():
    """jax, jax.numpy and the reference's nn, imported by the tests that use
    them: the ``cuda`` tests also run where there is no JAX."""
    import jax
    import jax.numpy as jnp

    from image_restoration_platform_tpu.models import nn as jnn

    return jax, jnp, jnn


def _normal(shape, seed, scale=1.0, loc=0.0):
    return (loc + np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bf16_ulp(ref: np.ndarray) -> float:
    """One bf16 ulp (8 significant bits) at the largest |ref|."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(ref).max()))) - 7)


def _film_case(c: int, seed: int, n: int = 2, hw=(8, 6), emb_dim: int = 16):
    """raw conv output, conv bias, cond, FiLM dense and GroupNorm params."""
    return dict(
        raw=_normal((n, *hw, c), seed), conv_b=_normal((c,), seed + 1, 0.2), emb=_normal((n, emb_dim), seed + 2, 0.5),
        fw=_normal((emb_dim, 2 * c), seed + 3, 0.1), fb=_normal((2 * c,), seed + 4, 0.1),
        scale=_normal((c,), seed + 5, 0.1, 1.0), bias=_normal((c,), seed + 6, 0.1),
    )


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


# ------------------------------------------------- the functions against JAX


def _reference(jax, fn, dtype: str, *args):
    """``fn(*args)`` of the reference, jitted as the reference serves it
    (one compile, not one an op), read back in f32."""
    with jax.default_matmul_precision("highest"):
        out = jax.jit(fn)(*args)
    return np.asarray(jax.numpy.asarray(out, jax.numpy.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_film_group_norm_silu_matches_jax(dtype):
    """The ResBlock's conv1 bias -> FiLM -> norm2 -> SiLU from the raw conv
    output, against jnn.film -> jnn.group_norm -> jnn.silu; 48 channels in
    8 groups of 6."""
    jax, jnp, jnn = _jax()
    c = 48
    k = _film_case(c, 10 + c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def chain(raw, conv_b, emb, fw, fb, scale, bias):
        y = jnn.film({"w": fw, "b": fb}, raw.astype(jdt) + conv_b.astype(jdt), emb)
        return jnn.silu(jnn.group_norm({"scale": scale, "bias": bias}, y, 8))

    ref = _reference(jax, chain, dtype, *(jnp.asarray(k[n]) for n in ("raw", "conv_b", "emb", "fw", "fb", "scale",
                                                                      "bias")))
    t = {name: torch.from_numpy(v) for name, v in k.items()}
    gamma_beta = L.dense(t["emb"].to(tdt), t["fw"], t["fb"])
    got = L.film_group_norm_silu(t["raw"].to(tdt), t["conv_b"], gamma_beta, t["scale"], t["bias"], 8)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(_to_np(got), ref, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert np.abs(_to_np(got) - ref).max() <= _bf16_ulp(ref)


@pytest.mark.parametrize("silu", [True, False], ids=["norm_silu", "norm_alone"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_silu_matches_jax(silu, dtype):
    """norm1 and the head (GroupNorm + SiLU), and the attention's norm
    (GroupNorm alone), against the reference's group_norm (+ silu)."""
    jax, jnp, jnn = _jax()
    x = _normal((2, 8, 6, 64), 21, 1.5, 0.3)
    scale, bias = _normal((64,), 22, 0.1, 1.0), _normal((64,), 23, 0.1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def norm(a, sc, bi):
        out = jnn.group_norm({"scale": sc, "bias": bi}, a.astype(jdt), 8)
        return jnn.silu(out) if silu else out

    ref = _reference(jax, norm, dtype, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    xt, st, bt = torch.from_numpy(x).to(tdt), torch.from_numpy(scale), torch.from_numpy(bias)
    got = L.group_norm_silu(xt, st, bt, 8, silu=silu)
    if not silu:
        assert torch.equal(got, L.group_norm(xt, st, bt, 8))
    if dtype == "float32":
        np.testing.assert_allclose(_to_np(got), ref, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert np.abs(_to_np(got) - ref).max() <= _bf16_ulp(ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_norm_cat_matches_jax(dtype):
    """The decoder's virtual concat: a group spans both parts (48 channels in
    8 groups of 6, parts of 16 and 32)."""
    jax, jnp, jnn = _jax()
    parts = [_normal((2, 8, 6, 16), 31), _normal((2, 8, 6, 32), 32, 0.7, -0.2)]
    scale, bias = _normal((48,), 33, 0.1, 1.0), _normal((48,), 34, 0.1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def norm_cat(a, b, sc, bi):
        return jnp.concatenate(
            [jnn.silu(p) for p in jnn.group_norm_cat({"scale": sc, "bias": bi}, [a.astype(jdt), b.astype(jdt)], 8)],
            axis=-1)

    refs = np.split(_reference(jax, norm_cat, dtype, *(jnp.asarray(a) for a in (*parts, scale, bias))), [16], axis=-1)
    got = L.group_norm_cat([torch.from_numpy(p).to(tdt) for p in parts], torch.from_numpy(scale),
                           torch.from_numpy(bias), 8, silu=True)
    for g, ref in zip(got, refs):
        if dtype == "float32":
            np.testing.assert_allclose(_to_np(g), ref, rtol=F32_TOL, atol=F32_TOL)
        else:
            assert np.abs(_to_np(g) - ref).max() <= _bf16_ulp(ref)


# --------------------------------------------------- the blocks and forwards


def _numpy_params(jax, init, seed: int, scale: float):
    """A reference parameter tree of ``init``'s shapes, every leaf from
    numpy (head and FiLM initialise at zero, so random everywhere): no JAX
    random draws, whose compiles would dominate the test's time."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init)
    return jax.tree_util.tree_map(lambda a: (scale * rng.standard_normal(a.shape)).astype(np.float32), shapes)


@pytest.mark.parametrize("in_ch,out_ch,lo_hw", [(32, 16, (4, 6)), (64, 32, (2, 4))])
def test_folded_res_block_up_matches_jax(in_ch, out_ch, lo_hw):
    """The folded decoder's first block (moments of x_lo weighted 4x, the
    affine + SiLU of both parts, the FiLM prologue of norm2) against the
    reference's folded ``_res_block_up``; base 16, groups 8."""
    jax, jnp, _ = _jax()
    from image_restoration_platform_tpu.models import folded as jfolded
    from image_restoration_platform_tpu.models import unet as junet
    from image_restoration_platform_tpu_torch.models import folded
    from image_restoration_platform_tpu_torch.models import weights as W
    from image_restoration_platform_tpu_torch.models.unet import ResBlock

    emb_dim, groups = 16, 8
    bp = _numpy_params(jax, lambda: junet._res_block_init(jax.random.PRNGKey(0), in_ch + out_ch, out_ch, emb_dim),
                       in_ch + out_ch, 0.1)
    x = _normal((2, *lo_hw, in_ch), 41)
    skip = _normal((2, 2 * lo_hw[0], 2 * lo_hw[1], out_ch), 42)
    emb = _normal((2, emb_dim), 43, 0.3)
    ci_x = in_ch

    def block_up(p, a, b, e):  # the reference's weight folds and block, jitted: one compile
        up = {"conv1_up": jfolded._fold_upconv(p["conv1"]["w"][:, :, :ci_x, :]),
              "skip_up": jfolded._fold_upconv(p["skip"]["w"][:, :, :ci_x, :])}
        return jfolded.unfold_w(jfolded._res_block_up(jfolded._fold_res_block(p), up, jfolded.fold_w(a),
                                                      jfolded.fold_w(b), e, groups))

    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jax.jit(block_up)(bp, jnp.asarray(x), jnp.asarray(skip), jnp.asarray(emb)))
    state = W.params_from_jax(W.flatten_params(bp))
    block = ResBlock(2 * (in_ch + out_ch), 2 * out_ch, emb_dim)
    block.load_state_dict(folded._fold_res_block(state, ""), strict=True)
    up0 = folded.PhaseKernels(2 * in_ch, 2 * out_ch)
    up0.load_state_dict({"conv1_up": folded._fold_upconv(state["conv1.w"][:, :ci_x]),
                         "skip_up": folded._fold_upconv(state["skip.w"][:, :ci_x])})
    with torch.no_grad():
        got = folded.unfold_w(folded._res_block_up(block, up0, folded.fold_w(torch.from_numpy(x)),
                                                   folded.fold_w(torch.from_numpy(skip)), torch.from_numpy(emb),
                                                   groups))
    np.testing.assert_allclose(got.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("layout", ["unfolded", "folded"])
def test_unet_forward_matches_jax(layout):
    """RestorationUNet and FoldedUNet at a narrow width (base 16, groups 8,
    32 px, batch 1) on random weights, against the reference's ``apply``
    and folded ``apply``: every GroupNorm site goes through the fused path."""
    jax, jnp, _ = _jax()
    from image_restoration_platform_tpu.models import folded as jfolded
    from image_restoration_platform_tpu.models import unet as junet
    from image_restoration_platform_tpu_torch.models import folded
    from image_restoration_platform_tpu_torch.models import weights as W
    from image_restoration_platform_tpu_torch.models.unet import RestorationUNet, UNetConfig

    jcfg, cfg = junet.UNetConfig(**NARROW), UNetConfig(**NARROW)
    params = _numpy_params(jax, lambda: junet.init(jax.random.PRNGKey(0), jcfg), 51, 0.1)
    x = np.random.default_rng(52).random((1, 32, 32, 3)).astype(np.float32)
    cond = _normal((1, 28), 53, 0.3)
    state = W.params_from_jax(W.flatten_params(params))
    if layout == "folded":
        apply = jax.jit(lambda p, a, b: jfolded.apply(jfolded.fold_params(p, jcfg), a, b, config=jcfg))
        model = folded.folded_model(cfg, state).eval()
    else:
        apply = jax.jit(lambda p, a, b: junet.apply(p, a, b, config=jcfg))
        model = RestorationUNet(cfg)
        model.load_state_dict(state, strict=True)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(apply(params, jnp.asarray(x), jnp.asarray(cond)))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)


# ------------------------------------------------------ the autograd Functions


def _weights(shape, seed, dtype):
    return torch.from_numpy(_normal(shape, seed)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moments_function_gradient_equals_eager(dtype):
    x = torch.from_numpy(_normal((2, 5, 4, 16), 61)).to(dtype)
    w1, w2 = torch.from_numpy(_normal((2, 16), 62)), torch.from_numpy(_normal((2, 16), 63))
    grads = []
    for fn in (G.GNMoments.apply, G.moments_reference):
        xi = x.clone().requires_grad_()
        s1, s2 = fn(xi)
        ((s1 * w1).sum() + (s2 * w2).sum()).backward()
        grads.append(xi.grad)
    assert grads[0].dtype == dtype and torch.equal(grads[0], grads[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_film_moments_function_gradient_equals_eager(dtype):
    k = _film_case(16, 70, hw=(5, 4))
    inputs = (torch.from_numpy(k["raw"]).to(dtype), torch.from_numpy(k["conv_b"]).to(dtype),
              _weights((2, 32), 71, dtype))
    wy, w1, w2 = _weights((2, 5, 4, 16), 72, torch.float32), _weights((2, 16), 73, torch.float32), \
        _weights((2, 16), 74, torch.float32)
    grads = []
    for fn in (G.GNFilmMoments.apply, G.film_moments_reference):
        leaves = [t.clone().requires_grad_() for t in inputs]
        y, s1, s2 = fn(*leaves)
        ((y.float() * wy).sum() + (s1 * w1).sum() + (s2 * w2).sum()).backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "affine"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_affine_silu_function_gradient_equals_eager(silu, dtype):
    inputs = (torch.from_numpy(_normal((2, 5, 4, 16), 81)).to(dtype), torch.from_numpy(_normal((2, 16), 82, 0.2, 1.0)),
              torch.from_numpy(_normal((2, 16), 83, 0.2)))
    w = _weights((2, 5, 4, 16), 84, torch.float32)
    grads = []
    for fn in (lambda x, s, b: G.GNAffineSilu.apply(x, s, b, silu), lambda x, s, b: G.affine_silu_reference(x, s, b, silu)):
        leaves = [t.clone().requires_grad_() for t in inputs]
        (fn(*leaves).float() * w).sum().backward()
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# --------------------------------------------------------- the launch plan


@pytest.mark.parametrize("shape", [s for s, _, _ in SMOKE.GN_SHAPES] + [(1, 8, 8, 8), (3, 7, 5, 4096)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_moments_plan_covers_every_pixel_once(shape, dtype):
    n, h, w, c = shape
    splits, chunk, tiles = G.moments_plan(n, h * w, c, dtype)
    assert (splits - 1) * chunk < h * w <= splits * chunk
    assert tiles == -(-(c // G.VEC[dtype]) // G.THREADS)
    if (n, h, w, c) in [s for s, _, _ in SMOKE.GN_SHAPES]:
        # the main path's tensors fill the card: at least a block an SM
        assert n * splits * tiles >= G.H100_SM_COUNT, (shape, splits)
        rows = G.THREADS // min(G.THREADS, c // G.VEC[dtype])
        assert chunk >= rows * G.MIN_PIXELS_PER_THREAD or splits == 1


def _emulate_moments(x: torch.Tensor):
    """The kernel's summation order in plain PyTorch (f32): each split's
    row groups sum their pixels in order, row group 0 adds the others in
    order, the combine adds the splits in order."""
    n, h, w, c = x.shape
    splits, chunk, _ = G.moments_plan(n, h * w, c, x.dtype)
    rows = G.THREADS // min(G.THREADS, c // G.VEC[x.dtype])
    flat = x.float().reshape(n, h * w, c)
    out = torch.zeros(2, n, c)
    for s in range(splits):
        group = [torch.zeros(2, n, c) for _ in range(rows)]
        for p in range(s * chunk, min(h * w, (s + 1) * chunk)):
            v = flat[:, p]
            g = group[(p - s * chunk) % rows]
            g[0] += v
            g[1] += v * v
        part = group[0]
        for g in group[1:]:
            part = part + g
        out = out + part
    return out[0], out[1]


def test_emulated_kernel_order_matches_plain_sums():
    x = torch.from_numpy(_normal((2, 12, 10, 64), 91, 1.0, 0.5))
    got, want = _emulate_moments(x), G.moments_reference(x)
    scale = x.abs().sum(dim=(1, 2))
    for a, b, sc in zip(got, want, (scale, (x * x).sum(dim=(1, 2)))):
        assert bool(((a - b).abs() <= 1e-5 * sc).all())


# ------------------------------------------------------------ the routing


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    before = (G.moments_kernel.launches, G.affine_silu_kernel.launches)
    k = _film_case(16, 95)
    raw, cb, gb = torch.from_numpy(k["raw"]), torch.from_numpy(k["conv_b"]), _weights((2, 32), 96, torch.float32)
    y, s1, s2 = G.gn_film_moments(raw, cb, gb)
    want = G.film_moments_reference(raw, cb, gb)
    assert all(torch.equal(a, b) for a, b in zip((y, s1, s2), want))
    assert all(torch.equal(a, b) for a, b in zip(G.gn_moments(raw), G.moments_reference(raw)))
    sc, bi = s1 * 0.01 + 1.0, s2 * 0.001
    assert torch.equal(G.gn_affine_silu(y, sc, bi), G.affine_silu_reference(y, sc, bi))
    assert (G.moments_kernel.launches, G.affine_silu_kernel.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        G.moments_kernel(raw)
    with pytest.raises(ValueError, match="CUDA"):
        G.affine_silu_kernel(y, sc, bi)


def test_kernel_source_names_what_it_ports_and_nothing_is_built_on_import():
    text = open(os.path.join(build.CSRC_DIR, G.SOURCE)).read()
    assert "irp_gn_moments" in text and "irp_gn_affine_silu" in text and "models/nn.py:81-125" in text
    assert G.moments_kernel._fn is None or torch.cuda.is_available()
    assert G.affine_silu_kernel._fn is None or torch.cuda.is_available()


def test_launch_delta_carries_the_fused_norm_kernels():
    from image_restoration_platform_tpu_torch.serve.exec_cache import LaunchDelta

    before = (G.moments_kernel.launches, G.affine_silu_kernel.launches)
    delta = LaunchDelta()
    G.moments_kernel.launches += 3  # what a capture would have recorded
    G.moments_kernel.launches_by_variant["film"] += 3
    delta.close()
    assert G.moments_kernel.launches == before[0]
    delta.replay()
    assert G.moments_kernel.launches == before[0] + 3
    G.moments_kernel.launches -= 3
    G.moments_kernel.launches_by_variant["film"] -= 3


KERNEL_MODULES = {"flash_attention": ("attention", "flash_kernel"), "blend_tiles": ("blend", "blend_kernel"),
                  "gn_moments": ("group_norm", "moments_kernel"), "gn_affine_silu": ("group_norm", "affine_silu_kernel"),
                  "window_attention": ("window_attention", "window_attention_kernel"),
                  "swin_add_norm": ("swin_add_norm", "swin_add_norm_kernel"),
                  "overlap_attention": ("overlap_attention", "overlap_attention_kernel")}


@pytest.mark.parametrize("name", list(KERNEL_MODULES))
def test_every_kernel_binding_is_registered_under_its_counter_name(name):
    """Each hand-written kernel's binding registers itself as it is made,
    under the name of its counter ``kernels.launches.<name>``."""
    from image_restoration_platform_tpu_torch.obs.metrics import KERNELS

    module, attribute = KERNEL_MODULES[name]
    kernel = getattr(importlib.import_module(f"image_restoration_platform_tpu_torch.ops.cuda.{module}"), attribute)
    assert isinstance(kernel, build.Kernel) and kernel.name == name
    assert [k for k in KERNELS if k.name == name] == [kernel]


def test_launch_delta_carries_a_kernel_registered_after_it_opened():
    """A binding first made while a capture is open (its module imported
    then) counts from 0: the capture's launches are taken back and every
    replay adds them."""
    from image_restoration_platform_tpu_torch.obs import metrics
    from image_restoration_platform_tpu_torch.serve.exec_cache import LaunchDelta

    class ProbeKernel(build.Kernel):
        name, variants = "probe", ("plain", "fused")
        source, symbol, argtypes = "probe.cu", "irp_probe", ()

    delta = LaunchDelta()
    probe = ProbeKernel()
    try:
        assert metrics.KERNELS[-1] is probe
        probe.launches += 3  # what a capture would have recorded
        probe.launches_by_variant["fused"] += 3
        delta.close()
        assert (probe.launches, probe.launches_by_variant) == (0, {"plain": 0, "fused": 0})
        published = metrics.get_counters().snapshot().get("kernels.launches.probe", 0.0)
        delta.replay()
        delta.replay()
        assert (probe.launches, probe.launches_by_variant) == (6, {"plain": 0, "fused": 6})
        assert metrics.get_counters().snapshot()["kernels.launches.probe"] - published == 6
    finally:
        metrics.KERNELS.remove(probe)
    assert probe._fn is None  # nothing was bound or built


# -------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card(shape, seed, dtype, device, loc=0.0, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=device) * scale + loc).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 12, 128), (1, 128, 64, 128), (2, 8, 8, 4096), (3, 5, 7, 24)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("loc,scale", [(0.0, 1.0), (4.0, 0.1)], ids=["unit", "offset"])
def test_cuda_moments_match_plain(cuda_device, shape, dtype, loc, scale):
    x = _card(shape, 1, dtype, cuda_device, loc, scale)
    s1, s2 = G.moments_kernel(x)
    torch.cuda.synchronize()
    w1, w2 = G.moments_reference(x)
    mag = x.float().abs().sum(dim=(1, 2))
    assert bool(((s1 - w1).abs() <= 1e-5 * mag).all()) and bool(((s2 - w2).abs() <= 1e-5 * w2).all())
    again = G.moments_kernel(x)
    assert torch.equal(again[0], s1) and torch.equal(again[1], s2)  # the same bits every run


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 12, 128), (1, 64, 32, 256), (3, 5, 7, 24)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_film_prologue_matches_plain(cuda_device, shape, dtype):
    n, h, w, c = shape
    raw = _card(shape, 2, dtype, cuda_device)
    cb, gb = _card((c,), 3, dtype, cuda_device, scale=0.3), _card((n, 2 * c), 4, dtype, cuda_device, scale=0.5)
    y, s1, s2 = G.moments_kernel(raw, cb, gb)
    torch.cuda.synchronize()
    wy, w1, w2 = G.film_moments_reference(raw, cb, gb)
    assert torch.equal(y, wy)  # bit for bit
    mag = wy.float().abs().sum(dim=(1, 2))
    assert bool(((s1 - w1).abs() <= 1e-5 * mag).all()) and bool(((s2 - w2).abs() <= 1e-5 * w2).all())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 12, 128), (8, 64, 32, 512), (3, 5, 7, 24)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("silu", [True, False], ids=["silu", "affine"])
def test_cuda_affine_silu_matches_plain_bit_for_bit(cuda_device, shape, dtype, silu):
    n, h, w, c = shape
    x = _card(shape, 5, dtype, cuda_device, scale=3.0)
    sc, bi = _card((n, c), 6, torch.float32, cuda_device, 1.0, 0.5), _card((n, c), 7, torch.float32, cuda_device)
    out = G.affine_silu_kernel(x, sc, bi, silu)
    torch.cuda.synchronize()
    assert torch.equal(out, G.affine_silu_reference(x, sc, bi, silu))


@pytest.mark.cuda
def test_cuda_affine_takes_column_slices_of_the_concat_affine(cuda_device):
    """Each part of a virtual concat reads its columns of the [N, C] affine
    through the row stride, without a copy."""
    x = _card((2, 8, 8, 64), 15, torch.bfloat16, cuda_device)
    sc, bi = _card((2, 192), 16, torch.float32, cuda_device, 1.0, 0.5), _card((2, 192), 17, torch.float32, cuda_device)
    for start in (0, 64, 128):
        s, b = sc[:, start : start + 64], bi[:, start : start + 64]
        assert torch.equal(G.affine_silu_kernel(x, s, b), G.affine_silu_reference(x, s, b))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    x = _card((2, 8, 8, 64), 8, torch.bfloat16, cuda_device)
    sc = torch.ones((2, 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        G.moments_kernel(x.transpose(1, 2))
    with pytest.raises(ValueError, match="multiple"):
        G.moments_kernel(x[..., :60].contiguous())
    with pytest.raises(TypeError):
        G.moments_kernel(x.half())
    with pytest.raises(TypeError):
        G.affine_silu_kernel(x, sc.bfloat16(), sc)
    with pytest.raises(ValueError, match="shape"):
        G.affine_silu_kernel(x, sc[:1], sc[:1])
    with pytest.raises(ValueError, match="rows"):
        G.affine_silu_kernel(x, sc.t().contiguous().t(), sc.t().contiguous().t())


@pytest.mark.cuda
def test_cuda_functions_give_the_plain_gradients(cuda_device):
    dtype = torch.bfloat16
    raw = _card((2, 8, 8, 64), 9, dtype, cuda_device).requires_grad_()
    cb = _card((64,), 10, dtype, cuda_device, scale=0.3).requires_grad_()
    gb = _card((2, 128), 11, dtype, cuda_device, scale=0.5).requires_grad_()
    scale = _card((64,), 12, torch.float32, cuda_device, 1.0, 0.1).requires_grad_()
    bias = _card((64,), 13, torch.float32, cuda_device, scale=0.1).requires_grad_()
    before = (G.moments_kernel.launches, G.affine_silu_kernel.launches)
    out = L.film_group_norm_silu(raw, cb, gb, scale, bias, 8)
    assert (G.moments_kernel.launches, G.affine_silu_kernel.launches) == (before[0] + 1, before[1] + 1)
    dout = _card(out.shape, 14, dtype, cuda_device)
    got = torch.autograd.grad(out, (raw, cb, gb, scale, bias), dout)
    # autograd through the plain chain on the same inputs: the forward's sums
    # differ only in order, so the gradients agree to the bf16 rounding
    y = G.film_modulate(raw + cb, gb)
    s1, s2 = G.moments_reference(y)
    mean, inv = L._group_moments(s1, s2, 8, 8 * 8 * 8, 1e-5)
    s, b = L._folded_affine(scale, bias, mean, inv)
    want = torch.autograd.grad(G.affine_silu_reference(y, s, b), (raw, cb, gb, scale, bias), dout)
    for a, b_ in zip(got, want):
        assert torch.allclose(a.float(), b_.float(), rtol=2e-2, atol=2e-2 * float(b_.float().abs().max()))
