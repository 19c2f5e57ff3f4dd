"""PyTorch port: tiling and the overlap blend against the JAX package.

``tile_grid``, ``_hann_window`` and ``tile_image`` are exact copies, so they
are held to equality. The port's plain ``blend_tiles`` is held against the
reference's XLA fold and against the Pallas kernel run in interpret mode, at
the reference's own bar of atol 1e-3 on a 0..255 range (f32 sums of at most
a few windowed tiles; measured 0 against the XLA fold and 1.5e-5 against the
Pallas kernel). On the CPU ``ops.cuda.blend.blend_tiles``
takes the plain fold; the CUDA kernel is held against it on the card by the
``cuda``-marked tests below and by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.ops import tile as JT
from image_restoration_platform_tpu.ops.pallas.blend import blend_tiles_pallas
from image_restoration_platform_tpu_torch.ops import tile as T
from image_restoration_platform_tpu_torch.ops.cuda import blend as B

torch.set_num_threads(2)
ATOL = 1e-3

# (canvas h x w, tile, overlap, scale): the four geometries of
# tests/test_pallas_blend.py, one with scale-2 origins (tiles of 2T at 2y, 2x)
# and one where three tiles cover a row (overlap > T/2)
GEOMETRIES = [
    ((96, 80), 32, 8, 1),
    ((64, 64), 32, 16, 1),  # overlap = T/2
    ((100, 68), 32, 8, 1),  # clamped last tiles in both axes
    ((32, 32), 32, 8, 1),  # single tile
    ((48, 40), 16, 4, 2),  # super-resolution origins
    ((64, 56), 32, 24, 1),  # stride 8: up to four tiles cover a row
]
IDS = ["96x80", "half-overlap", "clamped", "single", "scale2", "three-cover"]


def _case(hw, tile, overlap, scale, seed=1):
    """(out tiles [n, T*s, T*s, 3] f32 numpy, ys, xs) for a canvas of hw."""
    rng = np.random.default_rng(seed)
    stride = tile - overlap
    ys, xs = T.tile_grid(hw[0], tile, stride), T.tile_grid(hw[1], tile, stride)
    tiles = rng.uniform(0, 255, (len(ys) * len(xs), tile * scale, tile * scale, 3)).astype(np.float32)
    return tiles, ys, xs


@pytest.mark.parametrize("size,tile,stride", [(96, 32, 24), (100, 32, 24), (32, 32, 24), (20, 32, 24),
                                              (64, 32, 16), (1024, 256, 224), (2048, 256, 224), (68, 32, 24)])
def test_tile_grid_equals_reference(size, tile, stride):
    assert T.tile_grid(size, tile, stride) == JT.tile_grid(size, tile, stride)


def test_tile_grid_main_shapes():
    assert T.tile_grid(2048, 256, 224) == tuple(range(0, 2048 - 256 + 1, 224))  # uniform: 9 starts
    assert T.tile_grid(1024, 256, 224)[-2:] == (672, 768)  # clamped last tile: 160 rows of overlap


@pytest.mark.parametrize("tile", [16, 32, 256, 512])
def test_hann_window_equals_reference(tile):
    w = T._hann_window(tile)
    assert w.dtype == np.float32 and w.shape == (tile, tile)
    np.testing.assert_array_equal(w, JT._hann_window(tile))
    assert w.min() >= 1e-6  # floored at 1e-3 per axis: the divide is safe


@pytest.mark.parametrize("hw,tile,overlap", [((96, 80), 32, 8), ((100, 68), 32, 8), ((32, 32), 32, 8)])
def test_tile_image_equals_reference(hw, tile, overlap):
    img = np.random.default_rng(0).uniform(0, 255, (*hw, 3)).astype(np.float32)
    ref, rys, rxs = JT.tile_image(jnp.asarray(img), tile, overlap)
    got, ys, xs = T.tile_image(torch.from_numpy(img), tile, overlap)
    assert (ys, xs) == (rys, rxs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("hw,tile,overlap,scale", GEOMETRIES, ids=IDS)
def test_plain_blend_matches_xla_fold(hw, tile, overlap, scale):
    tiles, ys, xs = _case(hw, tile, overlap, scale)
    ref = np.asarray(JT.blend_tiles(jnp.asarray(tiles), hw, ys, xs, scale=scale))
    got = T.blend_tiles(torch.from_numpy(tiles), hw, ys, xs, scale=scale)
    assert got.dtype == torch.float32 and tuple(got.shape) == (hw[0] * scale, hw[1] * scale, 3)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw,tile,overlap,scale", GEOMETRIES, ids=IDS)
def test_blend_matches_pallas_kernel_in_interpret_mode(hw, tile, overlap, scale):
    """The dispatching ``blend_tiles`` (plain fold on the CPU) with origins
    already scaled, as ``tiled_apply`` calls it, against the TPU kernel."""
    tiles, ys, xs = _case(hw, tile, overlap, scale)
    out_hw = (hw[0] * scale, hw[1] * scale)
    out_ys, out_xs = tuple(y * scale for y in ys), tuple(x * scale for x in xs)
    ref = np.asarray(blend_tiles_pallas(jnp.asarray(tiles), out_hw, out_ys, out_xs, interpret=True))
    got = B.blend_tiles(torch.from_numpy(tiles), out_hw, out_ys, out_xs)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL)


def test_identity_reconstruction():
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (96, 96, 3)).astype(np.float32))
    tiles, ys, xs = T.tile_image(img, tile=32, overlap=8)
    np.testing.assert_allclose(B.blend_tiles(tiles, (96, 96), ys, xs).numpy(), img.numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("tile_batch", [None, 4, 5])
def test_tiled_apply_identity_and_chunk_padding(tile_batch):
    """Chunks are filled by repeating the last tile, so ``fn`` always sees
    ``tile_batch`` tiles; the padding never reaches the blend."""
    img = torch.from_numpy(np.random.default_rng(3).uniform(0, 255, (64, 64, 3)).astype(np.float32))
    seen = []

    def fn(t):
        seen.append(t.shape[0])
        return t.clone()

    out = T.tiled_apply(img, fn, tile=32, overlap=8, tile_batch=tile_batch)
    np.testing.assert_allclose(out.numpy(), img.numpy(), rtol=0, atol=ATOL)
    n = len(T.tile_grid(64, 32, 24)) ** 2
    assert seen == ([n] if tile_batch is None else [tile_batch] * -(-n // tile_batch))


def test_tiled_apply_scale_matches_reference():
    img = np.random.default_rng(4).uniform(0, 255, (48, 40, 3)).astype(np.float32)
    ref = JT.tiled_apply(jnp.asarray(img), lambda t: jnp.repeat(jnp.repeat(t, 2, axis=1), 2, axis=2) * 0.5,
                         tile=16, overlap=4, scale=2, tile_batch=4, use_pallas_blend=False)
    got = T.tiled_apply(torch.from_numpy(img),
                        lambda t: t.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2) * 0.5,
                        tile=16, overlap=4, scale=2, tile_batch=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw,tile,overlap,scale", [GEOMETRIES[0], GEOMETRIES[2], GEOMETRIES[5]],
                         ids=[IDS[0], IDS[2], IDS[5]])
def test_bar_rejects_a_fold_that_drops_one_tile(hw, tile, overlap, scale):
    """The 1e-3 bar is sharp: a fold that leaves one interior tile out of the
    sum (but not out of the window sum) errs by tens of levels."""
    tiles, ys, xs = _case(hw, tile, overlap, scale)
    ref = T.blend_tiles(torch.from_numpy(tiles), hw, ys, xs)
    bad_tiles = tiles.copy()
    bad_tiles[len(xs) + 1] = 0.0  # second row, second column
    bad = T.blend_tiles(torch.from_numpy(bad_tiles), hw, ys, xs)
    assert float((bad - ref).abs().max()) > 1e4 * ATOL


def test_environment_switch_is_not_read(monkeypatch):
    """The reference's opt-in variable chooses nothing in the port: the
    device of the tensor alone does."""
    img = torch.from_numpy(np.random.default_rng(5).uniform(0, 255, (64, 64, 3)).astype(np.float32))
    outs = []
    for value in ("0", "1"):
        monkeypatch.setenv("IRP_PALLAS_BLEND", value)
        launches = B.blend_kernel.launches
        outs.append(T.tiled_apply(img, lambda t: t, tile=32, overlap=8))
        assert B.blend_kernel.launches == launches  # CPU tensors never launch
    assert torch.equal(outs[0], outs[1])


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper has no CPU path: the plain fold is chosen by
    ``blend_tiles`` only for CPU tensors, never inside the wrapper."""
    launches = B.blend_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        B.blend_kernel(torch.zeros((4, 8, 8, 3)), (12, 12), (0, 4), (0, 4))
    assert B.blend_kernel.launches == launches


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("hw,tile,overlap,scale", GEOMETRIES, ids=IDS)
def test_cuda_kernel_matches_plain_fold(cuda_device, hw, tile, overlap, scale):
    tiles, ys, xs = _case(hw, tile, overlap, scale)
    out_hw = (hw[0] * scale, hw[1] * scale)
    out_ys, out_xs = tuple(y * scale for y in ys), tuple(x * scale for x in xs)
    t = torch.from_numpy(tiles).to(cuda_device)
    launches = B.blend_kernel.launches
    out = B.blend_tiles(t, out_hw, out_ys, out_xs)
    torch.cuda.synchronize()
    assert B.blend_kernel.launches == launches + 1
    ref = T.blend_tiles(t, out_hw, out_ys, out_xs)
    assert float((out - ref).abs().max()) <= ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "grid", "shape", "strided", "origin"])
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take(cuda_device, bad):
    t = torch.zeros((4, 8, 8, 3), device=cuda_device)
    ys = xs = (0, 4)
    tiles, hw, cy, cx, exc = {
        "dtype": (t.half(), (12, 12), ys, xs, TypeError),
        "grid": (t, (12, 12), (0, 4, 8), xs, ValueError),
        "shape": (t[:, :4], (12, 12), ys, xs, ValueError),
        "strided": (t.permute(0, 2, 1, 3), (12, 12), ys, xs, ValueError),
        "origin": (t, (10, 12), ys, xs, ValueError),
    }[bad]
    launches = B.blend_kernel.launches
    with pytest.raises(exc):
        B.blend_kernel(tiles, hw, cy, cx)
    assert B.blend_kernel.launches == launches
