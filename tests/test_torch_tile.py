"""PyTorch port: tiling and the overlap blend against the JAX package.

``tile_grid``, ``_hann_window`` and ``tile_image`` are exact copies, so they
are held to equality. The port's plain ``blend_tiles`` is held against the
reference's XLA fold and against the Pallas kernel run in interpret mode, at
the reference's own bar of atol 1e-3 on a 0..255 range (f32 sums of at most
a few windowed tiles; measured 0 against the XLA fold and 1.5e-5 against the
Pallas kernel). On the CPU ``ops.cuda.blend.blend_tiles``
takes the plain fold; the CUDA kernel is held against it on the card by the
``cuda``-marked tests below and by chip_smoke.py. What surrounds the kernel
is tested here: the wrapper's choice of the vector or the scalar variant,
and a plain emulation of the kernel's per-block contributor lists, which must
give the plain fold bit for bit."""

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


# ------------------------------------------- the kernel's variants and its lists

# the variant kernel_variant must choose for GEOMETRIES, in order: with C = 3
# every length is a multiple of 4 unless an origin or the width is odd
VARIANT_OF = ["vector", "vector", "vector", "vector", "vector", "vector"]
# (canvas, tile, overlap, scale) -> variant, beyond GEOMETRIES
MORE_VARIANTS = [
    (((2048, 2048), 256, 32, 2), "vector"),  # the 2K -> 4K grid of the SR path
    (((1024, 1024), 256, 32, 2), "vector"),  # clamped last tile at 768
    (((99, 67), 32, 8, 1), "scalar"),  # row length 201, clamped origin 35
    (((100, 66), 32, 8, 1), "scalar"),  # row length 198
    (((100, 70), 32, 8, 1), "scalar"),  # clamped origin 38: 114 floats in
]


@pytest.mark.parametrize("geometry,variant", list(zip(GEOMETRIES, VARIANT_OF)) + MORE_VARIANTS)
def test_kernel_variant_follows_the_alignment_rule(geometry, variant):
    hw, tile, overlap, scale = geometry
    xs = T.tile_grid(hw[1], tile, tile - overlap)
    t, out_w, out_xs = tile * scale, hw[1] * scale, tuple(x * scale for x in xs)
    got = B.kernel_variant(t, 3, out_w, out_xs)
    lengths = [out_w * 3, t * 3] + [x * 3 for x in out_xs]
    assert got == variant == ("vector" if all(v % 4 == 0 for v in lengths) else "scalar")
    assert B.VARIANTS[got] == (4 if got == "vector" else 1)


def test_kernel_variant_with_one_channel():
    assert B.kernel_variant(32, 1, 96, (0, 24, 48, 64)) == "vector"
    assert B.kernel_variant(32, 1, 96, (0, 24, 48, 62)) == "scalar"  # origin 62
    assert B.kernel_variant(30, 1, 96, (0, 24)) == "scalar"  # tile rows of 30 floats


BLOCK_ROWS, BLOCK_THREADS = 8, 256  # csrc/blend_tiles.cu: kRows, kThreads


def _blocked_blend(tiles, out_hw, ys, xs, vec):
    """The kernel's walk in numpy f32: a block owns 8 canvas rows by a span of
    256 * vec floats of the flattened [H, W*C] canvas, lists once the tile
    columns that touch its span and, per row, the tile rows that cover it
    (both ascending), and every float adds its contributors in that order.
    Also returns the longest lists met."""
    n, t, _, c = tiles.shape
    out_h, out_w = out_hw
    row_len, tile_len, span_len = out_w * c, t * c, BLOCK_THREADS * vec
    window = T._hann_window(t)
    flat = tiles.reshape(len(ys), len(xs), t, tile_len)
    out = np.zeros((out_h, row_len), np.float32)
    longest = [0, 0]
    for y0 in range(0, out_h, BLOCK_ROWS):
        for j0 in range(0, row_len, span_len):
            j1 = min(j0 + span_len, row_len)
            cols = [cx for cx in range(len(xs)) if xs[cx] * c < j1 and (xs[cx] + t) * c > j0]
            j = np.arange(j0, j1)
            for y in range(y0, min(y0 + BLOCK_ROWS, out_h)):
                rows = [r for r in range(len(ys)) if ys[r] <= y < ys[r] + t]
                longest = [max(longest[0], len(rows)), max(longest[1], len(cols))]
                acc = np.zeros(j1 - j0, np.float32)
                wsum = np.zeros(j1 - j0, np.float32)
                for r in rows:
                    ty = y - ys[r]
                    for cx in cols:
                        jt = j - xs[cx] * c
                        inside = (jt >= 0) & (jt < tile_len)
                        w = window[ty, j[inside] // c - xs[cx]]
                        acc[inside] = acc[inside] + flat[r, cx, ty, jt[inside]] * w
                        wsum[inside] = wsum[inside] + w
                out[y, j0:j1] = acc / np.maximum(wsum, np.float32(1e-8))
    return out.reshape(out_h, out_w, c), longest


@pytest.mark.parametrize("vec", [4, 1], ids=["vector", "scalar"])
@pytest.mark.parametrize("hw,tile,overlap,scale", GEOMETRIES + [((99, 67), 32, 8, 1), ((1024, 1024), 256, 32, 1)],
                         ids=IDS + ["odd", "1024-clamped"])
def test_contributor_lists_give_the_plain_fold(hw, tile, overlap, scale, vec):
    """Rows and columns found once per block, walked in ascending order, are
    the brute-force fold bit for bit, also with clamped last tiles (1024 with
    stride 224 ends 672, 768) and with overlap > T/2, where the lists grow
    longer than two."""
    tiles, ys, xs = _case(hw, tile, overlap, scale)
    out_hw = (hw[0] * scale, hw[1] * scale)
    out_ys, out_xs = tuple(y * scale for y in ys), tuple(x * scale for x in xs)
    got, longest = _blocked_blend(tiles, out_hw, out_ys, out_xs, vec)
    ref = T.blend_tiles(torch.from_numpy(tiles), out_hw, out_ys, out_xs).numpy()
    np.testing.assert_array_equal(got, ref)
    # brute force: the most tiles over any one pixel, by rows and by columns
    t = tile * scale
    cover_y = max(sum(y0 <= y < y0 + t for y0 in out_ys) for y in range(out_hw[0]))
    cover_x = max(sum(x0 <= x < x0 + t for x0 in out_xs) for x in range(out_hw[1]))
    assert longest[0] == cover_y and longest[1] >= cover_x
    if (hw, tile, overlap) == ((64, 56), 32, 24):
        assert cover_y == 4 and cover_x == 4
    if hw == (1024, 1024):
        assert out_ys[-2:] == (672, 768) and cover_y == 2  # the clamped tile overlaps its neighbour by 160 rows


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["chosen", "scalar"])
@pytest.mark.parametrize("hw,tile,overlap,scale", GEOMETRIES + [((99, 67), 32, 8, 1), ((1024, 1024), 256, 32, 2)],
                         ids=IDS + ["odd", "1024-clamped-scale2"])
def test_cuda_kernel_variants_equal_the_plain_fold(cuda_device, hw, tile, overlap, scale, variant):
    """Both variants repeat the plain fold's f32 arithmetic: the error is 0."""
    tiles, ys, xs = _case(hw, tile, overlap, scale)
    out_hw = (hw[0] * scale, hw[1] * scale)
    out_ys, out_xs = tuple(y * scale for y in ys), tuple(x * scale for x in xs)
    t = torch.from_numpy(tiles).to(cuda_device)
    if variant == "chosen":
        variant = B.kernel_variant(tile * scale, 3, out_hw[1], out_xs)
    by_variant = dict(B.blend_kernel.launches_by_variant)
    out = B.blend_kernel(t, out_hw, out_ys, out_xs, variant=variant)
    torch.cuda.synchronize()
    assert B.blend_kernel.launches_by_variant[variant] == by_variant[variant] + 1
    assert torch.equal(out, T.blend_tiles(t, out_hw, out_ys, out_xs))


@pytest.mark.cuda
def test_cuda_wrapper_refuses_the_vector_variant_on_odd_geometry(cuda_device):
    tiles, ys, xs = _case((99, 67), 32, 8, 1)
    launches = B.blend_kernel.launches
    with pytest.raises(ValueError):
        B.blend_kernel(torch.from_numpy(tiles).to(cuda_device), (99, 67), ys, xs, variant="vector")
    assert B.blend_kernel.launches == launches


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
