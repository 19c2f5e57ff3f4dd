"""PyTorch port: ``ops/resize.py`` against the JAX package's, on the CPU.

``resize_u8`` down- and upscales with every filter of ``_FILTERS``, on a
photo-like image and on uniform noise, at the ratios the serving edge uses
(the upload preprocess fits the longest side into 2048: 3000 x 2000 ->
2048 x 1365 is 1.46x) and at 2x and an upscale. Both sides run the same
host-built sampling matrices in f32 (the reference at ``precision=HIGHEST``);
XLA and PyTorch accumulate the products in other orders, so a value that
lies on a rounding tie may land one level apart. Bar: at most 1 level, and at
least 99.9 % of values exact (measured here: 99.986 % or more; the box filter
at 2.43x on uniform noise, not among these cases, gave 99.81 %)."""

import importlib

import numpy as np
import pytest
import torch

from image_restoration_platform_tpu.train.ood import ood_clean
from image_restoration_platform_tpu_torch.ops import resize as R

JR = importlib.import_module("image_restoration_platform_tpu.ops.resize")

SRC_HW = (150, 192)
OUT_HW = {"down_1.46x": (102, 131), "down_2x": (75, 96), "down_2.5x": (60, 77), "up_1.45x": (217, 280)}


def _inputs():
    photo = np.clip(np.round(ood_clean(np.random.default_rng(3), 1, 192)[0][: SRC_HW[0]] * 255), 0, 255)
    noise = np.random.default_rng(0).integers(0, 256, (*SRC_HW, 3))
    return {"photo": photo.astype(np.uint8), "noise": noise.astype(np.uint8)}


@pytest.mark.parametrize("scale", sorted(OUT_HW))
@pytest.mark.parametrize("method", sorted(JR._FILTERS))
def test_resize_u8_matches_jax(method, scale):
    out_hw = OUT_HW[scale]
    for name, img in _inputs().items():
        ref = np.asarray(JR.resize_u8(img, out_hw, method))
        port = R.resize_u8(img, out_hw, method, device="cpu")
        assert port.dtype == torch.float32 and tuple(port.shape) == (*out_hw, 3)
        diff = np.abs(port.numpy() - ref)
        assert diff.max() <= 1.0, (name, diff.max())
        assert (diff == 0).mean() >= 0.999, (name, (diff == 0).mean())


def test_resize_shapes_and_matrix():
    np.testing.assert_array_equal(R.resize_matrix(97, 40, "lanczos3"), JR.resize_matrix(97, 40, "lanczos3"))
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 255, (2, 20, 24, 3)).astype(np.float32)
    batched = R.resize(x, (10, 30), device="cpu")
    assert tuple(batched.shape) == (2, 10, 30, 3)
    torch.testing.assert_close(R.resize(x[1], (10, 30), device="cpu"), batched[1])
    grey = R.resize(x[0, :, :, 0], (10, 30), device="cpu")
    torch.testing.assert_close(grey, batched[0, :, :, 0])
    assert R.resize(x[0], (20, 24), device="cpu").equal(torch.from_numpy(x[0]))
    with pytest.raises(ValueError):
        R.resize_matrix(10, 5, "nearest")


def test_resize_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.resize_u8(np.zeros((8, 8, 3), np.uint8), (4, 4))
