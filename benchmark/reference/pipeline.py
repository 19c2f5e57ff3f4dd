"""The served upscale, worked out again from the upload's bytes: the upload
preprocess (decode with EXIF orientation, the q85 4:4:4 re-encode), the
decode the restorator makes of that JPEG, the letterbox into the serving
bucket, the configuration's network tiled over the canvas, the crop and the
returned JPEG.

The codec is Pillow, as on a machine without the native one. ``upscale``
returns the pixels of the JPEG a served job would return, so the comparison
reads both sides through one decoder.
"""

from __future__ import annotations

import io

import numpy as np
import torch
from PIL import Image, ImageOps

from .models import Precision, sr_tiled


def decode(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(ImageOps.exif_transpose(im).convert("RGB"), dtype=np.uint8)


def encode_jpeg(pixels: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(pixels)).save(buf, "JPEG", quality=quality, subsampling=0)
    return buf.getvalue()


def preprocessed(upload: bytes, cfg: dict) -> np.ndarray:
    """The pixels the restorator decodes: the upload re-encoded as the
    submission's preprocess does (no resize: the traffic stays inside
    ``max_dimension``)."""
    pixels = decode(upload)
    if max(pixels.shape[:2]) > cfg["serving"]["max_dimension"]:
        raise ValueError("the reference takes uploads inside max_dimension only")
    return decode(encode_jpeg(pixels, cfg["serving"]["upload_jpeg_quality"]))


def letterbox(pixels: np.ndarray, buckets) -> tuple[np.ndarray, int]:
    """Edge-pad into the smallest square bucket that holds the image."""
    h, w = pixels.shape[:2]
    fitting = [b for b in sorted(buckets) if max(h, w) <= b]
    if not fitting:
        raise ValueError("the reference takes uploads that fit a bucket without a resize")
    b = fitting[0]
    return np.pad(pixels, ((0, b - h), (0, b - w), (0, 0)), mode="edge"), b


def upscale(upload: bytes, cfg: dict, network, params: dict, device, prec: Precision = Precision()) -> np.ndarray:
    """The returned JPEG's pixels [h*s, w*s, 3] u8 of a tiled upscale by
    ``network`` (a reference module's ``network``)."""
    pixels = preprocessed(upload, cfg)
    h, w = pixels.shape[:2]
    buckets = set(cfg["serving"]["size_buckets"]) | {cfg["arch"]["tiled_canvas"]}
    canvas, bucket = letterbox(pixels, buckets)
    if bucket <= cfg["arch"]["direct_max"]:
        raise ValueError("the reference serves the tiled path only")
    s = cfg["arch"]["scale"]
    out = sr_tiled(network, params, cfg["arch"], torch.from_numpy(canvas).to(device), prec)
    out_u8 = torch.round(torch.clamp(out, 0.0, 255.0)).to(torch.uint8)[: h * s, : w * s]
    return decode(encode_jpeg(out_u8.cpu().numpy(), cfg["serving"]["sr_jpeg_quality"]))
