"""imageio — host-side image codec stage (C++ over libjpeg/libpng/libwebp).

The port's own copy of image_restoration_platform_tpu/imageio: decode,
magic-byte sniffing, EXIF auto-orient, JPEG q85 4:4:4 encode with sRGB ICC
attach and EXIF strip, raw YCbCr 4:2:0 JPEG encode, Lanczos resize, and the
raw 16-bit PNG decode of the HDR pre-pass (``decode_image_u16``, native codec
only), and PNG and WebP encode. Decoding lands in numpy arrays that the engine copies to the device.

The C++ source (csrc/imageio.cpp) is compiled at first use into
``build/imageio/`` at the repository root (listed in ``.gitignore``) and
loaded via ctypes; if the native build is unavailable (no compiler or no
codec headers) the module degrades to a Pillow-backed fallback with the same
semantics. ``codec()`` says which one a process got.
"""

from __future__ import annotations

import ctypes
import io
import os
import subprocess
import threading
from dataclasses import dataclass

import numpy as np

from ..utils.logging import get_logger

_log = get_logger("imageio")

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "build", "imageio")
_SO = os.path.join(_BUILD_DIR, "libirpimageio.so")

_FORMATS = {1: "jpeg", 2: "png", 3: "webp"}
ACCEPTED_MIMES = {"image/jpeg": "jpeg", "image/png": "png", "image/webp": "webp"}
FORMAT_TO_MIME = {"jpeg": "image/jpeg", "png": "image/png", "webp": "image/webp"}

_lib = None
_lib_lock = threading.Lock()
_native_failed = False


def _build_native() -> bool:
    # build to a per-process name, then rename: concurrent processes never
    # load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["make", "-s", "-B", "-C", _CSRC, f"OUT={tmp}"],
            check=True,
            capture_output=True,
            timeout=180,
        )
        os.replace(tmp, _SO)
        return True
    except Exception as error:  # pragma: no cover - toolchain issues
        _log.warn_once("build", "native imageio build failed; using Pillow fallback", {"error": str(error)})
        return False


def _load_native():
    global _lib, _native_failed
    if _lib is not None or _native_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _native_failed:
            return _lib
        if not os.path.exists(_SO) and not _build_native():
            _native_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
            lib.irp_sniff.restype = ctypes.c_int
            lib.irp_sniff.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.irp_decode_info.restype = ctypes.c_int
            lib.irp_decode_info.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ]
            lib.irp_decode.restype = ctypes.c_int
            lib.irp_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int,
            ]
            lib.irp_encode_jpeg.restype = ctypes.c_int
            lib.irp_encode_jpeg.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.irp_encode_jpeg_raw420.restype = ctypes.c_int
            lib.irp_encode_jpeg_raw420.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.irp_encode_png.restype = ctypes.c_int
            lib.irp_encode_png.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.irp_encode_webp.restype = ctypes.c_int
            lib.irp_encode_webp.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.POINTER(ctypes.c_size_t),
            ]
            lib.irp_free.restype = None
            lib.irp_free.argtypes = [ctypes.c_void_p]
            lib.irp_png_bit_depth.restype = ctypes.c_int
            lib.irp_png_bit_depth.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            lib.irp_decode_png16.restype = ctypes.c_int
            lib.irp_decode_png16.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int,
            ]
            lib.irp_resize_rgb8.restype = ctypes.c_int
            lib.irp_resize_rgb8.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ]
            _lib = lib
        except OSError as error:  # pragma: no cover
            _log.warn_once("load", "native imageio load failed; using Pillow fallback", {"error": str(error)})
            _native_failed = True
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def codec() -> str:
    """'native' (libjpeg/libpng/libwebp via csrc/imageio.cpp) or 'pillow'."""
    return "native" if native_available() else "pillow"


@dataclass
class DecodedImage:
    pixels: np.ndarray  # [H, W, 3] uint8, orientation already applied
    format: str         # 'jpeg' | 'png' | 'webp'
    width: int          # post-orientation width
    height: int
    orientation: int    # original EXIF orientation tag (1..8)


def sniff_format(data: bytes) -> str | None:
    """Magic-byte container sniff (uploadValidation.js:87-115 equivalent)."""
    lib = _load_native()
    if lib is not None:
        return _FORMATS.get(lib.irp_sniff(data, len(data)))
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if len(data) >= 12 and data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    return None


def _apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF auto-orient (imagePreprocess.js:42 '.rotate()' equivalent)."""
    if orientation == 2:
        return img[:, ::-1]
    if orientation == 3:
        return img[::-1, ::-1]
    if orientation == 4:
        return img[::-1, :]
    if orientation == 5:
        return np.rot90(img, k=-1)[:, ::-1]
    if orientation == 6:
        return np.rot90(img, k=-1)
    if orientation == 7:
        return np.rot90(img, k=1)[:, ::-1]
    if orientation == 8:
        return np.rot90(img, k=1)
    return img


# Decompression-bomb guard: a <10 MB container can declare arbitrarily large
# dimensions (the header drives the output allocation, not the payload). The
# reference's sharp/libvips enforces an input pixel limit the same way.
MAX_INPUT_PIXELS = int(os.environ.get("IMAGEIO_MAX_INPUT_PIXELS", 64 * 1024 * 1024))


def _check_pixel_budget(width: int, height: int) -> None:
    if width <= 0 or height <= 0 or width * height > MAX_INPUT_PIXELS:
        raise ValueError(
            f"image dimensions {width}x{height} exceed the {MAX_INPUT_PIXELS}-pixel input limit"
        )


def decode_image(data: bytes, auto_orient: bool = True) -> DecodedImage:
    """Decode JPEG/PNG/WebP bytes to an RGB8 array, applying EXIF orientation."""
    lib = _load_native()
    if lib is not None:
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        orient = ctypes.c_int()
        fmt_code = lib.irp_decode_info(
            data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), ctypes.byref(orient)
        )
        if fmt_code <= 0:
            raise ValueError("unsupported or corrupt image data")
        _check_pixel_budget(w.value, h.value)
        out = np.empty((h.value, w.value, 3), dtype=np.uint8)
        rc = lib.irp_decode(data, len(data), out.ctypes.data_as(ctypes.c_void_p), w.value, h.value)
        if rc != 0:
            raise ValueError(f"image decode failed (code {rc})")
        orientation = orient.value if auto_orient else 1
        if orientation != 1:
            out = np.ascontiguousarray(_apply_orientation(out, orientation))
        return DecodedImage(
            pixels=out,
            format=_FORMATS[fmt_code],
            width=out.shape[1],
            height=out.shape[0],
            orientation=orient.value,
        )
    return _decode_pillow(data, auto_orient)


def decode_bit_depth(data: bytes) -> int:
    """Source sample bit depth of an image byte stream (8 or 16).

    JPEG and WebP are always 8; PNG carries its depth in the IHDR. Used by
    the serving edge to route 16-bit PNGs through the high-bit-depth
    deconvolution pre-pass (ops/deblur.py disk channel) before the standard
    8-bit pipeline."""
    fmt = sniff_format(data)
    if fmt is None:
        raise ValueError("unsupported or corrupt image data")
    if fmt != "png":
        return 8
    lib = _load_native()
    if lib is not None:
        depth = lib.irp_png_bit_depth(data, len(data))
        if depth <= 0:
            raise ValueError("corrupt PNG header")
        return depth
    return int(data[24]) if len(data) > 24 else 8  # IHDR bit-depth byte


def decode_image_u16(data: bytes) -> np.ndarray:
    """Decode a PNG to host-endian RGB16 [H, W, 3] uint16 RAW code values.

    8-bit sources are promoted v*257 (exact u8 round trip); 16-bit sources
    keep full precision — the point of this entry: a defocus disk's spectral
    ring nulls sit below the 8-bit quantization floor, so the deblur disk
    channel needs these samples. No EXIF orientation is applied (PNG has no
    EXIF in our encode path; orientation-bearing formats are 8-bit here).
    """
    lib = _load_native()
    if lib is None:
        raise RuntimeError("16-bit decode requires the native imageio codec")
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    orient = ctypes.c_int()
    fmt_code = lib.irp_decode_info(
        data, len(data), ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), ctypes.byref(orient)
    )
    if fmt_code != 2:  # IRP_FMT_PNG
        raise ValueError("decode_image_u16 accepts PNG only")
    _check_pixel_budget(w.value, h.value)
    out = np.empty((h.value, w.value, 3), dtype=np.uint16)
    rc = lib.irp_decode_png16(data, len(data), out.ctypes.data_as(ctypes.c_void_p), w.value, h.value)
    if rc != 0:
        raise ValueError(f"16-bit PNG decode failed (code {rc})")
    return out


def _decode_pillow(data: bytes, auto_orient: bool) -> DecodedImage:
    from PIL import Image, ImageOps

    fmt = sniff_format(data)
    if fmt is None:
        raise ValueError("unsupported or corrupt image data")
    # Pillow reports corrupt, truncated and oversized inputs as OSError,
    # SyntaxError or DecompressionBombError: all are ValueError here, as the
    # native codec raises them
    try:
        with Image.open(io.BytesIO(data)) as im:
            _check_pixel_budget(im.width, im.height)
            orientation = 1
            try:
                orientation = int(im.getexif().get(0x0112, 1))
            except Exception:
                pass
            if auto_orient:
                im = ImageOps.exif_transpose(im)
            arr = np.asarray(im.convert("RGB"), dtype=np.uint8)
    except Image.DecompressionBombError as error:
        raise ValueError(f"image dimensions exceed the {MAX_INPUT_PIXELS}-pixel input limit: {error}") from error
    except (OSError, SyntaxError) as error:
        raise ValueError(f"unsupported or corrupt image data: {error}") from error
    return DecodedImage(arr, fmt, arr.shape[1], arr.shape[0], orientation)


def resize_rgb8(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """Host-side Lanczos3 resize of an [H, W, 3] uint8 array (C++ stage).

    Used for arbitrary-shape work at the serving edge (preprocess downscale,
    final upscale to the caller's native size).
    """
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    out_h, out_w = out_hw
    if (h, w) == (out_h, out_w):
        return img
    lib = _load_native()
    if lib is not None:
        out = np.empty((out_h, out_w, 3), dtype=np.uint8)
        rc = lib.irp_resize_rgb8(
            img.ctypes.data_as(ctypes.c_void_p), w, h,
            out.ctypes.data_as(ctypes.c_void_p), out_w, out_h,
        )
        if rc != 0:
            raise ValueError(f"resize failed (code {rc})")
        return out
    from PIL import Image  # pragma: no cover

    return np.asarray(
        Image.fromarray(img).resize((out_w, out_h), Image.LANCZOS), dtype=np.uint8
    )


def encode_jpeg(
    img: np.ndarray,
    quality: int = 85,
    chroma_444: bool = True,
    attach_srgb_icc: bool = True,
) -> bytes:
    """JPEG encode with the reference preprocess policy: q85, 4:4:4 chroma,
    EXIF stripped, sRGB ICC attached (imagePreprocess.js:57-64)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    lib = _load_native()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.irp_encode_jpeg(
            img.ctypes.data_as(ctypes.c_void_p), w, h, int(quality),
            1 if chroma_444 else 0, 1 if attach_srgb_icc else 0,
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc != 0:
            raise ValueError(f"jpeg encode failed (code {rc})")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            lib.irp_free(out)
    from PIL import Image  # pragma: no cover

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=quality, subsampling=0 if chroma_444 else 2)
    return buf.getvalue()


def encode_jpeg_ycbcr420(
    y: np.ndarray,
    cb: np.ndarray,
    cr: np.ndarray,
    quality: int = 90,
    attach_srgb_icc: bool = True,
) -> bytes | None:
    """JPEG encode from pre-subsampled full-range BT.601 YCbCr 4:2:0 planes
    (libjpeg raw-data path, no host colorspace conversion).

    This is the egress half of the device-side planarization: the tiled-SR
    program emits Y [H,W] + Cb/Cr [(H+1)/2,(W+1)/2] u8 planes, so the
    device->host transfer is 1.5 B/px instead of 3 B/px RGB — the transfer
    dominates the 2K->4K wall time (BASELINE config 3). Returns None when the
    native codec is unavailable (callers fall back to the RGB path)."""
    y = np.ascontiguousarray(y, dtype=np.uint8)
    cb = np.ascontiguousarray(cb, dtype=np.uint8)
    cr = np.ascontiguousarray(cr, dtype=np.uint8)
    h, w = y.shape
    assert cb.shape == cr.shape == ((h + 1) // 2, (w + 1) // 2), (y.shape, cb.shape)
    lib = _load_native()
    if lib is None:  # pragma: no cover - native is the product path
        return None
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_size_t()
    rc = lib.irp_encode_jpeg_raw420(
        y.ctypes.data_as(ctypes.c_void_p),
        cb.ctypes.data_as(ctypes.c_void_p),
        cr.ctypes.data_as(ctypes.c_void_p),
        w, h, int(quality), 1 if attach_srgb_icc else 0,
        ctypes.byref(out), ctypes.byref(out_len),
    )
    if rc != 0:
        raise ValueError(f"jpeg raw420 encode failed (code {rc})")
    try:
        return ctypes.string_at(out, out_len.value)
    finally:
        lib.irp_free(out)


def encode_png(img: np.ndarray) -> bytes:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    lib = _load_native()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.irp_encode_png(
            img.ctypes.data_as(ctypes.c_void_p), w, h, ctypes.byref(out), ctypes.byref(out_len)
        )
        if rc != 0:
            raise ValueError(f"png encode failed (code {rc})")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            lib.irp_free(out)
    from PIL import Image  # pragma: no cover

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return buf.getvalue()


def encode_webp(img: np.ndarray, quality: float = 85.0) -> bytes:
    """Lossy WebP encode (libwebp natively, else Pillow's WebP plugin; a
    Pillow built without WebP raises rather than write another format)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    lib = _load_native()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_uint8)()
        out_len = ctypes.c_size_t()
        rc = lib.irp_encode_webp(
            img.ctypes.data_as(ctypes.c_void_p), w, h, ctypes.c_float(quality),
            ctypes.byref(out), ctypes.byref(out_len),
        )
        if rc != 0:
            raise ValueError(f"webp encode failed (code {rc})")
        try:
            return ctypes.string_at(out, out_len.value)
        finally:
            lib.irp_free(out)
    from PIL import Image, features

    if not features.check("webp"):
        raise RuntimeError("WebP encode needs libwebp: the native codec did not build and Pillow has no WebP support")
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", quality=int(quality))
    return buf.getvalue()
