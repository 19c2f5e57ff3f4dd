"""PyTorch port: the host codec stage (imageio/), on both of its codecs.

The tests of tests/test_imageio.py, each run on the native library
(csrc/imageio.cpp over libjpeg/libpng/libwebp, where it builds) and on the
Pillow codec that the port takes where it does not (the card's machine has
no libjpeg/libpng/libwebp): round trips, sniffing, the corrupt-input fuzz
corpus, the pixel budget, EXIF orientation and stripping, plus the job
store's result retention. A case skips only where a codec lacks the
feature, and says which."""

import io
import struct
import zlib

import numpy as np
import pytest

from image_restoration_platform_tpu_torch import imageio


@pytest.fixture(params=["native", "pillow"])
def codec(request, monkeypatch):
    if request.param == "native":
        if not imageio.native_available():
            pytest.skip("the native codec did not build on this machine (no libjpeg/libpng/libwebp)")
    else:
        monkeypatch.setattr(imageio, "_load_native", lambda: None)
    assert imageio.codec() == request.param
    return request.param


@pytest.fixture(scope="module")
def rgb():
    rng = np.random.default_rng(42)
    return rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)


def test_jpeg_roundtrip(codec, rgb):
    data = imageio.encode_jpeg(rgb, quality=95)
    assert imageio.sniff_format(data) == "jpeg"
    decoded = imageio.decode_image(data)
    assert decoded.format == "jpeg"
    assert decoded.pixels.shape == rgb.shape
    assert np.abs(decoded.pixels.astype(int) - rgb.astype(int)).mean() < 12


def test_png_roundtrip_lossless(codec, rgb):
    data = imageio.encode_png(rgb)
    assert imageio.sniff_format(data) == "png"
    decoded = imageio.decode_image(data)
    assert np.array_equal(decoded.pixels, rgb)


def test_webp_roundtrip(codec, rgb):
    from PIL import features

    if codec == "pillow" and not features.check("webp"):
        pytest.skip("this Pillow has no WebP support")
    data = imageio.encode_webp(rgb, quality=90)
    assert imageio.sniff_format(data) == "webp"
    decoded = imageio.decode_image(data)
    assert decoded.format == "webp"
    assert decoded.pixels.shape == rgb.shape


def test_webp_without_libwebp_raises(monkeypatch, rgb):
    """No native codec and a Pillow without WebP: a clear error, never
    another format."""
    from PIL import features

    monkeypatch.setattr(imageio, "_load_native", lambda: None)
    monkeypatch.setattr(features, "check", lambda name: name != "webp")
    with pytest.raises(RuntimeError, match="WebP"):
        imageio.encode_webp(rgb)


def test_jpeg_attaches_srgb_icc(codec, rgb):
    if codec == "pillow":
        pytest.skip("the Pillow codec attaches no sRGB ICC profile")
    data = imageio.encode_jpeg(rgb, attach_srgb_icc=True)
    assert b"ICC_PROFILE" in data
    assert imageio.decode_image(data).pixels.shape == rgb.shape


def _jpeg_with_exif(pixels, **tags):
    from PIL import Image

    buf = io.BytesIO()
    im = Image.fromarray(pixels)
    exif = im.getexif()
    for tag, value in tags.items():
        exif[int(tag[1:], 16)] = value
    im.save(buf, "JPEG", quality=95, exif=exif.tobytes())
    return buf.getvalue()


def test_jpeg_strips_exif(codec, rgb):
    data = _jpeg_with_exif(rgb, x0112=6, x0131="secret-software-tag")
    decoded = imageio.decode_image(data)
    assert decoded.orientation == 6
    reencoded = imageio.encode_jpeg(decoded.pixels)
    assert b"Exif" not in reencoded


def test_exif_auto_orient(codec, rgb):
    data = _jpeg_with_exif(rgb, x0112=6)  # rotate 90 CW to display
    decoded = imageio.decode_image(data)
    assert (decoded.height, decoded.width) == (96, 64)
    unoriented = imageio.decode_image(data, auto_orient=False)
    assert (unoriented.height, unoriented.width) == (64, 96)


def test_sniff_rejects_unknown(codec):
    assert imageio.sniff_format(b"GIF89a not supported") is None
    assert imageio.sniff_format(b"\x00" * 32) is None


@pytest.mark.parametrize(
    "corrupt",
    [
        b"",
        b"\xff\xd8\xff",  # jpeg magic, no body
        b"\x89PNG\r\n\x1a\n" + b"\x00" * 16,  # png magic, garbage body
        b"RIFF\x00\x00\x00\x00WEBP" + b"\x00" * 8,
        b"\xff\xd8\xff\xe0" + bytes(range(256)) * 4,  # fuzzed jpeg-ish
    ],
    ids=["empty", "jpeg-magic-only", "png-garbage", "webp-garbage", "jpeg-fuzz"],
)
def test_fuzz_corrupt_inputs_raise(codec, corrupt):
    with pytest.raises(ValueError):
        imageio.decode_image(corrupt)


def test_truncated_jpeg_does_not_crash(codec, rgb):
    data = imageio.encode_jpeg(rgb)
    truncated = data[: len(data) // 2]
    # the codec may error or salvage partial rows: no crash, and any
    # returned pixels have the advertised shape
    try:
        decoded = imageio.decode_image(truncated)
        assert decoded.pixels.shape[2] == 3
    except ValueError:
        pass


def _patched_ihdr(png: bytes, width: int, height: int) -> bytes:
    ihdr_start = png.index(b"IHDR")
    patched = bytearray(png)
    patched[ihdr_start + 4 : ihdr_start + 12] = struct.pack(">II", width, height)
    crc = zlib.crc32(bytes(patched[ihdr_start : ihdr_start + 17]))
    patched[ihdr_start + 17 : ihdr_start + 21] = struct.pack(">I", crc)
    return bytes(patched)


def test_decompression_bomb_rejected(codec, rgb):
    """A small container declaring huge dimensions is rejected before the
    output buffer is allocated."""
    patched = _patched_ihdr(bytes(imageio.encode_png(rgb)), 60000, 60000)
    with pytest.raises(ValueError, match="pixel"):
        imageio.decode_image(patched)


def test_zero_dimension_rejected(codec):
    rng = np.random.default_rng(7)
    png = bytes(imageio.encode_png(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)))
    with pytest.raises(ValueError):
        imageio.decode_image(_patched_ihdr(png, 0, 8))


def test_property_exif_gps_strip_random_orientations(codec):
    """Over random orientations, sizes and metadata payloads, decode applies
    the orientation and re-encode carries no EXIF, GPS or XMP bytes."""
    from PIL import Image
    from PIL.ExifTags import IFD

    rng = np.random.default_rng(1234)
    for _trial in range(24):
        h = int(rng.integers(16, 96))
        w = int(rng.integers(16, 96))
        orientation = int(rng.integers(1, 9))
        pixels = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)

        im = Image.fromarray(pixels)
        exif = im.getexif()
        exif[0x0112] = orientation
        exif[0x010E] = "desc-" + "".join(chr(65 + int(c)) for c in rng.integers(0, 26, 12))
        exif[0x0131] = "secret-software"
        lat = (float(rng.integers(0, 90)), float(rng.integers(0, 60)), 30.0)
        exif[IFD.GPSInfo] = {1: "N", 2: lat, 3: "W"}
        buf = io.BytesIO()
        im.save(buf, "JPEG", quality=95, exif=exif.tobytes())
        original = buf.getvalue()
        assert b"Exif" in original

        decoded = imageio.decode_image(original)
        assert decoded.orientation == orientation
        if orientation >= 5:  # orientations 5-8 transpose the canvas
            assert (decoded.height, decoded.width) == (w, h)
        else:
            assert (decoded.height, decoded.width) == (h, w)

        reencoded = imageio.encode_jpeg(decoded.pixels, quality=85, chroma_444=True)
        assert b"Exif" not in reencoded
        assert b"secret-software" not in reencoded
        assert b"GPS" not in reencoded
        assert b"http://ns.adobe.com/xap" not in reencoded
        redecoded = imageio.decode_image(reencoded)
        assert redecoded.orientation == 1
        assert redecoded.pixels.shape == decoded.pixels.shape


def test_codecs_agree_on_lossless_decode(rgb):
    """A PNG decodes to the same bytes on both codecs, and each codec's
    orientation transform gives the same canvas."""
    if not imageio.native_available():
        pytest.skip("the native codec did not build on this machine")
    png = imageio.encode_png(rgb)
    oriented = _jpeg_with_exif(rgb, x0112=7)
    native = imageio.decode_image(png).pixels, imageio.decode_image(oriented).pixels
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(imageio, "_load_native", lambda: None)
        pillow = imageio.decode_image(png).pixels, imageio.decode_image(oriented).pixels
    assert np.array_equal(native[0], pillow[0])
    assert native[1].shape == pillow[1].shape == (96, 64, 3)
    assert np.abs(native[1].astype(int) - pillow[1].astype(int)).mean() < 2


def test_result_retention_purges_payloads():
    """Finished-job results expire per the retention policy while the
    metadata stays queryable."""
    from image_restoration_platform_tpu_torch.serve.jobs import JobState, JobStore

    now = [1000.0]
    store = JobStore(result_retention_s=100.0, clock=lambda: now[0])
    job = store.create("u", {})
    store.transition(job.id, JobState.RUNNING)
    store.transition(job.id, JobState.SUCCEEDED, result={"restoredImage": "AAAA"})
    assert store.get(job.id).result is not None

    now[0] += 50
    assert store.get(job.id).result is not None  # inside retention
    now[0] += 100
    assert store.purge_expired_results() == 1
    survivor = store.get(job.id)
    assert survivor is not None and survivor.result is None
    assert survivor.state is JobState.SUCCEEDED
    assert "expired" in survivor.error["message"]
