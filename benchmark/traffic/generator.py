"""The one generator of the benchmark's traffic: seeded uploads and arrival
schedules from a mix's parameter file (``benchmark/traffic/<mix>.json``).

A mix names a pool of uploads (how many, the longest side's range, the
aspects, the share in portrait, the degradations with their shares and
parameters, the upload's JPEG quality) and a closed loop of ``clients``,
each sending its next job when the last returns. Every seed draws the same
set of sizes and degradation parameters, each spread evenly over its range
and dealt out in the seed's order; only the picture content and the order
change with the seed, so two seeds give the same work.

Uploads are synthetic photographs: a smooth two-colour field, soft-edged
shapes and fine texture, then the mix's degradation, saved as JPEG with
Pillow.
"""

from __future__ import annotations

import io
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
from PIL import Image

@dataclass(frozen=True)
class Upload:
    index: int
    filename: str
    data: bytes
    height: int
    width: int
    kind: str


def _spread(lo: float, hi: float, n: int) -> np.ndarray:
    """n values spread evenly over [lo, hi] (the midpoints of n equal bins)."""
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def _counts(shares: list[float], n: int) -> list[int]:
    """Whole counts of ``n`` in the given shares (largest remainders)."""
    raw = np.asarray(shares, np.float64) / sum(shares) * n
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts))[: n - counts.sum()]:
        counts[i] += 1
    return counts.tolist()


def _photo(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A synthetic photograph [h, w, 3] f32 in byte range."""
    sh, sw = max(8, h // 4), max(8, w // 4)
    yy, xx = np.mgrid[0:sh, 0:sw].astype(np.float32)
    yy /= sh
    xx /= sw
    c0, c1 = rng.uniform(30, 225, 3), rng.uniform(30, 225, 3)
    t = np.clip(0.5 + 0.6 * ((xx - 0.5) * np.cos(rng.uniform(0, 6.28)) + (yy - 0.5) * np.sin(rng.uniform(0, 6.28))),
                0, 1)
    img = c0 * (1 - t[..., None]) + c1 * t[..., None]
    for _ in range(3):
        fy, fx, ph = rng.uniform(1, 4), rng.uniform(1, 4), rng.uniform(0, 6.28)
        img += rng.uniform(8, 25) * np.sin(6.28 * (fy * yy + fx * xx) + ph)[..., None] * rng.uniform(0.5, 1, 3)
    for _ in range(int(rng.integers(10, 22))):
        cy, cx = rng.uniform(0, 1, 2)
        ry, rx = rng.uniform(0.03, 0.25, 2)
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        if rng.random() < 0.5:
            d = np.maximum(np.abs(yy - cy) / ry, np.abs(xx - cx) / rx) ** 2
        alpha = np.clip((1.0 - d) * 6.0, 0, 1)[..., None] * rng.uniform(0.6, 1.0)
        img = img * (1 - alpha) + rng.uniform(0, 255, 3) * alpha
    small = Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))
    big = np.asarray(small.resize((w, h), Image.NEAREST), dtype=np.float32)
    # fine texture: sinusoids of 0.04-0.3 cycles a pixel in all directions,
    # each an outer product (sin(a + b) = sin a cos b + cos a sin b)
    ys, xs = np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32)
    tex = np.zeros((h, w), np.float32)
    for _ in range(6):
        f, a, ph = rng.uniform(0.04, 0.3), rng.uniform(0, np.pi), rng.uniform(0, 6.28)
        u, v = 6.2832 * f * np.cos(a) * xs, 6.2832 * f * np.sin(a) * ys + ph
        tex += np.outer(np.cos(v), np.sin(u)) + np.outer(np.sin(v), np.cos(u))
    big += (28.0 / np.sqrt(6.0)) * tex[..., None]
    return big + rng.normal(0.0, 6.0, big.shape).astype(np.float32)


def _convolve(img: np.ndarray, psf: np.ndarray) -> np.ndarray:
    """Circular-free convolution of [h, w, 3] with a small PSF by FFT over an
    edge-padded frame."""
    r = psf.shape[0] // 2
    padded = np.pad(img, ((r, r), (r, r), (0, 0)), mode="edge")
    ph, pw = padded.shape[:2]
    kernel = np.zeros((ph, pw), np.float32)
    kernel[: psf.shape[0], : psf.shape[1]] = psf
    kernel = np.roll(kernel, (-r, -r), axis=(0, 1))
    spec = np.fft.rfft2(padded, axes=(0, 1)) * np.fft.rfft2(kernel)[..., None]
    return np.fft.irfft2(spec, s=(ph, pw), axes=(0, 1))[r : r + img.shape[0], r : r + img.shape[1]]


def _blur_psf(kind: str, size: float, angle: float) -> np.ndarray:
    k = int(np.ceil(size)) | 1
    r = k // 2
    yy, xx = np.mgrid[-r : r + 1, -r : r + 1].astype(np.float32)
    if kind == "motion":
        t = xx * np.cos(angle) + yy * np.sin(angle)
        perp = -xx * np.sin(angle) + yy * np.cos(angle)
        psf = np.clip(1.0 - np.abs(perp), 0, 1) * (np.abs(t) <= size / 2)
    else:
        psf = np.clip(size / 2 + 0.5 - np.sqrt(yy**2 + xx**2), 0, 1)
    return (psf / psf.sum()).astype(np.float32)


def _jpeg(pixels: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", quality=int(quality))
    return buf.getvalue()


def _render(spec: dict) -> bytes:
    """The upload's bytes for one drawn spec."""
    rng = np.random.default_rng(spec["seed"])
    img = _photo(rng, spec["height"], spec["width"])
    deg = spec["degradation"]
    kind = deg["kind"]
    if kind in ("motion", "defocus"):
        img = _convolve(img, _blur_psf(kind, deg["size"], deg["angle"]))
    if kind == "fade":
        gray = img.mean(axis=-1, keepdims=True)
        img = gray + (img - gray) * (1.0 - deg["fade"])
        img = 128.0 + (img - 128.0) * (1.0 - 0.6 * deg["fade"]) + np.asarray(deg["cast"], np.float32)
    if deg.get("noise", 0.0) > 0:
        img = img + rng.normal(0.0, deg["noise"], img.shape).astype(np.float32)
    return _jpeg(np.clip(np.round(img), 0, 255).astype(np.uint8), deg["quality"])


def draw_specs(mix: dict, seed: int) -> list[dict]:
    """The pool's specs for ``seed``: one fixed set of (size, aspect,
    orientation, degradation) for the mix, its parameters spread evenly over
    their ranges and paired the same way for every seed; the seed picks the
    pictures' content and the order of the pool."""
    n = int(mix["pool"])
    lo, hi = mix["longest"]
    longest = np.round(_spread(lo, hi, n)).astype(int)
    aspects = [tuple(a) for a in mix["aspects"]]
    share = float(mix.get("portrait_share", 0.0))
    kinds: list[dict] = []
    for deg, count in zip(mix["degradations"], _counts([d["share"] for d in mix["degradations"]], n)):
        kinds += [dict(deg, _rank=i, _count=count) for i in range(count)]
    # a fixed pairing of degradations with sizes, the same for every seed
    kinds = [kinds[i] for i in np.random.default_rng(0).permutation(n)]
    base = []
    for i in range(n):
        a, b = aspects[i % len(aspects)]
        long_side, short_side = int(longest[i]), int(round(longest[i] * min(a, b) / max(a, b)))
        portrait = int((i + 1) * share) > int(i * share)
        deg = kinds[i]
        frac = (deg["_rank"] + 0.5) / deg["_count"]  # this spec's place in its kind's sets

        def at(key):
            lo_, hi_ = deg[key]
            return lo_ + (hi_ - lo_) * frac

        d = {"kind": deg["kind"], "quality": int(round(at("quality")))}
        if "size" in deg:
            d["size"] = float(at("size"))
            d["angle"] = float(np.pi * ((deg["_rank"] * 0.618034) % 1.0))
        if "noise" in deg:
            d["noise"] = float(at("noise"))
        if deg["kind"] == "fade":
            d["fade"] = float(at("fade"))
            d["cast"] = [float(v) for v in np.asarray(deg["cast"]) * np.cos(2.0 * np.pi * frac + np.arange(3))]
        base.append({"height": long_side if portrait else short_side,
                     "width": short_side if portrait else long_side, "degradation": d})
    rng = np.random.default_rng(seed)
    return [dict(base[j], index=i, seed=int(rng.integers(0, 2**63 - 1))) for i, j in enumerate(rng.permutation(n))]


def make_pool(mix: dict, seed: int, workers: int = 4) -> list[Upload]:
    """The mix's pool of uploads for ``seed``, rendered in ``workers``
    threads (NumPy's FFT and Pillow's codec release the interpreter lock)."""
    specs = draw_specs(mix, seed)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        datas = list(pool.map(_render, specs))
    return [Upload(s["index"], f"upload{s['index']}.jpg", d, s["height"], s["width"], s["degradation"]["kind"])
            for s, d in zip(specs, datas)]


def client_orders(n_uploads: int, clients: int, length: int, seed: int) -> list[list[int]]:
    """For each closed-loop client, the pool indices it sends in turn: each
    client walks its own seeded permutations of the pool."""
    rng = np.random.default_rng([seed, 1])
    orders = []
    for _ in range(clients):
        seq: list[int] = []
        while len(seq) < length:
            seq += rng.permutation(n_uploads).tolist()
        orders.append(seq[:length])
    return orders
