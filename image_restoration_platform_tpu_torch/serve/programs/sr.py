"""Tiled and row-sharded super-resolution programs.

Counterpart of image_restoration_platform_tpu/serve/programs/sr.py:

- ``build_sr_tiled_program``: tile extraction, batched SRNet calls over tile
  chunks and the windowed fold all run on the device, with no host round
  trip between tiles. The residual limiter runs per tile, inside the model,
  as in the reference;
- ``build_sr_tiled_mesh_program``: the same with the tile axis split over
  the mesh's data slots; the tiles come back to the first slot, where the
  blend kernel runs once;
- ``build_sr_spatial_program``: ONE canvas split by rows over the spatial
  slots, every convolution exchanging a one-row halo; the limiter runs once
  on the gathered canvas.

Each is a ``Program`` of one segment (serve/programs/segments.py), so the
engine's executable tier captures it whole where its slots are one device.

The SR routes' sizes are defined here and nowhere else: the restorator sends
a canvas above ``DIRECT_MAX`` to the tiled program (or the row-sharded one)
and adds the ``TILED_CANVAS`` bucket, ``warmup_serving`` warms both routes,
and ``engine.sr_tiled`` tiles at ``TILE`` with ``OVERLAP`` in chunks of
``TILE_BATCH`` by default. They equal the benchmark configurations'
``direct_max``, ``tiled_canvas``, ``tile``, ``overlap`` and ``tile_batch``:
a graph of other sizes would be built inside a timed window.
"""

from __future__ import annotations

import torch

from ...models import get_family, srnet
from ...ops.tile import tile_grid, tile_image, tiled_apply
from ...parallel.halo import spatial_shard_model_apply
from ...parallel.mesh import AXIS_SPATIAL
from ...parallel.sharding import gather, split_batch
from .egress import to_yuv420
from .restore import PLANES, check_layout
from .segments import Piece, Program

DIRECT_MAX = 512  # the largest bucket the family's network takes whole
TILED_CANVAS = 2048  # the 2K -> 4K bucket
TILE, OVERLAP, TILE_BATCH = 256, 32, 8


def _emit(out: torch.Tensor, output: str):
    """The f32 [H, W, 3] canvas as RGB u8, or its (Y, Cb, Cr) u8 planes."""
    if output == "yuv420":
        return tuple(p[0] for p in to_yuv420(out[None]))
    return torch.round(torch.clamp(out, 0.0, 255.0)).to(torch.uint8)


def build_sr_tiled_program(
    family_name: str, *, dtype: torch.dtype, tile: int, overlap: int, tile_batch: int, output: str,
    use_folded: bool = False,
):
    """``fn(model, canvas [H,W,3] u8)`` -> the RGB u8 canvas at
    ``[H*scale, W*scale, 3]``, or with ``output="yuv420"`` its (Y, Cb, Cr)
    u8 planes: one segment, the blend kernel's launch inside it.
    ``use_folded``: the model is the W-folded SRNet (models/folded.py)."""
    if output not in ("rgb", "yuv420"):
        raise ValueError(f"unknown output {output!r}")
    scale = get_family(family_name).config.scale

    def pieces(model, shapes):
        check_layout(model, use_folded)

        def per_tiles(tiles):
            # the limiter's f32 output goes straight to the 255 scaling
            return model(tiles.to(dtype) / 255.0).float() * 255.0

        def run(s):
            out = tiled_apply(
                s["canvas"].float(), per_tiles, tile=tile, overlap=overlap, scale=scale, tile_batch=tile_batch,
            )
            emitted = _emit(out, output)
            return dict(zip(PLANES, emitted)) if output == "yuv420" else {"out": emitted}

        return [Piece(run)]

    return Program(("canvas",), pieces, PLANES if output == "yuv420" else ("out",))


def build_sr_tiled_mesh_program(
    family_name: str, *, dtype: torch.dtype, slots: list, tile: int, overlap: int, tile_batch: int, output: str,
    use_folded: bool = False,
) -> Program:
    """``fn(models, canvas [H,W,3] u8)``, ``models`` the network on each of
    the data ``slots`` and the canvas on the first: the tiles are cut on the
    first slot and taken in chunks of ``tile_batch`` x the data size (the
    last filled by repeating the last tile), each chunk split evenly over
    the slots; the restored tiles are gathered on the first slot and blended
    there in one launch. Each slot sees chunks of ``tile_batch`` tiles, as
    the single-device program does, so the output is the same. One
    segment; the padding and the chunks are fixed from the canvas shape
    when the segments are made, so a capture holds them. ``use_folded``:
    the models are the W-folded SRNet (models/folded.py)."""
    from ...ops.cuda.blend import blend_tiles

    if output not in ("rgb", "yuv420"):
        raise ValueError(f"unknown output {output!r}")
    scale = get_family(family_name).config.scale
    dp = len(slots)
    mesh_chunk = tile_batch * dp

    def pieces(models, shapes):
        check_layout(models, use_folded)
        h, w, _ = shapes[0]
        stride = tile - overlap
        n = len(tile_grid(h, tile, stride)) * len(tile_grid(w, tile, stride))
        pad = (-n) % mesh_chunk if n > mesh_chunk else (-n) % dp
        step = min(mesh_chunk, n + pad)

        def run(s):
            tiles, ys, xs = tile_image(s["canvas"].float(), tile, overlap)
            if pad:
                tiles = torch.cat([tiles, tiles[-1:].expand(pad, -1, -1, -1)], dim=0)
            chunks = []
            for i in range(0, n + pad, step):
                shards = split_batch(tiles[i : i + step], slots)
                outs = [m(t.to(dtype) / 255.0).float() * 255.0 for m, t in zip(models, shards)]
                chunks.append(gather(outs, slots[0]))
            out_tiles = torch.cat(chunks, dim=0)[:n].contiguous()
            out = blend_tiles(
                out_tiles, (h * scale, w * scale), tuple(y * scale for y in ys), tuple(x * scale for x in xs)
            )
            emitted = _emit(out, output)
            return dict(zip(PLANES, emitted)) if output == "yuv420" else {"out": emitted}

        return [Piece(run)]

    return Program(("canvas",), pieces, PLANES if output == "yuv420" else ("out",))


def build_sr_spatial_program(family_name: str, *, dtype: torch.dtype, mesh):
    """(``fn(models, canvas [H,W,3] u8)``, receptive halo, scale, spatial
    size): ``models`` the network on each spatial slot, H a multiple of the
    spatial size. Row blocks run ``srnet.apply_rowsharded`` (the unlimited
    network, a halo row exchanged at every convolution), the canvas is
    gathered on the first slot, and ``residual_limit`` runs on it whole:
    the limiter is local in (input, output), so the result is the
    single-device forward's up to convolution round-off. (The reference
    feeds its limiter here the f32 input, which its single-device forward
    never sees in bf16; this program feeds the input in the compute type.)
    ``fn`` is a ``Program`` of one segment."""
    cfg = get_family(family_name).config

    def local_fn(models, blocks):
        outs = srnet.apply_rowsharded(models, [b.to(dtype) / 255.0 for b in blocks])
        return [o.float() * 255.0 for o in outs]

    sharded_apply = spatial_shard_model_apply(local_fn, mesh)

    def pieces(models, shapes):
        def run(s):
            canvas_f = s["canvas"].float()[None]
            out = sharded_apply(models, canvas_f)
            if cfg.limit_pool > 0:
                # the limiter reads the input as the network did, in the
                # compute type, as the single-device forward's limiter does
                out = srnet.residual_limit(canvas_f.to(dtype) / 255.0, out / 255.0, cfg) * 255.0
            return {"out": _emit(out[0], "rgb")}

        return [Piece(run)]

    program = Program(("canvas",), pieces, ("out",))
    return program, srnet.receptive_halo(cfg), cfg.scale, mesh.shape[AXIS_SPATIAL]
