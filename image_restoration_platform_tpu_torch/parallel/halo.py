"""Halo exchange for stencils and convolutions on row-sharded images.

Counterpart of image_restoration_platform_tpu/parallel/halo.py. An image is
split by rows over the mesh's ``spatial`` slots; a convolution needs rows
of its neighbours, so before each one the boundary rows are copied between
slots. The reference runs one program per shard inside ``shard_map`` and
moves rows with ``ppermute``; here every function takes the list of all
shards (one tensor per slot, in row order) and copies the rows from slot
to slot, which is the same exchange seen from one controller.

Blocks are NHWC, [N, H_loc, W, C]: the rows are dim 1, and the exchange
and the crops act there, before a convolution permutes to NCHW.

The exchange reads nothing on the host and allocates and copies the same
tensors, of shapes fixed by the blocks', on every call, so a CUDA graph
holds it where every slot is one device (``mesh.capture_plan``); a copy
between distinct devices is the one thing a capture cannot hold.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mesh import AXIS_SPATIAL, Mesh
from .sharding import gather, replicate, split_rows

ROWS = 1  # the row axis of an NHWC block


def halo_exchange_rows(blocks: list[torch.Tensor], halo: int, boundary: str = "edge") -> list[torch.Tensor]:
    """Extend each row block with ``halo`` rows from the previous and the
    next shard, copied onto the block's own slot.

    ``boundary`` fills the outermost shards' missing neighbours: ``edge``
    repeats their own edge rows (clamped-stencil semantics); ``zero`` fills
    zeros, as a SAME convolution pads, so a conv stack run shard-wise equals
    the whole-image one."""
    if boundary not in ("edge", "zero"):
        raise ValueError(f"unknown boundary {boundary!r}")
    if halo == 0:
        return list(blocks)
    if any(b.shape[ROWS] < halo for b in blocks):
        raise ValueError(f"row blocks {[b.shape[ROWS] for b in blocks]} are shorter than the halo {halo}")
    n = len(blocks)
    out = []
    for i, x in enumerate(blocks):
        if i > 0:
            top = blocks[i - 1].narrow(ROWS, blocks[i - 1].shape[ROWS] - halo, halo).to(x.device)
        elif boundary == "zero":
            top = x.new_zeros(x.shape[:ROWS] + (halo,) + x.shape[ROWS + 1:])
        else:
            top = x.narrow(ROWS, 0, 1).expand(*x.shape[:ROWS], halo, *x.shape[ROWS + 1:])
        if i < n - 1:
            bottom = blocks[i + 1].narrow(ROWS, 0, halo).to(x.device)
        elif boundary == "zero":
            bottom = x.new_zeros(x.shape[:ROWS] + (halo,) + x.shape[ROWS + 1:])
        else:
            bottom = x.narrow(ROWS, x.shape[ROWS] - 1, 1).expand(*x.shape[:ROWS], halo, *x.shape[ROWS + 1:])
        out.append(torch.cat([top, x, bottom], dim=ROWS))
    return out


def spatial_shard_apply(fn, mesh: Mesh, halo: int, boundary: str = "edge"):
    """Lift ``fn`` (an extended block [N, H_loc + 2 halo, W, C] -> the
    same rows of output) to a whole [N, H, W, C] image: split its rows over
    the spatial slots, exchange the halo, apply ``fn`` on each slot, crop
    the halo off and gather the rows on the first slot. Stencil semantics:
    compute everywhere, keep the valid centre."""
    slots = mesh.slots(AXIS_SPATIAL)

    def apply(x: torch.Tensor) -> torch.Tensor:
        blocks = halo_exchange_rows(split_rows(x, slots), halo, boundary)
        outs = [fn(b) for b in blocks]
        if halo > 0:
            outs = [o.narrow(ROWS, halo, o.shape[ROWS] - 2 * halo) for o in outs]
        return gather(outs, slots[0], dim=ROWS)

    return apply


def conv2d_rowsharded(layers, blocks: list[torch.Tensor]) -> list[torch.Tensor]:
    """A SAME 3x3 convolution of row blocks: exchange ONE boundary row each
    way (zeros at the true image edges), then convolve each extended block
    VALID in rows and SAME in columns, the bias added after. ``layers`` is
    the layer's copy on each block's slot (``models.nn.Conv``).

    The exchange is per layer: one deep halo of the stack's receptive field
    is not the same function, since every convolution's bias and
    nonlinearity would reach into the rows that SAME zero padding supplies
    at the image edges."""
    out = []
    for layer, ext in zip(layers, halo_exchange_rows(blocks, 1, boundary="zero")):
        w = layer.w.to(ext.dtype)
        y = F.conv2d(ext.permute(0, 3, 1, 2), w, None, 1, (0, w.shape[3] // 2)).permute(0, 2, 3, 1)
        out.append(y + layer.b.to(ext.dtype))
    return out


def spatial_shard_model_apply(local_fn, mesh: Mesh):
    """Lift ``local_fn(models, blocks)`` (a model body whose convolutions
    exchange their own halos through ``conv2d_rowsharded``; ``models`` holds
    the model's copy on each slot) to a whole [N, H, W, C] image split by
    rows over the spatial slots, with the model replicated (``wrapped(model,
    x)``; a list of per-slot copies is taken as it is). Returns the output
    rows gathered on the first slot."""
    slots = mesh.slots(AXIS_SPATIAL)

    def wrapped(model, x: torch.Tensor) -> torch.Tensor:
        models = model if isinstance(model, list) else [replicate(model, d) for d in slots]
        return gather(local_fn(models, split_rows(x, slots)), slots[0], dim=ROWS)

    return wrapped
