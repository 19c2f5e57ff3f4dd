"""Sharding policies: how parameters and activations lay out on the mesh.

Counterpart of image_restoration_platform_tpu/parallel/sharding.py. The
reference states layouts and lets GSPMD insert the collectives; here the
layouts are explicit modules and copies:

- activations [N, H, W, C]: N over ``data`` (``split_batch``), rows over
  ``spatial`` (``split_rows``), C whole on every slot;
- conv and dense layers: output channels over ``tensor`` when there are at
  least 64 of them and the tensor size divides them (the reference's
  ``_leaf_spec``). Its out axis is the last of a JAX kernel; here it is dim 0
  of ``Conv.w`` (OIHW) and dim 1 of ``Dense.w`` ([in, out]), with the bias
  split alike. ``shard_params`` swaps such layers for column-parallel ones:
  each slot computes its slice of the output channels and the slices are
  gathered back on the layer's first slot, so GroupNorm and attention see
  whole activations, as under GSPMD;
- everything else (GroupNorm, small layers, the W-fold's phase kernels) is
  replicated. A W-folded model's output channels come in interleaved pairs
  (2c, 2c+1: models/folded.py), so its layers split only where each slot
  gets whole pairs.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from ..models import nn as L
from .mesh import AXIS_TENSOR, Mesh

# the reference's threshold: narrower layers stay whole
MIN_SHARDED_OUT = 64


def replicate(module: nn.Module, device: torch.device) -> nn.Module:
    """``module`` on ``device``: itself when it is already there (slots that
    repeat a device share one copy), else a copy moved there."""
    first = next(module.parameters(), None)
    if first is None or first.device == torch.device(device):
        return module
    return copy.deepcopy(module).to(device)


def split_batch(x: torch.Tensor, devices: list) -> list[torch.Tensor]:
    """Equal batch shards of ``x``, one on each slot (the data axis)."""
    if x.shape[0] % len(devices):
        raise ValueError(f"batch {x.shape[0]} not divisible by {len(devices)} data slots")
    return [part.to(d) for part, d in zip(x.chunk(len(devices), dim=0), devices)]


def split_rows(x: torch.Tensor, devices: list) -> list[torch.Tensor]:
    """Equal row blocks of an NHWC ``x`` (dim 1), one on each slot (the
    spatial axis)."""
    if x.shape[1] % len(devices):
        raise ValueError(f"{x.shape[1]} rows not divisible by {len(devices)} spatial slots")
    return [part.to(d) for part, d in zip(x.chunk(len(devices), dim=1), devices)]


def gather(parts: list[torch.Tensor], device: torch.device, dim: int = 0,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """The shards joined on one slot; with ``out`` (on that slot, of the
    joined shape) copied into it in place, so a caller that gathers every
    step keeps one buffer."""
    if out is None:
        return torch.cat([p.to(device) for p in parts], dim=dim)
    for p, chunk in zip(parts, out.split([p.shape[dim] for p in parts], dim=dim)):
        chunk.copy_(p)
    return out


class _ColumnParallel(nn.Module):
    """A layer whose output channels are split over tensor slots: ``w[j]``
    and ``b[j]`` live on ``devices[j]``; the output is gathered on
    ``devices[0]``."""

    out_dim = 0

    def __init__(self, layer: nn.Module, devices: list):
        super().__init__()
        self.devices = list(devices)
        n = len(self.devices)
        self.w = nn.ParameterList(
            nn.Parameter(c.detach().clone().to(d), requires_grad=layer.w.requires_grad)
            for c, d in zip(layer.w.chunk(n, self.out_dim), self.devices)
        )
        self.b = nn.ParameterList(
            nn.Parameter(c.detach().clone().to(d), requires_grad=layer.b.requires_grad)
            for c, d in zip(layer.b.chunk(n, 0), self.devices)
        )

    def _gather(self, fn) -> torch.Tensor:
        parts = [fn(w, b, d) for w, b, d in zip(self.w, self.b, self.devices)]
        return gather(parts, self.devices[0], dim=-1)


class ShardedConv(_ColumnParallel):
    out_dim = 0  # OIHW

    def forward(self, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
        return self._gather(lambda w, b, d: L.conv2d(x.to(d), w, b, stride))

    def cat(self, parts: list[torch.Tensor], stride: int = 1, bias: bool = True) -> torch.Tensor:
        return self._gather(lambda w, b, d: L.conv2d_cat([p.to(d) for p in parts], w, b if bias else None, stride))

    def full_bias(self) -> torch.Tensor:
        return gather(list(self.b), self.devices[0])

    def part(self, x: torch.Tensor, start: int) -> torch.Tensor:
        """``L.Conv.part`` over the slots: each its output channels."""
        parts = [L._conv_nchw(x.to(d), w[:, start:], 1) for w, d in zip(self.w, self.devices)]
        return gather(parts, self.devices[0], dim=-1)

    def add_bias(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.full_bias().to(x.dtype)


class ShardedDense(_ColumnParallel):
    out_dim = 1  # [in, out]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._gather(lambda w, b, d: L.dense(x.to(d), w, b))


class ShardedFilm(ShardedDense):
    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        return L.film_modulate(x, self.gamma_beta(cond, x.dtype))

    def gamma_beta(self, cond: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return ShardedDense.forward(self, cond.to(dtype))


def _sharded_type(module: nn.Module, tensor_size: int, unit: int = 1):
    """The column-parallel counterpart of ``module``, or None where the
    reference's ``_leaf_spec`` keeps the leaf replicated or a slot would not
    get whole groups of ``unit`` output channels."""
    if isinstance(module, L.Conv):
        kind, out = ShardedConv, module.w.shape[0]
    elif isinstance(module, L.Film):
        kind, out = ShardedFilm, module.w.shape[1]
    elif isinstance(module, L.Dense):
        kind, out = ShardedDense, module.w.shape[1]
    else:
        return None
    return kind if out >= MIN_SHARDED_OUT and out % (tensor_size * unit) == 0 else None


def shard_params(model: nn.Module, mesh: Mesh, data_index: int = 0) -> nn.Module:
    """``model`` laid out over the tensor slots of one data row: a copy
    whose eligible conv and dense layers are column-parallel over those
    slots, everything else on the row's first slot (a W-folded model's
    layers only where each slot gets whole channel pairs). A tensor axis of
    1 is the model on that slot (a no-op layout, as in the reference)."""
    slots = mesh.tensor_slots(data_index)
    if mesh.shape[AXIS_TENSOR] == 1:
        return replicate(model, slots[0])
    out = copy.deepcopy(model).to(slots[0])
    unit = 2 if getattr(model, "folded", False) else 1
    for name, module in list(out.named_modules()):
        kind = _sharded_type(module, len(slots), unit)
        if kind is None:
            continue
        parent_name, _, child = name.rpartition(".")
        setattr(out.get_submodule(parent_name) if parent_name else out, child, kind(module, slots))
    return out


def _slices(module: nn.Module, prefix: str = ""):
    """(name in the unsharded state dict, the tensors holding it, the dim
    they split it on or None) for every parameter of ``module``."""
    if isinstance(module, _ColumnParallel):
        yield f"{prefix}w", list(module.w), module.out_dim
        yield f"{prefix}b", list(module.b), 0
        return
    for name, p in module.named_parameters(recurse=False):
        yield f"{prefix}{name}", [p], None
    for name, child in module.named_children():
        yield from _slices(child, f"{prefix}{name}.")


def gather_state(module: nn.Module, device: torch.device) -> dict[str, torch.Tensor]:
    """The unsharded parameters of a (possibly column-parallel) module,
    joined on ``device`` under the unsharded module's names."""
    out = {}
    for name, parts, dim in _slices(module):
        out[name] = parts[0].detach().to(device) if dim is None else gather(parts, device, dim).detach()
    return out


def _chunks(full: torch.Tensor, parts: list, dim: int | None) -> list[torch.Tensor]:
    """The views of an unsharded tensor that a module's slices hold."""
    return [full] if dim is None else list(full.chunk(len(parts), dim))


def accumulate_grads_(module: nn.Module, into: dict[str, torch.Tensor]) -> None:
    """Add a (possibly column-parallel) module's gradients into ``into``,
    preallocated unsharded tensors under the unsharded module's names,
    slice by slice in place. Every parameter must hold a gradient."""
    with torch.no_grad():
        for name, parts, dim in _slices(module):
            for p, chunk in zip(parts, _chunks(into[name], parts, dim)):
                chunk.add_(p.grad.to(chunk.device))


def scatter_state_(module: nn.Module, state: dict[str, torch.Tensor]) -> None:
    """Copy unsharded tensors into a (possibly column-parallel) module's
    parameters, slice by slice, in place (a CUDA graph that holds the
    parameters stays valid)."""
    with torch.no_grad():
        for name, parts, dim in _slices(module):
            for p, chunk in zip(parts, _chunks(state[name], parts, dim)):
                p.copy_(chunk)
