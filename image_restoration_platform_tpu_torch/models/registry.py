"""Model registry: named families -> configs, and a cache of their weights.

The families of image_restoration_platform_tpu/models/registry.py: the two
restore UNets, the two SRNets and the diffusion family, whose model is the
time-conditioned UNet that ``models.diffusion.restore`` samples with; and
two transformers the JAX package does not have, SwinIR-M x2
(models/swinir.py) and HAT x2 (models/hat.py).
What a family is follows from its config's type; ``ModelFamily`` answers
it, and the rest of the port asks it, never a family's name or config type.
"""

from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass

import torch

from ..ops.cuda.attention import launch_plan
from ..utils.logging import get_logger
from . import hat, swinir
from . import weights as weights_mod
from .diffusion import DiffusionConfig
from .hat import HAT, HATConfig
from .nn import takes_attention_kernel
from .srnet import SRNet, SRNetConfig
from .swinir import SwinIR, SwinIRConfig
from .unet import RestorationUNet, UNetConfig


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config: UNetConfig | SRNetConfig | SwinIRConfig | HATConfig | DiffusionConfig

    def build(self) -> torch.nn.Module:
        """The family's module with zero parameters, ready for
        ``load_state_dict``."""
        if isinstance(self.config, SRNetConfig):
            return SRNet(self.config)
        if isinstance(self.config, SwinIRConfig):
            return SwinIR(self.config)
        if isinstance(self.config, HATConfig):
            return HAT(self.config)
        if isinstance(self.config, DiffusionConfig):
            return RestorationUNet(self.config.unet)
        return RestorationUNet(self.config)

    @property
    def kind(self) -> str:
        """``"sr"`` (SRNet, SwinIR, HAT), ``"diffusion"`` (the
        time-conditioned UNet the sampler runs) or ``"restore"`` (a restore
        UNet)."""
        if isinstance(self.config, (SRNetConfig, SwinIRConfig, HATConfig)):
            return "sr"
        return "diffusion" if isinstance(self.config, DiffusionConfig) else "restore"

    @property
    def has_folded_layout(self) -> bool:
        """Whether models/folded.py has a W-folded layout of the family: all
        but the transformers, whose window attention works on the unfolded
        token grid."""
        return not isinstance(self.config, (SwinIRConfig, HATConfig))

    @property
    def row_shards(self) -> bool:
        """Whether a canvas row-shards over spatial slots (parallel/halo.py):
        SRNet only, the halo exchange covering convolutions only."""
        return isinstance(self.config, SRNetConfig)

    @property
    def trainable(self) -> bool:
        """Whether the trainer (train/) has a loss for the family: all but
        the transformers."""
        return not isinstance(self.config, (SwinIRConfig, HATConfig))

    def uses_folded(self, serving) -> bool:
        """Whether an engine of ``serving`` (``config.ServingConfig``) serves
        the family W-folded: it has a folded layout and its kind's flag,
        ``fold_w_sr`` for SR and ``fold_w`` otherwise, is on."""
        return self.has_folded_layout and (serving.fold_w_sr if self.kind == "sr" else serving.fold_w)

    def uses_s2d_io(self, serving) -> bool:
        """Whether an engine of ``serving`` serves the family with
        space-to-depth IO: under ``s2d_io``, an unfolded restore UNet with an
        s2d stem and RGB in and out (the folded layout has its own)."""
        c = self.config
        return (serving.s2d_io and self.kind == "restore" and not self.uses_folded(serving) and c.input_scale > 1
                and c.in_channels == c.out_channels and not c.time_conditioned)

    def attention_shapes(self, sizes, batch: int) -> list[tuple[int, int, int, int]]:
        """The [N, H, T, D] shapes at which the family launches the flash
        attention kernel for square inputs of ``sizes`` in batches of up to
        ``batch``: the UNet bottleneck's tokens at each size up to
        ``max_attn_tokens``, routed as ``Attention`` routes them."""
        cfg = getattr(self.config, "unet", self.config)  # the diffusion family's model
        if not isinstance(cfg, UNetConfig):
            return []
        channels = cfg.base_channels * cfg.channel_mults[-1]
        head_dim = channels // cfg.attn_heads
        shapes = []
        for size in sizes:
            side = -(-size // cfg.input_scale)
            for _ in range(len(cfg.channel_mults) - 1):
                side = -(-side // 2)  # a stride-2 SAME conv
            tokens = side * side
            if tokens <= cfg.max_attn_tokens and takes_attention_kernel(tokens, head_dim):
                shapes.append((batch, cfg.attn_heads, tokens, head_dim))
        return shapes

    def check_kernel_shapes(self, sizes, batch: int, dtype: torch.dtype) -> None:
        """Raise, naming the family and the shape, if a hand-written kernel
        cannot take a shape the family gives it: the flash attention kernel
        one of ``attention_shapes`` (``ops/cuda/attention.py:launch_plan``
        states the limits), SwinIR's kernels its windows, heads and width
        (``models.swinir.check_kernel_shapes``), HAT's those and its overlap
        attention's (``models.hat.check_kernel_shapes``)."""
        if isinstance(self.config, SwinIRConfig):
            swinir.check_kernel_shapes(self.name, self.config)
        if isinstance(self.config, HATConfig):
            hat.check_kernel_shapes(self.name, self.config)
        for shape in self.attention_shapes(sizes, batch):
            try:
                launch_plan(shape, dtype)
            except (ValueError, TypeError) as error:
                raise ValueError(
                    f"model family {self.name!r} gives the attention kernel [N, H, T, D] = {list(shape)}, "
                    f"which it does not take: {error}"
                ) from error


_FAMILIES: dict[str, ModelFamily] = {
    # flagship: space-to-depth stem, soft-shrunk residual
    "restore-unet": ModelFamily("restore-unet", UNetConfig(input_scale=2, residual_shrink=0.01)),
    "restore-unet-small": ModelFamily(
        "restore-unet-small",
        UNetConfig(
            base_channels=32,
            channel_mults=(1, 2),
            blocks_per_level=1,
            attn_heads=2,
            residual_shrink=0.01,
        ),
    ),
    "sr-x2": ModelFamily("sr-x2", SRNetConfig(scale=2)),
    "sr-x4": ModelFamily("sr-x4", SRNetConfig(scale=4)),
    "swinir-m-x2": ModelFamily("swinir-m-x2", SwinIRConfig(scale=2)),
    "hat-x2": ModelFamily("hat-x2", HATConfig(scale=2)),
    "diffusion-restore": ModelFamily("diffusion-restore", DiffusionConfig()),
}


def register(family: ModelFamily) -> None:
    """Add ``family`` to the registry, or replace the family of its name."""
    _FAMILIES[family.name] = family


def get_family(name: str) -> ModelFamily:
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family: {name}; have {sorted(_FAMILIES)}")
    return _FAMILIES[name]


def list_families() -> list[str]:
    return sorted(_FAMILIES)


def is_sr_family(family_name: str) -> bool:
    """Whether ``family_name`` is a super-resolution family (SRNet, SwinIR, HAT)."""
    return get_family(family_name).kind == "sr"


def attention_shapes(family_name: str, sizes, batch: int) -> list[tuple[int, int, int, int]]:
    return get_family(family_name).attention_shapes(sizes, batch)


def check_attention_shapes(family_name: str, sizes, batch: int, dtype: torch.dtype) -> None:
    """``ModelFamily.check_kernel_shapes``: the engine and the trainer call it
    when they load a family on a card, so the refusal comes at load and not
    at the first launch."""
    get_family(family_name).check_kernel_shapes(sizes, batch, dtype)


class ParamCache:
    """Per-process cache of f32 CPU state dicts: the family's
    ``weights/<family>.npz`` when it exists, else random weights from a
    seeded ``torch.Generator``."""

    def __init__(self, seed: int = 0):
        self._params: dict[str, dict[str, torch.Tensor]] = {}
        self._lock = threading.Lock()
        self._seed = seed
        self._log = get_logger("registry")

    def get(self, family_name: str) -> dict[str, torch.Tensor]:
        with self._lock:
            if family_name not in self._params:
                family = get_family(family_name)
                path = weights_mod.weights_path(family_name)
                state = None
                if os.path.exists(path):
                    try:
                        state = weights_mod.load_state_dict(path)
                    except Exception as error:  # noqa: BLE001 - corrupt file: serve init weights
                        self._log.warn(
                            "failed to load weights",
                            {"family": family_name, "path": path, "error": str(error)},
                        )
                if state is None:
                    gen = torch.Generator().manual_seed(self._seed ^ zlib.crc32(family_name.encode()))
                    state = family.build().init_(gen).state_dict()
                self._params[family_name] = state
            return self._params[family_name]

    def put(self, family_name: str, state: dict[str, torch.Tensor]) -> None:
        """Serve ``state`` (a state dict of the family's module) for
        ``family_name`` from now on, in place of its weights file."""
        with self._lock:
            self._params[family_name] = state
