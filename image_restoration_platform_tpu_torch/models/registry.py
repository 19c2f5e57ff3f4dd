"""Model registry: named families -> configs, and a cache of their weights.

The restore families of image_restoration_platform_tpu/models/registry.py.
The SR and diffusion families are known by name but not ported yet; asking
for one raises ``NotImplementedError`` rather than serving something else.
"""

from __future__ import annotations

import os
import threading
import zlib
from dataclasses import dataclass

import torch

from ..utils.logging import get_logger
from . import weights as weights_mod
from .unet import RestorationUNet, UNetConfig


@dataclass(frozen=True)
class ModelFamily:
    name: str
    config: UNetConfig

    def build(self) -> RestorationUNet:
        return RestorationUNet(self.config)


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
}
NOT_PORTED = ("sr-x2", "sr-x4", "diffusion-restore")


def get_family(name: str) -> ModelFamily:
    if name in NOT_PORTED:
        raise NotImplementedError(f"model family {name} is not ported to PyTorch yet")
    if name not in _FAMILIES:
        raise KeyError(f"unknown model family: {name}; have {sorted(_FAMILIES)}")
    return _FAMILIES[name]


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
