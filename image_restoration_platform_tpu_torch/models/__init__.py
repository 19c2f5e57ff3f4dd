"""Restoration models of the port (PyTorch modules)."""

from .diffusion import DiffusionConfig
from .registry import ModelFamily, ParamCache, get_family, list_families, register
from .srnet import SRNet, SRNetConfig
from .unet import RestorationUNet, UNetConfig

__all__ = [
    "DiffusionConfig", "ModelFamily", "ParamCache", "RestorationUNet", "SRNet", "SRNetConfig", "UNetConfig",
    "get_family", "list_families", "register",
]
