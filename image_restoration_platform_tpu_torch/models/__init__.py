"""Restoration models of the port (PyTorch modules)."""

from .diffusion import DiffusionConfig
from .registry import ParamCache, get_family, list_families
from .srnet import SRNet, SRNetConfig
from .unet import RestorationUNet, UNetConfig

__all__ = [
    "DiffusionConfig", "ParamCache", "RestorationUNet", "SRNet", "SRNetConfig", "UNetConfig", "get_family",
    "list_families",
]
