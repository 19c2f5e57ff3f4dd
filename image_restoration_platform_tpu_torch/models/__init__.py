"""Restoration models of the port (PyTorch modules)."""

from .diffusion import DiffusionConfig
from .registry import ModelFamily, ParamCache, get_family, is_sr_family, list_families, register
from .srnet import SRNet, SRNetConfig
from .swinir import SwinIR, SwinIRConfig
from .unet import RestorationUNet, UNetConfig

__all__ = [
    "DiffusionConfig", "ModelFamily", "ParamCache", "RestorationUNet", "SRNet", "SRNetConfig", "SwinIR", "SwinIRConfig",
    "UNetConfig", "get_family", "is_sr_family", "list_families", "register",
]
