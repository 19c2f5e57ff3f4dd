"""Restoration models of the port (PyTorch modules)."""

from .diffusion import DiffusionConfig
from .hat import HAT, HATConfig
from .registry import ModelFamily, ParamCache, get_family, is_sr_family, list_families, register
from .srnet import SRNet, SRNetConfig
from .swinir import SwinIR, SwinIRConfig
from .unet import RestorationUNet, UNetConfig

__all__ = [
    "DiffusionConfig", "HAT", "HATConfig", "ModelFamily", "ParamCache", "RestorationUNet", "SRNet", "SRNetConfig", "SwinIR", "SwinIRConfig",
    "UNetConfig", "get_family", "is_sr_family", "list_families", "register",
]
