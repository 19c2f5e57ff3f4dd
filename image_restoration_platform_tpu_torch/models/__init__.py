"""Restoration models of the port (PyTorch modules)."""

from .registry import ParamCache, get_family
from .unet import RestorationUNet, UNetConfig

__all__ = ["ParamCache", "RestorationUNet", "UNetConfig", "get_family"]
