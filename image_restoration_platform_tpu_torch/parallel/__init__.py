"""Meshes of device slots and the data, tensor, spatial and pipe layouts
over them (counterpart of image_restoration_platform_tpu/parallel/)."""

from .halo import conv2d_rowsharded, halo_exchange_rows, spatial_shard_apply, spatial_shard_model_apply
from .mesh import CapturePlan, Mesh, capture_plan, default_mesh, make_mesh, maybe_initialize_distributed, mesh_axes
from .pipeline import pipeline_bubble_fraction, srnet_pipeline_apply, unet_pipeline_apply
from .sharding import gather, replicate, shard_params, split_batch, split_rows

__all__ = [
    "CapturePlan", "Mesh", "capture_plan", "conv2d_rowsharded", "default_mesh", "gather", "halo_exchange_rows", "make_mesh",
    "maybe_initialize_distributed", "mesh_axes", "pipeline_bubble_fraction", "replicate", "shard_params",
    "spatial_shard_apply", "spatial_shard_model_apply", "split_batch", "split_rows", "srnet_pipeline_apply",
    "unet_pipeline_apply",
]
