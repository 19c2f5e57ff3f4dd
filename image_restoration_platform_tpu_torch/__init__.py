"""PyTorch/CUDA port of image_restoration_platform_tpu (see README, "PyTorch/CUDA port")."""
