"""Device ops of the port: stencils, deblock, deblur and the CUDA kernels."""
