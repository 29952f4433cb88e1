"""Attention ops of the port: ``flash`` (CUDA kernel + plain version),
``attention`` (routing), ``_build`` (nvcc at first use)."""
