"""Kernels: flash attention (CUDA) and the helper that builds them."""
