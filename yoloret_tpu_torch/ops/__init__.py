"""Tensor ops of the serving path and the wrappers of its CUDA kernels."""
