"""Kernels: CUDA C++ for Hopper beside their plain PyTorch versions."""
