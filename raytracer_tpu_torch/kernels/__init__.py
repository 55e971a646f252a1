"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them."""
