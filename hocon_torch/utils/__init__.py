"""Utilities: the Flax weight bridge and the CUDA kernel build."""
