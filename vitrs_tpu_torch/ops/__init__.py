"""Kernels and tensor ops of the PyTorch port."""
