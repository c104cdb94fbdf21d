"""Parallel training steps of the PyTorch port (one device so far)."""
