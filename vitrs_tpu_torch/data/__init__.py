"""Data utilities of the PyTorch port."""
