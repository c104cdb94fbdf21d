"""Training loop of the PyTorch port."""
