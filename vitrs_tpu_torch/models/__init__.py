"""Model forwards and generation of the PyTorch port."""
