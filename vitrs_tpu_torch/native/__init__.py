"""Host-side native components of the PyTorch port (C++ built by g++)."""
