"""Hand-written GPU kernels of the PyTorch port."""
