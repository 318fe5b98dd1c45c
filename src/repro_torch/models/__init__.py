"""Runnable networks of the PyTorch port: the hand-tracking CNNs."""
