"""Optimizers of the PyTorch port (the reference's ``repro.optim``)."""

from . import adamw  # noqa: F401
from .adamw import AdamWConfig, AdamWState  # noqa: F401
