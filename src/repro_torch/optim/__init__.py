"""Optimizers of the PyTorch port (the reference's ``repro.optim``)."""

from . import adamw, compression  # noqa: F401
from .adamw import AdamWConfig, AdamWState  # noqa: F401
from .compression import (Compressed, CompressionConfig,  # noqa: F401
                          compress_leaf, compress_with_feedback,
                          compressed_bytes, decompress_leaf,
                          decompress_tree, init_error_feedback)
