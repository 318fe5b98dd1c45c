"""Sweep-grid kernels (CUDA C++ for Hopper) and their plain versions."""

from .kernel import sweep_grid_chunk, sweep_grid_eval  # noqa: F401
from .ops import CudaGridBackend  # noqa: F401  (registers "cuda")
from .ref import chunk_partials_ref, sweep_grid_eval_ref  # noqa: F401
