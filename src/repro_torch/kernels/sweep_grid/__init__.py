"""Sweep-grid kernels (CUDA C++ for Hopper) and their plain versions."""

from .kernel import (sweep_grid_chunk, sweep_grid_eval,  # noqa: F401
                     sweep_grid_fold)
from .ops import CudaGridBackend  # noqa: F401  (registers "cuda")
from .ref import (chunk_partials_ref, fold_chunk_ref,  # noqa: F401
                  sweep_grid_eval_ref)
