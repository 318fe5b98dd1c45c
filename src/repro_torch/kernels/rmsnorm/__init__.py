"""Kernel D, RMSNorm (CUDA C++ for Hopper), its plain version and its
autograd Function."""

from .kernel import plan, rmsnorm_fused  # noqa: F401
from .ops import RMSNormFunction, rmsnorm  # noqa: F401
from .ref import rmsnorm_bwd, rmsnorm_ref  # noqa: F401
