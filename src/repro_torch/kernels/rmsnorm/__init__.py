"""Kernel D, RMSNorm (CUDA C++ for Hopper), and its plain version."""

from .kernel import plan, rmsnorm_fused  # noqa: F401
from .ops import rmsnorm  # noqa: F401
from .ref import rmsnorm_ref  # noqa: F401
