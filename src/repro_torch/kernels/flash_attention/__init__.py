"""Kernel E, flash-attention forward (CUDA C++ for Hopper), its public
wrapper and its plain version."""

from .kernel import flash_attention_fwd, plan  # noqa: F401
from .ops import flash_attention  # noqa: F401
from .ref import flash_attention_ref  # noqa: F401
