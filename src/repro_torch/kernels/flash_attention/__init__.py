"""Kernel E, flash-attention forward (CUDA C++ for Hopper), and its plain
version."""

from .kernel import flash_attention_fwd, plan  # noqa: F401
from .ref import flash_attention_ref  # noqa: F401
