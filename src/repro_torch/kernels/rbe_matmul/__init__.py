"""RBE int8 matmul kernel (CUDA C++ for Hopper) and its plain versions."""

from .kernel import quantize_rowwise, rbe_matmul_raw  # noqa: F401
from .ops import rbe_matmul  # noqa: F401
from .ref import dequant_matmul_ref, rbe_matmul_ref  # noqa: F401
