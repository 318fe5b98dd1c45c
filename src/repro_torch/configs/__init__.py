"""Architecture configs and input shapes of the port: copies of the
reference's ``repro/configs`` arch modules, registry and shapes (data
only).  Every arch id the reference knows resolves here and runs in the
port's LM (dense and MoE GQA, MLA, the SSM stacks, the modality stubs);
:mod:`.shapes` gives the four assigned input shapes and which (arch x
shape) cells run."""

from .registry import ARCH_IDS, BUILDERS, get_config, get_reduced_config  # noqa: F401
from .shapes import SHAPES, InputShape, cell_is_runnable  # noqa: F401
