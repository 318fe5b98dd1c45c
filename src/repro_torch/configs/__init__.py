"""Architecture configs of the port: copies of the reference's
``repro/configs`` arch modules and registry (data only).  The LM slice
runs the dense GQA ones (gemma2-2b, qwen2-0.5b, phi4-mini,
codeqwen1.5-7b); the others are here so that ``--arch`` resolves every
id the reference knows."""

from .registry import ARCH_IDS, BUILDERS, get_config, get_reduced_config  # noqa: F401
