"""Plain float32 references of the language models that a configuration
of kind ``lm`` names (``"reference": "<module>"``): one module each,
with ``logits`` (the full forward without a cache) and ``token_flops``
(the frozen work of one token).  They import nothing of the program."""

import importlib


def module(name: str):
    """The reference module ``portbench.reference.lm.<name>``."""
    return importlib.import_module(f"{__name__}.{name}")
