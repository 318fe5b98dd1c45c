"""Work credit for the hand-written kernels while a program is counted.

A count of a torch program (``repro_torch.core.hlo_cost.analyze_program``)
sees the aten operations the program dispatches.  A kernel launched
through ``ctypes`` dispatches none: the count would see its output's
allocation and nothing of its work.  So each kernel wrapper, where it
launches its kernel, reports the launch here; while a count is active
its sink credits the kernel with the work of the kernel's plain twin
at the same arguments (the function the kernel computes, as torch ops)
and with the kernel's own bytes.  With no count active, :func:`active`
is false and a wrapper does nothing more.
"""

from __future__ import annotations

from typing import Callable

#: The active counts' sinks, innermost last.
_SINKS: list[Callable] = []


def active() -> bool:
    return bool(_SINKS)


def credit(name: str, twin: Callable, args: tuple, kwargs: dict,
           inputs: tuple, outputs: tuple) -> None:
    """Report one launch of kernel ``name``: its work is that of
    ``twin(*args, **kwargs)``; it read ``inputs`` once and wrote
    ``outputs`` once (tensors, or ``None`` for an output not made)."""
    for sink in _SINKS:
        sink(name, twin, args, kwargs, inputs, outputs)
