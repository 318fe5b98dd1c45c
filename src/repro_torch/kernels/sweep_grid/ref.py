"""Plain PyTorch versions of the sweep-grid kernels.

Not a re-implementation: each is the port's shared plain expression of
:mod:`repro_torch.core.backend` (decode + :func:`repro_torch.core.sweep.
config_eval` + :func:`~repro_torch.core.backend.chunk_partials`), i.e.
exactly what the ``"torch"`` backend runs.  The wrappers of
:mod:`.kernel` take these on CPU tensors; on the card they are the
reference each kernel is held against.
"""

from __future__ import annotations

from repro_torch.core import backend as B


def chunk_partials_ref(spec, T, axvals, aux, start: int) -> dict:
    """Block partials of one chunk (the plain version of kernel A)."""
    return B.plain_chunk(spec, T, axvals, aux, start)


def sweep_grid_eval_ref(T, shape, fields, axvals, flat) -> dict:
    """Channel values at flat grid indices (the plain version of
    kernel B)."""
    return B.plain_dense(T, tuple(shape), tuple(fields), axvals, flat)
