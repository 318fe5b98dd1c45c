"""Registry integration: the ``"cuda"`` evaluation backend.

Importing this module (or ``backend.get_backend("cuda")``, which imports
it lazily) registers :class:`CudaGridBackend`: the chunk step runs
kernel A and dense evaluation (the dense engine, the stream probe and
the survivor-overflow fallback) runs kernel B.
"""

from __future__ import annotations

from repro_torch.core import backend as B

from . import kernel


class CudaGridBackend(B.EvalBackend):
    """The chunk contract on the hand-written Hopper kernels of
    :mod:`.kernel` (their wrappers take the plain version only for
    tensors on the CPU)."""

    name = "cuda"

    def build_chunk_eval(self, spec, device):
        T = B.device_tables(spec.S, device)
        return lambda axvals, aux, start: kernel.sweep_grid_chunk(
            spec, T, axvals, aux, start)

    def build_dense_eval(self, S, shape, fields, device):
        T = B.device_tables(S, device)
        shape, fields = tuple(shape), tuple(fields)
        return lambda axvals, flat: kernel.sweep_grid_eval(
            T, shape, fields, axvals, flat)


B.register_backend(CudaGridBackend())
