"""Registry integration: the ``"cuda"`` evaluation backend.

Importing this module (or ``backend.get_backend("cuda")``, which imports
it lazily) registers :class:`CudaGridBackend`: the chunk step runs
kernel A and folds each chunk with kernel F (``fold_chunk``'s torch ops
for a spec kernel F does not serve, :func:`.kernel.fold_runs`, chosen
when the step is built), and dense evaluation (the dense engine, the
stream probe and the survivor-overflow fallback) runs kernel B.  No
kernel runs the session loop of a scenario sweep, so the backend
refuses scenario stacks
(``supports_scenarios = False``, as the reference's Pallas backend does);
``backend=None`` sends those to ``"torch"`` on the same device.  It
refuses several shards too (``supports_multi_device = False``, the
reference Pallas backend's ``supports_pmap = False``): an automatic
device list shrinks to one card for it, an explicit one raises.
"""

from __future__ import annotations

from repro_torch.core import backend as B
from repro_torch.core.spans import count

from . import kernel


class CudaGridBackend(B.EvalBackend):
    """The chunk contract on the hand-written Hopper kernels of
    :mod:`.kernel` (their wrappers take the plain version only for
    tensors on the CPU)."""

    name = "cuda"
    supports_multi_device = False
    supports_scenarios = False

    def build_chunk_eval(self, spec, device):
        T = B.device_tables(spec.S, device)
        return lambda axvals, aux, start, base=None: kernel.sweep_grid_chunk(
            spec, T, axvals, aux, start, base)

    def build_chunk_fold(self, spec, device):
        if not kernel.fold_runs(spec):
            return super().build_chunk_fold(spec, device)

        def fold(carry, aux, base, partials_at, scan):
            out = kernel.survivor_rows(spec, scan, device)
            for j in range(scan):
                off = j * spec.chunk
                kernel.sweep_grid_fold(spec, carry, partials_at(off), aux,
                                       off, base, out, j)
            return out
        return fold

    def graph_replayed(self, spec, chunks):
        kernel.sweep_grid_chunk.launches += chunks
        if kernel.fold_runs(spec):
            kernel.sweep_grid_fold.launches += chunks
            count("fold_kernel_chunks", chunks)

    def build_dense_eval(self, S, shape, fields, device):
        T = B.device_tables(S, device)
        shape, fields = tuple(shape), tuple(fields)
        return lambda axvals, flat: kernel.sweep_grid_eval(
            T, shape, fields, axvals, flat)


B.register_backend(CudaGridBackend())
