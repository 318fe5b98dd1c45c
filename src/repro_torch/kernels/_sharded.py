"""The hand-written kernels on sharded tensors.

A kernel takes plain tensors: a data pointer each, or a ``meta``
tensor's shape.  A DTensor (``torch.distributed.tensor``, the port's
counterpart of a sharded ``jax.Array``) reaches a kernel through
:func:`local_call`, which redistributes its arguments to placements the
kernel can compute on a shard alone, runs the kernel on the local
shards (``local_map``) and wraps the results back with their
placements.  Each kernel wrapper refuses a DTensor itself
(:func:`refuse`), so none reaches a plain twin or a data pointer.
"""

from __future__ import annotations

import sys


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (never true before
    ``torch.distributed.tensor`` is imported)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def refuse(name: str, *tensors) -> None:
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{name} takes local tensors, not a DTensor: call "
                        f"the public op, which runs the kernel on each "
                        f"local shard")


def local_call(fn, args: tuple, in_placements: tuple, out_placements,
               grad_placements: tuple | None = None):
    """``fn`` on the local shards of ``args`` redistributed to
    ``in_placements`` (one entry an argument: a placements tuple for a
    DTensor, ``None`` for anything else); its results wrapped as
    a DTensor with ``out_placements``.  ``grad_placements`` are those of
    the arguments' gradients (``Partial`` where a replicated argument's
    gradient is summed over the shards)."""
    from torch.distributed.tensor.experimental import local_map

    # one result's placements as a list: local_map reads a tuple as one
    # placements entry a result
    return local_map(fn, out_placements=list(out_placements),
                     in_placements=in_placements,
                     in_grad_placements=grad_placements,
                     redistribute_inputs=True)(*args)
