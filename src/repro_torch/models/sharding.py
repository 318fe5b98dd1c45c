"""Activation-sharding helpers usable inside model code (the reference's
``repro/models/sharding.py``), over ``torch.distributed`` DTensors.

Model code calls :func:`constrain` with *logical* axes.  Without a mesh
(every one-device path) the call returns its argument itself, so the
same model runs unsharded and keeps its numbers bit for bit; under
:func:`use_mesh` (the counterpart of ``jax.set_mesh``) a DTensor is
redistributed to the placements of the logical spec, as
``with_sharding_constraint`` places an array, but for a dim its axes do
not divide, which stays whole.  A plain tensor is returned as it is
under a mesh too.

A spec is the reference's ``PartitionSpec`` as a tuple, one entry a
tensor dim: ``None``, an axis name, or a tuple of axis names.
:func:`to_placements` turns it into DTensor placements, one a mesh dim.
"""

from __future__ import annotations

import contextlib
import math

import torch

# logical axis names
BATCH = "batch"      # maps to ("pod", "data") when a pod axis exists
MODEL = "model"
NONE = None

#: The meshes of the active :func:`use_mesh` contexts, innermost last.
_MESHES: list = []


def current_mesh():
    return _MESHES[-1] if _MESHES else None


@contextlib.contextmanager
def use_mesh(mesh):
    """Run model code under ``mesh``: :func:`constrain` redistributes,
    and a plain tensor meeting a DTensor in an operation counts as
    replicated (the positions, masks and constants model code makes)."""
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    _MESHES.append(mesh)
    dispatcher._allow_implicit_replication = True
    try:
        yield mesh
    finally:
        _MESHES.pop()
        dispatcher._allow_implicit_replication = before


def _current_axis_names() -> tuple[str, ...]:
    mesh = current_mesh()
    if mesh is None:
        return ()
    return tuple(mesh.mesh_dim_names or ())


def resolve(axis: str | None):
    """Map a logical axis to the current mesh's physical axes."""
    names = _current_axis_names()
    if not names or axis is None:
        return None
    if axis == BATCH:
        batch_axes = tuple(n for n in ("pod", "data") if n in names)
        return batch_axes if batch_axes else None
    return axis if axis in names else None


def to_placements(mesh, spec) -> tuple:
    """DTensor placements, one a mesh dim, of a spec over ``mesh``'s
    axis names: ``Shard(d)`` on each mesh dim that tensor dim ``d``
    names, ``Replicate()`` on the others.  A tensor dim over several
    mesh dims is split in mesh-dim order, as DTensor splits it, so its
    names must come in mesh order (a ``PartitionSpec`` splits in tuple
    order)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: dim {dim} lists {axes} out of "
                             f"the mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]!r} used "
                                 f"twice")
            out[i] = Shard(dim)
    return tuple(out)


def _placements(mesh, logical_axes, shape) -> tuple:
    """The placements of logical axes on ``mesh`` for a tensor of
    ``shape``: a dim the axes' sizes do not divide stays whole, since
    DTensor's views cannot split an uneven shard (the reference's
    compiler pads it)."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    phys = []
    for ax, n in zip(logical_axes, shape):
        ax = resolve(ax)
        axes = ax if isinstance(ax, tuple) else (ax,)
        whole = ax is None or n % math.prod(sizes[a] for a in axes)
        phys.append(None if whole else ax)
    return to_placements(mesh, tuple(phys))


def constrain(x, *logical_axes):
    """``redistribute`` by logical axes; ``x`` itself without a mesh or
    when ``x`` is not a DTensor."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, _placements(
        x.device_mesh, logical_axes, x.shape))


def axis_size(axis: str) -> int:
    """Size of a (logical) mesh axis; 1 if absent/no mesh."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if axis == BATCH:
        return int(math.prod(sizes[n] for n in ("pod", "data")
                             if n in sizes))
    return int(sizes.get(axis, 1))


def local_region(fn, args: tuple, specs: tuple, out_spec: tuple,
                 out_shape: tuple):
    """``fn(*args)`` on local shards under a mesh: each DTensor argument
    placed by its logical spec (one entry a tensor dim, as for
    :func:`constrain`), the result (of ``out_shape``) wrapped by
    ``out_spec``; a dim an axis does not divide stays whole.  A
    replicated argument's gradient is summed over the mesh dims that
    shard the result.  Without DTensor arguments, ``fn(*args)``.  For
    loops that must not run operation by operation on DTensors: the SSM
    scans, a step a time along a sequence that stays whole."""
    from repro_torch.kernels._sharded import is_dtensor, local_call

    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate

    out_p = _placements(mesh, out_spec, out_shape)
    in_p = tuple(_placements(mesh, s, a.shape) if is_dtensor(a) else None
                 for s, a in zip(specs, args))
    grads = tuple(None if p is None else tuple(
        q if q.is_shard() else Partial() if o.is_shard() else Replicate()
        for q, o in zip(p, out_p)) for p in in_p)
    return local_call(fn, args, in_p, out_p, grads)


def pointwise(fn, x):
    """``fn(x)`` for an elementwise ``fn``; a DTensor's on its local
    shards, in its own placements (a partial one made whole first): for
    operations DTensor has no rule for (``logsigmoid``'s backward)."""
    from repro_torch.kernels._sharded import is_dtensor, local_call

    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate

    p = tuple(Replicate() if q.is_partial() else q for q in x.placements)
    return local_call(fn, (x,), (p,), p, (p,))


def take_last(x, idx):
    """``x[..., idx]`` row by row: ``x.gather(-1, idx[..., None])[...,
    0]``.  On a DTensor sharded along its last dim (vocab-sharded
    logits) each shard takes the ids in its own range, zero elsewhere,
    and the shards' sum is the result (a partial over those mesh
    dims)."""
    from repro_torch.kernels._sharded import is_dtensor, local_call

    if not is_dtensor(x):
        return x.gather(-1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate

    mesh, last = x.device_mesh, x.ndim - 1
    xp = tuple(Replicate() if q.is_partial() else q for q in x.placements)
    split = [i for i, q in enumerate(xp) if q.is_shard() and q.dim == last]
    ip = tuple(Replicate() if i in split else q for i, q in enumerate(xp))
    op = tuple(Partial() if i in split else q for i, q in enumerate(ip))
    grad = tuple(q if q.is_shard() else Partial() if o.is_shard()
                 else Replicate() for q, o in zip(xp, op))

    def local(xl, il):
        first = 0
        for i in split:
            first = first * mesh.size(i) + mesh.get_local_rank(i)
        first *= xl.shape[-1]
        mine = (il >= first) & (il < first + xl.shape[-1])
        got = xl.gather(-1, (il - first).clamp(0, xl.shape[-1] - 1)[..., None])
        return torch.where(mine, got[..., 0], 0)

    return local_call(local, (x, idx), (xp, ip), op, (grad, ip))


def unflatten_last(y, sizes: tuple):
    """``y.view(*y.shape[:-1], *sizes)``.  A DTensor sharded along its
    last dim over a mesh dim that does not divide ``sizes[0]`` (a
    projection's heads fewer than, or not a multiple of, the "model"
    axis) is made whole along it first, as a view cannot split it."""
    from repro_torch.kernels._sharded import is_dtensor

    if is_dtensor(y):
        y = _whole_where_split(y, y.ndim - 1, sizes[0])
    return y.view(*y.shape[:-1], *sizes)


def _whole_where_split(g, dim: int, size: int):
    """``g`` made whole along ``dim`` over every mesh dim that shards it
    and does not divide ``size`` (the leading size it splits into)."""
    from torch.distributed.tensor import Replicate

    p = tuple(Replicate() if q.is_shard() and q.dim == dim and size % n
              else q for q, n in zip(g.placements, g.device_mesh.shape))
    return g if p == tuple(g.placements) else g.redistribute(
        g.device_mesh, p)


class _Merge(torch.autograd.Function):
    """A DTensor's dims [start, stop) merged into one; its gradient split
    back with :func:`_whole_where_split` first (a view's backward would
    split a gradient sharded along the merged dim unevenly)."""

    @staticmethod
    def forward(ctx, x, start: int, stop: int):
        ctx.shape, ctx.start = tuple(x.shape), start
        return x.flatten(start, stop - 1)

    @staticmethod
    def backward(ctx, g):
        g = _whole_where_split(g, ctx.start, ctx.shape[ctx.start])
        return g.reshape(ctx.shape), None, None


def merge_dims(x, start: int, stop: int):
    """``x.flatten(start, stop - 1)``; for a DTensor under autograd,
    through :class:`_Merge`."""
    from repro_torch.kernels._sharded import is_dtensor

    if is_dtensor(x) and x.requires_grad and torch.is_grad_enabled():
        return _Merge.apply(x, start, stop)
    return x.flatten(start, stop - 1)
