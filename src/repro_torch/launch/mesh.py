"""Production mesh builders (the reference's ``repro/launch/mesh.py``),
as ``torch.distributed`` device meshes.

Single pod: (16, 16) over ("data", "model") — 256 chips.
Multi pod:  (2, 16, 16) over ("pod", "data", "model") — 512 chips; the
"pod" axis is the DCN tier of the DOSC two-tier link model.

A mesh spans the default process group, which must have the mesh's
size.  The reference fakes its 512 devices with
``--xla_force_host_platform_device_count``; the port's counterpart is
:func:`fake_world`: one process, rank 0 of N, on torch's ``fake``
backend, whose collectives complete at once and move no data.  Under
it a mesh of N ranks holds rank 0's shards, on ``meta`` tensors for a
dry-run or on the card for rank 0's real run.

Functions, not module constants: importing this module never touches a
process group.
"""

from __future__ import annotations

import contextlib
import math


def _init_mesh(shape: tuple, axes: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _init_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 4, device_type: str = "cpu"):
    """Small mesh for CPU integration tests (8 ranks)."""
    return _init_mesh((data, model), ("data", "model"), device_type)


def make_mesh(dims: tuple, device_type: str = "cpu"):
    """A mesh of ``dims``: ("data", "model") for two, ("pod", "data",
    "model") for three (the dry-run's ``--mesh-shape``)."""
    axes = ("pod", "data", "model") if len(dims) == 3 else ("data", "model")
    return _init_mesh(tuple(dims), axes, device_type)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a device mesh, or of a duck-typed mesh
    whose ``shape`` is that mapping already (the reference's
    ``mesh.shape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def mesh_chips(mesh) -> int:
    return math.prod(axis_sizes(mesh).values())


def intra_pod_chips(mesh) -> int:
    """Chips per pod = product of non-pod axes."""
    sizes = axis_sizes(mesh)
    return math.prod(n for a, n in sizes.items() if a != "pod")


@contextlib.contextmanager
def fake_world(size: int):
    """A process group of ``size`` ranks in this one process, which is
    rank 0, on the ``fake`` backend (collectives complete at once and
    move no data); destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()
