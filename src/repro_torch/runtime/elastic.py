"""Elastic scaling: recompute the mesh after losing/gaining workers (the
port's own copy of the reference ``repro.runtime.elastic``).

Policy: the model axis is load-bearing (weights are sharded over it —
changing it requires resharding *math*, not just data placement), so we
keep ``model`` fixed whenever the surviving chip count allows and shrink
``data`` (and then ``pod``).  Checkpoints are stored unsharded, so restore
onto the new mesh places each tensor anew (see
``repro_torch.checkpoint``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    axes: tuple[str, ...]
    shape: tuple[int, ...]
    dropped_chips: int

    @property
    def chips(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def replan_mesh(available_chips: int, model: int = 16,
                pods: int | None = None) -> MeshPlan:
    """Largest usable (pod, data, model) grid within available chips.

    Keeps ``model`` fixed (weight-sharding invariant); maximizes ``data``;
    drops remainder chips (they become hot spares).
    """
    if available_chips < model:
        # degenerate: shrink the model axis to the largest power-of-two
        # divisor that fits (full reshard)
        m = 1
        while m * 2 <= available_chips:
            m *= 2
        return MeshPlan(("data", "model"), (max(available_chips // m, 1),
                                            m),
                        available_chips - max(available_chips // m, 1) * m)
    if pods and pods > 1:
        per_pod = available_chips // pods
        data = per_pod // model
        if data >= 1:
            used = pods * data * model
            return MeshPlan(("pod", "data", "model"), (pods, data, model),
                            available_chips - used)
    data = available_chips // model
    used = data * model
    return MeshPlan(("data", "model"), (data, model),
                    available_chips - used)


def drop_worker(pool, lost_index: int) -> tuple:
    """Surviving ordered worker pool after losing one worker.

    The 1-D (pure data-parallel) specialization of :func:`replan_mesh`
    used by the streaming sweep executor: its shards (one chunk step a
    device entry) form a single ``data`` axis of interchangeable chunk
    workers, so the replan is simply the ordered survivor pool — every
    survivor keeps its role
    and the lost shard's chunk ranges are re-issued from the last
    consistent snapshot.  An out-of-range ``lost_index`` (a worker we
    cannot identify) drops the last worker, so the pool always shrinks.
    """
    pool = list(pool)
    if len(pool) <= 1:
        raise ValueError("cannot drop the last worker; degrade the job "
                         "to single-device execution instead")
    if not 0 <= lost_index < len(pool):
        lost_index = len(pool) - 1
    return tuple(pool[:lost_index] + pool[lost_index + 1:])


def rescale_batch(global_batch: int, old_data: int, new_data: int,
                  keep_global: bool = True) -> int:
    """Either keep the global batch (more grad accumulation per chip) or
    scale it with the data axis (keep per-chip batch)."""
    if keep_global:
        return global_batch
    per = global_batch // old_data
    return per * new_data
