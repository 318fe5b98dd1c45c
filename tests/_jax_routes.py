"""Routes of the reference's MoE layers, read from the JAX package in
process, for holding the port's routes to them exactly.

The reference picks each token's experts with ``jax.lax.top_k``
(``repro/models/moe.py``, in ``moe_apply`` and ``moe_ref``) inside
``lax.scan`` and ``jit``; :func:`recorded_top_k` wraps it so that every
call also sends its indices and its k+1 largest values to the host.
:func:`capacity_keep` ranks the picks by a plain loop, an oracle
independent of both packages' cumulative counts.
"""

import contextlib

import jax
import numpy as np


@contextlib.contextmanager
def recorded_top_k():
    """Inside the ``with``, every ``jax.lax.top_k(x, k)`` also appends
    ``(the k+1 largest values, the k indices)`` as numpy arrays to the
    list it yields, in call order (traced calls as they run)."""
    rec, orig = [], jax.lax.top_k

    def top_k(operand, k):
        vals, idx = orig(operand, k)
        more, _ = orig(operand, min(k + 1, operand.shape[-1]))
        jax.debug.callback(
            lambda v, i: rec.append((np.asarray(v), np.asarray(i))),
            more, idx, ordered=True)
        return vals, idx

    jax.lax.top_k = top_k
    try:
        yield rec
        jax.effects_barrier()
    finally:
        jax.lax.top_k = orig


def capacity_keep(top_e: np.ndarray, num_experts: int,
                  cap: int) -> np.ndarray:
    """keep (G, gs, k): whether each pick of ``top_e`` (G, gs, k) ranks
    under ``cap`` among its group's earlier picks of its expert, picks
    taken token by token, then by k."""
    g, gs, k = top_e.shape
    keep = np.zeros(top_e.shape, bool)
    for gi in range(g):
        seen = np.zeros(num_experts, int)
        for t in range(gs):
            for j in range(k):
                e = top_e[gi, t, j]
                keep[gi, t, j] = seen[e] < cap
                seen[e] += 1
    return keep


def min_gap(recs) -> float:
    """The smallest gap between consecutive values among the k+1 largest
    of every recorded call."""
    return min(float(np.min(v[..., :-1] - v[..., 1:])) for v, _ in recs)
