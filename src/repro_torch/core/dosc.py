"""DOSC partition advisor — the paper's technique as a framework feature
(the port of the reference package's ``core/dosc.py``; the chip is an
argument, ``TPU_V5E`` by default, :data:`.constants.H100_SXM` for the
port's card, on which the cheap tier is NVLink and the expensive one the
inter-node fabric).

The paper's decision problem: *given a two-tier communication hierarchy
(cheap local tier, expensive global tier), where do you place compute and
what do you send across the expensive tier?*  On an AR/VR headset that is
on-sensor-vs-aggregator; on a multi-pod TPU machine it is ICI-vs-DCN.

The advisor evaluates candidate distribution plans for a training step using
the adapted semi-analytical model (:mod:`.tpu_energy`) and picks
the minimum-energy (or minimum-time) plan.  Candidate axes:

* which mesh axes gradient reduction uses (flat all-reduce vs hierarchical
  reduce-scatter(ICI) + all-reduce(DCN) + all-gather(ICI));
* whether the cross-pod payload is compressed (bf16/int8 + error feedback)
  — the paper's 'send the ROI, not the frame';
* how often the cross-pod sync runs (every step vs every k-th step with
  local accumulation) — the paper's 'DetNet at 10 fps, KeyNet at 30 fps'.

This is an *analytical* advisor: it reasons over byte/FLOP counts exactly
like the paper's Eq. 1-11, so it runs in microseconds at job-launch time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .constants import TPU_V5E, TPUChipSpec


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """One candidate cross-device communication plan for data parallelism."""

    name: str
    hierarchical: bool          # RS(ICI) -> AR(DCN) -> AG(ICI) vs flat AR
    dcn_dtype_bytes: int        # 4 = f32, 2 = bf16, 1 = int8 (compressed)
    sync_every: int = 1         # cross-pod sync cadence (local accum between)


@dataclasses.dataclass(frozen=True)
class PlanCost:
    plan: CommPlan
    t_comm_s: float
    e_comm_j: float             # per chip per step
    ici_bytes: float            # per chip
    dcn_bytes: float            # per chip
    dcn_edge_bytes: float       # per inter-pod boundary link (time-critical)

    def better_than(self, other: "PlanCost", objective: str) -> bool:
        a, b = (self.t_comm_s, other.t_comm_s) if objective == "time" else \
               (self.e_comm_j, other.e_comm_j)
        return a < b


DEFAULT_PLANS: tuple[CommPlan, ...] = (
    CommPlan("flat-ar-f32", hierarchical=False, dcn_dtype_bytes=4),
    CommPlan("hier-f32", hierarchical=True, dcn_dtype_bytes=4),
    CommPlan("hier-bf16", hierarchical=True, dcn_dtype_bytes=2),
    CommPlan("hier-int8-ef", hierarchical=True, dcn_dtype_bytes=1),
    CommPlan("hier-bf16-k4", hierarchical=True, dcn_dtype_bytes=2,
             sync_every=4),
)


def grad_reduce_cost(plan: CommPlan, grad_elems_per_chip: float,
                     pods: int, intra_pod_chips: int,
                     grad_dtype_bytes: int = 4,
                     chip: TPUChipSpec = TPU_V5E) -> PlanCost:
    """Byte/energy/time cost of one data-parallel gradient reduction.

    Ring formulas (``g`` = gradient bytes, ``n`` = chips/pod, ``p`` = pods,
    ``N = n*p``):

    * **flat all-reduce** over all N chips: every ring edge carries
      ``2 (N-1)/N * g`` bytes — *including the p inter-pod boundary edges*.
      The slow DCN boundary edge therefore gates the whole ring:
      ``t = 2 (N-1)/N * g / BW_dcn``.  This is the paper's centralized
      system: bulk payload rides the expensive link.
    * **hierarchical** (the DOSC plan): reduce-scatter over ICI
      ((n-1)/n * g), all-reduce of the 1/n shard across pods over DCN
      (2 (p-1)/p * g/n, optionally compressed — the 'ROI'), all-gather over
      ICI ((n-1)/n * g).  Only a 1/n-sized, optionally-compressed shard
      ever touches DCN.
    """
    g_bytes = grad_elems_per_chip * grad_dtype_bytes
    n, p = intra_pod_chips, pods
    if plan.hierarchical:
        ici = 2.0 * (n - 1) / n * g_bytes                 # RS + AG
        shard = g_bytes / n
        dcn_payload = shard * plan.dcn_dtype_bytes / grad_dtype_bytes
        dcn_edge = (2.0 * (p - 1) / p * dcn_payload) if p > 1 else 0.0
        dcn = dcn_edge            # per chip == per rail here
        dcn_edge /= plan.sync_every
        dcn /= plan.sync_every
        t = (ici / chip.ici_link_bandwidth
             + dcn_edge / chip.dcn_bandwidth)
    else:
        total = n * p
        per_edge = 2.0 * (total - 1) / total * g_bytes
        # p of the N ring edges are pod boundaries; amortized per chip:
        dcn = per_edge * p / total
        ici = per_edge * (total - p) / total
        dcn_edge = per_edge if p > 1 else 0.0
        dcn_edge /= plan.sync_every
        dcn /= plan.sync_every
        # the slowest edge gates the ring
        t = max(per_edge / chip.ici_link_bandwidth,
                dcn_edge / chip.dcn_bandwidth)
    e = ici * chip.e_ici_per_byte + dcn * chip.e_dcn_per_byte
    return PlanCost(plan=plan, t_comm_s=t, e_comm_j=e,
                    ici_bytes=ici, dcn_bytes=dcn, dcn_edge_bytes=dcn_edge)


def advise(grad_elems_per_chip: float, pods: int, intra_pod_chips: int,
           plans: Sequence[CommPlan] = DEFAULT_PLANS,
           objective: str = "energy",
           chip: TPUChipSpec = TPU_V5E) -> list[PlanCost]:
    """Rank candidate plans (best first) by time or energy.

    Mirrors the paper's partition sweep: enumerate placements, run the
    analytical model, pick the minimum.
    """
    costs = [grad_reduce_cost(p, grad_elems_per_chip, pods, intra_pod_chips,
                              chip=chip) for p in plans]
    key = (lambda c: c.t_comm_s) if objective == "time" else \
          (lambda c: c.e_comm_j)
    return sorted(costs, key=key)
