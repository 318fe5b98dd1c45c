"""TPU adaptation of the paper's semi-analytical energy model (Eq. 1/2),
the port of the reference package's ``core/tpu_energy.py``; the chip is
an argument (``TPU_V5E`` by default, :data:`.constants.H100_SXM` for the
port's card, where "ICI" reads NVLink and "DCN" the inter-node fabric).

The paper sums per-module energies — cameras, links, compute, memory — with
counts extracted by GVSoC.  On a TPU pod the same decomposition is:

    E_step =  HLO_FLOPs   x E_flop                      (Eq. 7 analogue)
            + HBM_bytes   x E_hbm_byte                  (Eq. 8 analogue)
            + ICI_bytes   x E_ici_byte                  (Eq. 5, cheap tier)
            + DCN_bytes   x E_dcn_byte                  (Eq. 5, MIPI tier)
            + P_idle      x max(0, T_step - T_busy)     (Eq. 11 analogue)

per chip, with counts taken from the compiled dry-run (cost_analysis + HLO
collective parse).  The host input pipeline plays the camera's role: a fixed
per-byte ingest cost at the data-delivery rate.

This module powers the energy-aware partition advisor in
:mod:`.dosc` — the paper's technique as a framework feature.
"""

from __future__ import annotations

import dataclasses

from .constants import TPU_V5E, TPUChipSpec
from .hlo_analysis import CollectiveSummary
from .roofline import RooflineTerms


@dataclasses.dataclass(frozen=True)
class StepEnergy:
    """Per-chip, per-step energy breakdown (joules)."""

    e_compute: float
    e_hbm: float
    e_ici: float
    e_dcn: float
    e_idle: float
    t_step: float

    @property
    def total(self) -> float:
        return (self.e_compute + self.e_hbm + self.e_ici + self.e_dcn
                + self.e_idle)

    @property
    def avg_power_w(self) -> float:
        """Eq. 2 analogue: energy x step rate."""
        return self.total / self.t_step if self.t_step > 0 else 0.0

    def breakdown(self) -> dict[str, float]:
        return {"compute": self.e_compute, "hbm": self.e_hbm,
                "ici": self.e_ici, "dcn": self.e_dcn, "idle": self.e_idle}


def split_tiers(collectives: CollectiveSummary,
                intra_pod_chips: int) -> tuple[float, float]:
    """Split collective wire bytes into (ICI, DCN) tiers by group size.

    Collectives whose participating groups fit inside one pod ride the
    cheap ICI tier (the paper's uTSV); groups spanning more devices than a
    pod holds must traverse the inter-pod DCN tier (the paper's MIPI).
    """
    ici = dcn = 0.0
    for group_size, wire in collectives.by_group_size().items():
        if group_size <= intra_pod_chips:
            ici += wire
        else:
            dcn += wire
    return ici, dcn


def step_energy(terms: RooflineTerms, collectives: CollectiveSummary,
                intra_pod_chips: int,
                t_step: float | None = None,
                chip: TPUChipSpec = TPU_V5E) -> StepEnergy:
    """Eq. 1 analogue for one training/serving step on one chip.

    ``t_step`` defaults to the roofline bound (perfect overlap); pass a
    measured/estimated step time to account for idle (Eq. 10/11 analogue:
    idle arises when a chip waits — stragglers, pipeline bubbles, input
    stalls).
    """
    ici_b, dcn_b = split_tiers(collectives, intra_pod_chips)
    t_busy = terms.t_bound
    t = t_step if t_step is not None else t_busy
    e_idle = chip.idle_power * max(0.0, t - t_busy)
    # idle_power also burns during busy time as a baseline floor:
    e_idle += chip.idle_power * t_busy
    return StepEnergy(
        e_compute=terms.hlo_flops * chip.e_per_flop,
        e_hbm=terms.hlo_bytes * chip.e_hbm_per_byte,
        e_ici=ici_b * chip.e_ici_per_byte,
        e_dcn=dcn_b * chip.e_dcn_per_byte,
        e_idle=e_idle,
        t_step=t,
    )


def system_power_w(e: StepEnergy, chips: int) -> float:
    """Whole-machine average power (Eq. 2 over all chip 'modules')."""
    return e.avg_power_w * chips
