"""Three-term roofline from a program's counts (the port of the reference
package's ``core/roofline.py``).

    compute term    = HLO_FLOPs        / (chips x peak_FLOP/s)
    memory term     = HLO_bytes        / (chips x HBM_bw)
    collective term = collective_bytes / (chips x link_bw)

All terms are *seconds per step*; the dominant (largest) term is the
bottleneck, and ``max_term / sum-ish`` gives the achievable fraction.  This
is the paper's Fig. 4 methodology lifted from the RBE (weight-streaming
roofline) to the TPU (HBM + ICI roofline).

Notes on sources:
* FLOPs/bytes come from ``compiled.cost_analysis()`` in the reference, or
  from :func:`repro_torch.core.hlo_cost.analyze_program` over a torch
  program here — *per-device* numbers (the program is the per-device
  program), so the "/chips" division is already materialized; we keep the
  formulas explicit.
* collective bytes come from :mod:`.hlo_analysis` (HLO text) or from the
  ``torch.distributed`` operations ``analyze_program`` counts.
* the chip is an argument: the reference's ``TPU_V5E`` by default, the
  port's own H100 (:data:`.constants.H100_SXM`) where it runs.

One deviation from the reference, on purpose: its ``roofline_fraction``
divides by ``TPU_V5E``'s peak whatever chip the terms were built for;
here it divides by that chip's own peak (``peak_flops``), which is the
same number under ``TPU_V5E``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .constants import TPU_V5E, TPUChipSpec
from .hlo_analysis import CollectiveSummary


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw counts (per device unless noted)
    hlo_flops: float
    hlo_bytes: float
    collective_payload_bytes: float
    collective_wire_bytes: float
    model_flops_global: float       # 6*N*D (dense) or 6*N_active*D (MoE)
    # seconds
    t_compute: float
    t_memory: float
    t_collective: float
    # the chip's bf16 peak, FLOP/s (the port's; see roofline_fraction)
    peak_flops: float = TPU_V5E.peak_flops_bf16

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def t_bound(self) -> float:
        """Lower-bound step time: perfectly-overlapped execution."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_serial(self) -> float:
        """Upper-bound step time: zero overlap."""
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (HLO_FLOPs x chips): how much of the compiled
        compute is 'useful' — catches remat / redundancy waste."""
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops_global / total_hlo if total_hlo else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU at the bound: useful FLOPs / (chips x peak x t),
        with the peak of the chip the terms were built for (the
        reference takes ``TPU_V5E``'s whatever the chip: the same under
        ``TPU_V5E``)."""
        if self.t_bound <= 0:
            return 0.0
        return (self.model_flops_global
                / (self.chips * self.peak_flops * self.t_bound))

    def to_dict(self) -> dict:
        """The fields and the derived readings, as the reference's, plus
        one key the reference has not: ``peak_flops``, the chip's bf16
        peak that ``roofline_fraction`` divides by."""
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, t_bound=self.t_bound,
                 t_serial=self.t_serial,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def build_terms(arch: str, shape: str, mesh: str, chips: int,
                cost: dict, collectives: CollectiveSummary,
                model_flops_global: float,
                chip: TPUChipSpec = TPU_V5E,
                per_device_cost: bool = True) -> RooflineTerms:
    """Assemble roofline terms from compiled artifacts.

    ``cost`` is ``compiled.cost_analysis()`` (flops / bytes accessed), or
    the same keys from a counted program (``{"flops": c.flops, "bytes
    accessed": c.bytes}`` of an :class:`.hlo_cost.HLOCost`).
    In SPMD mode the compiled module is the per-device program, so its
    counts are already per-chip (``per_device_cost=True``).
    """
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    if not per_device_cost:
        flops /= chips
        byts /= chips
    wire = collectives.total_wire_bytes
    payload = collectives.total_payload_bytes
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=flops, hlo_bytes=byts,
        collective_payload_bytes=payload, collective_wire_bytes=wire,
        model_flops_global=model_flops_global,
        t_compute=flops / chip.peak_flops_bf16,
        t_memory=byts / chip.hbm_bandwidth,
        t_collective=wire / chip.ici_link_bandwidth,
        peak_flops=chip.peak_flops_bf16,
    )


def format_table(rows: list[RooflineTerms]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':10s} "
           f"{'t_comp(ms)':>10s} {'t_mem(ms)':>10s} {'t_coll(ms)':>10s} "
           f"{'dominant':>10s} {'useful':>7s} {'roofl%':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.mesh:10s} "
            f"{r.t_compute*1e3:10.3f} {r.t_memory*1e3:10.3f} "
            f"{r.t_collective*1e3:10.3f} {r.dominant:>10s} "
            f"{r.useful_flops_ratio:7.3f} {r.roofline_fraction*100:6.2f}%")
    return "\n".join(lines)
