"""Semi-analytical energy equations — faithful implementations of Eqs. 3-11.

Every function cites the equation it implements.  Units: joules, seconds,
bytes, watts.  The equations are deliberately simple ("semi-analytical"): all
workload-dependent complexity lives in the *counts* fed into them, which the
paper extracts with GVSoC/DORY and we extract either from
:mod:`repro.core.workloads` layer tables (faithful path) or from compiled XLA
HLO (TPU-adapted path, :mod:`repro.core.tpu_energy`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .constants import CameraPower, LinkSpec, MemorySpec


# ---------------------------------------------------------------------------
# Eq. 5 / Eq. 6 — communication links
# ---------------------------------------------------------------------------


def comm_energy(a_size_bytes: float, link: LinkSpec) -> float:
    """Eq. 5:  E_comm = A_size * E_byte_comm."""
    return a_size_bytes * link.energy_per_byte


def comm_time(a_size_bytes: float, link: LinkSpec) -> float:
    """Eq. 6:  T_comm = A_size / BW_comm."""
    return a_size_bytes / link.bandwidth


# ---------------------------------------------------------------------------
# Eq. 3 / Eq. 4 — camera
# ---------------------------------------------------------------------------


def camera_off_time(fps: float, t_sense: float, t_comm: float) -> float:
    """Eq. 4:  T_off = 1/fps - T_sense - T_comm  (clamped at 0)."""
    return max(0.0, 1.0 / fps - t_sense - t_comm)


def camera_energy(power: CameraPower, fps: float, t_sense: float,
                  t_comm: float) -> float:
    """Eq. 3:  E_ca = P_sense*T_sense + P_rd*T_comm + P_off*T_off.

    ``t_comm`` is the readout time, which depends on the interface between
    the camera and the compute module (Eq. 6) — this is where the uTSV's
    200x bandwidth advantage over MIPI shortens the 36 mW readout window.
    """
    t_off = camera_off_time(fps, t_sense, t_comm)
    return (power.sense * t_sense + power.read * t_comm + power.idle * t_off)


# ---------------------------------------------------------------------------
# Eq. 7 — compute
# ---------------------------------------------------------------------------


def compute_energy(num_macs: float, e_mac: float) -> float:
    """Eq. 7:  E_comp = #MACs * E_MAC."""
    return num_macs * e_mac


# ---------------------------------------------------------------------------
# Eq. 8 — memory access
# ---------------------------------------------------------------------------


def memory_access_energy(read_bytes: float, write_bytes: float,
                         mem: MemorySpec) -> float:
    """Eq. 8:  E_rw = #Read * E_byte_read + #Write * E_byte_write."""
    return read_bytes * mem.e_read + write_bytes * mem.e_write


# ---------------------------------------------------------------------------
# Eq. 9 / Eq. 10 / Eq. 11 — leakage with On / Retention / Off states
# ---------------------------------------------------------------------------


def idle_time(fps: float, t_processing: float) -> float:
    """Eq. 10:  T_idle = 1/fps - T_processing  (clamped at 0)."""
    return max(0.0, 1.0 / fps - t_processing)


def memory_leakage_energy(t_processing: float, fps: float,
                          capacity_bytes: float, mem: MemorySpec) -> float:
    """Eq. 11:  E_lk = T_proc * Lk_on + T_idle * Lk_ret_off   (per frame).

    ``Lk`` scales with the memory instance capacity.  For SRAM the idle
    state is data-retentive drowsy mode (``leak_ret``); for STT-MRAM it is a
    true power-off (leak_ret == 0) because the array is non-volatile.
    """
    t_idle = idle_time(fps, t_processing)
    return capacity_bytes * (mem.leak_on * t_processing
                             + mem.leak_ret * t_idle)


# ---------------------------------------------------------------------------
# Eq. 1 / Eq. 2 — module aggregation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ModuleEnergy:
    """Per-frame energy of one module instance plus its operating rate.

    Eq. 2 multiplies each module's per-frame energy by the fps *at which that
    module operates* — the paper's key knob for running DetNet at a lower
    rate than the camera.
    """

    name: str
    group: str            # breakdown key: "camera", a link tag ("mipi.0",
                          # "utsv"), or "<site>.compute" / "<site>.memory"
    energy_per_frame: float
    fps: float

    @property
    def avg_power(self) -> float:
        """Eq. 2 contribution:  P = E_frame * fps."""
        return self.energy_per_frame * self.fps


def total_energy_per_frame(modules: list[ModuleEnergy]) -> float:
    """Eq. 1:  E_total = sum over module energies (per frame)."""
    return sum(m.energy_per_frame for m in modules)


def average_power(modules: list[ModuleEnergy]) -> float:
    """Eq. 2:  P_avg = sum over module energies x module fps."""
    return sum(m.avg_power for m in modules)


def power_breakdown(modules: list[ModuleEnergy]) -> dict[str, float]:
    """Average power per module group (the stacked bars of Fig. 5)."""
    out: dict[str, float] = {}
    for m in modules:
        out[m.group] = out.get(m.group, 0.0) + m.avg_power
    return out
