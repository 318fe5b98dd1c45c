"""Silicon & system constants for the DOSC semi-analytical power model.

Published constants are taken verbatim from the paper:

* Table 1 — AR/VR custom digital-pixel-sensor (DPS) power states [Liu, IEDM'20].
* Table 2 — communication links: uTSV (5 pJ/B, 100 GB/s) [Vivet, ISSCC'20] and
  MIPI (100 pJ/B, 0.5 GB/s) [Choi'21, Takla'17].
* RBE accelerator — 133 MAC/cycle peak at 8-bit [Conti, TCAD'18].

The paper states that MAC energy and memory read/write/leakage values were
"extracted from post-synthesis simulations and memory compilers" for 7 nm and
16 nm foundry libraries, plus a 16 nm STT-MRAM test vehicle [Guedj, MRAM
Forum'21] — but does not publish the numbers.  The values below are taken from
public literature ranges for those nodes and then *calibrated* (see
``benchmarks/power_tables.py --calibrate`` provenance notes) so that the model
reproduces the paper's three headline results:

* 24 % system power reduction, distributed(7nm) vs centralized(7nm)  (Fig. 5a)
* 16 % system power reduction, distributed(16nm) vs centralized(7nm) (Fig. 5a)
* 39 % on-sensor power reduction, hybrid SRAM+MRAM vs pure SRAM      (Fig. 5b)

TPU-v5e class constants used by the adapted (beyond-paper) TPU energy model
and the roofline analysis are at the bottom.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# ---------------------------------------------------------------------------
# Table 1 — DPS camera power states (W)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CameraPower:
    """Power draw of the digital pixel sensor in each operating state (W)."""

    sense: float = 15e-3  # "Sensing"  (exposure + ADC)
    read: float = 36e-3   # "Read Out"
    idle: float = 1.5e-3  # "Idle"


DPS_CAMERA = CameraPower()

# Default sensing time: exposure + ADC.  The DPS in [10] supports global
# shutter with short exposures; ~4.8 ms exposure + 1 ms triple-quantization
# ADC is representative for an indoor AR/VR tracking camera.  (Calibrated —
# see module docstring.)
T_EXPOSURE_S = 4.8e-3
T_ADC_S = 1.0e-3
T_SENSE_S = T_EXPOSURE_S + T_ADC_S


# ---------------------------------------------------------------------------
# Table 2 — communication links
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """A point-to-point communication interface (Eq. 5/6)."""

    name: str
    energy_per_byte: float  # J/B
    bandwidth: float        # B/s


UTSV = LinkSpec("uTSV", energy_per_byte=5e-12, bandwidth=100e9)
MIPI = LinkSpec("MIPI", energy_per_byte=100e-12, bandwidth=0.5e9)


# ---------------------------------------------------------------------------
# Memory technology (per-node, per-type) — calibrated, literature-plausible
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemorySpec:
    """Energy/leakage characteristics of one memory technology instance.

    ``leak_on``/``leak_ret`` are W per byte of capacity; read/write energies
    are J per byte accessed.  STT-MRAM is modelled with negligible array
    leakage (non-volatile; only periphery leaks) and ~2x the density of SRAM
    [Guedj'21], at the price of higher write energy.
    """

    name: str
    e_read: float      # J/B
    e_write: float     # J/B
    leak_on: float     # W/B while the bank is active
    leak_ret: float    # W/B while in retention / standby
    density_rel: float = 1.0  # density relative to SRAM at the same node


# 16 nm values (calibrated; see module docstring).  SRAM leakage
# ~1.8 mW/MiB active / ~0.47 mW/MiB in state-retentive drowsy mode is
# representative of high-speed compiled SRAM at operating temperature.
# MRAM array leakage is negligible (periphery only); reads cost slightly
# more than SRAM, writes ~10x.
SRAM_16NM = MemorySpec(
    name="SRAM-16nm",
    e_read=0.80e-12,
    e_write=1.00e-12,
    leak_on=1.7701e-3 / (1 << 20),
    leak_ret=0.4662e-3 / (1 << 20),
)
MRAM_16NM = MemorySpec(
    name="STT-MRAM-16nm",
    e_read=1.20e-12,
    e_write=10.0e-12,
    leak_on=0.0531e-3 / (1 << 20),  # periphery only (3% of SRAM)
    leak_ret=0.00,                  # non-volatile: full power-off retention
    density_rel=2.0,
)
# 7 nm SRAM: lower dynamic energy, ~0.73x the 16 nm leakage per byte.
SRAM_7NM = MemorySpec(
    name="SRAM-7nm",
    e_read=0.50e-12,
    e_write=0.65e-12,
    leak_on=1.2986e-3 / (1 << 20),
    leak_ret=0.3420e-3 / (1 << 20),
)


# ---------------------------------------------------------------------------
# Logic / accelerator technology nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TechNode:
    """A logic process node for the PULP+RBE compute cluster."""

    name: str
    e_mac: float              # J per 8-bit MAC (incl. local dataflow overhead)
    f_clk: float              # Hz
    sram: MemorySpec
    mram: Optional[MemorySpec] = None


# E_MAC for an 8-bit MAC including operand movement inside the accelerator.
# The RBE descends from the XNOR Neural Engine (21.6 fJ/op binary [5]); an
# 8-bit reconfigurable MAC at ~0.11 pJ (7 nm) / ~0.16 pJ (16 nm, 1.5x node
# scaling) is in line with that lineage.  (Calibrated; see module docstring.)
NODE_16NM = TechNode(name="16nm", e_mac=0.1635e-12, f_clk=500e6,
                     sram=SRAM_16NM, mram=MRAM_16NM)
NODE_7NM = TechNode(name="7nm", e_mac=0.109e-12, f_clk=700e6,
                    sram=SRAM_7NM, mram=None)  # no MRAM test vehicle at 7 nm

TECH_NODES = {"16nm": NODE_16NM, "7nm": NODE_7NM}


# ---------------------------------------------------------------------------
# RBE accelerator (Reconfigurable Binary Engine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RBESpec:
    """Throughput model parameters for the RBE DNN accelerator [5].

    ``peak_mac_per_cycle`` is the paper's 133 MAC/cycle at 8-bit.
    ``weight_port_bytes_per_cycle`` is the L2-weight streaming port width that
    produces the weight-streaming-bound roofline of Fig. 4.
    ``util`` captures the engine's structural efficiency per layer kind
    (Fig. 4: regular convs near peak, pointwise lower, depthwise lowest —
    depthwise cannot fill the engine's input-channel parallelism).
    """

    peak_mac_per_cycle: float = 133.0
    weight_port_bytes_per_cycle: float = 8.0
    util_conv: float = 0.92
    util_pointwise: float = 0.55
    util_depthwise: float = 0.16
    util_fc: float = 0.50


RBE = RBESpec()

# The paper: "we assume that the on-sensor compute capability and
# corresponding memory size to be one fourth of the aggregator's."
ON_SENSOR_SCALE = 0.25

# L1 scratchpad sizes of the two processor-site classes, and the L1's
# access-energy discount vs L2 SRAM (ProcessorSite.l1_spec).  Shared by the
# scalar builders and the vectorized kernel — a single source of truth so
# the two evaluation paths cannot drift.
SENSOR_L1_BYTES = 16 * 1024
AGG_L1_BYTES = 64 * 1024
L1_ENERGY_SCALE = 0.4


# ---------------------------------------------------------------------------
# Hand-tracking system parameters (MEgATrack [8])
# ---------------------------------------------------------------------------

NUM_CAMERAS = 4                 # four monochrome cameras
IMAGE_W, IMAGE_H = 640, 480     # VGA monochrome
# The DPS of [10] quantizes at 10 bit (triple quantization, 127 dB DR); the
# raw readout stream is MIPI RAW10-packed at 1.25 B/px.  ROI crops are
# normalized to int8 by the on-sensor ISP before transmission (1 B/px).
BYTES_PER_PIXEL_RAW = 1.25
DETNET_INPUT_W, DETNET_INPUT_H = 320, 240
ROI_W, ROI_H = 96, 96           # KeyNet crop
CAMERA_FPS = 30.0               # frame delivery rate
KEYNET_FPS = 30.0               # KeyNet runs every frame
DETNET_FPS = 10.0               # DetNet re-runs every 3rd frame (ROI reuse [8])
BOX_COORDS_BYTES = 64           # detection boxes returned sensor-ward (per frame)


# ---------------------------------------------------------------------------
# Session dynamics: battery + lumped-thermal parameters (scenario engine)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BatterySpec:
    """Glasses-class battery for the session simulator (``core/scenario``).

    ``capacity_j`` is usable energy (a ~2.1 Wh cell is representative of
    the Google-Glass-class devices "Draining our Glass" characterizes).
    ``peukert`` models rate-dependent capacity loss: the effective drain
    power is ``P * (P / p_ref_w) ** (peukert - 1)``, so ``peukert=1``
    (default) is exactly linear coulomb counting — which keeps the
    closed-form battery oracle of ``tests/test_scenario.py`` bitwise.
    """

    name: str = "glass-2.1Wh"
    capacity_j: float = 2.1 * 3600.0   # usable energy (J)
    soc0: float = 1.0                  # initial state of charge [0, 1]
    peukert: float = 1.0               # 1.0 = ideal linear drain
    p_ref_w: float = 1.0               # Peukert reference draw (W)


@dataclasses.dataclass(frozen=True)
class ThermalSpec:
    """One lumped RC node (case) + throttle law for the session simulator.

    ``T' = T_amb + P*R + (T - T_amb - P*R) * exp(-dt / (R*C))`` is the
    exact step response, so the discretized trajectory matches the
    analytic exponential regardless of step size.  The throttle factor
    ``clip(1 - gain * max(0, T - onset), floor, 1)`` multiplies the
    DetNet/KeyNet inference rates; below onset it is exactly 1.0, so a
    cool device reproduces the static operating point bitwise.
    """

    name: str = "ar-frame"
    r_th_k_per_w: float = 25.0         # case-to-ambient resistance (K/W)
    c_th_j_per_k: float = 40.0         # lumped heat capacity (J/K); tau ~17min
    ambient_c: float = 25.0            # ambient temperature (degC)
    throttle_onset_c: float = 35.0     # skin-comfort throttle threshold
    throttle_gain_per_c: float = 0.25  # rate reduction per K above onset
    throttle_floor: float = 0.3        # lowest allowed rate multiplier


DEFAULT_BATTERY = BatterySpec()
DEFAULT_THERMAL = ThermalSpec()


# ---------------------------------------------------------------------------
# TPU v5e-class constants (beyond-paper adaptation + roofline analysis)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TPUChipSpec:
    """Per-chip roofline constants for the TPU target."""

    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12      # FLOP/s
    hbm_bandwidth: float = 819e9         # B/s
    ici_link_bandwidth: float = 50e9     # B/s per link
    dcn_bandwidth: float = 6.25e9        # B/s per host (inter-pod tier)
    hbm_bytes: float = 16 * (1 << 30)    # 16 GiB capacity
    vmem_bytes: float = 128 * (1 << 20)  # ~128 MiB vector memory
    # Energy constants for the adapted semi-analytical model (public
    # literature ranges for 5nm-class accelerators + optics/ICI serdes).
    e_per_flop: float = 0.25e-12         # J/FLOP (bf16 MXU, incl. local SRAM)
    e_hbm_per_byte: float = 15e-12       # J/B HBM access
    e_ici_per_byte: float = 10e-12       # J/B intra-pod ICI
    e_dcn_per_byte: float = 60e-12       # J/B inter-pod DCN (the "MIPI" tier)
    idle_power: float = 70.0             # W/chip static + fixed


TPU_V5E = TPUChipSpec()
