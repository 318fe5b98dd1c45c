"""System topology assembly: centralized vs distributed on-sensor compute.

Builds the full module list (cameras, links, processors, memories) for the
two architectures of Fig. 1 and evaluates Eq. 1/2 over them.  The returned
:class:`SystemReport` carries the per-group breakdown used to reproduce the
stacked bars of Fig. 5a and the on-sensor subsystem split of Fig. 5b.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

from . import energy as E
from . import rbe
from .constants import (AGG_L1_BYTES, CAMERA_FPS, DETNET_FPS, DPS_CAMERA,
                        KEYNET_FPS, L1_ENERGY_SCALE, MIPI, NUM_CAMERAS,
                        ON_SENSOR_SCALE, RBE, SENSOR_L1_BYTES, T_SENSE_S,
                        TECH_NODES, UTSV, CameraPower, LinkSpec, MemorySpec,
                        TechNode)
from .handtracking import (FULL_FRAME_BYTES, ROI_BYTES, build_detnet,
                           build_keynet)
from .workloads import NNWorkload

MemKind = Literal["sram", "mram"]


@dataclasses.dataclass(frozen=True)
class ProcessorSite:
    """One compute site (an on-sensor processor or the aggregator)."""

    name: str
    node: TechNode
    scale: float                      # compute capability vs full RBE
    weight_mem: MemKind = "sram"
    l1_bytes: int = AGG_L1_BYTES

    def weight_mem_spec(self) -> MemorySpec:
        if self.weight_mem == "mram":
            if self.node.mram is None:
                raise ValueError(f"no MRAM test vehicle at {self.node.name}")
            return self.node.mram
        return self.node.sram

    def l1_spec(self) -> MemorySpec:
        # L1 is a small, faster SRAM: cheaper per-byte access than L2.
        return dataclasses.replace(
            self.node.sram,
            name=f"L1-{self.node.name}",
            e_read=self.node.sram.e_read * L1_ENERGY_SCALE,
            e_write=self.node.sram.e_write * L1_ENERGY_SCALE)


@dataclasses.dataclass(frozen=True)
class Deployment:
    """A set of networks running on one processor site, each at its own fps."""

    site: ProcessorSite
    workloads: Sequence[tuple[NNWorkload, float]]   # (network, fps)
    extra_buffer_bytes: int = 0     # e.g. raw-frame input buffers (L2 act)

    # ---- derived ----
    def t_processing_per_frame(self, wl: NNWorkload) -> float:
        """Eq. 9 for one inference of ``wl`` on this site."""
        return rbe.processing_time_s(wl, self.site.node, RBE, self.site.scale)

    def duty_processing_per_second(self) -> float:
        """Total accelerator-busy seconds per second (all networks)."""
        return sum(self.t_processing_per_frame(wl) * fps
                   for wl, fps in self.workloads)

    def l2_weight_capacity(self) -> int:
        """Paper: 'The L2 weight memories were sized to hold the full
        weights of the models.'"""
        return sum(wl.total_weight_bytes for wl, _ in self.workloads)

    def l2_act_capacity(self) -> int:
        peak = max((wl.peak_act_bytes for wl, _ in self.workloads), default=0)
        return peak + self.extra_buffer_bytes

    def modules(self) -> list[E.ModuleEnergy]:
        """Compute + memory modules for Eq. 1/2 (per-second accounting).

        We evaluate at fps=1 with per-second energies so that multiple
        networks at different rates on one shared site aggregate exactly.
        """
        site = self.site
        node = site.node
        sram = node.sram
        wspec = site.weight_mem_spec()
        l1 = site.l1_spec()
        mods: list[E.ModuleEnergy] = []

        # --- Eq. 7: compute ---
        macs_per_s = sum(wl.total_macs * fps for wl, fps in self.workloads)
        mods.append(E.ModuleEnergy(
            name=f"{site.name}.compute", group=f"{site.name}.compute",
            energy_per_frame=E.compute_energy(macs_per_s, node.e_mac),
            fps=1.0))

        # --- Eq. 8: memory accesses (per second) ---
        w_read = act_read = act_write = 0.0
        for wl, fps in self.workloads:
            w_read += rbe.total_weight_stream_bytes(wl) * fps
            act_read += wl.total_act_traffic_bytes / 2 * fps
            act_write += wl.total_act_traffic_bytes / 2 * fps
        # L1 sees every streamed byte once more (L2 -> L1 -> engine).
        l1_traffic = w_read + act_read + act_write

        mods.append(E.ModuleEnergy(
            name=f"{site.name}.l2w.rw", group=f"{site.name}.memory",
            energy_per_frame=E.memory_access_energy(w_read, 0.0, wspec),
            fps=1.0))
        mods.append(E.ModuleEnergy(
            name=f"{site.name}.l2a.rw", group=f"{site.name}.memory",
            energy_per_frame=E.memory_access_energy(act_read, act_write,
                                                    sram),
            fps=1.0))
        mods.append(E.ModuleEnergy(
            name=f"{site.name}.l1.rw", group=f"{site.name}.memory",
            energy_per_frame=E.memory_access_energy(l1_traffic / 2,
                                                    l1_traffic / 2, l1),
            fps=1.0))

        # --- Eq. 9/10/11: leakage (per second: fps=1, T window = 1 s) ---
        t_proc = min(1.0, self.duty_processing_per_second())
        for cap, spec, tag in (
                (self.l2_weight_capacity(), wspec, "l2w"),
                (self.l2_act_capacity(), sram, "l2a"),
                (site.l1_bytes, l1, "l1")):
            mods.append(E.ModuleEnergy(
                name=f"{site.name}.{tag}.leak", group=f"{site.name}.memory",
                energy_per_frame=E.memory_leakage_energy(
                    t_proc, 1.0, cap, spec),
                fps=1.0))
        return mods


@dataclasses.dataclass
class SystemReport:
    name: str
    modules: list[E.ModuleEnergy]

    @property
    def avg_power(self) -> float:
        return E.average_power(self.modules)

    def breakdown(self) -> dict[str, float]:
        return E.power_breakdown(self.modules)

    def group_power(self, *prefixes: str) -> float:
        return sum(p for g, p in self.breakdown().items()
                   if any(g.startswith(pre) for pre in prefixes))


# ---------------------------------------------------------------------------
# Topology builders
# ---------------------------------------------------------------------------


def _camera_modules(n: int, readout_link: LinkSpec,
                    frame_bytes: int = FULL_FRAME_BYTES,
                    fps: float = CAMERA_FPS,
                    power: CameraPower = DPS_CAMERA,
                    t_sense: float = T_SENSE_S) -> list[E.ModuleEnergy]:
    """Cameras (Eq. 3): readout window set by the camera-side interface."""
    t_comm = E.comm_time(frame_bytes, readout_link)
    e = E.camera_energy(power, fps, t_sense, t_comm)
    return [E.ModuleEnergy(name=f"camera{i}", group="camera",
                           energy_per_frame=e, fps=fps) for i in range(n)]


def _link_modules(n: int, link: LinkSpec, payload_bytes: float, fps: float,
                  tag: str) -> list[E.ModuleEnergy]:
    e = E.comm_energy(payload_bytes, link)
    return [E.ModuleEnergy(name=f"{tag}{i}", group=tag,
                           energy_per_frame=e, fps=fps) for i in range(n)]


def _resolve_node(node: str | TechNode) -> TechNode:
    return TECH_NODES[node] if isinstance(node, str) else node


def replicate_site_modules(base: list[E.ModuleEnergy], base_site: str,
                           count: int) -> list[E.ModuleEnergy]:
    """Replicate one site's module list across ``count`` identical sites.

    The per-camera sensor deployments are identical except for the site
    name, so the (layer-reduction-heavy) module list is built once and
    copies are relabelled — ``base_site`` ("sensor0") becomes "sensor1",
    "sensor2", ... in both the module name and its breakdown group.
    """
    if not base_site.endswith("0"):
        raise ValueError(f"base_site {base_site!r} must name replica 0 "
                         "(end in '0') so siblings can be derived")
    if count <= 0:
        return []
    out = list(base)
    for i in range(1, count):
        site = base_site[:-1] + str(i)
        out += [dataclasses.replace(m,
                                    name=m.name.replace(base_site, site, 1),
                                    group=m.group.replace(base_site, site, 1))
                for m in base]
    return out


def build_centralized(agg_node: str | TechNode = "7nm",
                      detnet: NNWorkload | None = None,
                      keynet: NNWorkload | None = None,
                      num_cameras: int = NUM_CAMERAS,
                      camera_fps: float = CAMERA_FPS,
                      detnet_fps: float = DETNET_FPS,
                      keynet_fps: float = KEYNET_FPS,
                      t_sense: float = T_SENSE_S) -> SystemReport:
    """Fig. 1(a): full frames cross MIPI; everything runs on the aggregator.

    The aggregator's L2 activation memory additionally buffers the incoming
    raw frames from all cameras.
    """
    detnet = detnet or build_detnet()
    keynet = keynet or build_keynet()
    node = _resolve_node(agg_node)
    mods: list[E.ModuleEnergy] = []
    mods += _camera_modules(num_cameras, readout_link=MIPI, fps=camera_fps,
                            t_sense=t_sense)
    mods += _link_modules(num_cameras, MIPI, FULL_FRAME_BYTES, camera_fps,
                          tag="mipi")
    agg = Deployment(
        site=ProcessorSite(name="agg", node=node, scale=1.0),
        workloads=[(detnet, detnet_fps * num_cameras),
                   (keynet, keynet_fps * num_cameras)],
        extra_buffer_bytes=FULL_FRAME_BYTES * num_cameras,
    )
    mods += agg.modules()
    return SystemReport(name=f"centralized[A={node.name}]", modules=mods)


def build_distributed(agg_node: str | TechNode = "7nm",
                      sensor_node: str | TechNode = "7nm",
                      sensor_weight_mem: MemKind = "sram",
                      detnet: NNWorkload | None = None,
                      keynet: NNWorkload | None = None,
                      num_cameras: int = NUM_CAMERAS,
                      camera_fps: float = CAMERA_FPS,
                      detnet_fps: float = DETNET_FPS,
                      keynet_fps: float = KEYNET_FPS,
                      t_sense: float = T_SENSE_S) -> SystemReport:
    """Fig. 1(b): DetNet on-sensor; only the ROI crosses MIPI.

    * Cameras read out over uTSV (100 GB/s) -> short 36 mW readout window.
    * Each sensor duplicates the DetNet weight memory (the paper's noted
      leakage cost of distribution).
    * MIPI carries the 96x96 ROI at KeyNet rate plus tiny DetNet outputs.
    """
    detnet = detnet or build_detnet()
    keynet = keynet or build_keynet()
    agg = _resolve_node(agg_node)
    sen = _resolve_node(sensor_node)
    mods: list[E.ModuleEnergy] = []
    mods += _camera_modules(num_cameras, readout_link=UTSV, fps=camera_fps,
                            t_sense=t_sense)
    mods += _link_modules(num_cameras, UTSV, FULL_FRAME_BYTES, camera_fps,
                          tag="utsv")
    # MIPI now carries ROI crops (at KeyNet rate) + DetNet outputs (tiny).
    mods += _link_modules(num_cameras, MIPI, ROI_BYTES, keynet_fps,
                          tag="mipi")
    mods += _link_modules(num_cameras, MIPI, detnet.output_bytes, detnet_fps,
                          tag="mipi-det")
    # The per-camera sensor deployments are identical: build once, relabel.
    sensor0 = Deployment(
        site=ProcessorSite(name="sensor0", node=sen,
                           scale=ON_SENSOR_SCALE,
                           weight_mem=sensor_weight_mem,
                           l1_bytes=SENSOR_L1_BYTES),
        workloads=[(detnet, detnet_fps)],
        extra_buffer_bytes=detnet.input_bytes,
    ).modules()
    mods += replicate_site_modules(sensor0, "sensor0", num_cameras)
    aggd = Deployment(
        site=ProcessorSite(name="agg", node=agg, scale=1.0),
        workloads=[(keynet, keynet_fps * num_cameras)],
        extra_buffer_bytes=ROI_BYTES * num_cameras,
    )
    mods += aggd.modules()
    return SystemReport(
        name=(f"distributed[A={agg.name},O={sen.name},"
              f"wmem={sensor_weight_mem}]"),
        modules=mods)


# ---------------------------------------------------------------------------
# Fig. 5 headline comparisons
# ---------------------------------------------------------------------------


def fig5a_comparison() -> dict[str, float]:
    """Normalized system power for the Fig. 5a bars.

    Returns powers normalized to centralized[A=7nm] — the paper's
    normalization — for the three systems shown.
    """
    cen = build_centralized("7nm")
    dis77 = build_distributed("7nm", "7nm")
    dis716 = build_distributed("7nm", "16nm")
    base = cen.avg_power
    return {
        "centralized[A=7nm]": 1.0,
        "distributed[A=7nm,O=7nm]": dis77.avg_power / base,
        "distributed[A=7nm,O=16nm]": dis716.avg_power / base,
        "_saving_7nm": 1.0 - dis77.avg_power / base,
        "_saving_16nm": 1.0 - dis716.avg_power / base,
    }


def fig5b_comparison(sensor_node: str = "16nm",
                     fps: float = 10.0) -> dict[str, float]:
    """On-sensor processor+memory power, pure-SRAM vs hybrid MRAM (Fig. 5b).

    Normalized to the pure-SRAM hierarchy; the paper runs the on-sensor
    processor at 10 fps in 16 nm.
    """
    def onsensor_power(weight_mem: MemKind) -> float:
        rep = build_distributed("7nm", sensor_node,
                                sensor_weight_mem=weight_mem,
                                detnet_fps=fps)
        return rep.group_power("sensor")

    sram = onsensor_power("sram")
    hybrid = onsensor_power("mram")
    return {
        "sram": 1.0,
        "hybrid": hybrid / sram,
        "_saving": 1.0 - hybrid / sram,
    }
