"""Session simulator: time-varying traces with battery + thermal state.

The PyTorch counterpart of the reference ``repro.core.scenario``.  Every
other engine evaluates one *static* operating point of the Eq. 1-11
model; real AR/VR sessions duty-cycle: the inference rates and active
camera count follow user activity, dissipated power heats the case, heat
throttles the compute rates, and the battery drains.  This module adds
that session axis without forking the evaluation stack:

* A **scenario trace** is a piecewise-constant schedule of knob
  multipliers (:class:`Phase`: DetNet/KeyNet rate scales, a camera
  frame-rate scale and an active-camera fraction, each held for
  ``duration_s``).  :data:`PROFILES` names four user-behavior traces.
* A :class:`ScenarioSet` bundles traces with a :class:`BatterySpec`,
  a :class:`ThermalSpec` and a time resolution; :func:`scenario_stack`
  lowers it against a stacked model lowering into a
  :class:`ScenarioStack`, which the backend layer evaluates through the
  same chunk contract, with **trace as one more grid axis**.
* The session evaluation (:func:`session_eval`) evaluates the static
  fields once at the base knobs, then runs a Python loop over the
  ``n_steps`` columns of the step tables: each step re-evaluates Eq.
  1-11 (:func:`repro_torch.core.sweep.config_eval`) at the phase's
  scaled knobs (times the current throttle factor) for every lane, then
  advances battery state-of-charge and one lumped-thermal RC node with
  the *exact* RC step response.  The loop replaces the reference's
  per-lane ``lax.scan``; on a CUDA device the whole loop is captured
  into the chunk step's CUDA graph with the rest of the chunk.

Four session channels join the static fields as objectives and
constraints (``sweep.SCENARIO_FIELDS``): ``session_energy_j``,
``time_to_empty_s``, ``peak_case_temp_c`` and ``throttle_fraction``.
All four inherit validity from ``avg_power``: invalid grid corners are
NaN, exactly like the static channels.

All arithmetic is float64 tensors; every quotient is an IEEE division of
two tensors (:func:`repro_torch.core.sweep._div`), as in the reference.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch

from . import arrays as A
from . import sweep as SW
from .constants import (CAMERA_FPS, DEFAULT_BATTERY, DEFAULT_THERMAL,
                        DETNET_FPS, KEYNET_FPS, NUM_CAMERAS, BatterySpec,
                        ThermalSpec)

F64 = SW.F64

#: Default number of steps each phase is subdivided into.  The RC update
#: is exact per step, so substeps only matter for how often the throttle
#: factor is refreshed against the rising temperature.
DEFAULT_STEPS_PER_PHASE = 4

#: Names of the step tables in a scenario stack's device tables
#: (:func:`repro_torch.core.backend.device_tables`), in row order of
#: :func:`_step_tables`.
STEP_TABLES = ("step.dt", "step.det_scale", "step.key_scale",
               "step.cam_scale", "step.cams_active")


# ---------------------------------------------------------------------------
# Trace description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Phase:
    """One piecewise-constant segment of a scenario trace.

    The scales multiply the swept base knobs, so one trace composes with
    every grid axis.  ``cameras_active`` is the *fraction* of the
    configured cameras powered during the phase.
    """

    duration_s: float
    detnet_scale: float = 1.0
    keynet_scale: float = 1.0
    camera_fps_scale: float = 1.0
    cameras_active: float = 1.0


@dataclasses.dataclass(frozen=True)
class ScenarioTrace:
    """A named sequence of :class:`Phase` segments."""

    name: str
    phases: tuple[Phase, ...]

    @property
    def duration_s(self) -> float:
        return float(sum(p.duration_s for p in self.phases))


def _idle(duration_s):
    return Phase(duration_s, detnet_scale=0.25, keynet_scale=0.25,
                 camera_fps_scale=0.5, cameras_active=0.5)


#: Named user-behavior traces (the reference's four profiles).
PROFILES: Mapping[str, ScenarioTrace] = {
    "steady": ScenarioTrace("steady", (Phase(1800.0),)),
    "commute": ScenarioTrace("commute", (
        _idle(420.0),
        Phase(900.0),                                   # navigate, full rate
        Phase(180.0, detnet_scale=1.5, keynet_scale=1.2),   # interaction burst
        _idle(300.0),
    )),
    "workday": ScenarioTrace("workday", (
        _idle(1200.0),
        Phase(240.0),                                   # notification burst
        _idle(1200.0),
        Phase(240.0, detnet_scale=1.25),
        _idle(900.0),
    )),
    "gaming": ScenarioTrace("gaming", (
        Phase(300.0),                                   # lobby
        Phase(1200.0, detnet_scale=1.5, keynet_scale=1.2,
              camera_fps_scale=1.2),                    # match, high rate
        Phase(120.0, detnet_scale=0.5, keynet_scale=0.5,
              camera_fps_scale=0.5, cameras_active=0.5),    # cooldown
    )),
}


@dataclasses.dataclass(frozen=True)
class ScenarioSet:
    """Hashable bundle of traces + device dynamics for one sweep: what
    the ``scenarios=`` knob lowers to (:func:`as_scenario_set`).  The
    traces become the values of the trailing ``trace`` grid axis, in
    order."""

    traces: tuple[ScenarioTrace, ...]
    battery: BatterySpec = DEFAULT_BATTERY
    thermal: ThermalSpec = DEFAULT_THERMAL
    steps_per_phase: int = DEFAULT_STEPS_PER_PHASE
    throttle: bool = True

    def __post_init__(self):
        if not self.traces:
            raise ValueError("a ScenarioSet needs at least one trace")
        names = [t.name for t in self.traces]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate trace names: {names}")
        if self.steps_per_phase < 1:
            raise ValueError("steps_per_phase must be >= 1")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(t.name for t in self.traces)

    def only(self, name: str) -> "ScenarioSet":
        """The same set restricted to one named trace (winner rendering)."""
        for t in self.traces:
            if t.name == name:
                return dataclasses.replace(self, traces=(t,))
        raise KeyError(f"unknown trace {name!r}; have {self.names}")


def as_scenario_set(spec) -> ScenarioSet:
    """Lower the ``scenarios=`` knob into a canonical :class:`ScenarioSet`.

    Accepted: a :class:`ScenarioSet` (returned as-is), a profile name
    from :data:`PROFILES` (or ``"all"`` for every profile), a
    :class:`ScenarioTrace`, or an iterable mixing names and traces.
    """
    if isinstance(spec, ScenarioSet):
        return spec
    if isinstance(spec, str):
        spec = tuple(PROFILES) if spec == "all" else (spec,)
    elif isinstance(spec, ScenarioTrace):
        spec = (spec,)
    traces = []
    for t in spec:
        if isinstance(t, ScenarioTrace):
            traces.append(t)
        elif isinstance(t, str):
            if t not in PROFILES:
                raise ValueError(f"unknown scenario profile {t!r}; "
                                 f"have {tuple(PROFILES)}")
            traces.append(PROFILES[t])
        else:
            raise TypeError(f"scenarios entries must be trace names or "
                            f"ScenarioTrace, got {type(t).__name__}")
    return ScenarioSet(traces=tuple(traces))


# ---------------------------------------------------------------------------
# State-update physics (shared by the batched loop and simulate_session)
# ---------------------------------------------------------------------------


def throttle_factor(temp_c, thermal: ThermalSpec):
    """Rate multiplier ``clip(1 - gain * max(0, T - onset), floor, 1)``:
    exactly 1.0 at or below the onset temperature."""
    over = torch.maximum(torch.zeros_like(temp_c),
                         temp_c - thermal.throttle_onset_c)
    return torch.clamp(1.0 - thermal.throttle_gain_per_c * over,
                       thermal.throttle_floor, 1.0)


def thermal_step(temp_c, power_w, dt_s, thermal: ThermalSpec):
    """Exact RC step response under constant power for ``dt_s`` seconds:
    ``T' = T_ss + (T - T_ss) * exp(-dt / tau)`` with ``T_ss = T_amb + P *
    R`` and ``tau = R * C``."""
    t_ss = thermal.ambient_c + power_w * thermal.r_th_k_per_w
    decay = torch.exp(SW._div(-dt_s, thermal.r_th_k_per_w
                              * thermal.c_th_j_per_k))
    return t_ss + (temp_c - t_ss) * decay


def effective_drain_w(power_w, battery: BatterySpec):
    """Peukert-corrected drain ``P * (P / p_ref) ** (peukert - 1)``; at
    ``peukert == 1`` the exponent is exactly 0.0, the factor exactly 1.0
    and the drain bitwise linear."""
    return power_w * SW._div(power_w, battery.p_ref_w) ** (battery.peukert
                                                           - 1.0)


def _make_step(base_fn, sset: ScenarioSet):
    """The per-step state update ``(carry, cfg, x) -> carry``.

    One function object serves both the batched session evaluation and
    the loop of :func:`simulate_session`, which is why the two agree
    bitwise.  ``carry = (t, soc, temp, peak, throttled_s, energy, tte)``;
    ``cfg`` the ten static-config lane tensors of ``config_eval``; ``x =
    (dt, det_scale, key_scale, cam_scale, cams_active)``, one column of
    the step tables gathered per lane.
    """
    bat, th = sset.battery, sset.thermal

    def step(carry, cfg, x):
        t, soc, temp, peak, throttled_s, energy, tte = carry
        dt, dsc, ksc, csc, act = x
        (model_i, cut, agg_i, sen_i, wm_i, det_fps, key_fps, ncam,
         mipi_scale, cam_fps) = cfg
        thr = (throttle_factor(temp, th) if sset.throttle
               else torch.ones_like(temp))
        out = base_fn(model_i, cut, agg_i, sen_i, wm_i,
                      det_fps * (dsc * thr), key_fps * (ksc * thr),
                      ncam * act, mipi_scale, cam_fps * csc)
        power = out["avg_power"]
        drain = effective_drain_w(power, bat)
        soc_new = soc - SW._div(drain * dt, bat.capacity_j)
        temp_new = thermal_step(temp, power, dt, th)
        # Zero-duration steps (phase-count padding across the traces of
        # one set) are bitwise no-ops on every state variable.
        live = dt > 0.0
        soc_new = torch.where(live, soc_new, soc)
        temp_new = torch.where(live, temp_new, temp)
        # Exact in-step linear crossing (soc never increases, so there
        # is at most one crossing a session).
        cross = (soc > 0.0) & (soc_new <= 0.0)
        tte = torch.where(cross, t + SW._div(soc * bat.capacity_j, drain),
                          tte)
        return (t + dt, soc_new, temp_new, torch.maximum(peak, temp_new),
                throttled_s + dt * (thr < 1.0), energy + power * dt, tte)

    return step


def _finalize(carry, static_power, bat: BatterySpec):
    """Map the final carry to the four session channels.  Adding
    ``static_power * 0.0`` poisons every channel on invalid grid corners
    (a finite power adds an exact 0.0, and ``inf + 0.0`` keeps the
    never-empties sentinel)."""
    t_end, soc_end, _, peak, throttled_s, energy, tte = carry
    poison = static_power * 0.0
    drained = bat.soc0 - soc_end
    # No in-session crossing: extrapolate the whole-session average
    # drain cyclically (sessions repeat back-to-back until empty).
    extrap = torch.where(drained > 0.0, SW._div(t_end * bat.soc0, drained),
                         torch.full_like(drained, float("inf")))
    tte = torch.where(torch.isfinite(tte), tte, extrap)
    live = t_end > 0.0
    frac = torch.where(live, SW._div(throttled_s, torch.where(
        live, t_end, torch.ones_like(t_end))), torch.zeros_like(t_end))
    return {
        "session_energy_j": energy + poison,
        "time_to_empty_s": tte + poison,
        "peak_case_temp_c": peak + poison,
        "throttle_fraction": frac + poison,
    }


def _init_carry(sset: ScenarioSet, like):
    """The initial carry as float64 tensors shaped like ``like`` (a lane
    tensor; fills, so a CUDA graph can capture them)."""
    th = sset.thermal
    return tuple(torch.full_like(like, v, dtype=F64) for v in (
        0.0, sset.battery.soc0, th.ambient_c, th.ambient_c, 0.0, 0.0,
        float("inf")))


# ---------------------------------------------------------------------------
# Lowering: ScenarioSet -> step tables -> drop-in model stack
# ---------------------------------------------------------------------------


def _step_tables(sset: ScenarioSet) -> tuple[np.ndarray, ...]:
    """Lower the trace set to dense ``(n_traces, n_steps)`` step tables
    ``(dt, det_scale, key_scale, cam_scale, cams_active)``.  Each phase
    is split into ``steps_per_phase`` equal substeps; traces with fewer
    phases pad with zero-duration steps (exact no-ops)."""
    K = sset.steps_per_phase
    n_steps = max(len(t.phases) for t in sset.traces) * K
    tabs = [np.zeros((len(sset.traces), n_steps)) for _ in range(5)]
    for ti in range(1, 5):
        tabs[ti][:] = 1.0       # neutral scales in the padding
    for r, trace in enumerate(sset.traces):
        for p, ph in enumerate(trace.phases):
            cols = slice(p * K, (p + 1) * K)
            tabs[0][r, cols] = ph.duration_s / K
            tabs[1][r, cols] = ph.detnet_scale
            tabs[2][r, cols] = ph.keynet_scale
            tabs[3][r, cols] = ph.camera_fps_scale
            tabs[4][r, cols] = ph.cameras_active
    return tuple(tabs)


@dataclasses.dataclass(frozen=True, eq=False)
class ScenarioStack:
    """A scenario-wrapped model lowering: a drop-in for
    :class:`repro_torch.core.arrays.StackedModelArrays` in the backend
    layer.

    The backends only need ``is_scenario`` (the support gate),
    ``fields`` (``sweep.kernel_fields``) and the step tables (placed on
    the device by ``backend.device_tables``); node lookup, cut ranges
    and model names delegate to the wrapped stack.  Hashes by identity
    (``eq=False``) like the stack it wraps, which keys the step and
    dense-evaluator caches; checkpoint signatures hash it by *content*
    (``backend._hash_update`` recurses through the dataclass fields,
    the reference's bytes).
    """

    S: A.StackedModelArrays
    sset: ScenarioSet
    step_tables: tuple[np.ndarray, ...]

    #: Marker the backend support gate checks.
    is_scenario = True

    @property
    def fields(self) -> tuple[str, ...]:
        return SW.FIELDS + SW.SCENARIO_FIELDS

    @property
    def n_traces(self) -> int:
        return len(self.sset.traces)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(object.__getattribute__(self, "S"), name)


@functools.lru_cache(maxsize=16)
def scenario_stack(S: A.StackedModelArrays,
                   sset: ScenarioSet) -> ScenarioStack:
    """Lower (and cache, on ``(S identity, set content)``) one scenario
    set against one model stack."""
    return ScenarioStack(S=S, sset=sset, step_tables=_step_tables(sset))


def session_eval(stack: ScenarioStack, T, model_i, cut, agg_i, sen_i, wm_i,
                 det_fps, key_fps, ncam, mipi_scale, cam_fps,
                 trace_i) -> dict:
    """Every static field and the four session channels for every lane.

    ``T`` holds the wrapped stack's tables and the step tables
    (:data:`STEP_TABLES`, ``(n_traces, n_steps)`` each) on the lanes'
    device; the arguments are ``config_eval``'s ten lane tensors plus
    ``trace_i``.  The static fields are evaluated once at the base knobs
    (so a constant trace reproduces the static model bitwise); then a
    loop over the step columns, gathered by ``trace_i``, advances the
    carry with :func:`_make_step`'s step.
    """
    base_fn = functools.partial(SW.config_eval, T)
    static = base_fn(model_i, cut, agg_i, sen_i, wm_i, det_fps, key_fps,
                     ncam, mipi_scale, cam_fps)
    step = _make_step(base_fn, stack.sset)
    cfg = (model_i, cut, agg_i, sen_i, wm_i, det_fps, key_fps, ncam,
           mipi_scale, cam_fps)
    xs = tuple(T[name][trace_i] for name in STEP_TABLES)   # (n, n_steps)
    carry = _init_carry(stack.sset, det_fps)
    for s in range(xs[0].shape[-1]):
        carry = step(carry, cfg, tuple(x[..., s] for x in xs))
    out = dict(static)
    out.update(_finalize(carry, static["avg_power"], stack.sset.battery))
    return out


# ---------------------------------------------------------------------------
# Loop twin (docs, tests, trajectory rendering)
# ---------------------------------------------------------------------------


def simulate_session(scenarios="steady", trace: str | None = None,
                     cut: int = 0, agg_node="7nm", sensor_node="7nm",
                     sensor_weight_mem: str = "sram",
                     detnet_fps: float = DETNET_FPS,
                     keynet_fps: float = KEYNET_FPS,
                     num_cameras: float = NUM_CAMERAS,
                     mipi_energy_scale: float = 1.0,
                     camera_fps: float = CAMERA_FPS,
                     detnet=None, keynet=None, device="cuda") -> dict:
    """Simulate one configuration through one trace, step by step.

    The twin of the batched session evaluation: a host loop over the
    rows of the step table calling the *same* step function
    (:func:`_make_step`) on one-lane tensors on ``device``, so its final
    state is bitwise the batched path's on that device.  Returns
    per-step trajectory arrays (``t_s``, ``soc``, ``temp_c``,
    ``energy_j``, ``power_w``, ``throttle``) plus the four session
    channels.
    """
    from . import backend as B

    dev = SW.resolve_device(device)
    sset = as_scenario_set(scenarios)
    if trace is None:
        trace = sset.traces[0].name
    sset = sset.only(trace)
    S = A.stack_model_arrays((A.model_arrays(detnet, keynet),))
    stack = scenario_stack(S, sset)
    T = B.device_tables(stack, dev)
    base_fn = functools.partial(SW.config_eval, T)
    step = _make_step(base_fn, sset)
    wm_i = A.WEIGHT_MEM_KINDS.index(sensor_weight_mem)

    def lane(v, dtype):
        return torch.tensor([v], dtype=dtype, device=dev)

    cfg = (tuple(lane(v, torch.int64) for v in (
        0, int(cut), S.node_index(agg_node), S.node_index(sensor_node),
        wm_i))
        + tuple(lane(float(v), F64) for v in (
            detnet_fps, keynet_fps, num_cameras, mipi_energy_scale,
            camera_fps)))
    carry = _init_carry(sset, cfg[5])
    rows = np.stack(stack.step_tables, axis=-1)[0]       # (n_steps, 5)

    def host(v):
        return float(v.cpu()[0])

    traj = {"t_s": [0.0], "soc": [host(carry[1])],
            "temp_c": [host(carry[2])], "energy_j": [0.0], "throttle": []}
    for x in rows:
        thr = (host(throttle_factor(carry[2], sset.thermal))
               if sset.throttle else 1.0)
        carry = step(carry, cfg, tuple(lane(float(v), F64) for v in x))
        traj["t_s"].append(host(carry[0]))
        traj["soc"].append(host(carry[1]))
        traj["temp_c"].append(host(carry[2]))
        traj["energy_j"].append(host(carry[5]))
        traj["throttle"].append(thr)
    out = {k: np.asarray(v) for k, v in traj.items()}
    # Per-step power from the energy accumulator's differences (NaN
    # across zero-duration padding steps).
    dt = np.diff(out["t_s"])
    with np.errstate(invalid="ignore", divide="ignore"):
        out["power_w"] = np.where(
            dt > 0, np.diff(out["energy_j"]) / np.where(dt > 0, dt, 1.0),
            np.nan)
    static = base_fn(*cfg)
    final = _finalize(carry, static["avg_power"], sset.battery)
    out.update({k: host(v) for k, v in final.items()})
    out["final_carry"] = tuple(host(v) for v in carry)
    return out
