"""Gradient-based search over the continuous design knobs (the port of the
reference ``repro.core.optimize``).

The Eq. 1-11 model of :mod:`repro_torch.core.sweep` is differentiable
end to end with respect to every float knob (DetNet/KeyNet rates, the
MIPI energy scale, the camera frame rate), so instead of densifying a
grid axis until the optimum is resolved, this module drives float64
``torch.autograd`` straight through the analytical model:

* :func:`objective_fn` — a differentiable scalarized objective (a
  weighted sum of model channels, e.g. ``{"avg_power": 1, "latency":
  10}``) closed over one *discrete* configuration (cut, nodes, weight
  memory, camera count).
* :func:`evaluate` / :func:`gradient` / :func:`evaluate_fields` — scalar
  conveniences (float64, as the grid engine).
* :func:`optimize_knobs` — projected Adam over box-bounded knobs,
  normalized to [0, 1] over their bounds so one learning rate serves
  mixed scales; the update is :mod:`repro_torch.optim.adamw` with its
  cosine decay (float32 moments and update, as the reference's), and
  every step projects back into the box.
* :func:`grid_argmin` — the dense-grid cross-check: the same scalarized
  objective minimized by brute force over ``sweep.evaluate_grid`` on the
  same bounds (on a CUDA device one launch of kernel B).

The gradient runs through the plain Eq. 1-11 (``sweep.config_eval``), as
the reference's runs through plain ``jnp``: no kernel has a backward
pass.  Every entry point takes ``device=`` (default ``"cuda"``, which
raises without a card; ``device="cpu"`` runs on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from ..optim import adamw
from . import arrays as A
from . import sweep as S
from .constants import CAMERA_FPS, DETNET_FPS, KEYNET_FPS, NUM_CAMERAS

F64 = torch.float64

#: The continuous knobs of the kernel, in its argument order.
KNOBS = ("detnet_fps", "keynet_fps", "mipi_energy_scale", "camera_fps")

_KNOB_DEFAULTS = dict(detnet_fps=DETNET_FPS, keynet_fps=KEYNET_FPS,
                      mipi_energy_scale=1.0, camera_fps=CAMERA_FPS)

_CONFIG_KEYS = frozenset(
    ("cut", "agg_node", "sensor_node", "weight_mem", "num_cameras",
     "model")) | frozenset(KNOBS)


def _weights(objective) -> dict[str, float]:
    """Normalize an objective spec to ``{channel: weight}``."""
    if isinstance(objective, str):
        objective = {objective: 1.0}
    w = {k: float(v) for k, v in objective.items()}
    unknown = sorted(set(w) - set(S.FIELDS))
    if unknown or not w:
        raise ValueError(f"bad objective channels {unknown}; "
                         f"have {S.FIELDS}")
    return w


def _check_knobs(names: Sequence[str]):
    unknown = sorted(set(names) - set(KNOBS))
    if unknown:
        raise ValueError(f"unknown knobs {unknown}; have {KNOBS}")


@dataclasses.dataclass(frozen=True)
class _Resolved:
    """A validated discrete configuration + fixed-knob defaults."""

    M: A.ModelArrays
    cut: int
    agg_i: int
    sen_i: int
    wm_i: int
    num_cameras: float
    base_knobs: dict    # every KNOB bound to its fixed (default) value

    def kernel_kwargs(self, knobs: Mapping) -> tuple:
        kw = {**self.base_knobs, **knobs}
        return (self.cut, self.agg_i, self.sen_i, self.wm_i,
                kw["detnet_fps"], kw["keynet_fps"], self.num_cameras,
                kw["mipi_energy_scale"], kw["camera_fps"])


def _resolve(config: Mapping) -> _Resolved:
    unknown = sorted(set(config) - _CONFIG_KEYS)
    if unknown:
        raise ValueError(f"unknown config keys {unknown}; "
                         f"have {sorted(_CONFIG_KEYS)}")
    if "cut" not in config:
        raise ValueError("a discrete configuration needs cut=<int>")
    model = config.get("model")
    M = model if model is not None else A.model_arrays()
    cut = int(config["cut"])
    if not 0 <= cut < M.n_cuts:
        raise ValueError(f"cut {cut} outside [0, {M.n_cuts - 1}]")
    agg_i = M.node_index(config.get("agg_node", "7nm"))
    sen_i = M.node_index(config.get("sensor_node", "7nm"))
    wm = config.get("weight_mem", "sram")
    if wm not in A.WEIGHT_MEM_KINDS:
        raise ValueError(f"unknown weight_mem {wm!r}; "
                         f"have {A.WEIGHT_MEM_KINDS}")
    wm_i = A.WEIGHT_MEM_KINDS.index(wm)
    ncam = config.get("num_cameras", NUM_CAMERAS)
    if ncam < 1 or ncam % 1:
        raise ValueError("num_cameras must be an integer >= 1")
    # Mirror the scalar path: refuse impossible memory choices eagerly
    # instead of silently optimizing a NaN landscape.
    if cut > 0 and np.isnan(M.wm_e_read[sen_i, wm_i]):
        raise ValueError(f"no {wm.upper()} test vehicle at "
                         f"{M.node_names[sen_i]}")
    fixed = {k: float(config[k]) for k in KNOBS if k in config}
    return _Resolved(M=M, cut=cut, agg_i=agg_i, sen_i=sen_i, wm_i=wm_i,
                     num_cameras=float(ncam),
                     base_knobs={**_KNOB_DEFAULTS, **fixed})


def objective_fn(objective="avg_power", *, device="cuda",
                 **config) -> Callable:
    """Build a differentiable scalarized objective over the continuous
    knobs.

    ``objective`` is a model channel name or a ``{channel: weight}``
    mapping (see ``sweep.FIELDS``); ``config`` fixes the discrete
    configuration (``cut=`` required; ``agg_node``/``sensor_node``/
    ``weight_mem``/``num_cameras``/``model`` optional) and may pin any
    knob of :data:`KNOBS` to a non-default fixed value.

    Returns ``f(knobs: Mapping[str, Tensor]) -> Tensor`` (0-d float64 on
    ``device``) where ``knobs`` binds any subset of :data:`KNOBS` to
    float64 tensors (or Python floats).  The discrete configuration is
    validated eagerly: an MRAM request on a node with no test vehicle
    raises here, mirroring the scalar path, instead of yielding NaN.
    """
    w = _weights(objective)
    r = _resolve(config)
    kernel = S.config_kernel(r.M, device)

    def f(knobs: Mapping) -> torch.Tensor:
        _check_knobs(knobs)
        out = kernel(*r.kernel_kwargs(knobs))
        return sum(wi * out[k] for k, wi in w.items())

    return f


def _knob_tensors(knobs: Mapping, device, grad: bool = False) -> dict:
    return {k: torch.tensor(float(v), dtype=F64, device=device,
                            requires_grad=grad)
            for k, v in knobs.items()}


def evaluate(objective="avg_power", knobs: Mapping[str, float] | None = None,
             *, device="cuda", **config) -> float:
    """Scalarized objective value at one knob setting (float64)."""
    dev = S.resolve_device(device)
    f = objective_fn(objective, device=dev, **config)
    with torch.no_grad():
        return float(f(_knob_tensors(knobs or {}, dev)))


def evaluate_fields(knobs: Mapping[str, float] | None = None, *,
                    device="cuda", **config) -> dict[str, float]:
    """Every model channel at one knob setting, like ``sweep.evaluate_one``
    but resolved through the optimizer's config/knob plumbing (custom
    ``model=`` lowerings included)."""
    dev = S.resolve_device(device)
    r = _resolve(config)
    kernel = S.config_kernel(r.M, dev)
    with torch.no_grad():
        out = kernel(*r.kernel_kwargs(_knob_tensors(knobs or {}, dev)))
        return {k: float(v) for k, v in out.items()}


def _value_and_grad(f, x: Mapping[str, torch.Tensor]):
    """``(f(x), {knob: df/dknob})`` through float64 autograd; a knob the
    objective does not read has gradient 0, as under ``jax.grad``."""
    x = {k: v.detach().requires_grad_(True) for k, v in x.items()}
    v = f(x)
    g = torch.autograd.grad(v, list(x.values()), allow_unused=True)
    return v.detach(), {k: (torch.zeros_like(t) if gi is None else gi)
                        for (k, t), gi in zip(x.items(), g)}


def gradient(objective="avg_power", knobs: Mapping[str, float] | None = None,
             *, device="cuda", **config) -> tuple[float, dict[str, float]]:
    """``(value, {knob: d objective / d knob})`` by float64 autograd
    through the Eq. 1-11 model at one knob setting (all four knobs, at
    their config-pinned or default values, when ``knobs`` is omitted)."""
    dev = S.resolve_device(device)
    f = objective_fn(objective, device=dev, **config)
    at = dict(knobs) if knobs is not None else _resolve(config).base_knobs
    v, g = _value_and_grad(f, _knob_tensors(at, dev))
    return float(v), {k: float(x) for k, x in g.items()}


@dataclasses.dataclass(frozen=True)
class KnobOptResult:
    """Outcome of one projected-Adam knob search."""

    knobs: dict[str, float]        # optimized knob values (de-normalized)
    objective: float               # scalarized objective at ``knobs``
    weights: dict[str, float]      # the scalarization used
    fields: dict[str, float]       # every model channel at the optimum
    trajectory: np.ndarray         # objective value at each iterate
    steps: int


def optimize_knobs(bounds: Mapping[str, tuple[float, float]],
                   objective="avg_power", *,
                   steps: int = 200,
                   lr: float = 0.05,
                   init: Mapping[str, float] | None = None,
                   device="cuda",
                   **config) -> KnobOptResult:
    """Projected-Adam minimization of a scalarized objective over knobs.

    ``bounds`` maps knob name -> ``(lo, hi)`` box constraints and selects
    which knobs are optimized (the rest stay fixed); ``config`` carries
    the discrete configuration of :func:`objective_fn` (``cut=...``
    required).  Optimization runs in [0, 1]-normalized knob space with a
    cosine-decayed Adam (:mod:`repro_torch.optim.adamw`), clipping back
    into the box after every step, and returns the best iterate seen.

    ``trajectory[i]`` is the objective at the iterate step ``i`` started
    from, and ``trajectory[steps]`` at the last iterate; the best is the
    first minimum of the trajectory.  The search is local: cross-check
    against :func:`grid_argmin` when the objective may be multi-modal.
    """
    if not bounds:
        raise ValueError("bounds must select at least one knob")
    _check_knobs(bounds)
    names = tuple(bounds)
    lo = {n: float(bounds[n][0]) for n in names}
    hi = {n: float(bounds[n][1]) for n in names}
    for n in names:
        if not hi[n] > lo[n]:
            raise ValueError(f"degenerate bounds for {n}: {bounds[n]}")
    w = _weights(objective)
    dev = S.resolve_device(device)
    f = objective_fn(w, device=dev, **config)

    cfg = adamw.AdamWConfig(lr=lr, warmup_steps=0, total_steps=steps,
                            min_lr_ratio=0.02, weight_decay=0.0)

    def denorm(x):
        return {n: lo[n] + x[n] * (hi[n] - lo[n]) for n in names}

    def loss(x):
        return f(denorm(x))

    def f64(v):
        return torch.tensor(float(v), dtype=F64, device=dev)

    if init is None:
        x = {n: f64(0.5) for n in names}
    else:
        # tensor / tensor: the IEEE quotient on any device
        x = {n: torch.clamp((f64(init[n]) - lo[n]) / f64(hi[n] - lo[n]),
                            0.0, 1.0) for n in names}
    st = adamw.init(cfg, x)
    traj = np.empty(steps + 1, np.float64)
    best_v, best_x = np.inf, x
    for i in range(steps):
        v, g = _value_and_grad(loss, x)
        x2, st, _ = adamw.apply(cfg, x, g, st)
        x_before, x = x, {n: torch.clamp(x2[n], 0.0, 1.0) for n in names}
        traj[i] = float(v)
        if traj[i] < best_v:
            best_v, best_x = traj[i], x_before
    with torch.no_grad():
        traj[steps] = float(loss(x))
    if traj[steps] < best_v:
        best_v, best_x = traj[steps], x
    knobs = {n: float(v) for n, v in denorm(best_x).items()}

    return KnobOptResult(knobs=knobs, objective=best_v, weights=w,
                         fields=evaluate_fields(knobs, device=dev, **config),
                         trajectory=traj, steps=steps)


def grid_argmin(bounds: Mapping[str, tuple[float, float]],
                objective="avg_power", *,
                n: int = 33,
                device="cuda",
                **config) -> tuple[dict[str, float], float]:
    """Dense-grid brute force of the same scalarized objective.

    Evaluates ``sweep.evaluate_grid`` with ``n`` points per bounded knob
    (other knobs fixed as in :func:`objective_fn`; on a CUDA device one
    launch of kernel B) and returns ``(knobs, value)`` at the grid
    minimum: the cross-check oracle for :func:`optimize_knobs`, accurate
    to one grid step.
    """
    if not bounds:
        raise ValueError("bounds must select at least one knob")
    _check_knobs(bounds)
    r = _resolve(config)
    axes = {}
    for k in KNOBS:
        if k in bounds:
            axes[k] = tuple(np.linspace(bounds[k][0], bounds[k][1], n))
        else:
            axes[k] = (r.base_knobs[k],)
    res = S.evaluate_grid(
        cuts=(r.cut,),
        agg_nodes=(r.M.node_names[r.agg_i],),
        sensor_nodes=(r.M.node_names[r.sen_i],),
        weight_mems=(A.WEIGHT_MEM_KINDS[r.wm_i],),
        num_cameras=(r.num_cameras,),
        detnet_fps=axes["detnet_fps"], keynet_fps=axes["keynet_fps"],
        mipi_energy_scale=axes["mipi_energy_scale"],
        camera_fps=axes["camera_fps"],
        model=r.M, device=device)
    W = scalarize(res, objective)
    flat = int(np.nanargmin(W))
    cfg = res.config_at(flat)
    return ({k: float(cfg[k]) for k in bounds}, float(W.ravel()[flat]))


def scalarize(result: S.SweepResult, objective) -> np.ndarray:
    """Weighted-sum objective over a stored grid: the scalarization of
    :func:`objective_fn`, evaluated on ``SweepResult`` channels."""
    w = _weights(objective)
    return sum(wi * np.asarray(result.data[k], np.float64)
               for k, wi in w.items())
