"""Workload partition optimizer across the distributed compute hierarchy.

The PyTorch port of the reference ``repro.core.partition``.  The paper's
central system knob: where to cut the CV pipeline between the on-sensor
processor and the aggregator.  The hand-tracking pipeline is

    raw frame -> DetNet -> (boxes back to sensor) -> ROI crop -> KeyNet -> kp

and every layer boundary is a legal cut.  For cut index ``k`` over the
concatenated layer list (DetNet ++ KeyNet):

* ``k == 0``                  — fully centralized (Fig. 1a): the raw frame
  crosses MIPI at camera rate (the aggregator needs it for the ROI crop).
* ``0 < k < len(DetNet)``     — DetNet is split: the cut activation crosses
  MIPI at DetNet rate, *and* the ROI crop still has to cross at KeyNet rate
  (the raw frame only exists on-sensor; box coords return over MIPI, tiny).
* ``k == len(DetNet)``        — the paper's choice (Fig. 2): only the ROI
  (at KeyNet rate) + DetNet outputs (at DetNet rate) cross MIPI.
* ``k > len(DetNet)``         — KeyNet is split: the KeyNet cut activation
  crosses at KeyNet rate; ROI stays on-sensor.

**Two evaluation paths share these semantics.**  :func:`evaluate_cut` is
the *scalar* path: plain Python over the full, named ``ModuleEnergy`` list
of one configuration (the per-module report behind the Fig. 5 stacked
bars).  Grid-scale exploration belongs to the *array* path,
:func:`repro_torch.core.sweep.evaluate_grid` (and, past
:data:`STREAM_THRESHOLD` configurations,
:func:`repro_torch.core.stream.stream_grid`), which evaluates the same
Eqs. 1-11 on the device.  Both derive what crosses MIPI at each cut from
:func:`repro_torch.core.arrays.mipi_payloads`.  :func:`optimal_partition`
uses the array engine to locate the minimum of one objective channel and
the scalar path to render its report.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import energy as E
from .arrays import RATE_CAMERA, RATE_DETNET, RATE_KEYNET, mipi_payloads
from .constants import (CAMERA_FPS, DETNET_FPS, KEYNET_FPS, MIPI,
                        NUM_CAMERAS, ON_SENSOR_SCALE, SENSOR_L1_BYTES,
                        T_SENSE_S, TECH_NODES, UTSV, TechNode)
from .handtracking import FULL_FRAME_BYTES, build_detnet, build_keynet
from .latency import cut_latency
from .system import (Deployment, MemKind, ProcessorSite, SystemReport,
                     _camera_modules, _link_modules, _resolve_node,
                     replicate_site_modules)
from .workloads import NNWorkload

#: SweepResult channels / PartitionPoint attributes ``optimal_partition``
#: can minimize (the paper's three headline objectives).
OBJECTIVES = ("avg_power", "latency", "mipi_bytes_per_s")

#: Session-level channels, available when ``scenarios=`` is passed (the
#: battery/thermal session simulator of :mod:`repro_torch.core.scenario`).
#: All are minimized except ``time_to_empty_s``, which is maximized.
SESSION_OBJECTIVES = ("session_energy_j", "time_to_empty_s",
                      "peak_case_temp_c", "throttle_fraction")

#: Objective channels where "optimal" means the *largest* value.
_MAXIMIZED = ("time_to_empty_s",)

#: Grid size above which ``optimal_partition`` routes the search through
#: the streaming executor (`repro_torch.core.stream.stream_grid`) instead
#: of materializing a dense grid.
STREAM_THRESHOLD = 1 << 20

#: evaluate_cut kwarg for each sweep axis name (the winner of a grid /
#: stream search is rendered through the scalar path with these).
_AXIS_TO_KWARG = {"agg_node": "agg_node", "sensor_node": "sensor_node",
                  "weight_mem": "sensor_weight_mem",
                  "detnet_fps": "detnet_fps", "keynet_fps": "keynet_fps",
                  "num_cameras": "num_cameras",
                  "mipi_energy_scale": "mipi_energy_scale",
                  "camera_fps": "camera_fps"}


@dataclasses.dataclass(frozen=True)
class PartitionPoint:
    """One fully-evaluated partition cut: the three objective scalars
    (``avg_power`` W, ``latency`` s, ``mipi_bytes_per_s`` B/s) plus the
    named per-module :class:`~repro_torch.core.system.SystemReport`."""

    cut: int
    label: str
    avg_power: float
    mipi_bytes_per_s: float
    sensor_macs_per_s: float
    latency: float
    report: SystemReport
    #: Winning trace name and session channel dict (the four
    #: :data:`SESSION_OBJECTIVES` values) — populated only by scenario
    #: searches (``optimal_partition(..., scenarios=...)``).
    trace: str | None = None
    session: dict | None = None


def _sub_workload(wl: NNWorkload, lo: int, hi: int,
                  name: str) -> NNWorkload | None:
    layers = wl.layers[lo:hi]
    if not layers:
        return None
    return NNWorkload(name=name, layers=tuple(layers),
                      input_bytes=layers[0].in_act_bytes,
                      output_bytes=layers[-1].out_act_bytes)


def evaluate_cut(cut: int,
                 agg_node: str | TechNode = "7nm",
                 sensor_node: str | TechNode = "7nm",
                 sensor_weight_mem: MemKind = "sram",
                 detnet: NNWorkload | None = None,
                 keynet: NNWorkload | None = None,
                 num_cameras: int = NUM_CAMERAS,
                 camera_fps: float = CAMERA_FPS,
                 detnet_fps: float = DETNET_FPS,
                 keynet_fps: float = KEYNET_FPS,
                 mipi_energy_scale: float = 1.0) -> PartitionPoint:
    """Build the full Eq.1/2 module list for one partition point.

    This is the scalar, fully-annotated single-config path; for sweeps use
    :func:`repro_torch.core.sweep.evaluate_grid`.  ``mipi_energy_scale``
    multiplies the MIPI energy/byte (the Eq. 5 sensitivity knob) without
    touching the link bandwidth.
    """
    detnet = detnet or build_detnet()
    keynet = keynet or build_keynet()
    agg_n = _resolve_node(agg_node)
    sen_n = _resolve_node(sensor_node)
    n_det = len(detnet.layers)
    n_all = n_det + len(keynet.layers)
    if not 0 <= cut <= n_all:
        raise ValueError(f"cut {cut} outside [0, {n_all}]")
    if num_cameras < 1:
        raise ValueError("num_cameras must be >= 1")
    mipi = MIPI if mipi_energy_scale == 1.0 else dataclasses.replace(
        MIPI, energy_per_byte=MIPI.energy_per_byte * mipi_energy_scale)

    mods: list[E.ModuleEnergy] = []
    centralized = cut == 0
    cam_link = mipi if centralized else UTSV
    mods += _camera_modules(num_cameras, readout_link=cam_link,
                            fps=camera_fps, t_sense=T_SENSE_S)
    if not centralized:
        mods += _link_modules(num_cameras, UTSV, FULL_FRAME_BYTES,
                              camera_fps, tag="utsv")

    # ---- what crosses MIPI (shared plan with the array engine) ----
    rate_of = {RATE_CAMERA: camera_fps, RATE_DETNET: detnet_fps,
               RATE_KEYNET: keynet_fps}
    payload_plan = mipi_payloads(cut, detnet, keynet)
    mipi_payload_rates = [(b, rate_of[tag]) for b, tag in payload_plan]
    for i, (b, r) in enumerate(mipi_payload_rates):
        mods += _link_modules(num_cameras, mipi, b, r, tag=f"mipi.{i}")

    # ---- sensor-side deployment (identical per camera: build once) ----
    sensor_wls: list[tuple[NNWorkload, float]] = []
    det_s = _sub_workload(detnet, 0, min(cut, n_det), "DetNet.sensor")
    if det_s:
        sensor_wls.append((det_s, detnet_fps))
    key_s = _sub_workload(keynet, 0, max(0, cut - n_det), "KeyNet.sensor")
    if key_s:
        sensor_wls.append((key_s, keynet_fps))
    if not centralized:
        sensor0 = Deployment(
            site=ProcessorSite(name="sensor0", node=sen_n,
                               scale=ON_SENSOR_SCALE,
                               weight_mem=sensor_weight_mem,
                               l1_bytes=SENSOR_L1_BYTES),
            workloads=list(sensor_wls),
            extra_buffer_bytes=detnet.input_bytes,
        ).modules()
        mods += replicate_site_modules(sensor0, "sensor0", num_cameras)

    # ---- aggregator-side deployment ----
    agg_wls: list[tuple[NNWorkload, float]] = []
    det_a = _sub_workload(detnet, min(cut, n_det), n_det, "DetNet.agg")
    if det_a:
        agg_wls.append((det_a, detnet_fps * num_cameras))
    key_a = _sub_workload(keynet, max(0, cut - n_det), len(keynet.layers),
                          "KeyNet.agg")
    if key_a:
        agg_wls.append((key_a, keynet_fps * num_cameras))
    in_buf = max(b for b, _ in mipi_payload_rates) * num_cameras
    if agg_wls:
        mods += Deployment(
            site=ProcessorSite(name="agg", node=agg_n, scale=1.0),
            workloads=agg_wls,
            extra_buffer_bytes=in_buf,
        ).modules()

    label = ("centralized" if centralized else
             "paper-split(DetNet|KeyNet)" if cut == n_det else
             f"cut@{cut}")
    rep = SystemReport(name=f"partition[{label}]", modules=mods)
    mipi_rate = sum(b * r for b, r in mipi_payload_rates) * num_cameras
    sensor_macs = sum(w.total_macs * f for w, f in sensor_wls) * num_cameras
    lat = cut_latency(cut, agg_node=agg_n, sensor_node=sen_n,
                      detnet=detnet, keynet=keynet,
                      num_cameras=num_cameras, camera_fps=camera_fps,
                      detnet_fps=detnet_fps, keynet_fps=keynet_fps)
    return PartitionPoint(cut=cut, label=label, avg_power=rep.avg_power,
                          mipi_bytes_per_s=mipi_rate,
                          sensor_macs_per_s=sensor_macs,
                          latency=lat.total, report=rep)


def sweep_partitions(**kw) -> list[PartitionPoint]:
    """Scalar sweep over every cut, with full per-module reports.

    For grids beyond a single axis (or when reports are not needed) use
    :func:`repro_torch.core.sweep.evaluate_grid`.
    """
    detnet = kw.get("detnet") or build_detnet()
    keynet = kw.get("keynet") or build_keynet()
    kw["detnet"], kw["keynet"] = detnet, keynet
    n_all = len(detnet.layers) + len(keynet.layers)
    return [evaluate_cut(c, **kw) for c in range(n_all + 1)]


def _registry_name(node: str | TechNode) -> str | None:
    """Registry key for a node, or None if it isn't the registered object."""
    if isinstance(node, str):
        return node if node in TECH_NODES else None
    return node.name if TECH_NODES.get(node.name) is node else None


def _is_axis(v) -> bool:
    return isinstance(v, (list, tuple, np.ndarray))


def optimal_partition(engine: str = "array",
                      objective: str = "avg_power",
                      constraints=None, backend: str | None = None,
                      scenarios=None,
                      checkpoint_dir: str | None = None,
                      checkpoint_every_s: float | None = None,
                      device="cuda",
                      **kw) -> PartitionPoint:
    """Optimal partition point along one objective (Fig. 2 generalized).

    ``objective`` selects which channel is minimized over the cut axis —
    one of :data:`OBJECTIVES`, or with ``scenarios=`` one of
    :data:`SESSION_OBJECTIVES`.  ``constraints`` restricts the search to
    feasible configurations (:func:`repro_torch.core.sweep.
    parse_constraints`); raises :class:`ValueError` when none is.

    Any knob may also be a *sequence* (e.g. ``sensor_node=("7nm",
    "16nm")``, ``detnet_fps=np.linspace(5, 30, 50)``, or an explicit
    ``cuts=`` axis) — the search then runs over the full cartesian grid
    of all sequence-valued knobs × every cut.  Grids up to
    :data:`STREAM_THRESHOLD` configurations are evaluated densely
    (:func:`~repro_torch.core.sweep.evaluate_grid`); larger ones stream
    (:func:`~repro_torch.core.stream.stream_grid`).  Only the winner is
    rendered through the scalar path.

    With scalar knobs, ``engine="array"`` (default) evaluates the cut
    axis with the grid engine; ``engine="scalar"`` forces the full scalar
    sweep.  Custom ``TechNode`` objects outside the registry fall back to
    the scalar engine automatically.

    ``backend`` names the array engines' evaluation backend (``"torch"``,
    ``"cuda"``, or ``None`` for ``device``'s default, which is
    ``"torch"`` for a scenario search); ``device`` is where they run
    (``"cuda"`` by default, which raises without a card; pass ``"cpu"``
    for the plain PyTorch path).

    ``scenarios`` runs the search at *session* level: every
    configuration is simulated through the given user-behavior traces (a
    :class:`~repro_torch.core.scenario.ScenarioSet`, profile name(s), or
    ``"all"``), the trace becomes one more search axis, and ``objective``
    may then be any of :data:`SESSION_OBJECTIVES` (``time_to_empty_s``
    is maximized, the rest minimized).  The returned point carries the
    winning ``trace`` and a ``session`` dict of the four session
    channels.  Constraints may mix static and session channels.

    ``checkpoint_dir`` (with optional ``checkpoint_every_s``) makes the
    streaming route fault-tolerant: searches above
    :data:`STREAM_THRESHOLD` configurations snapshot their running
    reductions there and resume bitwise after a crash (see
    :func:`repro_torch.core.stream.stream_grid`).  Dense and scalar
    searches finish in one pass and ignore both.
    """
    if objective not in OBJECTIVES + SESSION_OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; "
                         f"have {OBJECTIVES} plus the session channels "
                         f"{SESSION_OBJECTIVES} (which require scenarios=)")
    if objective in SESSION_OBJECTIVES and scenarios is None:
        raise ValueError(
            f"objective {objective!r} is a session channel; pass "
            f"scenarios= (a ScenarioSet, profile name, or 'all' — see "
            f"repro_torch.core.scenario)")
    sset = None
    if scenarios is not None:
        from . import scenario as _scenario
        sset = _scenario.as_scenario_set(scenarios)
    from . import backend as _backend
    from . import sweep as _sweep
    dev = _sweep.resolve_device(device)
    if backend is not None and engine == "scalar":
        raise ValueError("backend= applies to the array/streaming "
                         "engines; engine='scalar' evaluates none")
    # fail fast, naming the backends
    _backend.get_backend(backend, dev, sset is not None)
    known = set(_AXIS_TO_KWARG.values()) | {"detnet", "keynet", "cuts"}
    unknown_kw = sorted(set(kw) - known)
    if unknown_kw:
        # The grid branch rebuilds its evaluate_cut call from the axis
        # map, so a misspelled knob would otherwise be dropped silently.
        raise TypeError(f"unknown knobs {unknown_kw}; have {sorted(known)}")

    cons = _sweep.parse_constraints(constraints)

    def constrained_best(res):
        if cons:
            res = res.constrain(cons)
            # isnan (not isfinite): time_to_empty_s is legitimately +inf
            # for configurations that drain nothing.
            if np.isnan(res.data[objective]).all():
                raise ValueError(
                    "no configuration satisfies constraints ("
                    + ", ".join(f"{f} {op} {v:g}" for f, op, v in cons)
                    + ") — loosen the constraints or widen the knobs")
        if objective in _MAXIMIZED:
            neg = dataclasses.replace(
                res, data={**dict(res.data),
                           objective: -np.asarray(res.data[objective])})
            win = neg.argmin(objective)
            win[objective] = -win[objective]
            return win
        return res.argmin(objective)

    cuts = kw.pop("cuts", None)
    if cuts is not None:
        cuts = tuple(cuts)        # may be a generator: materialize once
    multi = cuts is not None or sset is not None or any(
        _is_axis(v) for k, v in kw.items() if k not in ("detnet", "keynet"))
    if multi:
        if engine != "array":
            raise ValueError("sequence-valued knobs (cuts= or scenarios=) "
                             "require engine='array'")
        axes = _sweep.scalar_axes(kw)
        for name in ("agg_nodes", "sensor_nodes"):
            bad = [n for n in axes[name] if _registry_name(n) is None]
            if bad:
                raise ValueError(f"{name} entries outside the TECH_NODES "
                                 f"registry not supported in a grid "
                                 f"search: {bad}")
        # Same eager guard as the scalar path: if *every* (sensor node,
        # weight mem) combination lacks a test vehicle, all cut > 0
        # corners are NaN and the argmin would quietly return the one
        # valid centralized point instead of surfacing the error.
        if all(m == "mram" and _resolve_node(n).mram is None
               for m in axes["weight_mems"] for n in axes["sensor_nodes"]):
            raise ValueError(
                "no MRAM test vehicle at any requested sensor node "
                f"{tuple(_resolve_node(n).name for n in axes['sensor_nodes'])}"
                " — every distributed (cut > 0) configuration is invalid")
        n_det = len((kw.get("detnet") or build_detnet()).layers)
        n_key = len((kw.get("keynet") or build_keynet()).layers)
        n_configs = len(cuts) if cuts is not None else n_det + n_key + 1
        for name in ("agg_nodes", "sensor_nodes", "weight_mems",
                     "detnet_fps", "keynet_fps", "num_cameras",
                     "mipi_energy_scale", "camera_fps"):
            n_configs *= len(axes[name])
        if sset is not None:
            n_configs *= len(sset.traces)
        if n_configs > STREAM_THRESHOLD:
            from . import stream as _stream
            ckpt_kw = {}
            if checkpoint_dir is not None:
                ckpt_kw["checkpoint_dir"] = checkpoint_dir
                if checkpoint_every_s is not None:
                    ckpt_kw["checkpoint_every_s"] = checkpoint_every_s
            maximize = ((objective,) if objective in _MAXIMIZED else ())
            sres = _stream.stream_grid(
                cuts=cuts, objectives=(objective,), maximize=maximize,
                constraints=cons, backend=backend, scenarios=sset,
                device=dev, **ckpt_kw, **axes)
            # StreamResult.argmin minimizes the natural orientation;
            # under maximize= the best point heads the top-k table.
            win = (sres.top_k(objective)[0] if maximize
                   else sres.argmin(objective))
        else:
            win = constrained_best(_sweep.evaluate_grid(
                cuts=cuts, backend=backend, scenarios=sset, device=dev,
                **axes))
        scalar_kw = {_AXIS_TO_KWARG[name]: win[name]
                     for name in _AXIS_TO_KWARG}
        scalar_kw["num_cameras"] = int(scalar_kw["num_cameras"])
        point = evaluate_cut(int(win["cut"]), detnet=kw.get("detnet"),
                             keynet=kw.get("keynet"), **scalar_kw)
        if sset is not None:
            # Re-simulate the winning (config, trace) pair through the
            # dense engine to attach all four session channels.
            r1 = _sweep.evaluate_grid(
                cuts=(int(win["cut"]),), scenarios=sset.only(win["trace"]),
                detnet=kw.get("detnet"), keynet=kw.get("keynet"),
                backend=backend, device=dev,
                agg_nodes=(win["agg_node"],),
                sensor_nodes=(win["sensor_node"],),
                weight_mems=(win["weight_mem"],),
                detnet_fps=(float(win["detnet_fps"]),),
                keynet_fps=(float(win["keynet_fps"]),),
                num_cameras=(float(win["num_cameras"]),),
                mipi_energy_scale=(float(win["mipi_energy_scale"]),),
                camera_fps=(float(win["camera_fps"]),))
            session = {f: float(r1.data[f].ravel()[0])
                       for f in _sweep.SCENARIO_FIELDS}
            point = dataclasses.replace(point, trace=str(win["trace"]),
                                        session=session)
        return point

    agg = _registry_name(kw.get("agg_node", "7nm"))
    sen = _registry_name(kw.get("sensor_node", "7nm"))
    # Keep the engines interchangeable: the scalar sweep raises for an
    # MRAM request on a node with no test vehicle (every cut > 0 is
    # invalid), so the array path must not quietly return the one valid
    # centralized point instead.
    if (kw.get("sensor_weight_mem", "sram") == "mram"
            and _resolve_node(kw.get("sensor_node", "7nm")).mram is None):
        raise ValueError(
            f"no MRAM test vehicle at "
            f"{_resolve_node(kw.get('sensor_node', '7nm')).name}")
    if engine == "array" and agg is not None and sen is not None:
        res = _sweep.evaluate_grid(backend=backend, device=dev,
                                   **_sweep.scalar_axes(kw))
        return evaluate_cut(constrained_best(res)["cut"], **kw)
    if backend is not None:
        # Custom TechNodes outside the registry fall back to the scalar
        # engine, which evaluates no grids — an explicit backend request
        # must not be silently ignored there.
        raise ValueError(
            "backend= cannot be honored: these knobs fall back to the "
            "scalar engine (custom TechNode outside the registry)")
    points = sweep_partitions(**kw)
    if cons:
        # The scalar path only carries the objective scalars, so
        # constraint channels must be PartitionPoint attributes.
        for field, _, _ in cons:
            if not hasattr(points[0], field):
                raise ValueError(
                    f"constraint channel {field!r} is not available on "
                    f"the scalar engine; use engine='array'")
        points = [p for p in points
                  if all(_sweep.CONSTRAINT_OPS[op](getattr(p, f), v)
                         for f, op, v in cons)]
        if not points:
            raise ValueError(
                "no cut satisfies constraints ("
                + ", ".join(f"{f} {op} {v:g}" for f, op, v in cons) + ")")
    return min(points, key=lambda p: getattr(p, objective))
