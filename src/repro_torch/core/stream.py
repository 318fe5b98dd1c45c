"""Streaming sweep executor: memory-bounded giant design spaces.

The PyTorch counterpart of the reference ``repro.core.stream`` — its
single-device, synchronous core.  The grid is never materialized: each
chunk of flat indices is decoded on the device, evaluated, masked by
the compiled constraint predicates and the Pareto dominance pre-filter,
and folded into a running device carry (:func:`repro_torch.core.backend.
fold_chunk`): argmin, feasibility counts and bounds per tracked channel,
per-objective top-k, optional histograms.  Each step hands the host only
a compacted survivor set, which is merged into the exact running Pareto
front on the host.  Argmin, top-k and front are exactly the dense-path
results (:func:`repro_torch.core.sweep.evaluate_grid` +
:func:`repro_torch.core.pareto.pareto_front`).

On a CUDA device the chunk step runs kernel A of
:mod:`repro_torch.kernels.sweep_grid` and the strided probe and the
survivor-overflow fallback run kernel B — the same backend as the chunk
step, so all three evaluate through one compiled ``eval_config``.

Not in this slice (each raises ``NotImplementedError`` when passed):
checkpoint/resume, retries and fault injection, elastic replanning,
``flat_range``, the progress/stop/snapshot hooks, prefetch threads,
scan fusion, multiple devices and scenario sweeps.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from . import arrays as A
from . import backend as B
from . import pareto as P
from . import sweep as SW
from .constants import (CAMERA_FPS, DETNET_FPS, KEYNET_FPS, NUM_CAMERAS,
                        TechNode)
from .workloads import NNWorkload

#: Default flat-index chunk evaluated per step (the reference's default).
DEFAULT_CHUNK = 1 << 17

_FILTER_ROWS = 24      # explicit front rows in the dominance pre-filter
_FILTER_BINS = 256     # quantile bins of the prefix-min dominance table
_SURVIVOR_CAP = 16384  # per-chunk compacted-survivor capacity
_PROBE = 4096          # strided probe (front seed + histogram ranges)
_MERGE_EVERY = 4096    # candidate-buffer size that triggers an exact merge
_CHUNK_QUANTUM = 4096  # chunk sizes are clamped to multiples of this

#: Reference ``stream_grid`` parameters this slice does not run yet.
_NOT_PORTED = ("scenarios", "devices", "scan_chunks", "prefetch",
               "checkpoint_dir", "checkpoint_every_s",
               "checkpoint_every_steps", "checkpoint_keep", "retry_policy",
               "fault_injector", "flat_range", "should_stop", "on_progress",
               "on_snapshot", "snapshot_every_s")


def _reject_not_ported(kw: Mapping) -> None:
    for name in _NOT_PORTED:
        if kw.get(name) is not None:
            raise NotImplementedError(
                f"stream_grid({name}=...) is not ported yet: the PyTorch "
                f"port runs the single-device synchronous executor; "
                f"{name} arrives with a later slice (see ROADMAP.md)")


# ---------------------------------------------------------------------------
# Result container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Reductions of one streamed sweep (never the dense grid itself).

    Per-channel argmin winners, top-k tables for the objectives,
    feasibility counts, channel bounds, optional histograms and the
    exact Pareto front.  Flat indices are interchangeable with the dense
    path's.  Under ``constraints=`` every reduction is over the feasible
    subset only.
    """

    axes: "OrderedDict[str, tuple]"
    objectives: tuple[str, ...]
    maximize: tuple[str, ...]
    chunk_size: int

    min_val: Mapping[str, float]
    min_idx: Mapping[str, int]
    finite_counts: Mapping[str, int]
    channel_min: Mapping[str, float]
    channel_max: Mapping[str, float]
    #: Valid-config counts per axis value from the strided probe pass —
    #: diagnostics for the all-invalid error messages, not exact tallies.
    axis_valid: "OrderedDict[str, np.ndarray]"

    topk_idx: np.ndarray                  # (n_objectives, k) flat indices
    topk_val: np.ndarray                  # natural-orientation values

    front_indices: np.ndarray             # (f,) flat indices, exact front
    front_values: np.ndarray              # (f, d) natural-orientation values

    hist: Optional[Mapping[str, tuple[np.ndarray, np.ndarray]]]
    stats: Mapping[str, float]
    constraints: tuple[tuple[str, str, float], ...] = ()

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(v) for v in self.axes.values())

    @property
    def n_configs(self) -> int:
        return int(np.prod(self.shape))

    def config_at(self, flat_index: int) -> dict:
        return SW.config_from_flat(self.shape, self.axes, flat_index)

    def _invalid_notes(self) -> list[str]:
        return [f"{name}={vals[i]!r}"
                for (name, vals), counts in zip(self.axes.items(),
                                                self.axis_valid.values())
                for i in np.flatnonzero(counts == 0)]

    def _all_invalid_error(self, field: str) -> ValueError:
        if self.constraints:
            preds = ", ".join(f"{f} {op} {v:g}"
                              for f, op, v in self.constraints)
            return ValueError(
                f"no grid configuration is feasible in channel {field!r} "
                f"under constraints ({preds}) — loosen the constraints or "
                f"widen the grid axes")
        return ValueError(SW.invalid_message(field, self._invalid_notes()))

    def argmin(self, field: str = "avg_power") -> dict:
        """Best (lowest-``field``) feasible configuration; the first
        minimum (lowest flat index) wins, as ``np.nanargmin`` does."""
        if field not in self.min_val:
            raise ValueError(
                f"channel {field!r} was not tracked; this stream reduced "
                f"{sorted(self.min_val)} — re-run stream_grid with "
                f"track=({field!r},) or track='all'")
        if self.finite_counts[field] == 0:
            raise self._all_invalid_error(field)
        out = self.config_at(self.min_idx[field])
        out[field] = self.min_val[field]
        return out

    def top_k(self, field: str) -> list[dict]:
        """The k best feasible configurations of one objective, best
        first, ties by ascending flat index."""
        if field not in self.objectives:
            raise ValueError(f"top-k tracks only {self.objectives}; "
                             f"re-run stream_grid with {field!r} in "
                             f"objectives=")
        oi = self.objectives.index(field)
        out = []
        for flat, val in zip(self.topk_idx[oi], self.topk_val[oi]):
            if not np.isfinite(val):
                break
            cfg = self.config_at(int(flat))
            cfg[field] = float(val)
            out.append(cfg)
        return out

    def channel_bounds(self, field: str) -> tuple[float, float]:
        """(min, max) of the feasible entries of one channel."""
        if self.finite_counts[field] == 0:
            raise self._all_invalid_error(field)
        return self.channel_min[field], self.channel_max[field]

    def pareto_front(self) -> P.ParetoFront:
        """The exact non-dominated set as a :class:`~repro_torch.core.
        pareto.ParetoFront` (identical to ``pareto.pareto_front`` on the
        dense grid, post ``SweepResult.constrain`` under constraints)."""
        sign0 = -1.0 if self.objectives[0] in self.maximize else 1.0
        order = np.argsort(self.front_values[:, 0] * sign0, kind="stable")
        return P.ParetoFront(
            result=self, objectives=self.objectives, maximize=self.maximize,
            indices=self.front_indices[order],
            values=self.front_values[order])


# ---------------------------------------------------------------------------
# Host-side exact merges
# ---------------------------------------------------------------------------


def _np_undominated(cand_sg: np.ndarray, wit_sg: np.ndarray) -> np.ndarray:
    """Candidates (signed ``(n, d)``) no witness row strictly dominates —
    the exact vectorized cull behind :func:`_merge_into_front`."""
    keep = np.ones(cand_sg.shape[0], bool)
    d = cand_sg.shape[1]
    for lo in range(0, wit_sg.shape[0], 512):
        blk = wit_sg[lo:lo + 512]
        le = blk[:, None, 0] <= cand_sg[None, :, 0]
        lt = blk[:, None, 0] < cand_sg[None, :, 0]
        for c in range(1, d):
            le &= blk[:, None, c] <= cand_sg[None, :, c]
            lt |= blk[:, None, c] < cand_sg[None, :, c]
        keep &= ~(le & lt).any(axis=0)
    return keep


def _merge_into_front(front_v, front_i, cat_v, cat_i, sign):
    """Exactly merge pre-filtered candidates into the running front
    (which is already mutually non-dominated): entrants are culled
    against the front, then against each other, then surviving entrants
    evict the front members they dominate.  Rows stay sorted by flat
    index."""
    if cat_v.shape[0] == 0:
        return front_v, front_i
    cat_sg = cat_v * sign
    if front_v.shape[0]:
        front_sg = front_v * sign
        keep_c = _np_undominated(cat_sg, front_sg)
        cat_v, cat_i, cat_sg = cat_v[keep_c], cat_i[keep_c], cat_sg[keep_c]
        if cat_v.shape[0] == 0:
            return front_v, front_i
        keep_c = P.non_dominated_mask(cat_sg)
        cat_v, cat_i, cat_sg = cat_v[keep_c], cat_i[keep_c], cat_sg[keep_c]
        keep_f = _np_undominated(front_sg, cat_sg)
        V = np.concatenate([front_v[keep_f], cat_v])
        I = np.concatenate([front_i[keep_f], cat_i])
    else:
        keep = P.non_dominated_mask(cat_sg)
        V, I = cat_v[keep], cat_i[keep]
    order = np.argsort(I, kind="stable")
    return V[order], I[order]


def _probe(dense_eval, axvals, shape, n_total, obj_fields, sign, cons,
           hist_bins, hist_ranges, device):
    """Strided sample pass: seeds the front filter, the histogram ranges
    and the per-axis-value validity diagnostics.  The probe points only
    ever pre-filter (the exact front is built from chunk survivors), so
    correctness never depends on probe coverage; constraint predicates
    mask the probe exactly like the chunk step."""
    m = int(min(_PROBE, max(256, n_total // 128), n_total))
    flat = np.unique(np.linspace(0, n_total - 1, m).astype(np.int64))
    out = dense_eval(axvals, torch.as_tensor(flat, device=device))
    out = {f: v.cpu().numpy() for f, v in out.items()}
    O = np.stack([out[f] for f in obj_fields], axis=1)
    coords = SW.decode_flat_index(shape, flat)
    feas = np.ones(flat.size, bool)
    with np.errstate(invalid="ignore"):
        for f, op, v in cons:
            feas &= SW.CONSTRAINT_OPS[op](out[f], v)
    fin = np.isfinite(O).all(axis=1) & feas
    axis_valid = tuple(np.bincount(c[fin], minlength=sz)
                       for c, sz in zip(coords, shape))
    seed = O[fin] * sign
    if seed.shape[0]:
        # Pad the seed rows outward so a probe twin of a front point can
        # never strictly dominate (and wrongly cull) its chunk-evaluated
        # copy, whatever the last ulp of either: the filter stays
        # conservative, the host merge is exact.
        seed = seed + (1e-9 * np.abs(seed) + 1e-300)

    edges = None
    if hist_bins:
        edges = np.empty((len(obj_fields), hist_bins + 1))
        for oi, f in enumerate(obj_fields):
            if hist_ranges is not None and f in hist_ranges:
                lo, hi = map(float, hist_ranges[f])
            else:
                col = O[:, oi][np.isfinite(O[:, oi])]
                if col.size == 0:
                    lo, hi = 0.0, 1.0
                else:
                    lo, hi = float(col.min()), float(col.max())
                    pad = 0.05 * ((hi - lo) or max(abs(lo), 1.0))
                    lo, hi = lo - pad, hi + pad
            if hi <= lo:
                hi = lo + 1.0
            edges[oi] = np.linspace(lo, hi, hist_bins + 1)
    return seed, edges, axis_valid


# ---------------------------------------------------------------------------
# Plan: the resolved job definition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class StreamPlan:
    """Resolved execution plan of one streamed sweep: model stack, axes,
    tracked fields, constraints, chunk geometry, backend, device and the
    :class:`~repro_torch.core.backend.ChunkSpec`."""

    S: object
    axis_vals: tuple
    axes: "OrderedDict[str, tuple]"
    shape: tuple
    n_total: int
    objectives: tuple
    maximize: tuple
    fields: tuple                   # objectives + tracked + constrained
    cons: tuple                     # canonical (field, op, bound)
    sign: tuple                     # +1 minimize / -1 maximize per obj
    d: int
    k: int
    chunk: int
    backend: str
    device: torch.device
    hist_bins: int
    hist_ranges: Optional[Mapping]
    spec: B.ChunkSpec


def plan_stream(cuts: Optional[Iterable[int]] = None,
                agg_nodes: Sequence[str | TechNode] = ("7nm",),
                sensor_nodes: Sequence[str | TechNode] = ("7nm",),
                weight_mems: Sequence[str] = ("sram",),
                detnet_fps: Sequence[float] = (DETNET_FPS,),
                keynet_fps: Sequence[float] = (KEYNET_FPS,),
                num_cameras: Sequence[float] = (NUM_CAMERAS,),
                mipi_energy_scale: Sequence[float] = (1.0,),
                camera_fps: Sequence[float] = (CAMERA_FPS,),
                detnet: NNWorkload | None = None,
                keynet: NNWorkload | None = None,
                model: A.ModelArrays | None = None,
                models=None,
                scenarios=None,
                chunk_size: int = DEFAULT_CHUNK,
                top_k: int = 4,
                objectives: Sequence[str] = P.DEFAULT_OBJECTIVES,
                maximize: Iterable[str] = (),
                track: Optional[Sequence[str]] = None,
                constraints=None,
                hist_bins: int = 0,
                hist_ranges: Optional[Mapping] = None,
                backend: Optional[str] = None,
                device="cuda") -> StreamPlan:
    """Resolve a :func:`stream_grid` job into a :class:`StreamPlan`
    without running anything (same argument semantics)."""
    dev = SW.resolve_device(device)
    S, axis_vals, axes = SW.build_axes(
        cuts, agg_nodes, sensor_nodes, weight_mems, detnet_fps, keynet_fps,
        num_cameras, mipi_energy_scale, camera_fps, detnet, keynet, model,
        models, scenarios)
    full_shape = tuple(a.size for a in axis_vals)
    n_total = int(np.prod(full_shape))

    objectives = tuple(objectives)
    maximize = tuple(maximize)
    if not objectives:
        raise ValueError("need at least one objective channel")
    if track == "all":
        extra: tuple = SW.FIELDS
    else:
        extra = tuple(track) if track is not None else ()
    cons = SW.parse_constraints(constraints)
    extra = extra + tuple(f for f, _, _ in cons)
    fields = objectives + tuple(dict.fromkeys(
        f for f in extra if f not in objectives))
    unknown = [o for o in fields if o not in SW.FIELDS]
    if unknown:
        raise ValueError(f"unknown objective channels {unknown}; this "
                         f"sweep evaluates {SW.FIELDS}")
    stray = [o for o in maximize if o not in objectives]
    if stray:
        raise ValueError(f"maximize entries {stray} not in objectives")
    sign = np.where([o in maximize for o in objectives], -1.0, 1.0)
    d = len(objectives)
    cons_static = tuple((fields.index(f), op) for f, op, _ in cons)

    be = B.get_backend(backend, dev)     # fail fast on unknown backends
    k = max(1, min(int(top_k), n_total))
    # Clamp the chunk to the quantized grid size: a small grid must not
    # pay for a mostly-padded default chunk.
    chunk = max(1, int(chunk_size), k)
    chunk = min(chunk, -(-n_total // _CHUNK_QUANTUM) * _CHUNK_QUANTUM)
    spec = B.ChunkSpec(
        S=S, shape=full_shape, n_total=n_total, chunk=chunk,
        fields=fields, d=d, k=k, sign=tuple(float(s) for s in sign),
        cons_static=cons_static, hist_bins=hist_bins,
        survivor_cap=min(_SURVIVOR_CAP, chunk),
        small_index=n_total + chunk < 2**31,
        filter_rows=_FILTER_ROWS, filter_bins=_FILTER_BINS)
    return StreamPlan(
        S=S, axis_vals=tuple(axis_vals), axes=axes, shape=full_shape,
        n_total=n_total, objectives=objectives, maximize=maximize,
        fields=fields, cons=cons, sign=tuple(sign), d=d, k=k, chunk=chunk,
        backend=be.name, device=dev, hist_bins=hist_bins,
        hist_ranges=hist_ranges, spec=spec)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


def stream_grid(cuts: Optional[Iterable[int]] = None,
                agg_nodes: Sequence[str | TechNode] = ("7nm",),
                sensor_nodes: Sequence[str | TechNode] = ("7nm",),
                weight_mems: Sequence[str] = ("sram",),
                detnet_fps: Sequence[float] = (DETNET_FPS,),
                keynet_fps: Sequence[float] = (KEYNET_FPS,),
                num_cameras: Sequence[float] = (NUM_CAMERAS,),
                mipi_energy_scale: Sequence[float] = (1.0,),
                camera_fps: Sequence[float] = (CAMERA_FPS,),
                detnet: NNWorkload | None = None,
                keynet: NNWorkload | None = None,
                model: A.ModelArrays | None = None,
                models=None,
                chunk_size: int = DEFAULT_CHUNK,
                top_k: int = 4,
                objectives: Sequence[str] = P.DEFAULT_OBJECTIVES,
                maximize: Iterable[str] = (),
                track: Optional[Sequence[str]] = None,
                constraints=None,
                hist_bins: int = 0,
                hist_ranges: Optional[Mapping] = None,
                backend: Optional[str] = None,
                plan: Optional[StreamPlan] = None,
                device="cuda",
                **not_ported) -> StreamResult:
    """Stream Eqs. 1-11 over an arbitrarily large cartesian grid.

    Same axes (and ``models=`` workload batch) as :func:`repro_torch.
    core.sweep.evaluate_grid`, but the grid is never materialized: flat
    indices are decoded on the device in ``chunk_size`` pieces and folded
    into running reductions, so host memory is O(chunk + front).

    ``objectives``/``maximize`` select the channels tracked by top-k and
    the Pareto front; ``track`` adds channels to the argmin/count/bounds
    reductions (``"all"`` for every field); ``constraints`` compiles
    feasibility predicates (:func:`repro_torch.core.sweep.
    parse_constraints`) into the chunk step; ``hist_bins`` adds
    per-objective histograms (ranges from ``hist_ranges`` or the strided
    probe).  ``backend`` selects the chunk step's backend (``None``:
    ``"cuda"`` kernels on a CUDA device, plain ``"torch"`` on the CPU);
    ``plan`` reuses a :func:`plan_stream` result.  Reference parameters
    this slice does not run yet raise ``NotImplementedError``.
    """
    _reject_not_ported(not_ported)
    unknown = set(not_ported) - set(_NOT_PORTED)
    if unknown:
        raise TypeError(f"stream_grid() got unexpected keyword arguments "
                        f"{sorted(unknown)}")
    if plan is None:
        plan = plan_stream(
            cuts, agg_nodes, sensor_nodes, weight_mems, detnet_fps,
            keynet_fps, num_cameras, mipi_energy_scale, camera_fps,
            detnet, keynet, model, models,
            chunk_size=chunk_size, top_k=top_k, objectives=objectives,
            maximize=maximize, track=track, constraints=constraints,
            hist_bins=hist_bins, hist_ranges=hist_ranges, backend=backend,
            device=device)
    dev = plan.device
    objectives, fields, cons = plan.objectives, plan.fields, plan.cons
    sign = np.asarray(plan.sign)
    d, chunk, n_total = plan.d, plan.chunk, plan.n_total
    spec = plan.spec
    cap = spec.survivor_cap
    n_steps = math.ceil(n_total / chunk)

    t0 = time.perf_counter()
    axvals = SW.axes_to_device(plan.axis_vals, dev)
    # Probe, fallback and chunk step share one backend (and so, on the
    # card, one compiled eval_config).  The dense evaluator runs every
    # field, as the dense engine does.
    dense_eval = B.cached_dense_eval(plan.backend, plan.S, plan.shape,
                                     SW.FIELDS, dev)
    seed_signed, hist_edges, axis_valid = _probe(
        dense_eval, axvals, plan.shape, n_total, objectives, sign, cons,
        plan.hist_bins, plan.hist_ranges, dev)
    # Pre-cull the probe seed toward its near-front subset: the filter
    # build draws quantile bins and spread rows from the rows it is
    # given, and a mostly-dominated cloud drags both toward the data
    # mass instead of the front envelope.  Culling here is exact.
    if seed_signed.shape[0] > 4 * _FILTER_ROWS:
        f0 = P.build_dominance_filter(seed_signed, d, _FILTER_ROWS,
                                      _FILTER_BINS)
        seed_signed = seed_signed[P.dominance_filter_mask(
            f0, np.ascontiguousarray(seed_signed.T), xp=np)]

    step = B.build_step(spec, plan.backend, dev)
    carry = B.carry_to_device(B.init_carry(spec), dev)
    front_vals = np.empty((0, d))
    front_idx = np.empty((0,), np.int64)
    buf_vals: list = []                 # pending front candidates
    buf_idx: list = []
    buf_n = 0
    filt_np: dict = {}                  # host mirror of the device filter
    aux_extra = {}
    if cons:
        aux_extra["cons"] = torch.tensor([v for _, _, v in cons],
                                         dtype=SW.F64, device=dev)
    if plan.hist_bins:
        aux_extra["hist_edges"] = torch.as_tensor(hist_edges, device=dev)
    aux = dict(aux_extra)
    t_host = t_wait = t_dispatch = 0.0
    t_first = None
    n_fallback = 0

    def rebuild_filter():
        nonlocal filt_np, aux
        base_sg = (np.concatenate([front_vals * sign, seed_signed])
                   if seed_signed.size else front_vals * sign)
        filt_np = P.build_dominance_filter(base_sg, d, _FILTER_ROWS,
                                           _FILTER_BINS)
        aux = dict(aux_extra, filter={
            kk: torch.as_tensor(v, device=dev) for kk, v in filt_np.items()})

    def merge(final=False):
        # Fold the candidate buffer into the running exact front; the
        # filter-based pre-cull keeps the exact dominance passes small.
        nonlocal front_vals, front_idx, buf_vals, buf_idx, buf_n
        if buf_n:
            cat_v = np.concatenate(buf_vals)
            cat_i = np.concatenate(buf_idx)
            cat_sg = cat_v * sign
            base_sg = np.concatenate([front_vals * sign, cat_sg,
                                      seed_signed])
            f = P.build_dominance_filter(base_sg, d, _FILTER_ROWS,
                                         _FILTER_BINS)
            keep = P.dominance_filter_mask(
                f, np.ascontiguousarray(cat_sg.T), xp=np)
            front_vals, front_idx = _merge_into_front(
                front_vals, front_idx, cat_v[keep], cat_i[keep], sign)
            buf_vals, buf_idx, buf_n = [], [], 0
        if not final:
            rebuild_filter()

    def host_chunk_survivors(dstart, vlen):
        # Survivor-capacity overflow: re-derive this chunk's survivors
        # exactly through the dense evaluator (the chunk step's backend),
        # with the same constraint mask and (host-mirror) pre-filter.
        flat = np.arange(dstart, dstart + vlen, dtype=np.int64)
        out = dense_eval(axvals, torch.as_tensor(flat, device=dev))
        out = {f: v.cpu().numpy() for f, v in out.items()}
        O = np.stack([out[f] for f in objectives])
        feas = np.ones(vlen, bool)
        with np.errstate(invalid="ignore"):
            for f, op, v in cons:
                feas &= SW.CONSTRAINT_OPS[op](out[f], v)
        Osg = np.where(feas[None, :], O * sign[:, None], np.inf)
        keep = P.dominance_filter_mask(filt_np, Osg, xp=np)
        loc = np.flatnonzero(keep)
        return flat[loc], O[:, loc].T

    rebuild_filter()
    for si in range(n_steps):
        start = si * chunk
        td = time.perf_counter()
        carry, surv = step(carry, axvals, aux, start)
        tw = time.perf_counter()
        t_dispatch += tw - td
        flat_s, val_s, cnt = (x.cpu().numpy() for x in surv)
        t_wait += time.perf_counter() - tw
        th = time.perf_counter()
        cnt = int(cnt)
        if cnt > cap:
            n_fallback += 1
            fl, vv = host_chunk_survivors(start, min(chunk, n_total - start))
        else:
            fl, vv = flat_s[:cnt], val_s[:cnt]
        if len(fl):
            buf_idx.append(np.asarray(fl, np.int64))
            buf_vals.append(np.asarray(vv, np.float64))
            buf_n += len(fl)
        if buf_n >= _MERGE_EVERY or (si == 0 and n_steps > 1):
            merge()
        if t_first is None:
            t_first = time.perf_counter() - t0
        t_host += time.perf_counter() - th
    merge(final=True)
    carry = B.carry_to_host(carry)
    total_s = time.perf_counter() - t0

    stats = {
        "n_configs": float(n_total),
        "n_chunks": float(n_steps),
        "total_s": total_s,
        "first_chunk_s": t_first if t_first is not None else total_s,
        "configs_per_s": n_total / total_s if total_s else float("inf"),
        # dispatch_s: issuing the chunk steps (kernel launch and the
        # fold's torch ops; on the card this is host time, the work runs
        # asynchronously); device_wait_s: blocked fetching survivors
        # (un-hidden device work plus the transfer); host_merge_s: exact
        # front merges, buffering and overflow fallbacks on the host.
        "dispatch_s": t_dispatch,
        "device_wait_s": t_wait,
        "host_merge_s": t_host,
        "fallback_chunks": float(n_fallback),
    }
    # Entries past the feasible count keep the +inf sentinel value —
    # point their indices at n_total too.
    topk_val = carry["topk_val"] * sign[:, None]
    topk_idx = np.where(np.isfinite(carry["topk_val"]), carry["topk_idx"],
                        n_total)
    hist_out = None
    if plan.hist_bins:
        hist_out = {f: (np.asarray(carry["hist"][oi]), hist_edges[oi].copy())
                    for oi, f in enumerate(objectives)}
    axes = plan.axes
    visible_axis_valid = (axis_valid[1:] if len(axis_valid) == len(axes) + 1
                          else axis_valid)     # drop hidden model axis
    return StreamResult(
        axes=axes, objectives=objectives, maximize=plan.maximize,
        chunk_size=chunk,
        min_val={f: float(carry["min_val"][i]) for i, f in enumerate(fields)},
        min_idx={f: int(carry["min_idx"][i]) for i, f in enumerate(fields)},
        finite_counts={f: int(carry["finite"][i])
                       for i, f in enumerate(fields)},
        channel_min={f: float(carry["fmin"][i])
                     for i, f in enumerate(fields)},
        channel_max={f: float(carry["fmax"][i])
                     for i, f in enumerate(fields)},
        axis_valid=OrderedDict(zip(axes, visible_axis_valid)),
        topk_val=topk_val, topk_idx=topk_idx,
        front_indices=front_idx, front_values=front_vals,
        hist=hist_out, stats=stats, constraints=cons)
