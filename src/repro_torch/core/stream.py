"""Streaming sweep executor: memory-bounded giant design spaces.

The PyTorch counterpart of the reference ``repro.core.stream``.  The
grid is never materialized: each chunk of flat indices is
decoded on the device, evaluated, masked by the compiled constraint
predicates and the Pareto dominance pre-filter, and folded into a
running device carry (:func:`repro_torch.core.backend.fold_chunk`):
argmin, feasibility counts and bounds per tracked channel, per-objective
top-k, optional histograms.  Each step hands the host only a compacted
survivor set, which is merged into the exact running Pareto front on the
host.  Argmin, top-k and front are exactly the dense-path results
(:func:`repro_torch.core.sweep.evaluate_grid` +
:func:`repro_torch.core.pareto.pareto_front`).

* **Scan fusion** — ``scan_chunks=`` folds K consecutive chunks a
  dispatch (:class:`repro_torch.core.backend.ChunkStep`); on a CUDA
  device the K chunk steps (kernel A and the fold's ops) are one
  captured CUDA graph, replayed once a dispatch.  Results are bitwise
  the same for every K.
* **Prefetch** — ``prefetch=`` dispatches stay in flight ahead of the
  host merges: each dispatch's survivors are copied asynchronously into
  a ring of pinned host buffers, an event a buffer, and the host waits
  only on the oldest (:class:`_Fetch`).  One thread drives both sides,
  in the reference's order: chunk 0's survivors reach the filter before
  chunk 1 is dispatched, the filter is refreshed between dispatches, a
  checkpoint comes behind its step's survivors.
* **Fault tolerance** — ``checkpoint_dir=`` snapshots the consistent
  state (merged carry, exact front, next flat index) through
  :class:`repro_torch.checkpoint.CheckpointManager`, keyed by
  :func:`repro_torch.core.backend.job_signature`; a re-run resumes
  bitwise.  ``retry_policy=`` bounds in-place retries of faults raised
  before a dispatch and restarts from the snapshot (a lost device
  restarts too); ``fault_injector=`` (:mod:`repro_torch.runtime.
  fault_injection`) drives every path deterministically.
* **Ranges, stops and hooks** — ``flat_range=`` reduces one slice of the
  flat-index space and :func:`merge_results` folds a tiling back into the
  whole; ``should_stop=`` halts between dispatches with an exact prefix
  (``partial=True``); ``on_progress=`` / ``on_snapshot=`` report, after
  any checkpoint due is on disk.  :func:`result_to_json` and the delta
  codec are the results' wire format.

* **Scenarios** — ``scenarios=`` appends a trailing ``trace`` axis and
  drives every (config x trace) pair through the session simulator
  (:mod:`repro_torch.core.scenario`) inside the same chunk contract; the
  four session channels (``sweep.SCENARIO_FIELDS``) work as objectives,
  constraints and tracked channels like the static fields.
* **Devices** — ``devices=`` shards each dispatch: shard ``d`` folds the
  ``scan`` chunks from ``start + d * chunk * scan`` into a carry of its
  own (:class:`repro_torch.core.backend.ShardedStep`, one chunk step a
  entry, each on its own stream; an entry may repeat, so one card or the
  CPU can hold several shards), and the carries merge on the host
  (:func:`repro_torch.core.backend.merge_device_carries`).  A lost
  shard is dropped (:func:`repro_torch.runtime.elastic.drop_worker`)
  and the survivors re-issue the chunks past the last snapshot.  One
  process drives every shard, as the reference's ``pmap`` does.

On a CUDA device the chunk step runs kernel A of
:mod:`repro_torch.kernels.sweep_grid`, and the strided probe and the
survivor-overflow fallback run kernel B.  A scenario sweep runs the
plain ``"torch"`` backend on the same device (its chunk step, session
loop included, still one captured CUDA graph): the kernels do not run
the session loop, as the reference's Pallas kernel does not.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import OrderedDict, deque
from typing import Iterable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..runtime.elastic import drop_worker
from ..runtime.fault_injection import DeviceLostError, TransientDeviceError
from ..runtime.fault_tolerance import RetryPolicy, StragglerDetector
from . import arrays as A
from . import backend as B
from . import pareto as P
from . import sweep as SW
from .spans import span as _span
from .spans import sweep as _sweep
from .constants import (CAMERA_FPS, DETNET_FPS, KEYNET_FPS, NUM_CAMERAS,
                        TechNode)
from .workloads import NNWorkload

#: Default flat-index chunk evaluated per step (the reference's default).
DEFAULT_CHUNK = 1 << 17

#: Default number of dispatches kept in flight ahead of the host merges.
DEFAULT_PREFETCH = 2

_FILTER_ROWS = 24      # explicit front rows in the dominance pre-filter
_FILTER_BINS = 256     # quantile bins of the prefix-min dominance table
_SURVIVOR_CAP = 16384  # per-chunk compacted-survivor capacity
_PROBE = 4096          # strided probe (front seed + histogram ranges)
_MERGE_EVERY = 4096    # candidate-buffer size that triggers an exact merge
_CHUNK_QUANTUM = 4096  # chunk sizes are clamped to multiples of this
_SCAN_MAX = 8          # auto scan fusion: at most this many chunks/dispatch
_SCAN_PER = 16         # ... one fused chunk per this many raw steps

#: Default seconds between checkpoint snapshots when ``checkpoint_dir``
#: is set (``checkpoint_every_steps`` overrides it with a step cadence).
DEFAULT_CHECKPOINT_EVERY_S = 30.0

#: Failures that restart the pipeline from the last consistent snapshot
#: (after the in-place retries of pre-dispatch faults are spent).
_RESTARTABLE: tuple = (TransientDeviceError,)

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
    n_devices: int

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
    #: ``True`` when the stream halted early (``should_stop=``): every
    #: reduction is then exact over the contiguous flat-index prefix
    #: ``[range_start, range_start + fraction_complete * span)``.
    partial: bool = False
    #: The evaluation backend the chunk step ran on (``"cuda"``, or
    #: ``"torch"``: the CPU, or a scenario sweep on either device).  A
    #: property of the run, not of the deliverables: the wire format
    #: (:func:`result_to_json`) leaves it out, as the reference's does.
    backend: Optional[str] = None

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
# Exact JSON codec + progress snapshots (the reference's wire format)
# ---------------------------------------------------------------------------


def _jsonable_scalar(v):
    return v.item() if isinstance(v, np.generic) else v


def result_to_json(res: StreamResult) -> dict:
    """Exact JSON-able encoding of a :class:`StreamResult` (the
    reference's ``stream-result/v1``): floats round-trip bitwise
    (``repr`` is the shortest exact decimal; non-finite values use the
    ``NaN``/``Infinity`` tokens), index tables stay integers."""
    hist = None
    if res.hist is not None:
        hist = {f: [c.tolist(), e.tolist()]
                for f, (c, e) in res.hist.items()}
    return {
        "schema": "stream-result/v1",
        "axes": [[k, [_jsonable_scalar(v) for v in vals]]
                 for k, vals in res.axes.items()],
        "objectives": list(res.objectives),
        "maximize": list(res.maximize),
        "chunk_size": int(res.chunk_size),
        "n_devices": int(res.n_devices),
        "min_val": {k: float(v) for k, v in res.min_val.items()},
        "min_idx": {k: int(v) for k, v in res.min_idx.items()},
        "finite_counts": {k: int(v)
                          for k, v in res.finite_counts.items()},
        "channel_min": {k: float(v) for k, v in res.channel_min.items()},
        "channel_max": {k: float(v) for k, v in res.channel_max.items()},
        "axis_valid": [[k, np.asarray(v).tolist()]
                       for k, v in res.axis_valid.items()],
        "topk_idx": res.topk_idx.tolist(),
        "topk_val": res.topk_val.tolist(),
        "front_indices": res.front_indices.tolist(),
        "front_values": res.front_values.tolist(),
        "hist": hist,
        "stats": {k: float(v) for k, v in res.stats.items()},
        "constraints": [list(c) for c in res.constraints],
        "partial": bool(res.partial),
    }


def result_from_json(d: Mapping) -> StreamResult:
    """Inverse of :func:`result_to_json` (bitwise-exact round trip)."""
    n_obj = len(d["objectives"])
    hist = None
    if d.get("hist") is not None:
        hist = {f: (np.asarray(c), np.asarray(e, np.float64))
                for f, (c, e) in d["hist"].items()}
    front_v = np.asarray(d["front_values"], np.float64)
    return StreamResult(
        axes=OrderedDict((k, tuple(vals)) for k, vals in d["axes"]),
        objectives=tuple(d["objectives"]),
        maximize=tuple(d["maximize"]),
        chunk_size=int(d["chunk_size"]),
        n_devices=int(d["n_devices"]),
        min_val=dict(d["min_val"]),
        min_idx={k: int(v) for k, v in d["min_idx"].items()},
        finite_counts={k: int(v)
                       for k, v in d["finite_counts"].items()},
        channel_min=dict(d["channel_min"]),
        channel_max=dict(d["channel_max"]),
        axis_valid=OrderedDict((k, np.asarray(v))
                               for k, v in d["axis_valid"]),
        topk_idx=np.asarray(d["topk_idx"], np.int64).reshape(n_obj, -1),
        topk_val=np.asarray(d["topk_val"],
                            np.float64).reshape(n_obj, -1),
        front_indices=np.asarray(d["front_indices"], np.int64),
        front_values=front_v.reshape(-1, n_obj),
        hist=hist,
        stats=dict(d["stats"]),
        constraints=tuple((f, op, v) for f, op, v in d["constraints"]),
        partial=bool(d["partial"]),
    )


def _progress_snapshot(folded: int, n_total: int, front_vals, front_idx,
                       objectives, sign) -> dict:
    """JSON-able progress snapshot over the folded prefix ``[0,
    folded)``: fraction complete, running per-objective best (off the
    running front) and the front itself, rows sorted by flat index.  A
    mid-run ``best`` can only be pessimistic (the front is pre-filtered
    against probe witnesses of the whole grid); the final result and a
    cooperative-stop partial are exact."""
    best = {}
    for oi, f in enumerate(objectives):
        if front_vals.shape[0]:
            j = int(np.argmin(front_vals[:, oi] * sign[oi]))
            best[f] = {"value": float(front_vals[j, oi]),
                       "index": int(front_idx[j])}
    return {"fraction_complete": (folded / n_total if n_total else 1.0),
            "front_size": int(front_vals.shape[0]),
            "partial": True,
            "best": best,
            "front": {"i": [int(i) for i in front_idx],
                      "v": [[float(x) for x in row]
                            for row in front_vals]}}


def result_delta_to_json(prev: Optional[Mapping],
                         cur: Mapping) -> dict:
    """Delta between two consecutive progress snapshots: changed
    scalars, changed per-objective bests, front entrants and evictions
    keyed by flat index (a configuration's values never change).  With
    ``prev=None`` the delta is the full snapshot;
    :func:`apply_result_delta` rebuilds ``cur`` exactly."""
    if prev is None:
        return dict(cur)
    out: dict = {}
    for k in ("fraction_complete", "front_size", "partial"):
        if prev.get(k) != cur.get(k):
            out[k] = cur[k]
    pb, cb = prev.get("best", {}), cur.get("best", {})
    changed = {f: v for f, v in cb.items() if pb.get(f) != v}
    if changed:
        out["best"] = changed
    gone = [f for f in pb if f not in cb]
    if gone:
        out["best_del"] = gone
    pf = prev.get("front") or {"i": [], "v": []}
    cf = cur.get("front") or {"i": [], "v": []}
    pset = set(pf["i"])
    add_i = [i for i in cf["i"] if i not in pset]
    if add_i:
        vmap = dict(zip(cf["i"], cf["v"]))
        out["front_add"] = {"i": add_i, "v": [vmap[i] for i in add_i]}
    dels = sorted(pset - set(cf["i"]))
    if dels:
        out["front_del"] = dels
    return out


def apply_result_delta(prev: Optional[Mapping],
                       delta: Mapping) -> dict:
    """Inverse of :func:`result_delta_to_json`: fold one delta into the
    previous snapshot (rows re-sorted by flat index)."""
    if prev is None:
        return dict(delta)
    cur = dict(prev)
    for k in ("fraction_complete", "front_size", "partial"):
        if k in delta:
            cur[k] = delta[k]
    best = dict(prev.get("best", {}))
    best.update(delta.get("best", {}))
    for f in delta.get("best_del", ()):
        best.pop(f, None)
    cur["best"] = best
    pf = prev.get("front") or {"i": [], "v": []}
    rows = dict(zip(pf["i"], pf["v"]))
    for i in delta.get("front_del", ()):
        rows.pop(i, None)
    add = delta.get("front_add")
    if add:
        rows.update(zip(add["i"], add["v"]))
    idx = sorted(rows)
    cur["front"] = {"i": idx, "v": [rows[i] for i in idx]}
    return cur


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


def _resume_into(mgr: CheckpointManager, signature: str, state: dict,
                 counters: dict, chunk: int) -> None:
    """Restore the newest valid snapshot of ``mgr`` into ``state``.

    Snapshots are tried newest first; one whose manifest is unreadable
    falls back to the next older.  A snapshot recorded under a different
    job signature is a hard error: a stale snapshot must never merge
    into another sweep."""
    for step in reversed(mgr.all_steps()):
        try:
            meta = mgr.metadata(step)
        except (OSError, ValueError, KeyError):
            continue
        saved = meta.get("signature") if isinstance(meta, dict) else None
        if saved != signature:
            raise ValueError(
                f"checkpoint directory {mgr.root!r} (step {step}) was "
                f"written by a different sweep job (signature "
                f"{str(saved)[:12]}... != {signature[:12]}...): refusing "
                f"to resume, a stale snapshot must never merge into a "
                f"new sweep.  The signature covers the model stack, "
                f"axes, objectives/tracked fields, constraints, top_k, "
                f"histogram spec, backend, chunk size and scan fusion "
                f"(scan_chunks auto-derives from the grid unless passed "
                f"explicitly).  Point checkpoint_dir at a fresh directory "
                f"or delete the stale checkpoints.")
        items = mgr.restore_items(step)
        state["carry"] = {kk.split("/", 1)[1]: np.array(v)
                          for kk, v in items.items()
                          if kk.startswith("carry/")}
        state["front_vals"] = np.array(items["front_values"], np.float64)
        state["front_idx"] = np.array(items["front_indices"], np.int64)
        state["base"] = int(meta["next_flat"])
        for kk, v in (meta.get("counters") or {}).items():
            if kk in counters:
                counters[kk] = float(v)
        counters["resumed_from_step"] = float(state["base"] // chunk)
        return


# ---------------------------------------------------------------------------
# Plan: the resolved job definition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class StreamPlan:
    """Resolved execution plan of one streamed sweep: model stack, axes,
    tracked fields, constraints, chunk and scan geometry, backend, the
    shards' devices (``devices``; ``device`` is the first, where the
    probe runs), the :class:`~repro_torch.core.backend.ChunkSpec` and
    its content ``signature``.  Re-running the same plan object is what
    keeps its chunk steps (and on the card their captured graphs)
    cached."""

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
    scan: int                       # chunks folded per dispatch
    backend: str
    device: torch.device
    devices: tuple                  # one entry a shard
    hist_bins: int
    hist_ranges: Optional[Mapping]
    spec: B.ChunkSpec
    #: Content hash of the job (:func:`repro_torch.core.backend.
    #: job_signature`), the checkpoint/resume key.
    signature: str


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
                devices: Optional[Sequence] = None,
                backend: Optional[str] = None,
                scan_chunks: Optional[int] = None,
                device="cuda") -> StreamPlan:
    """Resolve a :func:`stream_grid` job into a :class:`StreamPlan`
    without running anything (same argument semantics)."""
    S, axis_vals, axes = SW.build_axes(
        cuts, agg_nodes, sensor_nodes, weight_mems, detnet_fps, keynet_fps,
        num_cameras, mipi_energy_scale, camera_fps, detnet, keynet, model,
        models, scenarios)
    full_shape = tuple(a.size for a in axis_vals)
    n_total = int(np.prod(full_shape))
    kfields = SW.kernel_fields(S)

    objectives = tuple(objectives)
    maximize = tuple(maximize)
    if not objectives:
        raise ValueError("need at least one objective channel")
    if track == "all":
        extra: tuple = kfields
    else:
        extra = tuple(track) if track is not None else ()
    cons = SW.parse_constraints(constraints)
    extra = extra + tuple(f for f, _, _ in cons)
    fields = objectives + tuple(dict.fromkeys(
        f for f in extra if f not in objectives))
    unknown = [o for o in fields if o not in kfields]
    if unknown:
        hint = (" — session channels require scenarios="
                if any(o in SW.SCENARIO_FIELDS for o in unknown) else "")
        raise ValueError(f"unknown objective channels {unknown}; this "
                         f"sweep evaluates {kfields}{hint}")
    stray = [o for o in maximize if o not in objectives]
    if stray:
        raise ValueError(f"maximize entries {stray} not in objectives")
    sign = np.where([o in maximize for o in objectives], -1.0, 1.0)
    d = len(objectives)
    cons_static = tuple((fields.index(f), op) for f, op, _ in cons)

    # fail fast on unknown backends; None -> the device's default, which
    # for a scenario sweep is "torch" on that device
    if devices is None:
        # Every visible card for a "cuda" device, one shard otherwise;
        # an automatic list shrinks to one for a backend without
        # multi-device support (an explicit one raises when its step is
        # built).
        dev = SW.resolve_device(device)
        be = B.get_backend(backend, dev, B.is_scenario(S))
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if dev.index is None and n_cards > 1 and be.supports_multi_device:
            dev_list = tuple(torch.device("cuda", i) for i in range(n_cards))
        else:
            dev_list = (dev,)
    else:
        dev_list = (tuple(SW.resolve_device(dv) for dv in devices)
                    or (SW.resolve_device(device),))
        be = B.get_backend(backend, dev_list[0], B.is_scenario(S))
    n_dev = len(dev_list)
    k = max(1, min(int(top_k), n_total))
    # Clamp the chunk to the quantized need of a shard: a small grid must
    # not pay for a mostly-padded default chunk.
    chunk = max(1, int(chunk_size), k)
    per_dev = -(-n_total // n_dev)
    chunk = min(chunk, -(-per_dev // _CHUNK_QUANTUM) * _CHUNK_QUANTUM)
    # Scan fusion: K consecutive chunks a dispatch.  Auto mode scales K
    # with the raw step count (the reference's rule); small grids keep
    # K = 1 and a fine-grained filter refresh.
    raw_steps = -(-per_dev // chunk)
    if scan_chunks is None:
        scan = max(1, min(_SCAN_MAX, raw_steps // _SCAN_PER))
    else:
        scan = max(1, int(scan_chunks))
    scan = min(scan, raw_steps)
    per_step = chunk * scan * n_dev
    spec = B.ChunkSpec(
        S=S, shape=full_shape, n_total=n_total, chunk=chunk,
        # np.float64 entries, as the reference's (the job signature
        # hashes their type)
        fields=fields, d=d, k=k, sign=tuple(sign),
        cons_static=cons_static, hist_bins=hist_bins,
        survivor_cap=min(_SURVIVOR_CAP, chunk),
        # the last dispatch decodes up to K chunks past its start
        small_index=n_total + per_step < 2**31,
        filter_rows=_FILTER_ROWS, filter_bins=_FILTER_BINS)
    signature = B.job_signature(spec, be.name, scan, cons, axis_vals,
                                hist_ranges)
    return StreamPlan(
        S=S, axis_vals=tuple(axis_vals), axes=axes, shape=full_shape,
        n_total=n_total, objectives=objectives, maximize=maximize,
        fields=fields, cons=cons, sign=tuple(sign), d=d, k=k, chunk=chunk,
        scan=scan, backend=be.name, device=dev_list[0], devices=dev_list,
        hist_bins=hist_bins,
        hist_ranges=hist_ranges, spec=spec, signature=signature)


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


class _Fetch:
    """Survivor fetches in flight, oldest first.

    A dispatch's survivors come as one part a shard, each ``(flat,
    values, count)`` with a leading ``scan`` axis; a fetch joins them in
    shard order.  On a CUDA device :meth:`put` copies them
    asynchronously into one of ``slots`` pinned host buffers, on the
    current stream of each part's device (which waited for the step, and
    which the next replay waits for, as it overwrites the graph's output
    buffers), and records an event there; :meth:`get` waits on the
    oldest fetch's events only.  On the CPU the survivors are host
    tensors already.  :attr:`in_use` counts, over every instance, the
    fetches put and not yet taken: it is back at zero once a stream
    ends, whether it finished or raised (:meth:`close`)."""

    in_use = 0

    def __init__(self, slots: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.free = list(range(slots))
        self.bufs: list = [None] * slots
        self.queue: deque = deque()

    def __len__(self) -> int:
        return len(self.queue)

    def put(self, tag, parts: list) -> None:
        if not self.cuda:
            surv = (parts[0] if len(parts) == 1
                    else tuple(torch.cat(c) for c in zip(*parts)))
            self.queue.append((tag, surv, ()))
        else:
            i = self.free.pop()
            if self.bufs[i] is None:
                self.bufs[i] = tuple(
                    torch.empty((len(parts) * t.shape[0], *t.shape[1:]),
                                dtype=t.dtype, pin_memory=True)
                    for t in parts[0])
            streams = {}
            for d, surv in enumerate(parts):
                for b, t in zip(self.bufs[i], surv):
                    n = t.shape[0]
                    b[d * n:(d + 1) * n].copy_(t, non_blocking=True)
                    streams.setdefault(t.device,
                                       torch.cuda.current_stream(t.device))
            events = []
            for st in streams.values():
                ev = torch.cuda.Event()
                ev.record(st)
                events.append(ev)
            self.queue.append((tag, i, events))
        _Fetch.in_use += 1

    def get(self):
        """``(tag, (flat, values, count))`` of the oldest fetch, the
        shards' parts joined, as numpy views valid until the next
        :meth:`put`."""
        tag, item, events = self.queue.popleft()
        _Fetch.in_use -= 1
        if not self.cuda:
            return tag, tuple(t.numpy() for t in item)
        for ev in events:
            ev.synchronize()
        self.free.append(item)
        return tag, tuple(b.numpy() for b in self.bufs[item])

    def close(self) -> None:
        """Drop every fetch still in flight, after its copies have landed
        (so no copy writes into a buffer that is gone)."""
        while self.queue:
            _, _, events = self.queue.popleft()
            _Fetch.in_use -= 1
            for ev in events:
                ev.synchronize()


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
                scenarios=None,
                chunk_size: int = DEFAULT_CHUNK,
                top_k: int = 4,
                objectives: Sequence[str] = P.DEFAULT_OBJECTIVES,
                maximize: Iterable[str] = (),
                track: Optional[Sequence[str]] = None,
                constraints=None,
                prefetch: int = DEFAULT_PREFETCH,
                hist_bins: int = 0,
                hist_ranges: Optional[Mapping] = None,
                devices: Optional[Sequence] = None,
                backend: Optional[str] = None,
                scan_chunks: Optional[int] = None,
                checkpoint_dir: Optional[str] = None,
                checkpoint_every_s: float = DEFAULT_CHECKPOINT_EVERY_S,
                checkpoint_every_steps: Optional[int] = None,
                checkpoint_keep: int = 3,
                retry_policy: Optional[RetryPolicy] = None,
                fault_injector=None,
                plan: Optional[StreamPlan] = None,
                flat_range: Optional[tuple] = None,
                should_stop=None,
                on_progress=None,
                on_snapshot=None,
                snapshot_every_s: float = 0.5,
                device="cuda") -> StreamResult:
    """Stream Eqs. 1-11 over an arbitrarily large cartesian grid.

    Same axes (and ``models=`` workload batch) as :func:`repro_torch.
    core.sweep.evaluate_grid`, but the grid is never materialized: flat
    indices are decoded on the device in ``chunk_size`` pieces and folded
    into running reductions, so host memory is O(chunk + front).  The
    reference's parameters, with its semantics:

    ``objectives``/``maximize`` select the channels tracked by top-k and
    the Pareto front; ``track`` adds channels to the argmin/count/bounds
    reductions (``"all"`` for every field); ``constraints`` compiles
    feasibility predicates (:func:`repro_torch.core.sweep.
    parse_constraints`) into the chunk step; ``hist_bins`` adds
    per-objective histograms (ranges from ``hist_ranges`` or the strided
    probe).  ``backend`` selects the chunk step's backend (``None``:
    ``"cuda"`` kernels on a CUDA device, plain ``"torch"`` on the CPU,
    and ``"torch"`` on either for a scenario sweep; the result's
    ``backend`` says which ran).

    ``scenarios=`` (a :class:`repro_torch.core.scenario.ScenarioSet` or
    profile name(s)) appends a trailing ``trace`` axis and drives every
    (config x trace) pair through the session simulator inside the same
    chunk contract; the four session channels (``sweep.SCENARIO_FIELDS``,
    e.g. ``time_to_empty_s`` with ``maximize=("time_to_empty_s",)``,
    and ``peak_case_temp_c``) then work as objectives, constraints and
    tracked channels exactly like the static fields.

    ``scan_chunks`` folds that many consecutive chunks a dispatch
    (``None``: one a dispatch per 16 chunks of the grid, at most 8; on a
    CUDA device one captured graph of them, replayed a dispatch);
    ``prefetch`` keeps that many dispatches in flight ahead of the host
    merges (0: synchronous).  Both leave the results bitwise unchanged.

    ``checkpoint_dir`` snapshots the consistent state (merged carry,
    exact front, next flat index) every ``checkpoint_every_s`` seconds,
    or every ``checkpoint_every_steps`` dispatches, keeping the
    ``checkpoint_keep`` newest; a later call with the same specification
    resumes from the newest with bitwise-identical deliverables, one
    with another specification raises :class:`ValueError`.
    ``retry_policy`` (default :class:`repro_torch.runtime.
    fault_tolerance.RetryPolicy`) bounds the in-place retries of faults
    raised before a dispatch and the restarts from the last snapshot
    (after spent retries or a lost device); ``fault_injector`` is called
    as ``injector(chunk_ordinal, flat_start)`` before every dispatch
    (:mod:`repro_torch.runtime.fault_injection`).

    ``devices`` lists the shards, one device each (an entry may repeat:
    ``("cpu",) * 4``, or ``("cuda:0",) * 2`` on one card): each dispatch
    folds ``chunk * scan_chunks`` consecutive indices on every shard,
    shard ``d`` from ``start + d * chunk * scan_chunks``, into a carry of
    its own, merged exactly on the host.  ``None``: every visible card
    for a ``"cuda"`` ``device`` with a backend that supports several
    (``"torch"``; the ``"cuda"`` kernels take one card, and refuse an
    explicit list of several), one shard otherwise.  The chunk and scan
    derive from the grid a shard holds, as the reference's do, so the
    deliverables equal the one-shard run's bitwise, and a checkpoint
    resumes onto any shard count.  A :class:`DeviceLostError` with
    several shards drops the lost one (``stats["elastic_replans"]``) and
    re-issues the chunks past the last snapshot on the survivors; on the
    last shard it restarts, as on one device.  ``n_devices`` reports
    the shards the run started with.

    ``plan`` reuses a :func:`plan_stream` result (the axis, objective,
    backend and device arguments are then ignored).  ``flat_range=(start,
    stop)`` reduces only that slice of the flat-index space: ``stop``
    must land on a dispatch boundary (``(stop - start) % (chunk *
    scan_chunks * n_devices) == 0``) unless it is the grid's end, and
    :func:`merge_results` folds the results of a tiling back into the
    whole grid's, bitwise.  ``should_stop`` is polled before every
    dispatch: when it returns truthy the executor folds what it has
    dispatched and returns the exact prefix as a ``partial=True`` result
    (``stats["fraction_complete"]`` < 1), checkpointed when
    ``checkpoint_dir`` is set.  ``on_progress`` is called after each
    dispatch with the fraction issued; ``on_snapshot`` (at most every
    ``snapshot_every_s`` seconds) with a JSON-able progress snapshot
    (:func:`_progress_snapshot`); both only after any checkpoint due at
    that step is durably on disk.
    """
    if plan is None:
        plan = plan_stream(
            cuts, agg_nodes, sensor_nodes, weight_mems, detnet_fps,
            keynet_fps, num_cameras, mipi_energy_scale, camera_fps,
            detnet, keynet, model, models, scenarios,
            chunk_size=chunk_size, top_k=top_k, objectives=objectives,
            maximize=maximize, track=track, constraints=constraints,
            hist_bins=hist_bins, hist_ranges=hist_ranges, devices=devices,
            backend=backend, scan_chunks=scan_chunks, device=device)
    dev = plan.device
    dev_list = list(plan.devices)
    n_dev = len(dev_list)
    objectives, fields, cons = plan.objectives, plan.fields, plan.cons
    sign = np.asarray(plan.sign)
    d, k, chunk, scan = plan.d, plan.k, plan.chunk, plan.scan
    n_total, spec = plan.n_total, plan.spec
    cap = spec.survivor_cap
    per_step = chunk * scan * n_dev
    if flat_range is None:
        start0, stop0 = 0, n_total
    else:
        start0, stop0 = int(flat_range[0]), int(flat_range[1])
        if not 0 <= start0 < stop0 <= n_total:
            raise ValueError(
                f"flat_range {flat_range} outside the grid "
                f"[0, {n_total})")
        if stop0 != n_total and (stop0 - start0) % per_step:
            # The step masks lanes only against the grid's end, so an
            # interior stop must land on a dispatch boundary or the last
            # dispatch would fold lanes of the next range.
            raise ValueError(
                f"flat_range length {stop0 - start0} is not a multiple "
                f"of the dispatch quantum {per_step} (chunk {chunk} x "
                f"scan {scan} x {n_dev} device(s)) and stop != n_total "
                f"({n_total}): pass chunk_size/scan_chunks explicitly "
                f"and carve ranges on dispatch boundaries")
    span = stop0 - start0
    n_steps = math.ceil(span / per_step)
    prefetch = max(0, int(prefetch))

    spent = dict.fromkeys(("total_s", "probe_s", "step_build_s",
                           "step_builds", "dispatch_s", "device_wait_s",
                           "host_merge_s", "fallback_s", "survivors",
                           "fold_kernel_chunks"),
                          0.0)
    with _sweep("stream_grid", "total_s", spent) as whole:
        t0 = whole.start
        policy = retry_policy if retry_policy is not None else RetryPolicy()
        counters = {
            "retries": 0.0, "restarts": 0.0, "resumed_from_step": 0.0,
            "checkpoint_write_s": 0.0, "checkpoints_written": 0.0,
            "chunks_reissued": 0.0, "elastic_replans": 0.0,
            "stragglers": 0.0, "step_timeouts": 0.0,
        }
        axvals = SW.axes_to_device(plan.axis_vals, dev)
        # Probe, fallback and chunk step share one backend (and so, on the
        # card, one compiled eval_config).  The dense evaluator runs every
        # field, as the dense engine does.
        dense_eval = B.cached_dense_eval(plan.backend, plan.S, plan.shape,
                                         SW.kernel_fields(plan.S), dev)
        with _span("stream.probe", "probe_s"):
            seed_signed, hist_edges, axis_valid = _probe(
                dense_eval, axvals, plan.shape, n_total, objectives, sign,
                cons, plan.hist_bins, plan.hist_ranges, dev)

        # The consistent snapshot every recovery pivots on: the host carry,
        # the exact running front and the next flat-index cursor — every
        # chunk below ``base`` is folded in, nothing above it is.
        state = {"carry": B.init_carry(spec),
                 "front_vals": np.empty((0, d)),
                 "front_idx": np.empty((0,), np.int64),
                 "base": start0}
        mgr = None
        signature = ""
        if checkpoint_dir is not None:
            mgr = CheckpointManager(checkpoint_dir,
                                    keep=max(1, int(checkpoint_keep)))
            # Ranged runs suffix the signature, so a range's checkpoint never
            # restores into another range of the same job.
            signature = (plan.signature if flat_range is None else
                         f"{plan.signature}:r{start0}-{stop0}")
            _resume_into(mgr, signature, state, counters, chunk)

        def write_checkpoint():
            # Into the counters a checkpoint keeps, so a resumed run goes
            # on adding to them.
            with _span("stream.checkpoint", "checkpoint_write_s", counters):
                mgr.save(int(state["base"]),
                         {"carry": state["carry"],
                          "front_values": state["front_vals"],
                          "front_indices": state["front_idx"]},
                         metadata={"signature": signature,
                                   "next_flat": int(state["base"]),
                                   "counters": dict(counters),
                                   "format": B.CARRY_VERSION})
            counters["checkpoints_written"] += 1.0

        # Pre-cull the probe seed toward its near-front subset: the filter
        # build draws quantile bins and spread rows from the rows it is
        # given, and a mostly-dominated cloud drags both toward the data
        # mass instead of the front envelope.  Culling here is exact.
        if seed_signed.shape[0] > 4 * _FILTER_ROWS:
            f0 = P.build_dominance_filter(seed_signed, d, _FILTER_ROWS,
                                          _FILTER_BINS)
            seed_signed = seed_signed[P.dominance_filter_mask(
                f0, np.ascontiguousarray(seed_signed.T), xp=np)]
        cons_np = np.asarray([v for _, _, v in cons], np.float64)
        t_first = None
        n_fallback = 0
        n_replays = 0
        detector = StragglerDetector(policy.straggler_factor,
                                     policy.straggler_window)
        dispatched_flat = state["base"]     # dispatch high-water mark
        # Cooperative halt: set when should_stop fires before a dispatch;
        # the incarnation then folds exactly the dispatches already issued.
        ctl = {"halted": False}
        snap_t = {"last": time.perf_counter()}

        def drive():
            # One incarnation of the pipeline: load the snapshot into the
            # step of the current shard list (the merged carry on shard 0),
            # run every remaining dispatch, then advance the snapshot to
            # completion (or to the halt).  Raises on device loss or spent
            # retries; the loop below decides whether to replan or restart.
            nonlocal t_first, n_fallback, dispatched_flat, n_replays
            base = state["base"]
            if base >= stop0:           # resumed from a finished run
                return
            n_shards = len(dev_list)
            per_step = chunk * scan * n_shards
            n_sub = n_shards * scan     # chunks folded a dispatch
            n_run = -(-(stop0 - base) // per_step)
            step = B.cached_step(spec, plan.backend, scan, dev_list[0],
                                 dev_list if n_shards > 1 else None)
            replays0 = step.replays
            fetch = _Fetch(max(1, prefetch), dev)
            try:
                step.load(carry=state["carry"], axvals=plan.axis_vals,
                          cons=cons_np if cons else None,
                          hist_edges=hist_edges if plan.hist_bins else None)
                front_vals = state["front_vals"].copy()
                front_idx = state["front_idx"].copy()
                buf_vals: list = []             # pending front candidates
                buf_idx: list = []
                buf_n = 0
                filt_np: dict = {}              # host mirror of the filter
                last_ckpt = time.perf_counter()

                def rebuild_filter():
                    nonlocal filt_np
                    base_sg = (np.concatenate([front_vals * sign,
                                               seed_signed])
                               if seed_signed.size else front_vals * sign)
                    filt_np = P.build_dominance_filter(
                        base_sg, d, _FILTER_ROWS, _FILTER_BINS)
                    step.load(filt=filt_np)

                def merge(final=False):
                    # Fold the candidate buffer into the running exact front;
                    # on the card this overlaps the dispatches in flight.
                    nonlocal front_vals, front_idx, buf_vals, buf_idx, buf_n
                    with _span("stream.merge"):
                        if buf_n:
                            cat_v = np.concatenate(buf_vals)
                            cat_i = np.concatenate(buf_idx)
                            cat_sg = cat_v * sign
                            base_sg = np.concatenate(
                                [front_vals * sign, cat_sg, seed_signed])
                            f = P.build_dominance_filter(
                                base_sg, d, _FILTER_ROWS, _FILTER_BINS)
                            keep = P.dominance_filter_mask(
                                f, np.ascontiguousarray(cat_sg.T), xp=np)
                            front_vals, front_idx = _merge_into_front(
                                front_vals, front_idx, cat_v[keep],
                                cat_i[keep], sign)
                            buf_vals, buf_idx, buf_n = [], [], 0
                        if not final:
                            rebuild_filter()

                def host_chunk_survivors(dstart, vlen):
                    # Survivor-capacity overflow: re-derive this chunk's
                    # survivors exactly through the dense evaluator (the
                    # chunk step's backend), with the same constraint mask
                    # and (host-mirror) pre-filter.
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

                def maybe_snapshot(covered):
                    # A consistent progress snapshot over the folded prefix
                    # [start0, covered), if the cadence allows one.
                    if (on_snapshot is not None
                            and time.perf_counter() - snap_t["last"]
                            >= snapshot_every_s):
                        merge()
                        snap_t["last"] = time.perf_counter()
                        on_snapshot(_progress_snapshot(
                            covered - start0, span, front_vals, front_idx,
                            objectives, sign))

                def process(start, surv, defer_snap):
                    # One dispatch's survivors, chunk by chunk in ascending
                    # order (shard-major, scan-minor: shard d holds the scan
                    # chunks from start + d * scan * chunk).  ``defer_snap``:
                    # a checkpoint is due at this step, and its snapshot
                    # waits until it is on disk.
                    nonlocal buf_n, t_first, n_fallback
                    with _span("stream.host", "host_merge_s"):
                        flat_s, val_s, cnt_s = surv
                        for j in range(n_sub):
                            dstart = start + chunk * j
                            vlen = min(chunk, n_total - dstart)
                            if vlen <= 0:
                                break
                            cnt = int(cnt_s[j])
                            if cnt > cap:
                                n_fallback += 1
                                with _span("stream.fallback", "fallback_s"):
                                    fl, vv = host_chunk_survivors(dstart,
                                                                  vlen)
                            else:
                                # copies: the fetch's buffers are reused
                                fl = np.array(flat_s[j, :cnt], np.int64)
                                vv = np.array(val_s[j, :cnt], np.float64)
                            if len(fl):
                                buf_idx.append(fl)
                                buf_vals.append(vv)
                                buf_n += len(fl)
                                spent["survivors"] += len(fl)
                        if buf_n >= _MERGE_EVERY:
                            merge()
                        if not defer_snap:
                            maybe_snapshot(min(start + per_step, stop0))
                        if t_first is None:
                            t_first = time.perf_counter() - t0

                def dispatch(si):
                    # Injector hook + bounded in-place retry + the dispatch;
                    # returns the step's survivors.  A TransientDeviceError
                    # fires before the step touched the carry, so running it
                    # again in place is safe.
                    nonlocal dispatched_flat
                    start = base + si * per_step
                    dispatched_flat = max(dispatched_flat,
                                          min(start + per_step, stop0))
                    tstep = time.perf_counter()
                    if fault_injector is not None:
                        backoff = policy.backoff_s
                        for attempt in range(policy.max_retries + 1):
                            try:
                                fault_injector(start // chunk, start)
                                break
                            except TransientDeviceError:
                                counters["retries"] += 1.0
                                if attempt >= policy.max_retries:
                                    raise
                                time.sleep(backoff)
                                backoff = min(backoff * 2.0,
                                              policy.backoff_max_s)
                    with _span("stream.dispatch", "dispatch_s"):
                        out = step(start)
                    dur = time.perf_counter() - tstep
                    if detector.record(dur):
                        counters["stragglers"] += 1.0
                    if (policy.step_timeout_s is not None
                            and dur > policy.step_timeout_s):
                        counters["step_timeouts"] += 1.0
                    return out if isinstance(out, list) else [out]

                def ckpt_due(si):
                    # Snapshot cadence, decided at dispatch; the last step
                    # never snapshots here (completion writes the terminal
                    # checkpoint).
                    nonlocal last_ckpt
                    if mgr is None or si + 1 >= n_run:
                        return False
                    if checkpoint_every_steps is not None:
                        due = ((si + 1) % max(1, int(checkpoint_every_steps))
                               == 0)
                    else:
                        due = (time.perf_counter() - last_ckpt
                               >= checkpoint_every_s)
                    if due:
                        last_ckpt = time.perf_counter()
                    return due

                merged_first = False

                def consume():
                    # Wait for the oldest dispatch's survivors and fold them;
                    # chunk 0's reach the filter before chunk 1 is issued.
                    nonlocal merged_first
                    with _span("stream.wait", "device_wait_s"):
                        (start, due), surv = fetch.get()
                    process(start, surv, due)
                    if not merged_first:
                        merged_first = True
                        if n_run > 1:
                            merge()

                def issue(si):
                    surv = dispatch(si)
                    due = ckpt_due(si)
                    with _span("stream.dispatch", "dispatch_s"):
                        fetch.put((base + si * per_step, due), surv)
                    if due:
                        # Durability barrier: snapshot the carry right after
                        # step si, fold every survivor up to si, write the
                        # checkpoint, and only then dispatch further.
                        carry_si = step.carry_to_host()
                        while len(fetch):
                            consume()
                        merge()
                        state["carry"] = carry_si
                        state["front_vals"] = front_vals.copy()
                        state["front_idx"] = front_idx.copy()
                        state["base"] = min(base + (si + 1) * per_step,
                                            stop0)
                        write_checkpoint()
                        maybe_snapshot(state["base"])
                    if on_progress is not None:
                        on_progress(min(1.0,
                                        (dispatched_flat - start0) / span))

                rebuild_filter()                # front/seed filter
                depth = max(1, prefetch)
                si = 0
                while True:
                    while (si < n_run and not ctl["halted"]
                           and len(fetch) < depth
                           and (si == 0 or merged_first)):
                        if should_stop is not None and should_stop():
                            ctl["halted"] = True
                            break
                        issue(si)
                        si += 1
                    if not len(fetch):
                        break
                    consume()
                merge(final=True)
                state["carry"] = step.carry_to_host()
                state["front_vals"] = front_vals
                state["front_idx"] = front_idx
                # A halt finalizes at the dispatch high-water mark: every
                # chunk below it was issued and folded, so the snapshot is
                # the exact contiguous prefix.
                state["base"] = (min(dispatched_flat, stop0)
                                 if ctl["halted"] else stop0)
            finally:
                fetch.close()
                n_replays += step.replays - replays0
                step.busy = False

        def reissue_count():
            # Chunks dispatched past the snapshot when an incarnation died:
            # the ranges the next one issues again.
            nonlocal dispatched_flat
            n = max(0, -(-(dispatched_flat - state["base"]) // chunk))
            dispatched_flat = state["base"]
            return float(n)

        restarts_left = policy.max_restarts
        while True:
            try:
                drive()
                break
            except DeviceLostError as e:
                counters["chunks_reissued"] += reissue_count()
                if len(dev_list) > 1:
                    # Elastic replan: drop the lost shard and re-issue the
                    # chunks past the snapshot on the survivors.
                    counters["elastic_replans"] += 1.0
                    dev_list = list(drop_worker(dev_list, e.device_index))
                elif restarts_left > 0:
                    # The last shard "died": restart it from the snapshot.
                    restarts_left -= 1
                    counters["restarts"] += 1.0
                else:
                    raise
            except _RESTARTABLE:
                # In-place retries spent: restart from the last snapshot.
                counters["chunks_reissued"] += reissue_count()
                if restarts_left <= 0:
                    raise
                restarts_left -= 1
                counters["restarts"] += 1.0
                time.sleep(min(policy.backoff_s
                               * (2.0 ** counters["restarts"]),
                               policy.backoff_max_s))
        # Terminal snapshot: resume == done (or, after a halt, resume ==
        # continue from the stop).
        if mgr is not None and mgr.latest_step() != state["base"]:
            write_checkpoint()
    total_s = spent["total_s"]

    # Deliverables come straight off the committed snapshot — the arrays
    # a checkpoint persists — so a resumed run and an uninterrupted one
    # return bitwise-identical results.
    carry = state["carry"]
    front_vals, front_idx = state["front_vals"], state["front_idx"]
    partial = int(state["base"]) < stop0
    stats = {
        "n_configs": float(n_total),
        "n_chunks": float(n_steps),
        "fraction_complete": ((int(state["base"]) - start0) / span
                              if span else 1.0),
        "range_start": float(start0),
        "range_stop": float(stop0),
        "total_s": total_s,
        "first_chunk_s": t_first if t_first is not None else total_s,
        "configs_per_s": span / total_s if total_s else float("inf"),
        "steady_configs_per_s": (
            (span - min(per_step, span))
            / max(total_s - (t_first or 0.0), 1e-9)
            if n_steps > 1 else span / max(total_s, 1e-9)),
        "steps_per_s": n_steps / total_s if total_s else float("inf"),
        "scan_chunks": float(scan),
        "prefetch": float(prefetch),
        "graph_replays": float(n_replays),
        "fallback_chunks": float(n_fallback),
        # This call's spans (each also a host range, under this call's
        # ``stream_grid`` range in a profiler's trace) and counters.
        # host_merge_s: handling a dispatch's survivors on the host
        # (``process``): buffering them, the overflow fallbacks
        # (fallback_s of it: re-deriving the survivors of chunks that
        # overflowed), and the merges and progress snapshots that
        # handling triggers; not the first filter build, the first-chunk
        # merge, a checkpoint barrier's merges nor the final merge (each
        # merge is a ``stream.merge`` range).  device_wait_s: blocked on
        # a dispatch's survivors (device work not hidden behind the
        # host, plus the copy).  dispatch_s: issuing the steps (on the
        # card host time: writing the start, replaying the graph,
        # queueing the copies).  probe_s: the strided probe.
        # step_build_s, step_builds: chunk steps built (on the card with
        # their warm-up and graph capture), not found in the step cache.
        # survivors: candidate rows that reached the host buffer (the
        # steps' compacted survivors and the rows fallbacks re-derived).
        # fold_kernel_chunks: chunks the steps' graph replays folded with
        # the "cuda" backend's fold kernel (0 where fold_chunk's torch
        # ops fold them).
        **spent,
        **counters,
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
        chunk_size=chunk, n_devices=n_dev,
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
        hist=hist_out, stats=stats, constraints=cons, partial=partial,
        backend=plan.backend)


# ---------------------------------------------------------------------------
# Cross-range folding (the worker pool's merge step)
# ---------------------------------------------------------------------------


def _carry_from_result(res: StreamResult, sign: np.ndarray,
                       n_total: int) -> dict:
    """The serialization-form carry of one :class:`StreamResult`, exactly
    (``topk_val`` is stored ``carry * sign`` with ``sign`` in ±1, so
    multiplying by ``sign`` again is a bitwise round trip, the ±inf
    sentinels included)."""
    fields = tuple(res.min_val)
    carry = {
        "min_val": np.array([res.min_val[f] for f in fields], np.float64),
        "min_idx": np.array([res.min_idx[f] for f in fields], np.int64),
        "finite": np.array([res.finite_counts[f] for f in fields],
                           np.int64),
        "fmin": np.array([res.channel_min[f] for f in fields], np.float64),
        "fmax": np.array([res.channel_max[f] for f in fields], np.float64),
        "topk_val": np.asarray(res.topk_val, np.float64) * sign[:, None],
        "topk_idx": np.where(np.isfinite(res.topk_val),
                             np.asarray(res.topk_idx, np.int64), n_total),
    }
    if res.hist is not None:
        carry["hist"] = np.stack([np.asarray(res.hist[f][0], np.int64)
                                  for f in res.objectives])
    return carry


def merge_results(parts: Sequence[StreamResult]) -> StreamResult:
    """Fold the results of ``flat_range=`` runs whose ranges tile ``[0,
    n_configs)`` into one, bitwise equal to a single sweep of the whole
    grid: every carry reduction is associative with the dense path's tie
    rules (:func:`repro_torch.core.backend.merge_device_carries`) and the
    parts' fronts merge exactly (:func:`_merge_into_front`).  Parts may
    come in any order.  Raises :class:`ValueError` on gaps, overlaps,
    partial parts or parts of different specifications."""
    if not parts:
        raise ValueError("merge_results needs at least one part")
    parts = sorted(parts, key=lambda r: r.stats.get("range_start", 0.0))
    first = parts[0]
    n_total = first.n_configs
    fields = tuple(first.min_val)
    sign = np.where([o in first.maximize for o in first.objectives],
                    -1.0, 1.0)
    cursor = 0
    for r in parts:
        if (r.axes != first.axes or r.objectives != first.objectives
                or r.maximize != first.maximize
                or tuple(r.min_val) != fields
                or r.constraints != first.constraints):
            raise ValueError("merge_results: parts from different "
                             "sweep specifications")
        start = int(r.stats.get("range_start", 0))
        stop = int(r.stats.get("range_stop", r.n_configs))
        if start != cursor:
            raise ValueError(
                f"merge_results: range gap/overlap at flat index "
                f"{cursor} (next part starts at {start})")
        if r.partial:
            raise ValueError(
                f"merge_results: part [{start}, {stop}) is partial "
                f"({r.stats.get('fraction_complete', 0.0):.1%})")
        cursor = stop
    if cursor != n_total:
        raise ValueError(f"merge_results: ranges cover [0, {cursor}) "
                         f"of {n_total} configs")

    t0 = time.perf_counter()
    k = first.topk_idx.shape[1]
    carry = B.merge_device_carries(B.stack_host_carries(
        [_carry_from_result(r, sign, n_total) for r in parts]), k)
    d = len(first.objectives)
    front_vals = np.empty((0, d))
    front_idx = np.empty((0,), np.int64)
    for r in parts:
        front_vals, front_idx = _merge_into_front(
            front_vals, front_idx, np.asarray(r.front_values, np.float64),
            np.asarray(r.front_indices, np.int64), sign)

    hist_out = None
    if first.hist is not None:
        for r in parts[1:]:
            for f in first.objectives:
                if not np.array_equal(r.hist[f][1], first.hist[f][1]):
                    raise ValueError(
                        f"merge_results: histogram edges of {f!r} "
                        f"differ across parts")
        hist_out = {f: (np.asarray(carry["hist"][oi]),
                        np.asarray(first.hist[f][1]).copy())
                    for oi, f in enumerate(first.objectives)}

    summed = ("retries", "restarts", "checkpoints_written",
              "checkpoint_write_s", "chunks_reissued", "elastic_replans",
              "stragglers", "step_timeouts", "fallback_chunks",
              "n_chunks", "host_merge_s", "device_wait_s", "dispatch_s",
              "fallback_s", "probe_s", "step_build_s", "step_builds",
              "survivors", "fold_kernel_chunks")
    total_s = max(float(r.stats.get("total_s", 0.0)) for r in parts)
    stats = {
        "n_configs": float(n_total),
        "fraction_complete": 1.0,
        "range_start": 0.0,
        "range_stop": float(n_total),
        "n_parts": float(len(parts)),
        # The slowest part's wall time: with parts running concurrently
        # that is the job's, and configs_per_s its aggregate rate.
        "total_s": total_s,
        "configs_per_s": (n_total / total_s if total_s
                          else float("inf")),
        "first_chunk_s": min(float(r.stats.get("first_chunk_s", 0.0))
                             for r in parts),
        "merge_s": 0.0,
        **{kk: float(sum(r.stats.get(kk, 0.0) for r in parts))
           for kk in summed},
    }
    topk_val = carry["topk_val"] * sign[:, None]
    topk_idx = np.where(np.isfinite(carry["topk_val"]),
                        carry["topk_idx"], n_total)
    stats["merge_s"] = time.perf_counter() - t0
    return StreamResult(
        axes=first.axes, objectives=first.objectives,
        maximize=first.maximize, chunk_size=first.chunk_size,
        n_devices=sum(r.n_devices for r in parts),
        min_val={f: float(carry["min_val"][i])
                 for i, f in enumerate(fields)},
        min_idx={f: int(carry["min_idx"][i])
                 for i, f in enumerate(fields)},
        finite_counts={f: int(carry["finite"][i])
                       for i, f in enumerate(fields)},
        channel_min={f: float(carry["fmin"][i])
                     for i, f in enumerate(fields)},
        channel_max={f: float(carry["fmax"][i])
                     for i, f in enumerate(fields)},
        axis_valid=OrderedDict((kk, np.asarray(v).copy())
                               for kk, v in first.axis_valid.items()),
        topk_val=topk_val, topk_idx=topk_idx,
        front_indices=front_idx, front_values=front_vals,
        hist=hist_out, stats=stats, constraints=first.constraints,
        partial=False, backend=first.backend)
