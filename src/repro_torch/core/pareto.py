"""Multi-objective Pareto analysis over design-space grids.

The paper's core claim is that the distributed on-sensor architecture wins
on *power, latency, and MIPI traffic simultaneously* — which makes the
partition search a multi-objective problem, not an ``argmin`` over one
channel.  This module extracts exact non-dominated sets from the dense
grids of :func:`repro_torch.core.sweep.evaluate_grid`:

* :func:`non_dominated_mask` — exact dominance filtering over an ``(n, d)``
  objective matrix: a lexicographic sort (dominators always precede the
  points they dominate) followed by chunked, vectorized culling against
  the running front, so cost scales with ``n × front_size`` instead of
  ``n²`` on realistic grids.  Rows with any non-finite entry (the NaN
  invalid-MRAM corners of the grid engine) are masked out up front.
* :func:`pareto_front` — the front of a :class:`~repro_torch.core.sweep.
  SweepResult` over arbitrary objective channels, each minimized by
  default or maximized via ``maximize=``.
* :func:`hypervolume` — exact dominated hypervolume w.r.t. a reference
  point (sweep for d ≤ 2, recursive objective slicing above), the scalar
  front-quality metric benchmarked in ``benchmarks/pareto_bench.py``.
* :func:`knee_point` — the balanced-compromise point: minimum Euclidean
  distance to the ideal point after per-objective [0, 1] normalization.

Dominance convention throughout (minimization): ``a`` dominates ``b`` iff
``a <= b`` in every objective and ``a < b`` in at least one.  Duplicate
points do not dominate each other, so ties survive into the front.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping, Sequence

import numpy as np
import torch

from .sweep import SweepResult

#: The paper's three headline objectives, all minimized.
DEFAULT_OBJECTIVES = ("avg_power", "latency", "mipi_bytes_per_s")

_CHUNK = 512   # pairwise-dominance block size (memory ~ chunk × n × d)


def non_dominated_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of the non-dominated rows of an ``(n, d)`` matrix.

    Minimization in every column; rows containing NaN/inf are never part
    of the front.  Exact: after a lexicographic sort any dominator
    precedes the points it dominates, and (by transitivity) a point
    dominated by a *discarded* point is also dominated by whichever front
    member discarded it — so checking each chunk against the running
    front plus pairwise within the chunk's survivors loses nothing.
    Worst case (everything mutually non-dominated) degrades gracefully to
    the plain O(n²) pairwise sweep.
    """
    pts = np.asarray(points, np.float64)
    if pts.ndim != 2:
        raise ValueError(f"expected (n, d) objective matrix, got {pts.shape}")
    mask = np.zeros(pts.shape[0], bool)
    idx = np.flatnonzero(np.isfinite(pts).all(axis=1))
    if idx.size == 0:
        return mask
    if idx.size <= 1024:
        # Small-set fast path: one shot of per-column (n, n) pairwise
        # compares — the sorted running-front machinery below has a fixed
        # cost that dwarfs sets this size (~10× slower at n=600,
        # measured).  Same dominance semantics, ties survive.
        Q = pts[idx]
        le = (Q[:, None, 0] <= Q[None, :, 0])
        lt = (Q[:, None, 0] < Q[None, :, 0])
        for c in range(1, Q.shape[1]):
            le &= Q[:, None, c] <= Q[None, :, c]
            lt |= Q[:, None, c] < Q[None, :, c]
        mask[idx] = ~(le & lt).any(axis=0)
        return mask
    order = np.lexsort(pts[idx].T[::-1])    # by col 0, ties by col 1, ...
    Q = pts[idx][order]
    out = np.zeros(Q.shape[0], bool)
    front = Q[:0]
    for lo in range(0, Q.shape[0], _CHUNK):
        blk = Q[lo:lo + _CHUNK]                              # (b, d)
        if front.shape[0]:
            le = (front[None, :, :] <= blk[:, None, :]).all(-1)
            lt = (front[None, :, :] < blk[:, None, :]).any(-1)
            alive = np.flatnonzero(~(le & lt).any(axis=1))
        else:
            alive = np.arange(blk.shape[0])
        if alive.size:
            B = blk[alive]                                   # pairwise
            le = (B[None, :, :] <= B[:, None, :]).all(-1)
            lt = (B[None, :, :] < B[:, None, :]).any(-1)
            sel = alive[~(le & lt).any(axis=1)]
            out[lo + sel] = True
            front = np.concatenate([front, blk[sel]], axis=0)
    mask[idx[order]] = out
    return mask


def merge_fronts(values_a: np.ndarray, indices_a: np.ndarray,
                 values_b: np.ndarray, indices_b: np.ndarray,
                 sign: np.ndarray | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Merge two partial non-dominated sets into one exact front.

    This is the incremental-front primitive of the streaming executor
    (:mod:`repro_torch.core.stream`): each chunk's surviving candidates are
    merged into the running front, so the exact Pareto front of an
    arbitrarily large grid is built with O(front + chunk) memory.
    ``values_*`` are ``(n, d)`` objective rows in their *natural*
    orientation with ``indices_*`` the flat grid indices; ``sign`` (+1
    minimize / -1 maximize per column, default all minimize) orients the
    dominance test.  Rows are deterministically ordered by flat index, so
    merging is associative and chunk-order independent.
    """
    Va = np.asarray(values_a, np.float64)
    Vb = np.asarray(values_b, np.float64)
    if Va.size == 0 and Va.ndim != 2:
        Va = Va.reshape(0, Vb.shape[1] if Vb.ndim == 2 else 0)
    if Vb.size == 0 and Vb.ndim != 2:
        Vb = Vb.reshape(0, Va.shape[1])
    V = np.concatenate([Va, Vb], axis=0)
    I = np.concatenate([np.asarray(indices_a, np.int64),
                        np.asarray(indices_b, np.int64)])
    if V.shape[0] != I.shape[0]:
        raise ValueError(f"values/indices length mismatch "
                         f"{V.shape[0]} != {I.shape[0]}")
    order = np.argsort(I, kind="stable")
    V, I = V[order], I[order]
    s = np.ones(V.shape[1]) if sign is None else np.asarray(sign, np.float64)
    keep = non_dominated_mask(V * s)
    return V[keep], I[keep]


# ---------------------------------------------------------------------------
# Dominance pre-filter (shared by the streaming executor's device chunk
# step and its host fallback path)
# ---------------------------------------------------------------------------


def _spread_rows(front_signed: np.ndarray, rows: int, d: int) -> np.ndarray:
    """Subsample a signed front into a fixed-size explicit-row filter.

    Rows are drawn at quantiles of the front sorted along *every*
    objective (not just the first) — a front with hundreds of members
    spreads differently along each trade-off axis, and a filter that only
    walks the first objective leaves holes that flood the exact merge
    with false survivors.  Unused rows are ``+inf`` (dominate nothing).
    """
    filt = np.full((rows, d), np.inf)
    k = front_signed.shape[0]
    if k == 0:
        return filt
    if k <= rows:
        filt[:k] = front_signed
        return filt
    per = max(1, rows // d)
    picks: list = []
    for col in range(d):
        order = np.argsort(front_signed[:, col], kind="stable")
        picks.extend(order[np.round(np.linspace(0, k - 1, per))
                           .astype(int)])
    take = np.unique(np.asarray(picks))[:rows]
    filt[:take.size] = front_signed[take]
    return filt


def build_dominance_filter(front_signed: np.ndarray, d: int,
                           rows: int = 24, bins: int = 64) -> dict:
    """Fixed-shape dominance pre-filter state over a signed running front.

    Two sufficient conditions for "this point is dominated" (so discarding
    is always exact; everything uncertain survives into the exact merge):

    * a few explicit front rows (:func:`_spread_rows`), checked directly;
    * for ``2 <= d <= 3``, a quantile-binned prefix-min table over the
      front: ``table[b1(, b2)]`` is the best (signed) first objective
      among front members whose objective-1/2 values fall in a *strictly
      lower* bin — ``table[pb1-1(, pb2-1)] <= p0`` therefore proves a
      member with ``m0 <= p0, m1 < p1 (, m2 < p2)`` exists, i.e. true
      domination.  This scales with front *shape*, not front size, which
      keeps survivor counts flat as fronts grow into the hundreds.

    Every array has a shape that depends only on ``(d, rows, bins)`` —
    never on the front size — so the streaming executor can pass the
    state straight into its compiled chunk step without retracing.
    Returns ``{"rows": (rows, d)}`` plus ``{"edges": (d-1, bins+1),
    "table": (bins+1,)*(d-1)}`` when the bin table applies (all ``+inf``
    when the front is still too small to bin).
    """
    F = np.asarray(front_signed, np.float64).reshape(-1, d)
    state = {"rows": _spread_rows(F, rows, d)}
    if not 2 <= d <= 3:
        return state
    edges = np.full((d - 1, bins + 1), np.inf)
    table = np.full((bins + 1,) * (d - 1), np.inf)
    if F.shape[0] >= 8:
        q = np.linspace(0, 1, bins + 1)
        for c in range(1, d):
            edges[c - 1] = np.quantile(F[:, c], q)
        # Members sit in [edges[0], edges[-1]] (the quantile endpoints are
        # the exact min/max), so searchsorted-1 lands in [0, bins] with no
        # clipping — duplicate edges are fine (some bins just stay empty).
        bin_idx = tuple(
            np.searchsorted(edges[c - 1], F[:, c], side="right") - 1
            for c in range(1, d))
        np.minimum.at(table, bin_idx, F[:, 0])
        for ax in range(table.ndim):
            table = np.minimum.accumulate(table, axis=ax)
    state["edges"] = edges
    state["table"] = table
    return state


def dominance_filter_mask(state: Mapping, Osg, xp=np):
    """Rows of signed ``(d, n)`` channel block ``Osg`` the filter cannot
    prove dominated (finite rows only — masked/infeasible lanes are
    ``inf``/NaN and never survive).

    ``xp`` selects the array namespace (``numpy`` here; the device
    version is :func:`dominance_filter_mask_torch`, the same expression
    over torch tensors).  Discarding is exact (both filter conditions
    are sufficient for domination); survivors still go through
    :func:`merge_fronts`.
    """
    rows = state["rows"]
    n_rows, d = rows.shape
    fin = xp.isfinite(Osg[0])
    for c in range(1, d):
        fin = fin & xp.isfinite(Osg[c])
    # Unrolled over the few filter rows so every op stays a flat (n,)
    # vector pass — a (rows, d, n) broadcast materializes ~10× the
    # intermediates and is an order of magnitude slower on CPU, both for
    # numpy and for the XLA lowering (which fuses this whole unrolled
    # chain into one loop over n).
    dom = xp.zeros(Osg.shape[1], bool)
    for r in range(n_rows):
        le = rows[r, 0] <= Osg[0]
        lt = rows[r, 0] < Osg[0]
        for c in range(1, d):
            le = le & (rows[r, c] <= Osg[c])
            lt = lt | (rows[r, c] < Osg[c])
        dom = dom | (le & lt)
    table = state.get("table")
    if table is not None:
        edges = state["edges"]
        ok = None
        idxs = []
        for c in range(1, d):
            # Strictly-lower bin: a member binned below edges[c-1][b+1]
            # has a value < edges[c-1][b+1] <= p, hence strictly smaller.
            b = xp.searchsorted(edges[c - 1], Osg[c], side="right") - 2
            ok = (b >= 0) if ok is None else (ok & (b >= 0))
            idxs.append(xp.clip(b, 0, table.shape[0] - 1))
        dom = dom | (ok & (table[tuple(idxs)] <= Osg[0]))
    return fin & ~dom


def dominance_filter_mask_torch(state: Mapping, Osg):
    """:func:`dominance_filter_mask` over torch tensors on any device:
    ``state`` holds the filter arrays as tensors on ``Osg``'s device.
    A separate twin because ``torch.searchsorted`` takes ``right=`` and a
    contiguous query where numpy takes ``side=``."""
    rows = state["rows"]
    n_rows, d = rows.shape
    fin = torch.isfinite(Osg[0])
    for c in range(1, d):
        fin = fin & torch.isfinite(Osg[c])
    dom = torch.zeros(Osg.shape[1], dtype=torch.bool, device=Osg.device)
    for r in range(n_rows):
        le = rows[r, 0] <= Osg[0]
        lt = rows[r, 0] < Osg[0]
        for c in range(1, d):
            le = le & (rows[r, c] <= Osg[c])
            lt = lt | (rows[r, c] < Osg[c])
        dom = dom | (le & lt)
    table = state.get("table")
    if table is not None:
        edges = state["edges"]
        ok = None
        idxs = []
        for c in range(1, d):
            # Strictly-lower bin: a member binned below edges[c-1][b+1]
            # has a value < edges[c-1][b+1] <= p, hence strictly smaller.
            b = torch.searchsorted(edges[c - 1].contiguous(),
                                   Osg[c].contiguous(), right=True) - 2
            ok = (b >= 0) if ok is None else (ok & (b >= 0))
            idxs.append(torch.clamp(b, 0, table.shape[0] - 1))
        dom = dom | (ok & (table[tuple(idxs)] <= Osg[0]))
    return fin & ~dom


def knee_point(points: np.ndarray) -> int:
    """Index of the knee (balanced compromise) of a front.

    Each objective is normalized to [0, 1] over the given points; the knee
    is the point closest (Euclidean) to the normalized ideal ``(0, ..., 0)``
    — extreme points that win one objective by sacrificing the others sit
    at distance ~1, the elbow of the trade-off curve sits closest.
    """
    P = np.asarray(points, np.float64)
    if P.ndim != 2 or P.shape[0] == 0:
        raise ValueError("knee_point needs a non-empty (n, d) matrix")
    lo, hi = P.min(axis=0), P.max(axis=0)
    span = np.where(hi > lo, hi - lo, 1.0)
    return int(np.argmin(np.linalg.norm((P - lo) / span, axis=1)))


#: Largest non-dominated point count the exact d>=3 slicer accepts.
#: The recursive slicing is exponential in the worst case (each slice
#: re-solves a (d-1)-dim subproblem over a growing prefix), so beyond
#: ~1e3 front points it silently turns into hours of compute; d<=2
#: stays an O(n log n) sweep and is unbounded.
HV_EXACT_MAX_POINTS = 1000


def hypervolume(points: np.ndarray, ref: Sequence[float]) -> float:
    """Exact dominated hypervolume of ``points`` w.r.t. ``ref`` (minimize).

    The Lebesgue measure of the region dominated by the point set and
    bounded above by the reference point — the standard scalar quality
    metric for a Pareto front (larger is better).  Points that do not
    strictly dominate ``ref`` contribute nothing.  Exact sweep for d ≤ 2;
    recursive slicing over the last objective for d ≥ 3 (fine for the
    front sizes the grids here produce, typically tens of points).

    For d ≥ 3 the non-dominated survivor count is capped at
    :data:`HV_EXACT_MAX_POINTS` — beyond that the exact slicer's cost
    explodes, so the call raises ``ValueError`` instead of silently
    hanging; reduce to 2 objectives or subsample the front first.
    """
    ref = np.asarray(ref, np.float64)
    P = np.asarray(points, np.float64)
    if P.ndim != 2 or P.shape[1] != ref.shape[0]:
        raise ValueError(f"points {P.shape} incompatible with ref {ref.shape}")
    P = P[np.isfinite(P).all(axis=1)]
    P = P[(P < ref).all(axis=1)]
    if P.shape[0] == 0:
        return 0.0
    P = P[non_dominated_mask(P)]
    if ref.shape[0] >= 3 and P.shape[0] > HV_EXACT_MAX_POINTS:
        raise ValueError(
            f"hypervolume: {P.shape[0]} non-dominated points in "
            f"{ref.shape[0]}-D exceeds the exact slicer's bound of "
            f"{HV_EXACT_MAX_POINTS} — runtime would explode; reduce to "
            f"2 objectives or subsample the front first")
    return _hv(sorted(map(tuple, P)), tuple(ref))


def _hv(pts: list[tuple], ref: tuple) -> float:
    d = len(ref)
    if d == 1:
        return ref[0] - min(p[0] for p in pts)
    if d == 2:
        # Sweep ascending in obj0; on a front, obj1 is then descending.
        hv, y_cover = 0.0, ref[1]
        for x, y in sorted(pts):
            if y < y_cover:
                hv += (ref[0] - x) * (y_cover - y)
                y_cover = y
        return hv
    # Slice along the last objective: between consecutive z values the
    # cross-section is the (d-1)-dim hypervolume of the points at or below.
    order = sorted(pts, key=lambda p: p[-1])
    hv = 0.0
    for i, p in enumerate(order):
        z_hi = order[i + 1][-1] if i + 1 < len(order) else ref[-1]
        if z_hi > p[-1]:
            hv += (z_hi - p[-1]) * _hv([q[:-1] for q in order[:i + 1]],
                                       ref[:-1])
    return hv


@dataclasses.dataclass(frozen=True)
class ParetoFront:
    """The exact non-dominated set of one grid over chosen objectives.

    ``values`` holds the objective channels in their natural orientation
    (rows sorted by the first objective, best first); ``indices`` are flat
    indices into the originating grid, so ``result.config_at(indices[i])``
    recovers the knob settings of front member ``i``.  ``result`` may be a
    dense :class:`~repro_torch.core.sweep.SweepResult` or any duck-typed result
    exposing ``config_at``/``channel_bounds`` (the streaming executor's
    ``StreamResult`` qualifies — its front is this same class).
    """

    result: SweepResult
    objectives: tuple[str, ...]
    maximize: tuple[str, ...]
    indices: np.ndarray          # (k,) flat grid indices
    values: np.ndarray           # (k, d) objective values, natural signs

    @property
    def size(self) -> int:
        return int(self.indices.size)

    def _signed(self, values: np.ndarray) -> np.ndarray:
        sign = np.where([o in self.maximize for o in self.objectives],
                        -1.0, 1.0)
        return values * sign

    def configs(self) -> list[dict]:
        """Knob settings + objective values of every front member."""
        out = []
        for flat, vals in zip(self.indices, self.values):
            cfg = self.result.config_at(int(flat))
            cfg.update(zip(self.objectives, map(float, vals)))
            out.append(cfg)
        return out

    def knee(self) -> dict:
        """Config dict of the balanced-compromise member (see
        :func:`knee_point`)."""
        return self.configs()[knee_point(self._signed(self.values))]

    def hypervolume(self, ref: Mapping[str, float] | None = None) -> float:
        """Dominated hypervolume of the front (larger is better).

        ``ref`` maps objective name -> reference value; when omitted, the
        per-objective worst *valid* value over the whole originating grid
        is used (nudged outward by 1e-9 of the span so nadir points still
        count).  Pass an explicit ``ref`` when comparing fronts extracted
        from different grids.
        """
        if ref is not None:
            r = self._signed(
                np.asarray([ref[o] for o in self.objectives], np.float64))
        else:
            # The originating result only needs to expose channel_bounds()
            # — both the dense SweepResult and the streaming StreamResult
            # do, so fronts from either path price identically.
            r = []
            for o in self.objectives:
                lo, hi = self.result.channel_bounds(o)
                s_lo, s_hi = ((-hi, -lo) if o in self.maximize
                              else (lo, hi))
                span = (s_hi - s_lo) or 1.0
                r.append(s_hi + 1e-9 * span)
            r = np.asarray(r, np.float64)
        return hypervolume(self._signed(self.values), r)


def pareto_front(result: SweepResult,
                 objectives: Sequence[str] = DEFAULT_OBJECTIVES,
                 maximize: Iterable[str] = ()) -> ParetoFront:
    """Extract the exact Pareto front of a sweep over objective channels.

    ``objectives`` name fields of ``result.data`` (see ``sweep.FIELDS``);
    each is minimized unless listed in ``maximize``.  Grid configurations
    with a NaN in any selected channel — the invalid MRAM corners — are
    excluded.  Returns a :class:`ParetoFront` sorted by the first
    objective (best first).
    """
    objectives = tuple(objectives)
    maximize = tuple(maximize)
    if len(objectives) < 1:
        raise ValueError("need at least one objective channel")
    unknown = [o for o in objectives if o not in result.data]
    if unknown:
        raise ValueError(f"unknown objective channels {unknown}; "
                         f"have {sorted(result.data)}")
    stray = [o for o in maximize if o not in objectives]
    if stray:
        raise ValueError(f"maximize entries {stray} not in objectives")

    V = np.stack([np.asarray(result.data[o], np.float64).ravel()
                  for o in objectives], axis=1)
    if V.shape[0] and not np.isfinite(V).all(axis=1).any():
        # Mirror SweepResult.argmin: an all-invalid grid is a configuration
        # error (e.g. MRAM-only on a node with no MRAM vehicle), not an
        # empty front.
        from .sweep import _fully_invalid_axis_values, invalid_message
        nan = ~np.isfinite(V).all(axis=1).reshape(result.shape)
        raise ValueError(invalid_message(
            "/".join(objectives),
            _fully_invalid_axis_values(nan, result.axes)))
    sign = np.where([o in maximize for o in objectives], -1.0, 1.0)
    Vs = V * sign
    if Vs.shape[0] > (1 << 16):
        # Large grids: cull the bulk with the sampled dominance
        # pre-filter before the exact pass — discarding is exact (every
        # culled row is strictly dominated by an evaluated witness), so
        # the front is unchanged while the n·front exact scan only ever
        # sees the near-front band (~60x faster on a 10⁶-row grid).
        sample = Vs[::max(1, Vs.shape[0] // 4096)]
        sample = sample[np.isfinite(sample).all(axis=1)]
        if sample.shape[0] > 64:
            state = build_dominance_filter(sample, Vs.shape[1])
            sample = sample[dominance_filter_mask(
                state, np.ascontiguousarray(sample.T))]
            state = build_dominance_filter(sample, Vs.shape[1])
            band = np.flatnonzero(dominance_filter_mask(
                state, np.ascontiguousarray(Vs.T)))
            mask = np.zeros(Vs.shape[0], bool)
            mask[band[non_dominated_mask(Vs[band])]] = True
        else:
            mask = non_dominated_mask(Vs)
    else:
        mask = non_dominated_mask(Vs)
    idx = np.flatnonzero(mask)
    vals = V[idx]
    order = np.argsort(vals[:, 0] * sign[0], kind="stable")
    return ParetoFront(result=result, objectives=objectives,
                       maximize=maximize, indices=idx[order],
                       values=vals[order])
