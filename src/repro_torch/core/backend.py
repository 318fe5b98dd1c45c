"""Evaluation-backend layer: one chunk contract for every engine.

The PyTorch counterpart of the reference ``repro.core.backend``.  Every
engine runs through the same **chunk-evaluation contract**::

    decode flat indices -> evaluate tracked channels
                        -> fold block reductions into the running carry

* :class:`EvalBackend` — the backend protocol.  ``build_dense_eval``
  covers the first arrow (``fn(axvals, flat) -> {field: values}``): the
  dense engine runs the whole grid as one chunk through it, and the
  streaming probe and survivor-overflow fallback reuse it.
  ``build_chunk_eval`` adds the constraint mask, the Pareto dominance
  pre-filter and the per-block reductions :func:`fold_chunk` consumes.
* Two registered backends: ``"torch"``, the plain PyTorch version
  (:func:`plain_dense`, :func:`plain_chunk`), and ``"cuda"``, the
  hand-written kernels of :mod:`repro_torch.kernels.sweep_grid` (which
  registers itself on first request).  ``backend=None`` resolves to
  ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU, and to
  ``"torch"`` on either for a scenario sweep (:func:`default_backend`).
* :func:`fold_chunk` — torch ops: folds one chunk's block partials into
  the running carry (argmin with first-minimum tie-breaking, counts,
  bounds, the exact per-objective top-k merge, optional histograms) and
  compacts the dominance survivors.  ``build_chunk_fold`` gives a
  backend's fold of a dispatch's chunks: :func:`fold_chunks` (these ops)
  by default, kernel F on the ``"cuda"`` backend, bit for bit the same.
* :class:`ChunkStep` (:func:`build_step` / :func:`cached_step`) — ``K``
  consecutive chunk folds as one dispatch (the reference's ``lax.scan``
  scan fusion), over state kept on the device at fixed addresses.  On a
  CUDA device the ``K`` folds are one captured CUDA graph, replayed once
  a dispatch; on the CPU they run as a loop.
* :class:`ShardedStep` — several shards, one :class:`ChunkStep` each
  (the counterpart of the reference's ``pmap``-sharded step: one carry a
  device, merged on the host by :func:`merge_device_carries`).  A device
  may repeat in the shard list; on a card every shard owns its step, its
  graph (and graph pool) and its stream.
* The carry's serialization contract: :data:`CARRY_VERSION`,
  :func:`merge_device_carries`, :func:`stack_host_carries` and the
  content hash :func:`job_signature` that keys checkpoints.

All channel arithmetic is float64; flat indices are int64.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import contextlib
import functools
import hashlib
import importlib
import threading
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from . import arrays as A
from . import pareto as P
from . import sweep as SW
from .spans import count as _count
from .spans import span as _span

_REGISTRY: "OrderedDict[str, EvalBackend]" = OrderedDict()

#: Backends that register themselves on first request: name -> module.
_LAZY = {"cuda": "repro_torch.kernels.sweep_grid"}


class EvalBackend:
    """Protocol of an evaluation backend (see the module docstring).

    Both builders take the device the evaluation runs on; the model
    tables are packed onto it once per build (:func:`device_tables`).
    ``supports_multi_device`` gates the several-shard step
    (:class:`ShardedStep`, the reference's ``supports_pmap``), and
    ``supports_scenarios`` scenario-wrapped lowerings
    (``scenario.ScenarioStack``, the session evaluation): a backend that
    re-implements the evaluation in a kernel of its own, like the
    ``"cuda"`` one, opts out of both, as the reference's Pallas backend
    does.
    """

    name: str = "?"
    supports_multi_device: bool = True
    supports_scenarios: bool = True

    def build_dense_eval(self, S, shape: tuple[int, ...],
                         fields: Sequence[str], device) -> Callable:
        """``fn(axvals, flat) -> {field: (n,) tensor}``: decode flat
        C-order indices, gather the axis values, evaluate ``fields``.
        ``axvals`` is the tuple of per-axis device tensors
        (:func:`repro_torch.core.sweep.axes_to_device`)."""
        raise NotImplementedError

    def build_chunk_eval(self, spec: "ChunkSpec", device) -> Callable:
        """``fn(axvals, aux, start, base=None) -> partials``: evaluate the
        chunk ``[base + start, base + start + spec.chunk)`` and return the
        block partials of :func:`chunk_partials`.  ``start`` is a host
        integer; ``base``, when given, a 0-d int64 tensor on the device,
        read there (so a captured CUDA graph can be replayed at any
        start)."""
        raise NotImplementedError

    def build_chunk_fold(self, spec: "ChunkSpec", device) -> Callable:
        """``fold(carry, aux, base, partials_at, scan) -> survivors``:
        fold chunks ``0 .. scan - 1`` of a dispatch, in order, into the
        device carry ``carry`` (updated in place).  Chunk ``j`` starts at
        ``base + j * spec.chunk`` (``base`` a 0-d int64 tensor) and its
        partials are ``partials_at(j * spec.chunk)``, the chunk
        evaluation, run when the fold asks for them.  Returns the
        survivors ``(flat, values, count)`` with a leading ``scan`` axis.
        The default is :func:`fold_chunks`: :func:`fold_chunk`'s torch
        ops."""
        return functools.partial(fold_chunks, spec)

    def graph_replayed(self, spec: "ChunkSpec", chunks: int) -> None:
        """Account ``chunks`` chunk steps of ``spec`` that a CUDA-graph
        replay of :class:`ChunkStep` just launched (the kernel wrappers
        count their eager launches themselves)."""


def register_backend(backend: EvalBackend) -> EvalBackend:
    """Register ``backend`` under ``backend.name`` (last one wins)."""
    _REGISTRY[backend.name] = backend
    return backend


def available_backends() -> tuple[str, ...]:
    """Names accepted by the ``backend=`` knob (registered + lazy)."""
    return tuple(dict.fromkeys((*_REGISTRY, *_LAZY)))


def default_backend(device, scenarios: bool = False) -> str:
    """The backend ``backend=None`` resolves to on ``device``.

    ``"cuda"`` (the hand-written kernels) on a CUDA device, ``"torch"``
    elsewhere.  A scenario sweep (``scenarios=True``: the lowering is a
    ``scenario.ScenarioStack``) resolves to ``"torch"`` on any device,
    the card included: the counterpart of the reference, whose sessions
    run only on its default ``xla`` backend (no TPU kernel computes the
    session loop, and the kernels here refuse it).  It runs where the
    caller's tensors are; it is never a move to the CPU.
    """
    if scenarios:
        return "torch"
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def get_backend(name: str | None = None, device="cuda",
                scenarios: bool = False) -> EvalBackend:
    """Resolve a backend name (``None`` -> :func:`default_backend` of
    ``device`` and ``scenarios``); raises :class:`ValueError` naming the
    available backends for unknown names."""
    name = name or default_backend(device, scenarios)
    if name not in _REGISTRY and name in _LAZY:
        importlib.import_module(_LAZY[name])
    be = _REGISTRY.get(name)
    if be is None:
        raise ValueError(f"unknown evaluation backend {name!r}; "
                         f"available: {available_backends()}")
    return be


def is_scenario(S) -> bool:
    """Whether ``S`` is a scenario-wrapped lowering (duck-checked via the
    ``is_scenario`` marker, so plain model stacks cost nothing)."""
    return getattr(S, "is_scenario", False)


def check_scenario_support(be: EvalBackend, S) -> None:
    """Reject a scenario-wrapped lowering on a backend that cannot run
    the session evaluation, naming the backends that can."""
    if is_scenario(S) and not be.supports_scenarios:
        scen = tuple(n for n in available_backends()
                     if get_backend(n).supports_scenarios)
        raise ValueError(
            f"evaluation backend {be.name!r} does not support "
            f"scenario sweeps (the session lax.scan kernel); "
            f"scenario-capable backends: {scen}")


@functools.lru_cache(maxsize=16)
def _device_tables(S, device: str) -> A.DeviceTables:
    if is_scenario(S):
        from . import scenario as SC
        T = _device_tables(S.S, device)
        steps = torch.as_tensor(np.stack(S.step_tables), dtype=SW.F64,
                                device=device)
        return dataclasses.replace(
            T, views={**T.views, **dict(zip(SC.STEP_TABLES, steps))})
    return A.tables_to_device(S, device)


def device_tables(S, device) -> A.DeviceTables:
    """The packed table buffer of ``S`` on ``device``, built once per
    (stack, device) and kept (``S`` hashes by identity).  For a
    scenario stack: the wrapped stack's tables plus its step tables
    (``scenario.STEP_TABLES``, each ``(n_traces, n_steps)``) on the same
    device."""
    return _device_tables(S, str(torch.device(device)))


def lane_eval(S) -> Callable:
    """The plain evaluation ``(T, *coords) -> channels`` of decoded lanes
    for the lowering ``S``, chosen once when an evaluator is built:
    Eq. 1-11 (:func:`repro_torch.core.sweep.config_eval`), or for a
    scenario stack every static field plus the session channels
    (:func:`repro_torch.core.scenario.session_eval`)."""
    if is_scenario(S):
        from . import scenario as SC
        return functools.partial(SC.session_eval, S)
    return SW.config_eval


# ---------------------------------------------------------------------------
# The chunk contract
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ChunkSpec:
    """Static description of one chunk-evaluation problem: chunk
    geometry, tracked channels, constraint structure, filter geometry.
    Axis values, constraint bounds and the filter *state* are runtime
    arguments."""

    S: object                          # arrays.StackedModelArrays
    shape: tuple[int, ...]             # full axis sizes (incl. model axis)
    n_total: int
    chunk: int
    fields: tuple[str, ...]            # tracked channels; first d objectives
    d: int                             # number of objective channels
    k: int                             # top-k table width
    sign: tuple[float, ...]            # +1 minimize / -1 maximize per obj
    cons_static: tuple[tuple[int, str], ...]   # (field index, op) pairs
    hist_bins: int
    survivor_cap: int
    small_index: bool                  # int32 decode arithmetic is safe
    filter_rows: int = 24              # dominance-filter explicit rows
    filter_bins: int = 256             # ... and prefix-min table bins

    @property
    def block(self) -> int:            # W — lanes per block
        return min(512, self.chunk)

    @property
    def n_blocks(self) -> int:         # B
        return -(-self.chunk // self.block)

    @property
    def padded(self) -> int:           # CP — lanes incl. block padding
        return self.n_blocks * self.block

    @property
    def nb(self) -> int:               # blocks gathered by the top-k select
        return min(self.k, self.n_blocks)


def decode_gather(shape: Sequence[int], axvals, flat):
    """Decode flat C-order indices and gather the per-axis model
    arguments — the one place "flat index -> model inputs" is written."""
    coords = SW.decode_flat_index(shape, flat)
    return [v[c] for v, c in zip(axvals, coords)]


def _pad_lanes(x, n: int, fill):
    """Append ``n`` lanes of ``fill`` along the last axis."""
    if not n:
        return x
    tail = torch.full((*x.shape[:-1], n), fill, dtype=x.dtype,
                      device=x.device)
    return torch.cat([x, tail], dim=-1)


def chunk_partials(spec: ChunkSpec, F, flat, ingrid, aux) -> dict:
    """Constraint masking + block reductions of one evaluated chunk.

    ``F`` is the ``(n_fields, chunk)`` float64 channel matrix, ``flat``
    the chunk's int64 flat indices, ``ingrid`` the in-grid lane mask.
    Returns the partials dict :func:`fold_chunk` consumes, every lane
    axis padded to ``spec.padded`` (the layout kernel A writes).
    """
    d, B, W = spec.d, spec.n_blocks, spec.block
    inf = float("inf")
    feas = ingrid
    for ci, (fi, op) in enumerate(spec.cons_static):
        # NaN channel values compare False, so invalid configurations
        # are infeasible under any predicate.
        feas = feas & SW.CONSTRAINT_OPS[op](F[fi], aux["cons"][ci])
    valid = torch.isfinite(F) & feas[None, :]
    Fm = torch.where(valid, F, inf)
    if all(s == 1.0 for s in spec.sign):
        Fsg = Fm[:d]
    else:
        # Scalar multiplies, not a sign tensor: no host-to-device copy,
        # so the step can be captured in a CUDA graph (x * -1.0 is exact).
        Fsg = torch.where(valid[:d], torch.stack(
            [F[c] * s for c, s in enumerate(spec.sign)]), inf)
    keep = P.dominance_filter_mask_torch(aux["filter"], Fsg)

    lp = spec.padded - spec.chunk
    Fb = _pad_lanes(Fm, lp, inf).reshape(-1, B, W)
    bmin = Fb.amin(dim=2)
    flatb = _pad_lanes(flat, lp, spec.n_total).reshape(B, W)
    bidx = torch.where(Fb == bmin[:, :, None], flatb[None],
                       spec.n_total).amin(dim=2)
    return {
        "Fd": _pad_lanes(F[:d], lp, float("nan")),
        "Fsg": _pad_lanes(Fsg, lp, inf),
        "valid": _pad_lanes(valid[:d], lp, False),
        "keep": _pad_lanes(keep, lp, False),
        "bmin": bmin,
        "bidx": bidx,
        "cnt": _pad_lanes(valid.to(torch.int32), lp, 0).reshape(
            -1, B, W).sum(dim=2, dtype=torch.int32),
        "bmax": _pad_lanes(torch.where(valid, F, -inf), lp, -inf
                           ).reshape(-1, B, W).amax(dim=2),
        "sgmin": _pad_lanes(Fsg, lp, inf).reshape(d, B, W).amin(dim=2),
    }


def plain_dense(T: A.DeviceTables, shape, fields, axvals, flat,
                evaluate=SW.config_eval) -> dict:
    """Plain-PyTorch dense evaluation: decode + ``evaluate`` (Eq. 1-11,
    or the session evaluation of :func:`lane_eval`) at ``flat``."""
    out = evaluate(T, *decode_gather(shape, axvals, flat))
    return {f: out[f] for f in fields}


def plain_chunk(spec: ChunkSpec, T: A.DeviceTables, axvals, aux,
                start: int, base=None, evaluate=SW.config_eval) -> dict:
    """Plain-PyTorch chunk step: decode + ``evaluate`` (Eq. 1-11, or the
    session evaluation of :func:`lane_eval`) + :func:`chunk_partials`
    over ``[base + start, base + start + spec.chunk)`` (``base``: an
    optional 0-d int64 tensor)."""
    flat = start + torch.arange(spec.chunk, dtype=torch.int64,
                                device=T.device)
    if base is not None:
        flat = base + flat
    out = evaluate(T, *decode_gather(spec.shape, axvals, flat))
    F = torch.stack([out[f] for f in spec.fields])
    return chunk_partials(spec, F, flat, flat < spec.n_total, aux)


def init_carry(spec: ChunkSpec) -> dict:
    """Fresh running-reduction carry (numpy, the reference's keys and
    dtypes; the executor moves it to the device)."""
    nf = len(spec.fields)
    carry = {
        "min_val": np.full((nf,), np.inf),
        "min_idx": np.full((nf,), spec.n_total, np.int64),
        "finite": np.zeros((nf,), np.int64),
        "fmin": np.full((nf,), np.inf),
        "fmax": np.full((nf,), -np.inf),
        "topk_val": np.full((spec.d, spec.k), np.inf),
        "topk_idx": np.full((spec.d, spec.k), spec.n_total, np.int64),
    }
    if spec.hist_bins:
        carry["hist"] = np.zeros((spec.d, spec.hist_bins), np.int64)
    return carry


def _sort_pairs(vals, idx):
    """Row-wise lexicographic sort of ``(vals, idx)`` pairs (the
    reference's two-key ``lax.sort``): a stable sort by index, then a
    stable sort by value.  Zeros carry one sign per channel here, so
    the reference's total order (-0.0 before +0.0) never decides."""
    o = torch.sort(idx, dim=1, stable=True).indices
    vals, idx = torch.gather(vals, 1, o), torch.gather(idx, 1, o)
    o = torch.sort(vals, dim=1, stable=True).indices
    return torch.gather(vals, 1, o), torch.gather(idx, 1, o)


def fold_chunk(spec: ChunkSpec, carry, partials, aux, start):
    """Fold one chunk's block partials into the running carry.

    ``start`` is the chunk's first flat index: a host integer, or a 0-d
    int64 tensor on the device (the graph-captured step).

    Returns ``(new_carry, survivors)``: the lexicographic ``(value,
    index)`` running argmin, counts and bounds; the exact top-k (the k
    best pairs of a chunk live in its k best blocks ranked by (block
    min, block index) — a stable sort of the signed block mins — merged
    against the running table by a two-key sort); optional histograms;
    and the survivors ``(flat, values, count)`` compacted by a binary
    search over the keep-count prefix sum, capped at
    ``spec.survivor_cap`` (the count reports an overflow).
    """
    d, k, W = spec.d, spec.k, spec.block
    n_total = spec.n_total
    dev = partials["bmin"].device

    lv = partials["bmin"].amin(dim=1)
    li = torch.where(partials["bmin"] == lv[:, None], partials["bidx"],
                     n_total).amin(dim=1)
    # isfinite guard: an all-invalid chunk ties at inf == inf and must
    # not swap the sentinel min_idx for an invalid config's index.
    better = (lv < carry["min_val"]) | ((lv == carry["min_val"])
                                        & torch.isfinite(lv)
                                        & (li < carry["min_idx"]))
    new_carry = {
        "min_val": torch.where(better, lv, carry["min_val"]),
        "min_idx": torch.where(better, li, carry["min_idx"]),
        "finite": carry["finite"] + partials["cnt"].sum(dim=1,
                                                        dtype=torch.int64),
        "fmin": torch.minimum(carry["fmin"], lv),
        "fmax": torch.maximum(carry["fmax"], partials["bmax"].amax(dim=1)),
    }

    # Ties between block mins go to the lower block, as lax.top_k does.
    bsel = torch.sort(partials["sgmin"], dim=1,
                      stable=True).indices[:, :spec.nb]          # (d, nb)
    sgb = partials["Fsg"].reshape(d, spec.n_blocks, W)
    gath = torch.gather(sgb, 1, bsel[:, :, None].expand(d, spec.nb, W))
    gpos = (bsel[:, :, None] * W
            + torch.arange(W, dtype=torch.int64, device=dev)[None, None, :])
    cand_v = torch.cat([carry["topk_val"], gath.reshape(d, spec.nb * W)],
                       dim=1)
    cand_i = torch.cat([carry["topk_idx"],
                        start + gpos.reshape(d, spec.nb * W)], dim=1)
    sv, si = _sort_pairs(cand_v, cand_i)
    new_carry["topk_val"] = sv[:, :k]
    new_carry["topk_idx"] = si[:, :k]

    if spec.hist_bins:
        he = aux["hist_edges"]                                 # (d, bins+1)
        hist = carry["hist"].clone()
        for oi in range(d):
            col = torch.clamp(partials["Fd"][oi], he[oi, 0], he[oi, -1])
            b = torch.clamp(
                torch.searchsorted(he[oi].contiguous(), col.contiguous(),
                                   right=True) - 1,
                0, spec.hist_bins - 1)
            hist[oi].index_add_(0, b, partials["valid"][oi].to(torch.int64))
        new_carry["hist"] = hist

    csum = torch.cumsum(partials["keep"].to(torch.int64), dim=0)
    want = torch.arange(1, spec.survivor_cap + 1, dtype=torch.int64,
                        device=dev)
    pos = torch.clamp(torch.searchsorted(csum, want), max=spec.padded - 1)
    surv = (start + pos, partials["Fd"][:, pos].T, csum[-1])
    return new_carry, surv


def fold_chunks(spec: ChunkSpec, carry, aux, base, partials_at, scan):
    """The torch fold of a dispatch (:meth:`EvalBackend.build_chunk_fold`
    's contract): :func:`fold_chunk` (this module's, looked up at each
    call) over each chunk's partials in turn, the carry written back in
    place once, and the survivors stacked along a leading ``scan``
    axis."""
    new, survs = carry, []
    for j in range(scan):
        off = j * spec.chunk
        new, surv = fold_chunk(spec, new, partials_at(off), aux, base + off)
        survs.append(surv)
    for key, v in new.items():
        carry[key].copy_(v)
    return tuple(torch.stack(parts) for parts in zip(*survs))


def carry_to_device(carry: dict, device) -> dict:
    """A host carry (:func:`init_carry` layout) as device tensors."""
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in carry.items()}


def carry_to_host(carry: dict) -> dict:
    """Owning numpy copy of a device carry."""
    return {k: v.detach().cpu().numpy().copy() for k, v in carry.items()}


def merge_device_carries(carry, k: int):
    """Fold per-device reduction carries (numpy, stacked on a leading
    axis) into one, exactly: lexicographic ``(value, index)`` argmin, a
    two-key sorted top-k merge, sums/min/max for counts, bounds and
    histograms.  The merged tree has :func:`init_carry`'s structure."""
    mv, mi = carry["min_val"], carry["min_idx"]     # (ndev, nf)
    order = np.lexsort((mi, mv), axis=0)[0]         # per-field best device
    nf = mv.shape[1]
    merged = {
        "min_val": mv[order, np.arange(nf)],
        "min_idx": mi[order, np.arange(nf)],
        "finite": carry["finite"].sum(axis=0),
        "fmin": carry["fmin"].min(axis=0),
        "fmax": carry["fmax"].max(axis=0),
    }
    tv, ti = carry["topk_val"], carry["topk_idx"]   # (ndev, d, k)
    d = tv.shape[1]
    cat_v = tv.transpose(1, 0, 2).reshape(d, -1)
    cat_i = ti.transpose(1, 0, 2).reshape(d, -1)
    out_v = np.empty((d, k))
    out_i = np.empty((d, k), np.int64)
    for oi in range(d):
        order = np.lexsort((cat_i[oi], cat_v[oi]))[:k]
        out_v[oi], out_i[oi] = cat_v[oi][order], cat_i[oi][order]
    merged["topk_val"], merged["topk_idx"] = out_v, out_i
    if "hist" in carry:
        merged["hist"] = carry["hist"].sum(axis=0)
    return merged


# ---------------------------------------------------------------------------
# The plain PyTorch backend
# ---------------------------------------------------------------------------


class TorchBackend(EvalBackend):
    """Plain PyTorch ops on whatever device the tensors live on — the
    CPU path, and on the card the reference the kernels are held
    against."""

    name = "torch"

    def build_dense_eval(self, S, shape, fields, device):
        T, ev = device_tables(S, device), lane_eval(S)
        shape, fields = tuple(shape), tuple(fields)
        return lambda axvals, flat: plain_dense(T, shape, fields, axvals,
                                                flat, ev)

    def build_chunk_eval(self, spec: ChunkSpec, device):
        T, ev = device_tables(spec.S, device), lane_eval(spec.S)
        return lambda axvals, aux, start, base=None: plain_chunk(
            spec, T, axvals, aux, start, base, ev)


register_backend(TorchBackend())


# ---------------------------------------------------------------------------
# Step assembly (scan fusion, CUDA graphs) and its cache
# ---------------------------------------------------------------------------


def _copy_in(dst: torch.Tensor, src) -> None:
    """Write host data into a device buffer in place (its address is what
    a captured graph holds), through pinned memory, without waiting."""
    src = torch.as_tensor(np.ascontiguousarray(src), dtype=dst.dtype)
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class ChunkStep:
    """``scan`` consecutive chunk folds as one dispatch.

    The counterpart of the reference's compiled step with scan fusion
    (``lax.scan`` over ``scan`` chunk carries).  Everything the step
    reads lives in buffers of fixed address: the axis values
    (:attr:`axvals`), the constraint bounds, histogram edges and
    dominance filter (:attr:`aux`), the running carry (:attr:`carry`)
    and the dispatch's first flat index (:attr:`base`, a 0-d int64
    tensor).  :meth:`load` writes new values into them in place, never
    rebinding them.  ``step(start)`` folds chunks ``start, start +
    chunk, ..., start + (scan - 1) * chunk`` in order into the carry and
    returns their survivors ``(flat, values, count)`` with a leading
    ``scan`` axis.  The same folds run in the same order for every
    ``scan``, so the results are bitwise the same.

    On a CUDA device the ``scan`` folds (the backend's chunk evaluation
    and its fold, :meth:`EvalBackend.build_chunk_fold`: kernels A and F
    on the ``"cuda"`` backend, A and :func:`fold_chunk`'s ops where F
    does not serve the spec, the torch ops on ``"torch"``) are captured
    once, at construction, as one ``torch.cuda.CUDAGraph`` after a
    warm-up run on a side stream
    (which makes the launchers' one-time attribute calls and the
    libraries' workspaces happen outside the capture); each dispatch
    writes :attr:`base` and replays it.  A capture that fails raises:
    there is no eager fallback on the card.  The returned survivors are
    then the graph's own output buffers, overwritten by the next replay,
    so the caller copies them out (on the same stream) first.  On the
    CPU the folds run as a Python loop and return fresh tensors.  A
    scenario stack's session loop (``n_steps`` evaluations of Eq. 1-11
    a chunk) is captured in the same graph.

    A step holds state between :meth:`load` and its last dispatch, so
    one run uses it at a time (:attr:`busy`, set by the executor).

    ``own_stream`` (a shard of :class:`ShardedStep`): on a CUDA device
    the step replays on a stream of its own (:attr:`stream`) instead of
    the current one, so shards on one card run side by side.
    """

    def __init__(self, spec: ChunkSpec, backend: str | None, device,
                 scan: int = 1, own_stream: bool = False):
        dev = torch.device(device)
        be = get_backend(backend, dev, is_scenario(spec.S))
        check_scenario_support(be, spec.S)
        self.spec, self.scan, self.device, self.backend = spec, scan, dev, be
        self.stream = (torch.cuda.Stream(dev)
                       if own_stream and dev.type == "cuda" else None)
        self._eval = be.build_chunk_eval(spec, dev)
        self._fold_chunks = be.build_chunk_fold(spec, dev)
        self.axvals = SW.axes_to_device(
            [np.zeros(n) for n in spec.shape], dev)
        d = spec.d
        filt = P.build_dominance_filter(np.empty((0, d)), d,
                                        spec.filter_rows, spec.filter_bins)
        self.aux = {"filter": {k: torch.as_tensor(v, device=dev)
                               for k, v in filt.items()}}
        if spec.cons_static:
            self.aux["cons"] = torch.zeros(len(spec.cons_static),
                                           dtype=SW.F64, device=dev)
        if spec.hist_bins:
            self.aux["hist_edges"] = torch.as_tensor(np.tile(
                np.linspace(0.0, 1.0, spec.hist_bins + 1), (d, 1)),
                device=dev)
        self.carry = carry_to_device(init_carry(spec), dev)
        self.base = torch.zeros((), dtype=torch.int64, device=dev)
        self.graph = None
        self.replays = 0
        self.busy = False
        self._out = None
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                self._capture()

    def _fold(self):
        return self._fold_chunks(
            self.carry, self.aux, self.base,
            lambda off: self._eval(self.axvals, self.aux, off, self.base),
            self.scan)

    def _capture(self) -> None:
        # Warm up on a side stream (first launches set kernel attributes
        # and library workspaces, which a capture must not do), then
        # capture the folds, on the same side stream of the step's device.
        # "thread_local": this thread's unsafe calls (a synchronisation, a
        # pageable copy) fail the capture, while the caller's other
        # threads may go on using the card.
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._fold()
        cur.wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self._out = self._fold()
        self.load(carry=init_carry(self.spec))

    def load(self, carry=None, axvals=None, cons=None, hist_edges=None,
             filt=None) -> None:
        """Write new state into the step's buffers, in place: a host
        carry (:func:`init_carry` layout), the axis values, the
        constraint bounds, the histogram edges, the dominance filter
        (:func:`repro_torch.core.pareto.build_dominance_filter`)."""
        for dst, src in ((self.carry, carry), (self.aux.get("filter"), filt)):
            if src is not None:
                for key, v in src.items():
                    _copy_in(dst[key], v)
        if axvals is not None:
            for dst, v in zip(self.axvals, axvals):
                _copy_in(dst, v)
        if cons is not None:
            _copy_in(self.aux["cons"], cons)
        if hist_edges is not None:
            _copy_in(self.aux["hist_edges"], hist_edges)

    def __call__(self, start: int):
        with (torch.cuda.stream(self.stream) if self.stream is not None
              else contextlib.nullcontext()):
            self.base.fill_(int(start))
            if self.graph is None:
                return self._fold()
            self.graph.replay()
        self.replays += 1
        self.backend.graph_replayed(self.spec, self.scan)
        return self._out

    def carry_to_host(self) -> dict:
        """Owning numpy copy of the running carry."""
        return carry_to_host(self.carry)


class ShardedStep:
    """One dispatch over several shards: ``steps[d]`` folds the ``scan``
    chunks from ``start + d * chunk * scan`` into its own carry.

    The counterpart of the reference's ``pmap``-sharded step.  Each
    shard is a :class:`ChunkStep` of its own (its state, and on a card
    its captured graph, graph pool and stream), so a replay on one shard
    never touches another's buffers.  :meth:`load` puts a (merged) host
    carry on shard 0 and fresh carries on the rest; the merge is exact
    and associative, so a snapshot restores onto any shard count.  On a
    card the shards' streams first wait for their devices' current
    streams (the loads), then replay, and the current streams wait for
    them in turn (the survivors' copies, the carry reads).
    """

    def __init__(self, steps: Sequence[ChunkStep]):
        self.steps = tuple(steps)
        self.spec, self.scan = steps[0].spec, steps[0].scan

    @property
    def busy(self) -> bool:
        return any(st.busy for st in self.steps)

    @busy.setter
    def busy(self, value: bool) -> None:
        for st in self.steps:
            st.busy = value

    @property
    def replays(self) -> int:
        return sum(st.replays for st in self.steps)

    def load(self, carry=None, **kw) -> None:
        """:meth:`ChunkStep.load` on every shard; ``carry`` goes to
        shard 0, a fresh :func:`init_carry` to the others."""
        for d, st in enumerate(self.steps):
            st.load(carry=(None if carry is None else
                           carry if d == 0 else init_carry(self.spec)), **kw)

    def __call__(self, start: int) -> list:
        """Dispatch every shard; their survivors, in shard order."""
        span = self.spec.chunk * self.scan
        on_card = [st for st in self.steps if st.stream is not None]
        for st in on_card:
            st.stream.wait_stream(torch.cuda.current_stream(st.device))
        out = [st(start + d * span) for d, st in enumerate(self.steps)]
        for st in on_card:
            torch.cuda.current_stream(st.device).wait_stream(st.stream)
        return out

    def carry_to_host(self) -> dict:
        """The shards' carries merged on the host (the device-count-
        independent form a checkpoint holds)."""
        return merge_device_carries(stack_host_carries(
            [st.carry_to_host() for st in self.steps]), self.spec.k)


def _shard_steps(spec: ChunkSpec, backend: str | None, device,
                 scan_chunks: int, devices, make):
    """The step over ``devices`` (``None``: ``device`` alone), shard
    ``shard = (position, count)`` built by ``make(spec, name,
    scan_chunks, dev, shard)``: one shard is its :class:`ChunkStep`,
    several a :class:`ShardedStep`.  A backend without multi-device
    support refuses several devices."""
    dev = torch.device(device)
    name = backend or default_backend(dev, is_scenario(spec.S))
    devs = [torch.device(dv) for dv in devices] if devices else [dev]
    if len(devs) > 1 and not get_backend(name).supports_multi_device:
        raise ValueError(f"backend {name!r} does not support the "
                         f"multi-device path (one chunk step a shard); "
                         f"pass devices= with a single device")
    steps = [make(spec, name, scan_chunks, dv, (d, len(devs)))
             for d, dv in enumerate(devs)]
    return steps[0] if len(steps) == 1 else ShardedStep(steps)


def _new_step(spec: ChunkSpec, name: str, scan_chunks: int,
              dev: torch.device, shard: tuple) -> ChunkStep:
    """A fresh :class:`ChunkStep` for shard ``shard = (position,
    count)`` on ``dev`` (its own stream when ``count > 1``)."""
    return ChunkStep(spec, name, dev, max(1, int(scan_chunks)),
                     own_stream=shard[1] > 1)


def build_step(spec: ChunkSpec, backend: str | None, device,
               scan_chunks: int = 1, devices=None):
    """The chunk step of one backend, folding ``scan_chunks``
    consecutive chunks a dispatch: a :class:`ChunkStep` on ``device``,
    or with several ``devices`` (an entry may repeat) a
    :class:`ShardedStep` of one step a entry.  A backend without
    multi-device support refuses several devices."""
    return _shard_steps(spec, backend, device, scan_chunks, devices,
                        _new_step)


_STEP_CACHE: "OrderedDict[tuple, ChunkStep]" = OrderedDict()
_STEP_CACHE_MAX = 32
_STEP_CACHE_STATS = {"hits": 0, "misses": 0, "evictions": 0}
_STEP_CACHE_LOCK = threading.Lock()


def cached_step(spec: ChunkSpec, backend: str | None, scan_chunks: int,
                device, devices=None):
    """LRU-cached :func:`build_step`: repeated sweeps of one spec reuse
    its step (and on the card its captured graph).

    Keyed like the reference's (``spec`` hashes its model stack by
    identity, so callers that want reuse keep the plan object).  With
    several ``devices`` each shard's :class:`ChunkStep` is cached under
    its position in the list as well as its device, so shards on one
    device never share a graph or its buffers.  A cached step that
    another run holds (:attr:`ChunkStep.busy`) is not shared: the caller
    gets a fresh, uncached one.
    """
    return _shard_steps(spec, backend, device, scan_chunks, devices,
                        _cached_chunk_step)


def _cached_chunk_step(spec: ChunkSpec, name: str, scan_chunks: int,
                       dev: torch.device, shard: tuple) -> ChunkStep:
    """:func:`_new_step`, cached under the shard's position as well as
    its device.  A miss builds the step (on the card with its warm-up
    and graph capture) under the ``stream.step_build`` span and counts
    it in the running sweep's ``stats["step_builds"]``."""
    key = (spec, name, int(scan_chunks), str(dev), shard)
    with _STEP_CACHE_LOCK:
        fn = _STEP_CACHE.get(key)
        if fn is not None and not fn.busy:
            _STEP_CACHE_STATS["hits"] += 1
            _STEP_CACHE.move_to_end(key)
            fn.busy = True
            return fn
        _STEP_CACHE_STATS["misses"] += 1
    with _span("stream.step_build", "step_build_s"):
        fn = _new_step(spec, name, scan_chunks, dev, shard)
    _count("step_builds")
    fn.busy = True
    with _STEP_CACHE_LOCK:
        if key not in _STEP_CACHE:
            _STEP_CACHE[key] = fn
            while len(_STEP_CACHE) > _STEP_CACHE_MAX:
                _STEP_CACHE.popitem(last=False)
                _STEP_CACHE_STATS["evictions"] += 1
    return fn


def step_cache_stats() -> dict:
    """Snapshot of the step LRU: ``hits`` / ``misses`` / ``evictions``
    since process start plus the current ``size`` and ``capacity``."""
    return dict(_STEP_CACHE_STATS, size=len(_STEP_CACHE),
                capacity=_STEP_CACHE_MAX)


def cached_dense_eval(backend: str | None, S, shape: tuple[int, ...],
                      fields: tuple[str, ...], device):
    """LRU-cached :meth:`EvalBackend.build_dense_eval` (keyed by the
    resolved backend name, stack identity, grid shape, fields and
    device)."""
    dev = torch.device(device)
    return _cached_dense_eval(backend or default_backend(dev, is_scenario(S)),
                              S, tuple(shape), tuple(fields), str(dev))


@functools.lru_cache(maxsize=32)
def _cached_dense_eval(backend: str, S, shape, fields, device: str):
    be = get_backend(backend)
    check_scenario_support(be, S)
    return be.build_dense_eval(S, shape, fields, device)


# ---------------------------------------------------------------------------
# Carry serialization contract (checkpoint/resume, range merging)
# ---------------------------------------------------------------------------

#: Version of the carry layout of :func:`init_carry` / :func:`fold_chunk`
#: (the reference's, key for key).  Baked into :func:`job_signature`, so a
#: checkpoint written under another carry format never restores.
CARRY_VERSION = 1


def stack_host_carries(carries: Sequence[dict]) -> dict:
    """Stack N host carries (:func:`init_carry` layout) into the ``(n,
    ...)`` leading-axis form :func:`merge_device_carries` folds.  Carries
    with and without histograms do not mix: their keys differ, which
    raises."""
    keys = tuple(carries[0])
    for c in carries[1:]:
        if tuple(c) != keys:
            raise ValueError(f"carries with different keys: {keys} vs "
                             f"{tuple(c)}")
    return {k: np.stack([c[k] for c in carries]) for k in keys}


def _hash_update(h, obj) -> None:
    """Recursively fold ``obj`` into hash ``h`` content-wise: scalars and
    strings, arrays (dtype + shape + bytes), dataclasses
    field by field (the model stack and its workload arrays; a scenario
    stack's wrapped stack, trace set with its battery and thermal specs,
    and step tables), sequences and mappings.  Type tags and delimiters
    keep the encoding prefix-free.  The bytes are the reference's, so
    equal jobs hash alike in both packages."""
    if obj is None or isinstance(obj, (bool, int, float, str,
                                       np.integer, np.floating)):
        h.update(f"<{type(obj).__name__}:{obj!r}>".encode())
    elif isinstance(obj, bytes):
        h.update(b"<bytes:")
        h.update(obj)
        h.update(b">")
    elif isinstance(obj, np.ndarray):
        h.update(f"<arr:{obj.dtype}:{obj.shape}:".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
        h.update(b">")
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        h.update(f"<dc:{type(obj).__name__}:".encode())
        for f in dataclasses.fields(obj):
            h.update(f.name.encode())
            h.update(b"=")
            _hash_update(h, getattr(obj, f.name))
        h.update(b">")
    elif isinstance(obj, (tuple, list)):
        h.update(b"<seq:")
        for x in obj:
            _hash_update(h, x)
        h.update(b">")
    elif isinstance(obj, collections.abc.Mapping):
        h.update(b"<map:")
        for kk in sorted(obj, key=str):
            h.update(str(kk).encode())
            h.update(b":")
            _hash_update(h, obj[kk])
        h.update(b">")
    else:
        _hash_update(h, np.asarray(obj))


#: ChunkSpec fields folded into the job signature — not ``small_index``,
#: ``survivor_cap`` or ``filter_*``, which shape the computation but never
#: the reductions (the filter is a pre-cull, a survivor overflow is
#: re-derived exactly), so they must not invalidate checkpoints.
_SIGNATURE_SPEC_FIELDS = ("shape", "n_total", "chunk", "fields", "d", "k",
                          "sign", "cons_static", "hist_bins")

#: The reference's name of each backend's counterpart, which the job
#: signature hashes: the plain path (``"torch"``; the reference's
#: ``xla``) and the hand-written kernel (``"cuda"``; its ``pallas``).
#: With it a job's signature is the reference's digest, so each package
#: resumes the other's checkpoints of the same job.
SIGNATURE_BACKEND = {"torch": "xla", "cuda": "pallas"}


def job_signature(spec: ChunkSpec, backend: str, scan_chunks: int,
                  cons: Sequence[tuple[str, str, float]],
                  axis_vals: Sequence, hist_ranges=None) -> str:
    """Content hash of one resumable sweep job: the model stack (by
    content, every table entry), the axes and their values, the tracked
    fields and their orientation, top-k width, constraints and bounds,
    chunk geometry and scan fusion, backend, histogram spec and carry
    format.  Two runs share it iff their checkpoints are
    interchangeable; the executor refuses to resume from a checkpoint
    recorded under another.  The backend enters under its reference name
    (:data:`SIGNATURE_BACKEND`), so the digest equals the reference's
    ``job_signature`` of the same job."""
    h = hashlib.sha256()
    _hash_update(h, ("carry-format", CARRY_VERSION))
    _hash_update(h, ("backend", SIGNATURE_BACKEND.get(backend, backend)))
    _hash_update(h, ("scan", int(scan_chunks)))
    for name in _SIGNATURE_SPEC_FIELDS:
        _hash_update(h, (name, getattr(spec, name)))
    _hash_update(h, ("model-stack", spec.S))
    _hash_update(h, ("constraints", tuple(cons)))
    _hash_update(h, ("axes", tuple(np.asarray(a) for a in axis_vals)))
    _hash_update(h, ("hist-ranges", hist_ranges))
    return h.hexdigest()
