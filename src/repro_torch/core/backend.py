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
  ``"cuda"`` on a CUDA device and ``"torch"`` on the CPU.
* :func:`fold_chunk` — backend-independent torch ops: folds one chunk's
  block partials into the running carry (argmin with first-minimum
  tie-breaking, counts, bounds, the exact per-objective top-k merge,
  optional histograms) and compacts the dominance survivors.

All channel arithmetic is float64; flat indices are int64.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
from collections import OrderedDict
from typing import Callable, Sequence

import numpy as np
import torch

from . import arrays as A
from . import pareto as P
from . import sweep as SW

_REGISTRY: "OrderedDict[str, EvalBackend]" = OrderedDict()

#: Backends that register themselves on first request: name -> module.
_LAZY = {"cuda": "repro_torch.kernels.sweep_grid"}


class EvalBackend:
    """Protocol of an evaluation backend (see the module docstring).

    Both builders take the device the evaluation runs on; the model
    tables are packed onto it once per build (:func:`device_tables`).
    """

    name: str = "?"

    def build_dense_eval(self, S, shape: tuple[int, ...],
                         fields: Sequence[str], device) -> Callable:
        """``fn(axvals, flat) -> {field: (n,) tensor}``: decode flat
        C-order indices, gather the axis values, evaluate ``fields``.
        ``axvals`` is the tuple of per-axis device tensors
        (:func:`repro_torch.core.sweep.axes_to_device`)."""
        raise NotImplementedError

    def build_chunk_eval(self, spec: "ChunkSpec", device) -> Callable:
        """``fn(axvals, aux, start) -> partials``: evaluate the chunk
        ``[start, start + spec.chunk)`` and return the block partials
        of :func:`chunk_partials`."""
        raise NotImplementedError


def register_backend(backend: EvalBackend) -> EvalBackend:
    """Register ``backend`` under ``backend.name`` (last one wins)."""
    _REGISTRY[backend.name] = backend
    return backend


def available_backends() -> tuple[str, ...]:
    """Names accepted by the ``backend=`` knob (registered + lazy)."""
    return tuple(dict.fromkeys((*_REGISTRY, *_LAZY)))


def default_backend(device) -> str:
    """``"cuda"`` (the kernels) on a CUDA device, ``"torch"`` elsewhere."""
    return "cuda" if torch.device(device).type == "cuda" else "torch"


def get_backend(name: str | None = None, device="cpu") -> EvalBackend:
    """Resolve a backend name (``None`` -> :func:`default_backend` of
    ``device``); raises :class:`ValueError` naming the available
    backends for unknown names."""
    name = name or default_backend(device)
    if name not in _REGISTRY and name in _LAZY:
        importlib.import_module(_LAZY[name])
    be = _REGISTRY.get(name)
    if be is None:
        raise ValueError(f"unknown evaluation backend {name!r}; "
                         f"available: {available_backends()}")
    return be


@functools.lru_cache(maxsize=16)
def _device_tables(S, device: str) -> A.DeviceTables:
    return A.tables_to_device(S, device)


def device_tables(S, device) -> A.DeviceTables:
    """The packed table buffer of ``S`` on ``device``, built once per
    (stack, device) and kept (``S`` hashes by identity)."""
    return _device_tables(S, str(torch.device(device)))


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
        sign = torch.tensor(spec.sign, dtype=SW.F64, device=F.device)
        Fsg = torch.where(valid[:d], F[:d] * sign[:, None], inf)
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


def plain_dense(T: A.DeviceTables, shape, fields, axvals, flat) -> dict:
    """Plain-PyTorch dense evaluation: decode + Eq. 1-11 at ``flat``."""
    out = SW.config_eval(T, *decode_gather(shape, axvals, flat))
    return {f: out[f] for f in fields}


def plain_chunk(spec: ChunkSpec, T: A.DeviceTables, axvals, aux,
                start: int) -> dict:
    """Plain-PyTorch chunk step: decode + Eq. 1-11 + :func:`
    chunk_partials` over ``[start, start + spec.chunk)``."""
    flat = start + torch.arange(spec.chunk, dtype=torch.int64,
                                device=T.device)
    out = SW.config_eval(T, *decode_gather(spec.shape, axvals, flat))
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


def fold_chunk(spec: ChunkSpec, carry, partials, aux, start: int):
    """Fold one chunk's block partials into the running carry.

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
        T = device_tables(S, device)
        shape, fields = tuple(shape), tuple(fields)
        return lambda axvals, flat: plain_dense(T, shape, fields, axvals,
                                                flat)

    def build_chunk_eval(self, spec: ChunkSpec, device):
        T = device_tables(spec.S, device)
        return lambda axvals, aux, start: plain_chunk(spec, T, axvals, aux,
                                                      start)


register_backend(TorchBackend())


def build_step(spec: ChunkSpec, backend: str | None, device):
    """The chunk step ``(carry, axvals, aux, start) -> (carry,
    survivors)`` of one backend on one device."""
    evalfn = get_backend(backend, device).build_chunk_eval(spec, device)

    def step(carry, axvals, aux, start):
        partials = evalfn(axvals, aux, start)
        return fold_chunk(spec, carry, partials, aux, start)

    return step


def cached_dense_eval(backend: str | None, S, shape: tuple[int, ...],
                      fields: tuple[str, ...], device):
    """LRU-cached :meth:`EvalBackend.build_dense_eval` (keyed by the
    resolved backend name, stack identity, grid shape, fields and
    device)."""
    dev = torch.device(device)
    return _cached_dense_eval(backend or default_backend(dev), S,
                              tuple(shape), tuple(fields), str(dev))


@functools.lru_cache(maxsize=32)
def _cached_dense_eval(backend: str, S, shape, fields, device: str):
    return get_backend(backend).build_dense_eval(S, shape, fields, device)
