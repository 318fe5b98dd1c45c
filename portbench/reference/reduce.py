"""What a sweep delivers, worked out plainly: argmin, top-k, bounds,
counts and the exact Pareto front over every configuration of a grid.

:class:`Grid` decodes flat indices into lanes the way a C-order grid
does and evaluates them with :mod:`.model` on the rig's own tables
(:func:`.rig.rig_tables`), in the dtype it is given.  :func:`sweep`
reduces the whole grid in blocks of lanes.  Plain PyTorch, on whatever
device the caller names; nothing of the program under test is read.
"""

from __future__ import annotations

import numpy as np
import torch

from . import model as M
from . import rig as R

_INDEX_AXES = ("cut", "agg_node", "sensor_node", "weight_mem")


class Grid:
    """One sweep's grid: ``axes`` maps each axis of :data:`.model`'s
    order (and ``trace`` for a session sweep) to its values, node and
    memory axes as names; ``session`` holds the battery, the thermal
    node, the traces (each a list of phases) and ``steps_per_phase``."""

    def __init__(self, axes: dict, session: dict | None, device,
                 dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        self.X = M.TorchOps(dtype)
        tables = R.rig_tables()
        self.n_det = int(tables["det.n_layers"])
        self.n_key = int(tables["key.n_layers"])
        self.T = {k: (torch.as_tensor(v, dtype=dtype, device=self.device)
                      if isinstance(v, np.ndarray) else v)
                  for k, v in tables.items()}
        nodes = list(R.NODES)
        idx = {"cut": list(axes["cut"]),
               "agg_node": [nodes.index(n) for n in axes["agg_node"]],
               "sensor_node": [nodes.index(n) for n in axes["sensor_node"]],
               "weight_mem": [R.WEIGHT_MEMS.index(m)
                              for m in axes["weight_mem"]]}
        self.names = list(_INDEX_AXES) + [a for a in axes
                                          if a not in _INDEX_AXES]
        self.lanes = []
        for name in self.names:
            if name in idx or name == "trace":
                v = (idx[name] if name in idx
                     else list(range(len(axes["trace"]))))
                self.lanes.append(torch.as_tensor(v, dtype=torch.int64,
                                                  device=self.device))
            else:
                self.lanes.append(torch.as_tensor(
                    np.asarray(axes[name], np.float64), dtype=dtype,
                    device=self.device))
        self.shape = tuple(len(v) for v in self.lanes)
        self.n_total = int(np.prod(self.shape))
        self.session = session
        if session is not None:
            self.steps = self._step_tables(session)

    def _step_tables(self, session: dict) -> dict:
        k = int(session["steps_per_phase"])
        traces = session["traces"]
        n_steps = max(len(p) for p in traces) * k
        tabs = {c: np.zeros((len(traces), n_steps)) if c == "dt"
                else np.ones((len(traces), n_steps))
                for c in M.STEP_COLUMNS}
        for r, phases in enumerate(traces):
            for p, ph in enumerate(phases):
                cols = slice(p * k, (p + 1) * k)
                tabs["dt"][r, cols] = ph["duration_s"] / k
                tabs["det_scale"][r, cols] = ph["detnet_scale"]
                tabs["key_scale"][r, cols] = ph["keynet_scale"]
                tabs["cam_scale"][r, cols] = ph["camera_fps_scale"]
                tabs["cams_active"][r, cols] = ph["cameras_active"]
        return {c: torch.as_tensor(v, dtype=self.dtype, device=self.device)
                for c, v in tabs.items()}

    def fields_at(self, flat: torch.Tensor) -> dict:
        """Every field at the flat indices ``flat`` (int64 on the grid's
        device)."""
        lanes, rest = [], flat
        for size, vals in zip(reversed(self.shape), reversed(self.lanes)):
            lanes.append(vals[rest % size])
            rest = rest // size
        lanes.reverse()
        if self.session is None:
            return M.config_eval(self.X, self.T, self.n_det, self.n_key,
                                 *lanes)
        return M.session_eval(self.X, self.T, self.n_det, self.n_key,
                              self.session, self.steps, *lanes)


def _dominated(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Rows of ``X`` that some row of ``W`` dominates (no worse in every
    column, better in one; minimisation)."""
    out = torch.zeros(X.shape[0], dtype=torch.bool, device=X.device)
    if W.shape[0] == 0 or X.shape[0] == 0:
        return out
    step = max(1, (1 << 25) // (W.shape[0] * X.shape[1]))
    for lo in range(0, X.shape[0], step):
        x = X[lo:lo + step, None, :]
        le = (W[None] <= x).all(dim=2)
        lt = (W[None] < x).any(dim=2)
        out[lo:lo + step] = (le & lt).any(dim=1)
    return out


def pareto_front(V: torch.Tensor, I: torch.Tensor, block: int = 2048):
    """The rows of ``V`` (signed, finite) that no other row dominates,
    with their indices ``I``.  After a lexicographic sort every dominator
    precedes what it dominates, so each block is checked against the
    front so far and against itself."""
    order = torch.sort(I, stable=True).indices
    for c in reversed(range(V.shape[1])):
        order = order[torch.sort(V[order, c], stable=True).indices]
    V, I = V[order], I[order]
    fv, fi = V[:0], I[:0]
    for lo in range(0, V.shape[0], block):
        b, bi = V[lo:lo + block], I[lo:lo + block]
        keep = ~(_dominated(fv, b) | _dominated(b, b))
        fv, fi = torch.cat([fv, b[keep]]), torch.cat([fi, bi[keep]])
    return fv, fi


def sweep(grid: Grid, objectives, maximize, track, k: int,
          block: int | None = None) -> dict:
    """The deliverables of a sweep of ``grid``, as numpy: per field
    (objectives, then tracked) ``min_val``/``min_idx`` (first minimum),
    ``finite``, ``fmin``/``fmax``; per objective the top ``k`` (``topk_val``
    in the natural orientation, ``topk_idx``; past the feasible count
    ``inf`` and ``n_total``); the exact front (``front_idx`` ascending,
    ``front_val``).  Invalid configurations (NaN) take part in nothing."""
    dev, n = grid.device, grid.n_total
    fields = list(dict.fromkeys([*objectives, *track]))
    sign = torch.tensor([-1.0 if o in maximize else 1.0 for o in objectives],
                        dtype=grid.dtype, device=dev)
    if block is None:
        block = (1 << 22) if grid.session is None else (1 << 19)
    inf = float("inf")
    nf, d = len(fields), len(objectives)
    min_val = torch.full((nf,), inf, dtype=grid.dtype, device=dev)
    min_idx = torch.full((nf,), n, dtype=torch.int64, device=dev)
    finite = torch.zeros(nf, dtype=torch.int64, device=dev)
    fmin = torch.full((nf,), inf, dtype=grid.dtype, device=dev)
    fmax = torch.full((nf,), -inf, dtype=grid.dtype, device=dev)
    top_v = torch.full((d, 0), inf, dtype=grid.dtype, device=dev)
    top_i = torch.zeros((d, 0), dtype=torch.int64, device=dev)

    def signed(out):
        V = torch.stack([out[o] for o in objectives], dim=1) * sign
        ok = torch.isfinite(V).all(dim=1)
        return V, ok

    # witnesses: the exact front of a strided sample prunes the main pass
    samp = torch.as_tensor(np.unique(np.linspace(0, n - 1, min(n, 65536))
                                     .astype(np.int64)), device=dev)
    V, ok = signed(grid.fields_at(samp))
    wit, _ = pareto_front(V[ok], samp[ok])
    cand_v, cand_i = [], []
    for lo in range(0, n, block):
        flat = torch.arange(lo, min(n, lo + block), dtype=torch.int64,
                            device=dev)
        out = grid.fields_at(flat)
        for j, f in enumerate(fields):
            v = out[f]
            ok = torch.isfinite(v)
            vm = torch.where(ok, v, inf)
            m = vm.min()
            if m < min_val[j]:
                min_val[j] = m
                min_idx[j] = flat[torch.nonzero(vm == m)[0, 0]]
            finite[j] += ok.sum()
            fmin[j] = torch.minimum(fmin[j], m)
            fmax[j] = torch.maximum(fmax[j], torch.where(ok, v, -inf).max())
        V, ok = signed(out)
        Vs = torch.where(ok[:, None], V, inf)
        o = torch.sort(Vs, dim=0, stable=True).indices[:k].T      # (d, k)
        cv = torch.cat([top_v, torch.gather(Vs.T, 1, o)], dim=1)
        ci = torch.cat([top_i, flat[o]], dim=1)
        s = torch.sort(cv, dim=1, stable=True).indices[:, :k]
        top_v, top_i = torch.gather(cv, 1, s), torch.gather(ci, 1, s)
        keep = ok.clone()
        keep[ok] = ~_dominated(wit, V[ok])
        cand_v.append(V[keep])
        cand_i.append(flat[keep])
    fv, fi = pareto_front(torch.cat(cand_v), torch.cat(cand_i))
    order = torch.argsort(fi)
    top_i = torch.where(torch.isfinite(top_v), top_i, n)
    cpu = {"min_val": min_val, "min_idx": min_idx, "finite": finite,
           "fmin": fmin, "fmax": fmax, "topk_val": top_v * sign[:, None],
           "topk_idx": top_i, "front_idx": fi[order],
           "front_val": fv[order] * sign}
    res = {k_: v.cpu().numpy() for k_, v in cpu.items()}
    for k_ in ("min_val", "fmin", "fmax", "topk_val", "front_val"):
        res[k_] = res[k_].astype(np.float64)
    res["fields"] = fields
    return res
