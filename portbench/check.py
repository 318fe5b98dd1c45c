"""How ``correct`` is decided: a sweep's deliverables against the plain
reference's, as three numbers, each held to the limit its configuration
states.

* ``count_err``: the largest difference, over the tracked fields, of the
  count of valid configurations.  Exact.
* ``index_mismatch``: configurations chosen differently: the argmin of
  each field, each top-k position, and each member of either front that
  the other lacks.  Exact.
* ``value_rel_err``: the largest relative difference between a value the
  sweep reports and the reference's value of the same configuration
  (argmins, top-k, front) or the reference's bound (channel bounds).
"""

from __future__ import annotations

import numpy as np
import torch

NAMES = ("count_err", "index_mismatch", "value_rel_err")


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    if got.size == 0:
        return 0.0
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    with np.errstate(invalid="ignore", divide="ignore"):
        err = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    err = np.where(same, 0.0, err)
    return float(np.max(np.where(np.isnan(err), np.inf, err)))


def numbers(prog: dict, ref: dict, grid) -> dict:
    """The three numbers of one sweep.  ``grid`` is the reference's
    :class:`~portbench.reference.reduce.Grid` of the sweep in float64,
    which evaluates the configurations the sweep names."""
    if list(prog["fields"]) != list(ref["fields"]):
        raise ValueError(f"fields {prog['fields']} != {ref['fields']}")
    n = grid.n_total
    fields = ref["fields"]
    d = ref["topk_idx"].shape[0]
    objectives = fields[:d]
    idx = np.unique(np.concatenate([
        prog["min_idx"], prog["topk_idx"].ravel(), prog["front_idx"]]))
    idx = idx[(idx >= 0) & (idx < n)]
    out = grid.fields_at(torch.as_tensor(idx, device=grid.device))
    at = {f: dict(zip(idx.tolist(), out[f].cpu().numpy().tolist()))
          for f in fields}

    def ref_at(f, flat):
        return np.array([at[f].get(int(i), np.nan) if 0 <= i < n
                         else np.inf for i in np.ravel(flat)])

    count_err = int(np.max(np.abs(prog["finite"] - ref["finite"])))
    front_p, front_r = set(prog["front_idx"].tolist()), set(
        ref["front_idx"].tolist())
    mismatch = (int(np.sum(prog["min_idx"] != ref["min_idx"]))
                + int(np.sum(prog["topk_idx"] != ref["topk_idx"]))
                + len(front_p ^ front_r))
    errs = [_rel(prog["fmin"], ref["fmin"]), _rel(prog["fmax"], ref["fmax"])]
    for j, f in enumerate(fields):
        errs.append(_rel(prog["min_val"][j], ref_at(f, prog["min_idx"][j])))
    for j, f in enumerate(objectives):
        pi = prog["topk_idx"][j]
        want = ref_at(f, pi)
        past = pi >= n
        want[past] = ref["topk_val"][j][past]
        errs.append(_rel(prog["topk_val"][j], want))
        if prog["front_idx"].size:
            errs.append(_rel(prog["front_val"][:, j],
                             ref_at(f, prog["front_idx"])))
    return {"count_err": count_err, "index_mismatch": mismatch,
            "value_rel_err": max(errs)}


def worst(readings: list) -> dict:
    """The largest of each number over several sweeps' readings."""
    return {k: max(r[k] for r in readings) for k in NAMES}


def verdict(found: dict, limits: dict) -> bool:
    """Whether every number is within its limit."""
    return all(found[k] <= limits[k] for k in NAMES)
