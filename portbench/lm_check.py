"""How ``correct`` is decided on a configuration of kind ``lm``: the
logits that the program served against the plain reference's, by
teacher forcing on the program's own tokens, at the prefill's last
position and at every decode step.  Each number is held to the limit
that the configuration file states (``limits``, with its reason under
``limits_why``).

* ``logits_rel_err``: the largest, over the rows compared (a sequence
  at a position), of the largest absolute gap to the reference's logit
  over the row's largest absolute reference logit;
* ``logits_rel_err_p50``: the median of the same over the rows;
* ``logits_scale_err``: how far the program's logits lie along the
  reference's from the reference itself, ``|sum(p r) / sum(r r) - 1|``
  over the rows: rounding errors cancel in it, and a scale does not;
* ``token_gap``: the largest, over the rows, of the gap by which the
  served token's reference logit lies below the row's best, over the
  row's largest absolute reference logit;
* ``nonfinite``: logits that are not finite.  Exact: 0.
"""

from __future__ import annotations

import math

import torch

NAMES = ("logits_rel_err", "logits_rel_err_p50", "logits_scale_err",
         "token_gap", "nonfinite")


def numbers(got: torch.Tensor, ref: torch.Tensor,
            tokens: torch.Tensor) -> dict:
    """The numbers of one request: ``got`` and ``ref`` (B, N, V) logits,
    ``tokens`` (B, N) the token chosen at each row."""
    got = got.float().reshape(-1, got.shape[-1])
    ref = ref.float().reshape(-1, ref.shape[-1])
    tok = tokens.reshape(-1, 1).long().to(ref.device)
    nonfinite = int((~torch.isfinite(got)).sum())
    top = ref.abs().amax(dim=-1)
    rel = ((got - ref).abs().amax(dim=-1) / top).nan_to_num(math.inf)
    gap = ((ref.amax(dim=-1) - ref.gather(1, tok)[:, 0]) / top)
    scale = float((got * ref).sum() / (ref * ref).sum()) - 1.0
    return {"logits_rel_err": float(rel.max()),
            "logits_rel_err_p50": float(rel.median()),
            "logits_scale_err": abs(scale) if math.isfinite(scale)
            else math.inf,
            "token_gap": float(gap.nan_to_num(math.inf).max()),
            "nonfinite": nonfinite}


def worst(readings: list) -> dict:
    """The largest of each number over several requests' readings."""
    return {k: max(r[k] for r in readings) for k in NAMES}


def verdict(found: dict, limits: dict) -> bool:
    """Whether every number is within its limit."""
    return all(found[k] <= limits[k] for k in NAMES)
