"""The control of ``correct``: the plain reference computed one
precision lower than the configuration states, put in the program's
place and held to the reference.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3
    python3 -m portbench.control --pair <config>,<traffic> --seeds 1,2,3 \
        [--seconds 20]

prints, for each seed, the numbers of the configuration's check at the
cell's own size (on the card when there is one).  A sweep: the float32
reference against the float64 one on the cell's first window sweep
(:mod:`portbench.check`).  A configuration of kind ``lm``: a short
window of the program's requests (``--seconds``), then the reference at
float8 against the float32 one on the requests a run checks, at the
same prompts and served tokens, each row's token the float8 one's first
(:mod:`portbench.lm_check`).  The limits of a configuration lie between
these readings and the largest that sound runs of the program give.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cells, check, lm_check, traffic
from .reference import reduce


def control_numbers(cell: cells.Cell, seed: int, device,
                    index: int = 0) -> dict:
    """The numbers of the float32 reference against the float64 one on
    sweep ``index`` of a run under ``seed``."""
    cfg, trf = cell.config, cell.traffic
    axes = traffic.sweep_axes(cfg, seed, index)
    session = traffic.session(cfg, trf)
    args = (trf["objectives"], trf["maximize"], trf["track"], trf["top_k"])
    g64 = reduce.Grid(axes, session, device, torch.float64)
    ref = reduce.sweep(g64, *args)
    low = reduce.sweep(reduce.Grid(axes, session, device, torch.float32),
                       *args)
    return check.numbers(low, ref, g64)


def lm_control_numbers(cell: cells.Cell, seed: int, device,
                       seconds: float, root=cells.ROOT) -> dict:
    """The numbers of the float8 reference against the float32 one on
    the requests that a window of ``seconds`` under ``seed`` checks."""
    from . import lm
    out = lm.run(cell, seed, seconds, False, device, root,
                 time.perf_counter(), control=True)
    return {k: v["value"] for k, v in out["checks"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    which = ap.add_mutually_exclusive_group(required=True)
    which.add_argument("--workload")
    which.add_argument("--pair", help="<config>,<traffic>: not a cell")
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="an lm configuration's window")
    args = ap.parse_args(argv)
    cell = (cells.resolve(args.workload) if args.workload
            else cells.assemble(*args.pair.split(",")))
    lm_kind = cell.config.get("kind") == "lm"
    verdict = lm_check.verdict if lm_kind else check.verdict
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        found = (lm_control_numbers(cell, seed, device, args.seconds)
                 if lm_kind else control_numbers(cell, seed, device))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "device": device, "numbers": found,
                          "limits": cell.config["limits"],
                          "fails": not verdict(found, cell.config["limits"]),
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
