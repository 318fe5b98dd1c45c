"""The control of ``correct``: the plain reference computed in float32,
put in the program's place and held to the float64 reference.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

prints, for each seed, the numbers of :mod:`portbench.check` for the
cell's first window sweep at the cell's own size (on the card when there
is one).  The limits of a configuration lie between these readings and
the largest that sound runs of the program give.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cells, check, traffic
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    cell = cells.resolve(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        found = control_numbers(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "device": device, "numbers": found,
                          "limits": cell.config["limits"],
                          "fails": not check.verdict(
                              found, cell.config["limits"]),
                          "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
