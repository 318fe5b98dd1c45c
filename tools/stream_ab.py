#!/usr/bin/env python3
"""The port's 100,096,000-config stream, two checkouts in turns on one card.

    python3 tools/stream_ab.py SRC_A SRC_B [--pairs N]

Each ``SRC`` is the ``src/`` directory of a checkout of the repository
(for example the parent commit unpacked with ``git archive`` into a
directory ``.gitignore`` lists, and this checkout's ``src``).  For each
pair the two run in turns, A B then B A, each in a child process that
imports ``repro_torch`` from its ``SRC``, builds what it needs, runs
``stream_grid`` over ``stream_grid_axes(10**8)`` at that checkout's
defaults once to warm up (the kernels' build, a graph's capture), then
once measured.  Prints the card's name and power limit, one JSON line a
measured run (``src``, the wall time and its dispatch, device-wait and
host-merge split, dispatches, scan depth and prefetch where the checkout
has them) and last a JSON line of each checkout's medians.  Needs one
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

KEYS = ("total_s", "dispatch_s", "device_wait_s", "host_merge_s",
        "n_chunks", "scan_chunks", "prefetch", "graph_replays",
        "fallback_chunks", "configs_per_s")

CHILD = """
import json, sys
import torch
from repro_torch.core import stream
from repro_torch.core.grids import stream_grid_axes
grid = stream_grid_axes(100_000_000)
stream.stream_grid(**grid)
torch.cuda.synchronize()
res = stream.stream_grid(**grid)
keys = json.loads(sys.argv[1])
print(json.dumps({k: res.stats[k] for k in keys if k in res.stats}))
"""


def run_once(src: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", CHILD, json.dumps(KEYS)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"{src}: the stream failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src_a")
    ap.add_argument("src_b")
    ap.add_argument("--pairs", type=int, default=1)
    args = ap.parse_args(argv)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {smi}")
    runs: dict = {args.src_a: [], args.src_b: []}
    for _ in range(args.pairs):
        for src in (args.src_a, args.src_b, args.src_b, args.src_a):
            stats = run_once(src)
            runs[src].append(stats)
            print(json.dumps({"src": src, **stats, "card": smi}))
    print(json.dumps({"medians": {
        src: {k: statistics.median(r[k] for r in rs)
              for k in ("total_s", "dispatch_s", "device_wait_s",
                        "host_merge_s") if all(k in r for r in rs)}
        for src, rs in runs.items()}, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
