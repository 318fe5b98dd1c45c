"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks
for.  Set-up builds the program's kernels (into ``build/`` of the
checkout, once), lowers the configuration and runs one warm sweep of the
cell's shapes.  The window then issues sweeps in a closed loop with one
client, each a ``stream_grid`` call on fresh inputs from the seed, as
soon as the previous result is on the host, until ``--seconds`` have
passed; the rate is over every sweep and the whole window.  With
``--trace 1`` the window is the cell's first ``trace_sweeps`` sweeps
under the profiler, and the line carries the per-layer metrics.  After
the window a sample of the sweeps, drawn from the seed, is held to the
plain reference (:mod:`portbench.check`).  A configuration of kind
``lm`` runs a language model's requests instead (:mod:`portbench.lm`).
The last line of standard output is the result; the numbers compared,
with their limits, end both it and standard error.
"""

from __future__ import annotations

import os
import time

T0 = time.perf_counter()

# One process, one host thread for the math libraries: the sweep's host
# work (merges, launches) runs on one thread, and idle pool threads
# spinning beside it only add noise.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from . import cells, check, traffic  # noqa: E402

#: Modules that may not be loaded in the process that prints a result
#: (top-level names compared whole: the port's name begins with the
#: reference package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env(root) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout."""
    build = root / "build" / "portbench"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda")


def forbidden_modules() -> list:
    loaded = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def work_per_sweep(config: dict, trf: dict) -> float:
    """The frozen float64 operations of one sweep (the configuration's
    ``work``): configurations times the operations their fields take, or
    for a session sweep, pairs times the per-pair part plus the steps
    that advance time times the per-step part."""
    fields = list(dict.fromkeys([*trf["objectives"], *trf["track"]]))
    key = "+".join(fields)
    work = config["work"]
    n = traffic.n_points(config)
    if "session" in config:
        w = work["per_pair"].get(key)
        if w is None:
            return None
        return (n * w["pair"]
                + traffic.pair_steps(config, trf) * w["pair_step"])
    per = work["per_config"]
    if key in per:
        return n * per[key]
    singles = [per[f] for f in fields if f in per]
    return n * max(singles) if singles else None


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        device="cuda", root=cells.ROOT) -> dict:
    """One run of ``cell``; returns the result line's fields (without the
    device) and the context its metrics read.  A configuration of kind
    ``lm`` is run by :func:`portbench.lm.run`."""
    if cell.config.get("kind") == "lm":
        from . import lm
        return lm.run(cell, seed, seconds, trace, device, root, T0)
    import torch

    from . import program, tracing
    from .reference import reduce

    cfg, trf = cell.config, cell.traffic
    session = traffic.session(cfg, trf)
    prog = program.Program(root, cfg, trf, session, device)
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    prog.sweep(traffic.sweep_axes(cfg, seed, -1))
    sync()
    setup_s = time.perf_counter() - T0

    records: list = []
    window = (tracing.profiled(records) if trace
              else contextlib.nullcontext())
    span = tracing.span if trace else None
    sweeps, failed, error = [], 0, None
    before = prog.launches()
    t0 = time.perf_counter()
    with window:
        while True:
            i = len(sweeps)
            try:
                sweeps.append(prog.sweep(traffic.sweep_axes(cfg, seed, i),
                                         span))
            except Exception as e:         # a sweep that raised failed
                failed, error = 1, f"{type(e).__name__}: {e}"
                break
            if len(sweeps) >= trf["trace_sweeps"] if trace else (
                    time.perf_counter() - t0 >= seconds):
                break
    window_s = time.perf_counter() - t0
    after = prog.launches()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    tr = None
    if trace and not failed:
        expect = {"graph replays": int(sum(s["stats"]["graph_replays"]
                                           for s in sweeps))}
        if sweeps[0]["backend"] == "cuda":
            expect.update(A=after["A"] - before["A"],
                          B=after["B"] - before["B"])
        tr = tracing.read(records, expect)
        window_s = tr["window_s"]
    del prog, records
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    pick = traffic.rng(seed, -2).permutation(len(sweeps))
    pick = sorted(pick[:trf["check_sweeps"]].tolist())
    readings = []
    for i in pick:
        grid = reduce.Grid(traffic.sweep_axes(cfg, seed, i), session,
                           device)
        ref = reduce.sweep(grid, trf["objectives"], trf["maximize"],
                           trf["track"], trf["top_k"])
        readings.append(check.numbers(sweeps[i], ref, grid))
    check_s = time.perf_counter() - t_check
    found = (check.worst(readings) if readings
             else dict.fromkeys(check.NAMES, float("inf")))
    limits = cfg["limits"]
    correct = (not failed and bool(readings)
               and check.verdict(found, limits))
    ctx = {"kind": "sessions" if session else "grid", "config": cfg,
           "traffic": trf, "rates": cell.rates, "setup_s": setup_s,
           "window_s": window_s, "sweeps": sweeps, "trace": tr,
           "ops_per_sweep": work_per_sweep(cfg, trf)}
    entries = cell.per_layer if trace else cell.end_to_end
    return {"correct": correct, "attempted": len(sweeps) + failed,
            "failed": failed, "metrics": cells.read_metrics(entries, ctx,
                                                            root),
            "checks": {k: {"value": found[k], "limit": limits[k]}
                       for k in check.NAMES},
            "memory_peak_bytes": int(peak), "trace": tr, "error": error,
            "check_s": check_s, "checked": pick, "readings": readings,
            "sweeps": sweeps}


def sweep_log(out: dict) -> list:
    """Standard error's lines on a sweep run: each sweep's stats, the
    trace's counts and the sweeps checked."""
    lines = []
    for i, s in enumerate(out["sweeps"]):
        st = s["stats"]
        lines.append(
            f"portbench: sweep {i}: plan {s['plan_s']:.4f} s, stream "
            f"{st['total_s']:.4f} s (merge {st['host_merge_s']:.4f}, "
            f"wait {st['device_wait_s']:.4f}, dispatch "
            f"{st['dispatch_s']:.4f}), replays "
            f"{st['graph_replays']:.0f} of K {s['scan']}, fallbacks "
            f"{st['fallback_chunks']:.0f}, front {s['front_idx'].size}")
    if out["trace"] is not None:
        lines.append(f"portbench: trace counts {out['trace']['counts']}")
    lines.append(f"portbench: checked sweeps {out['checked']} in "
                 f"{out['check_s']:.3f} s; readings {out['readings']}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = cells.ROOT
    cache_env(root)
    cell = cells.resolve(args.workload, root)
    import torch
    torch.set_num_threads(1)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.reset_peak_memory_stats()
    out = run(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 1
    if out["error"]:
        print(f"portbench: a run failed: {out['error']}", file=sys.stderr)
    if cell.config.get("kind") == "lm":
        from .lm import log
    else:
        log = sweep_log
    for line in log(out):
        print(line, file=sys.stderr)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if args.trace and out["trace"] is not None:
        device.update(busy_s=out["trace"]["busy_s"],
                      window_s=out["trace"]["window_s"])
        from .tracing import breakdown
        line["breakdown"] = breakdown(out["trace"])
    line["checks"] = out["checks"]
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
