#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which ends the run with a non-zero exit on any failure:

1. Build: compile the sweep-grid kernels (``src/repro_torch/kernels/
   sweep_grid/csrc``) and the RBE int8 kernel (``src/repro_torch/kernels/
   rbe_matmul/csrc``) with nvcc (sm_90a), one nvcc each, started
   together, and print the card and its power limit.
2. Kernel vs plain on the card: kernel A (the fused chunk step) against
   its plain PyTorch version for chunks of 997, 4096 and 131072 lanes,
   d = 1, 2, 3, constraints and a maximized objective; kernel B (dense
   evaluation) against its plain version on the 10,880-config reference
   grid and at 10^6 strided indices of the 100,096,000-config grid.
   Floats must agree to 1e-12 relative (bitwise is expected: both sides
   round every operation the same way), integers, booleans and NaN
   patterns exactly.
3. Dense: ``evaluate_grid`` of the reference grid on the card equals the
   port's CPU run, field for field, with the same argmin, top-k and
   Pareto front.
4. Stream (the main path): ``stream_grid`` over the 100,096,000-config
   grid through the kernels (launch counts read around exactly this
   run), then again with ``backend="torch"`` on the card: the same
   argmin, top-k, counts and front.  Then the 10,009,600-config grid
   against the anchors frozen from the JAX reference.
5. Kernel C vs plain on the card: ``rbe_matmul_raw`` against its plain
   version at KeyNet's three int8 shapes (1 and 4 ROIs), the reference
   test's shapes, a ragged shape and saturated (+-127) inputs: bitwise
   equal.  ``quantize_rowwise`` on the card equals its CPU run bitwise.
6. Hand-tracking pipeline (the second path): DetNet -> ROI -> KeyNet
   float and int8 on 4 frames (one per camera) through
   ``repro_torch.handtracking_pipeline``, with the launch count read
   around exactly that run (kernel C: 3 a forward), against the port's
   CPU run on the same frames and weights: the same ROI origins, DetNet
   and KeyNet float within rtol 1e-4 / atol 1e-5 (float32 sums in
   another order, TF32 off), the three int8 products bitwise equal to
   the CPU's on the same inputs, the int8 keypoints within relative L2
   5e-3 (an ulp of an activation can flip an int8 rounding at a tie,
   and one flip moves them by 1.45e-3); the pricing equals the anchors
   frozen from the JAX reference.
7. Report: a ``kernels`` JSON line (launches, error, kernel and plain
   time at the main path's shapes, the card's bound for the same work,
   the library call's time where there is one), ``stream``,
   ``rbe_shapes`` and ``handtracking`` JSON lines, the card's name and
   power limit, and last the ``ok`` line.

Imports nothing of JAX or of the JAX reference package.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import re
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

RTOL = 1e-12

# H100 SXM HBM3 peak (NVIDIA data sheet, at the 700 W limit).
PEAK_BYTES_PER_S = 3.35e12

# Float64 instructions an SM issues per clock on an H100 (4 partitions x
# 16 FP64 units).  The data sheet's 34 TFLOP/s is this at the boost clock
# with a DFMA counted as two; built with --fmad=false the kernels issue
# DADD and DMUL, one operation each, so the rate that bounds them is
# SMs x 64 x clock (fp64_rate).
FP64_PER_SM_CLOCK = 64

# Opcodes of the float64 pipe counted as operations in the SASS
# (MUFU.RCP64H seeds each IEEE divide's sequence).
FP64_OPCODES = ("DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX")
_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def query_gpu(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def card() -> str:
    return query_gpu("name,power.limit")


def fp64_rate() -> float:
    """Float64 operations a second at the card's top SM clock."""
    import torch

    mhz = float(query_gpu("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP64_PER_SM_CLOCK * mhz * 1e6


def sass_fp64(lib: pathlib.Path) -> dict:
    """Float64 instructions in each kernel of the built library, from
    ``cuobjdump -sass``: ``{kernel: {"fp64": n, "divides": k}}``.  Only
    the kernel's own body counts, up to its last ``EXIT`` before the
    first ``RET``: the subroutines after it (the IEEE divide's slow path
    for operands near the range's ends) do not run on this model's
    values.  The body of ``eval_kernel`` has no loop around its float64
    work, so its count is what one configuration of Eq. 1-11 issues."""
    from repro_torch.kernels._build import nvcc

    tool = pathlib.Path(nvcc()).parent / "cuobjdump"
    check(tool.exists(), f"{tool} not found: cannot count the kernels' "
          "float64 instructions")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    kernels: dict = {}
    name = None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            kernels[name] = []
        elif name is not None and (m := _SASS_LINE.search(line)):
            kernels[name].append(m.group(2))
    out = {}
    for name, ops in kernels.items():
        ret = next((i for i, op in enumerate(ops) if op.startswith("RET")),
                   len(ops))
        exits = [i for i, op in enumerate(ops[:ret]) if op == "EXIT"]
        body = ops[:exits[-1] + 1] if exits and ret < len(ops) else ops
        key = next((k for k in ("chunk_kernel", "eval_kernel") if k in name),
                   name)
        out[key] = {
            "fp64": sum(op.split(".")[0] in FP64_OPCODES
                        or op.startswith("MUFU.RCP64H") for op in body),
            "divides": sum(op.startswith("MUFU.RCP64H") for op in body)}
    check({"chunk_kernel", "eval_kernel"} <= out.keys(),
          f"kernels missing from the SASS of {lib}: {sorted(out)}")
    return out


def max_err(got: dict, want: dict, what: str) -> float:
    """Compare two dicts of tensors key by key; returns the largest
    absolute float difference (NaN positions excluded)."""
    import torch

    check(got.keys() == want.keys(), f"{what}: keys differ")
    worst = 0.0
    for k in want:
        g, w = got[k], want[k]
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}[{k}]: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if not w.dtype.is_floating_point:
            check(torch.equal(g, w), f"{what}[{k}]: values differ")
            continue
        gn, wn = torch.isnan(g), torch.isnan(w)
        check(torch.equal(gn, wn), f"{what}[{k}]: NaN patterns differ")
        g, w = g[~gn], w[~wn]
        check(torch.equal(torch.isinf(g), torch.isinf(w))
              and torch.equal(g[torch.isinf(g)], w[torch.isinf(w)]),
              f"{what}[{k}]: infinities differ")
        fin = torch.isfinite(w)
        if fin.any():
            d = (g[fin] - w[fin]).abs()
            rel = (d / w[fin].abs().clamp_min(1e-300)).max().item()
            check(rel <= RTOL, f"{what}[{k}]: relative error {rel:.3e}")
            worst = max(worst, d.max().item())
    return worst


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


def host_ms(fn, reps: int) -> float:
    """Wall time per call, synchronised: what one call costs its caller
    (host-side wrapper and launch overhead included)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def device_ms(fn, reps: int) -> float:
    """Device time per call: the summed duration of the device-side
    activities of ``reps`` calls in a torch.profiler trace (the work on
    the card, without the host's launch overhead)."""
    busy = device_busy(lambda: [fn() for _ in range(reps)])
    return sum(busy.values()) * 1e3 / reps


def device_busy(run) -> dict:
    """Device time of ``run()`` by kernel name (seconds), from the
    device-side events of a torch.profiler trace (CUPTI).  Fails when the
    trace holds none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + \
                ev.time_range.elapsed_us() / 1e6
    check(out, "profiler trace holds no device events")
    return out


def make_aux(spec, cons, front_sg, dev) -> dict:
    """The chunk step's runtime inputs: constraint bounds and the
    dominance filter built from ``front_sg`` (signed objective rows)."""
    import torch

    from repro_torch.core import pareto as P

    filt = P.build_dominance_filter(front_sg, spec.d, spec.filter_rows,
                                    spec.filter_bins)
    aux = {"filter": {k: torch.as_tensor(v, device=dev)
                      for k, v in filt.items()}}
    if cons:
        aux["cons"] = torch.tensor([v for _, _, v in cons],
                                   dtype=torch.float64, device=dev)
    return aux


def sample_front(T, shape, axvals, objectives, sign, dev) -> np.ndarray:
    """Signed front of 4096 strided grid points (the probe's seed)."""
    import torch

    from repro_torch.core import pareto as P
    from repro_torch.kernels import sweep_grid as K

    n = int(np.prod(shape))
    flat = torch.as_tensor(
        np.unique(np.linspace(0, n - 1, 4096).astype(np.int64)), device=dev)
    out = K.sweep_grid_eval_ref(T, shape, objectives, axvals, flat)
    V = np.stack([out[o].cpu().numpy() for o in objectives], axis=1) * sign
    V = V[np.isfinite(V).all(axis=1)]
    return V[P.non_dominated_mask(V)]


def phase_kernels(dev, grid_big, grid_ref) -> dict:
    """Kernels A and B against their plain versions; returns the largest
    absolute difference seen per kernel."""
    import torch

    from repro_torch.core import backend as B
    from repro_torch.core import stream as ST
    from repro_torch.core import sweep as SW
    from repro_torch.kernels import sweep_grid as K

    S, axis_arrays, _ = SW.build_axes(**grid_big)
    shape = tuple(a.size for a in axis_arrays)
    n = int(np.prod(shape))
    T = B.device_tables(S, dev)
    axvals = SW.axes_to_device(axis_arrays, dev)
    cases = [
        dict(chunk=997, objectives=("avg_power",), track=("latency",),
             start=n - 500),
        dict(chunk=4096, objectives=("avg_power", "latency"),
             constraints={"latency": 0.03, "mipi_bytes_per_s": (">=", 2e5)},
             hist_bins=16, start=4096 * 7),
        dict(chunk=131072, objectives=("avg_power", "latency",
                                       "mipi_bytes_per_s"),
             track=("sensor_memory",), start=131072 * 300),
        dict(chunk=131072, objectives=("avg_power", "latency",
                                       "sensor_macs_per_s"),
             maximize=("sensor_macs_per_s",),
             constraints={"avg_power": 0.02}, start=n - 100000),
    ]
    err = {"A": 0.0, "B": 0.0}
    for c in cases:
        start, chunk = c.pop("start"), c.pop("chunk")
        plan = ST.plan_stream(**grid_big, **c, chunk_size=chunk, device=dev)
        spec, cons = plan.spec, plan.cons
        front = sample_front(T, shape, axvals, spec.fields[:spec.d],
                             np.asarray(spec.sign), dev)
        aux = make_aux(spec, cons, front, dev)
        got = K.sweep_grid_chunk(spec, T, axvals, aux, start)
        want = K.chunk_partials_ref(spec, T, axvals, aux, start)
        sync(dev)
        e = max_err(got, want, f"kernel A chunk={spec.chunk} d={spec.d}")
        err["A"] = max(err["A"], e)
        print(f"kernel A chunk={spec.chunk} d={spec.d} "
              f"cons={len(cons)} sign={spec.sign}: max_abs_err={e!r}")

    # Kernel B: all of the reference grid, 10^6 strided indices of the
    # big one.
    for g, flat_np in ((grid_ref, None),
                       (grid_big, np.unique(np.linspace(0, n - 1, 10**6)
                                            .astype(np.int64)))):
        Sg, ax_g, _ = SW.build_axes(**g)
        shp = tuple(a.size for a in ax_g)
        Tg = B.device_tables(Sg, dev)
        axg = SW.axes_to_device(ax_g, dev)
        flat = (torch.arange(int(np.prod(shp)), dtype=torch.int64,
                             device=dev) if flat_np is None
                else torch.as_tensor(flat_np, device=dev))
        got = K.sweep_grid_eval(Tg, shp, SW.FIELDS, axg, flat)
        want = K.sweep_grid_eval_ref(Tg, shp, SW.FIELDS, axg, flat)
        sync(dev)
        e = max_err(got, want, f"kernel B n={flat.numel()}")
        err["B"] = max(err["B"], e)
        print(f"kernel B n={flat.numel()}: max_abs_err={e!r}")
    return err


def same_deliverables(a, b, what: str, exact_values: bool) -> None:
    """argmin, counts, top-k and the front index set of two stream (or
    dense-derived) results."""
    check(a.min_idx == b.min_idx, f"{what}: argmin indices differ")
    check(a.finite_counts == b.finite_counts, f"{what}: counts differ")
    check(np.array_equal(a.topk_idx, b.topk_idx), f"{what}: top-k differ")
    fa, fb = a.pareto_front(), b.pareto_front()
    check(np.array_equal(fa.indices, fb.indices),
          f"{what}: front index sets differ ({fa.size} vs {fb.size})")
    if exact_values:
        check(a.min_val == b.min_val, f"{what}: argmin values differ")
        check(np.array_equal(fa.values, fb.values),
              f"{what}: front values differ")
    else:
        for f in a.min_val:
            check(abs(a.min_val[f] - b.min_val[f])
                  <= RTOL * abs(b.min_val[f]), f"{what}: {f} min differs")


def phase_dense(grid_ref, dev) -> None:
    from repro_torch.core import pareto as P
    from repro_torch.core import sweep as SW

    gpu = SW.evaluate_grid(**grid_ref, device=dev)
    cpu = SW.evaluate_grid(**grid_ref, device="cpu")
    for f in SW.FIELDS:
        a, b = gpu.data[f], cpu.data[f]
        check(np.array_equal(np.isnan(a), np.isnan(b)), f"dense {f}: NaN")
        ok = ~np.isnan(b)
        rel = np.max(np.abs(a[ok] - b[ok]) / np.maximum(np.abs(b[ok]),
                                                        1e-300))
        check(rel <= RTOL, f"dense {f}: relative error {rel:.3e}")
        check(gpu.argmin(f) == cpu.argmin(f), f"dense {f}: argmin")
        check(gpu.top_k(f, 4) == cpu.top_k(f, 4), f"dense {f}: top-k")
    fg, fc = P.pareto_front(gpu), P.pareto_front(cpu)
    check(np.array_equal(fg.indices, fc.indices), "dense: front differs")
    print(f"dense {gpu.n_configs} configs: card == cpu "
          f"(front {fg.size} points, argmin {gpu.argmin()['avg_power']!r})")


def phase_stream(grid_big, grid_10m, anchor, dev) -> tuple:
    from repro_torch.core import stream as ST
    from repro_torch.core.grids import index_hash

    sync(dev)
    reset_counts()
    res = ST.stream_grid(**grid_big, device=dev)
    launches = read_counts()
    check(launches["A"] > 0 and launches["B"] > 0,
          f"main path skipped a kernel: launches {launches}")
    print(f"stream {res.n_configs} configs via kernels: "
          f"{res.stats['total_s']:.3f} s, launches {launches}, "
          f"front {res.front_indices.size}")
    plain = ST.stream_grid(**grid_big, backend="torch", device=dev)
    same_deliverables(res, plain, "stream cuda vs torch", exact_values=False)
    bitwise = (res.min_val == plain.min_val and np.array_equal(
        res.front_values, plain.front_values))
    print(f"stream {plain.n_configs} configs via plain torch on the card: "
          f"{plain.stats['total_s']:.3f} s, same deliverables "
          f"({'bitwise' if bitwise else 'within 1e-12'})")

    r10 = ST.stream_grid(**grid_10m, device=dev)
    check(r10.n_configs == anchor["n_configs"], "anchor grid size")
    check(r10.min_idx["avg_power"] == anchor["argmin_idx"],
          "anchor: argmin index differs from the JAX reference")
    best = r10.min_val["avg_power"]
    check(abs(best - anchor["best_avg_power"])
          <= RTOL * anchor["best_avg_power"], "anchor: best power differs")
    check(np.array_equal(r10.topk_idx, np.asarray(anchor["topk_idx"])),
          "anchor: top-k differs from the JAX reference")
    check(r10.finite_counts["avg_power"] == anchor["finite"],
          "anchor: valid count differs")
    check(r10.front_indices.size == anchor["front_size"]
          and index_hash(r10.front_indices) == anchor["front_hash"],
          "anchor: front differs from the JAX reference")
    print(f"stream {r10.n_configs} configs matches the JAX anchors "
          f"(best {best!r} W, front {r10.front_indices.size})")
    return res, launches


def kernel_report(res, launches, err, grid_big, dev) -> list:
    """Time both kernels and their plain versions at the main path's
    shapes: kernel A on a full chunk of the 100M plan with the final
    front's filter, kernel B on the stream probe's 4096 indices."""
    import torch

    from repro_torch.core import backend as B
    from repro_torch.core import stream as ST
    from repro_torch.core import sweep as SW
    from repro_torch.kernels import sweep_grid as K
    from repro_torch.kernels.sweep_grid.kernel import LIBRARY

    plan = ST.plan_stream(**grid_big, device=dev)
    spec = plan.spec
    T = B.device_tables(plan.S, dev)
    axvals = SW.axes_to_device(plan.axis_vals, dev)
    sign = np.asarray(plan.sign)
    aux = make_aux(spec, (), res.front_values * sign, dev)
    nf, d, CP, Bn = len(spec.fields), spec.d, spec.padded, spec.n_blocks
    run_a = lambda: K.sweep_grid_chunk(spec, T, axvals, aux, 0)  # noqa
    plain_a = lambda: K.chunk_partials_ref(spec, T, axvals, aux, 0)  # noqa
    ka, pa = device_ms(run_a, 50), device_ms(plain_a, 5)
    host = {"A": host_ms(run_a, 50), "A_plain": host_ms(plain_a, 5)}
    filt_bytes = sum(v.numel() * 8 for v in aux["filter"].values())
    bytes_a = (T.buf.numel() * 8 + sum(v.numel() * 8 for v in axvals)
               + filt_bytes
               + CP * d * (8 + 8 + 1) + CP            # Fd, Fsg, valid, keep
               + Bn * nf * (8 + 8 + 4 + 8) + Bn * d * 8)
    # Float64 operations a lane: Eq. 1-11 as the built eval_kernel issues
    # it, then (from the source) the signs, two compares per filter row
    # and objective, the edge searches and the table compare, and the
    # block reductions (about one combine a lane: two compares and a max
    # per tracked field, a min per objective).
    sass = sass_fp64(LIBRARY.path())
    eq_ops = sass["eval_kernel"]["fp64"]
    bins = spec.filter_bins + 1
    ops_a = spec.chunk * (eq_ops + d + spec.filter_rows * d * 2
                          + (d - 1) * int(np.ceil(np.log2(bins))) + 1
                          + 3 * nf + d)

    n = plan.n_total
    m = int(min(ST._PROBE, max(256, n // 128), n))
    flat = torch.as_tensor(np.unique(np.linspace(0, n - 1, m)
                                     .astype(np.int64)), device=dev)
    nb = flat.numel()
    run_b = lambda: K.sweep_grid_eval(T, plan.shape, SW.FIELDS,  # noqa
                                      axvals, flat)
    plain_b = lambda: K.sweep_grid_eval_ref(T, plan.shape,  # noqa
                                            SW.FIELDS, axvals, flat)
    kb, pb = device_ms(run_b, 50), device_ms(plain_b, 5)
    host.update(B=host_ms(run_b, 50), B_plain=host_ms(plain_b, 5))
    bytes_b = (T.buf.numel() * 8 + sum(v.numel() * 8 for v in axvals)
               + nb * 8 + nb * len(SW.FIELDS) * 8)
    ops_b = nb * eq_ops
    rate = fp64_rate()
    print(json.dumps({"sass_fp64": sass, "fp64_ops_per_s": rate}))

    def bound(nbytes, ops):
        tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, ops / rate * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    rows = []
    for name, fn, src, rep, key, ms, plain, nbytes, ops in (
            ("sweep_grid_chunk", "chunk_kernel",
             "src/repro_torch/kernels/sweep_grid/csrc/sweep_grid.cu",
             "src/repro/kernels/sweep_grid/kernel.py:98", "A", ka, pa,
             bytes_a, ops_a),
            ("sweep_grid_eval", "eval_kernel",
             "src/repro_torch/kernels/sweep_grid/csrc/sweep_grid.cu",
             "src/repro/kernels/sweep_grid/kernel.py:226", "B", kb, pb,
             bytes_b, ops_b)):
        b_ms, b_by = bound(nbytes, ops)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[key],
                     "max_abs_err": err[key], "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None})
    return rows, host


# ---------------------------------------------------------------------------
# Kernel C and the hand-tracking pipeline
# ---------------------------------------------------------------------------

#: Int8 operations an H100 SXM's tensor cores do a second (data sheet,
#: dense, at the 700 W limit).
PEAK_INT8_OPS_PER_S = 1979e12

#: ROIs (one a camera) of the pipeline's batch, and the batch of the
#: reading at which kernel C fills the card.
PIPELINE_BATCH = 4
BIG_ROIS = 256

#: Relative L2 within which the card's int8 keypoints match the CPU's:
#: a few int8 rounding flips at ties (see phase_pipeline).
INT8_REL_L2 = 5e-3

# Kernel C's cases against its plain version: (m, k, n, seed, saturate).
RBE_FIXED_CASES = (
    (128, 128, 128, 1, False), (256, 512, 384, 2, False),
    (512, 256, 128, 3, False),                     # reference test shapes
    (997, 130, 200, 4, False), (1, 7, 3, 5, False),    # ragged M, K, N
    (576, 128, 128, 6, True), (333, 4096, 65, 7, True))  # saturated


def reset_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from repro_torch.kernels import rbe_matmul as R
    from repro_torch.kernels import sweep_grid as K

    K.sweep_grid_chunk.launches = 0
    K.sweep_grid_eval.launches = 0
    R.rbe_matmul_raw.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import rbe_matmul as R
    from repro_torch.kernels import sweep_grid as K

    return {"A": K.sweep_grid_chunk.launches,
            "B": K.sweep_grid_eval.launches,
            "C": R.rbe_matmul_raw.launches}


def keynet_int8_shapes(batch: int) -> list:
    """(name, M, K, N) of each KeyNet layer the int8 path runs on kernel
    C, for ``batch`` ROIs."""
    from repro_torch.core.handtracking import build_keynet
    from repro_torch.models.cnn import rbe_routed

    return [(s.name, batch * s.in_act_bytes // s.cin, s.cin, s.cout)
            for s in build_keynet().layers if rbe_routed(s)]


def rbe_operands(m, k, n, seed, saturate, dev) -> tuple:
    """int8 operands and positive float32 scales, from a numpy seed."""
    import torch

    rng = np.random.default_rng(seed)
    if saturate:
        xq = rng.choice(np.asarray([-127, 127], np.int8), (m, k))
        wq = rng.choice(np.asarray([-127, 127], np.int8), (k, n))
    else:
        xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
        wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = (np.abs(rng.standard_normal(m)) + 0.1).astype(np.float32)
    sw = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in (xq, wq, sx, sw))


def int8_work(m: int, k: int, n: int) -> tuple:
    """Bytes and int8 operations one (m, k, n) product with its dequant
    needs: each operand, scale and output byte moved once; 2mnk."""
    return m * k + k * n + 4 * m + 4 * n + 4 * m * n, 2 * m * n * k


def int8_bound(nbytes: int, ops: int) -> tuple:
    """Least time (ms) the card needs for that work, and which of bytes
    and operations bounds it."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_INT8_OPS_PER_S * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def phase_rbe(dev) -> float:
    """Kernel C against its plain version, bitwise, and quantize_rowwise
    on ``dev`` against the CPU; returns the largest absolute difference
    seen (0.0 when every case is bitwise equal)."""
    import torch

    from repro_torch.kernels import rbe_matmul as R

    cases = [(m, k, n, 10 + b, False) for b in (1, PIPELINE_BATCH)
             for _, m, k, n in keynet_int8_shapes(b)]
    worst = 0.0
    for m, k, n, seed, sat in cases + list(RBE_FIXED_CASES):
        args = rbe_operands(m, k, n, seed, sat, dev)
        got = R.rbe_matmul_raw(*args)
        want = R.rbe_matmul_ref(*args)
        sync(dev)
        e = (got - want).abs().max().item()
        worst = max(worst, e)
        check(torch.equal(got, want),
              f"kernel C {m}x{k}x{n}{' saturated' if sat else ''}: "
              f"differs from its plain version (max_abs_err {e!r})")
        print(f"kernel C {m}x{k}x{n}{' saturated' if sat else ''}: "
              f"max_abs_err={e!r}")
    rng = np.random.default_rng(20)
    for shape, axis in (((576, 128), -1), ((128, 256), 0),
                        ((36864, 128), -1)):
        x = rng.standard_normal(shape) * np.exp(
            rng.uniform(-3, 3, (shape[0], 1)))
        x = torch.as_tensor(x.astype(np.float32))
        qc, sc = R.quantize_rowwise(x, axis=axis)
        qd, sd = R.quantize_rowwise(x.to(dev), axis=axis)
        check(torch.equal(qd.cpu(), qc) and torch.equal(sd.cpu(), sc),
              f"quantize_rowwise {shape} axis={axis}: the card differs "
              f"from the CPU")
    print("quantize_rowwise: card == cpu, bitwise (int8 values and scales)")
    return worst


@contextlib.contextmanager
def recorded_int8_layers():
    """Record ``(input, weight, output)`` of every ``rbe_matmul`` call a
    ``HandCNN`` forward makes inside the ``with``."""
    from repro_torch.models import cnn

    calls, real = [], cnn.rbe_matmul

    def recording(x, w):
        out = real(x, w)
        calls.append((x, w, out))
        return out

    cnn.rbe_matmul = recording
    try:
        yield calls
    finally:
        cnn.rbe_matmul = real


def pipeline_models(dev) -> tuple:
    """DetNet and KeyNet with the weights of fixed generator seeds, made
    on the CPU and moved to ``dev``, so every device gets the same."""
    import torch

    from repro_torch.models.cnn import HandCNN

    det = HandCNN.detnet(torch.Generator().manual_seed(0), "cpu")
    key = HandCNN.keynet(torch.Generator().manual_seed(1), "cpu")
    return det.to(dev), key.to(dev)


def rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def phase_pipeline(dev, smi: str) -> tuple:
    """The hand-tracking pipeline on ``dev`` against the port's CPU run;
    returns its launch counts and the ``handtracking`` report."""
    import torch

    from repro_torch import handtracking_pipeline as HP
    from repro_torch.core.grids import PRICING_ANCHOR
    from repro_torch.kernels.rbe_matmul import rbe_matmul

    frames_np = np.random.default_rng(7).random(
        (PIPELINE_BATCH, *HP.FRAME_HW, 1), dtype=np.float32)
    det_c, key_c = pipeline_models("cpu")
    want = HP.pipeline_forward(torch.as_tensor(frames_np), det_c, key_c)
    det, key = pipeline_models(dev)
    frames = torch.as_tensor(frames_np, device=dev)
    HP.pipeline_forward(frames, det, key)        # warm-up (cuDNN plans)

    sync(dev)
    reset_counts()
    got = HP.pipeline_forward(frames, det, key)
    sync(dev)
    launches = read_counts()
    check(launches == {"A": 0, "B": 0, "C": 3},
          f"pipeline: expected 3 launches of kernel C (one int8 KeyNet "
          f"forward) and none of A or B, got {launches}")
    price = HP.pricing()
    check(price == PRICING_ANCHOR,
          f"pricing differs from the JAX anchors: {price}")

    check(got["origins"] == want["origins"],
          f"ROI origins differ: {got['origins']} vs {want['origins']}")
    for k in ("det_out", "kp_f32"):
        g = got[k].cpu()
        check(torch.allclose(g, want[k], rtol=1e-4, atol=1e-5),
              f"pipeline {k}: card vs cpu max abs diff "
              f"{(g - want[k]).abs().max().item()!r}")
    # The int8 layers, exactly: each of the three int8 products of the
    # card's forward equals the port's CPU rbe_matmul on the same float
    # input and weight, bit for bit.
    with recorded_int8_layers() as calls:
        key(got["rois"], use_rbe_int8=True)
    sync(dev)
    check(len(calls) == 3, f"int8 KeyNet made {len(calls)} int8 products")
    for pix, w, out in calls:
        check(torch.equal(rbe_matmul(pix.cpu(), w.cpu()), out.cpu()),
              f"int8 layer {tuple(pix.shape)}x{tuple(w.shape)}: the card "
              f"differs from the CPU on the same input")
    # End to end: the float layers before each int8 one differ by ulps
    # between the card and the CPU, and an ulp at a rounding tie flips an
    # int8 value.  One such flip moves these keypoints by 1.45e-3
    # relative L2 (reproduced on the CPU alone by scaling the ROIs by
    # 1 + 1e-7 noise: tests/test_torch_cnn.py); a fault in quantization,
    # routing or the epilogue moves them by the int8 path's own error,
    # ~2e-2.
    int8_l2 = rel_l2(got["kp_int8"].cpu(), want["kp_int8"])
    check(int8_l2 <= INT8_REL_L2, f"pipeline kp_int8: card vs cpu "
          f"relative L2 {int8_l2!r} > {INT8_REL_L2}")
    print(f"pipeline {PIPELINE_BATCH} frames: card == cpu (ROIs "
          f"{got['origins']}, int8 layers bitwise, int8 keypoints rel L2 "
          f"{int8_l2!r}), launches {launches}, pricing == JAX anchors")

    rois = got["rois"]
    stages = {"detnet": lambda: det(frames),
              "keynet_f32": lambda: key(rois),
              "keynet_int8": lambda: key(rois, use_rbe_int8=True)}
    report = {"batch": PIPELINE_BATCH,
              "origins": got["origins"],
              "int8_rel_err": got["rel_err"],
              "card_vs_cpu": {
                  "det_max_abs": (got["det_out"].cpu()
                                  - want["det_out"]).abs().max().item(),
                  "kp_f32_max_abs": (got["kp_f32"].cpu()
                                     - want["kp_f32"]).abs().max().item(),
                  "kp_int8_rel_l2": int8_l2}}
    for name, fn in stages.items():
        report[name] = {"device_ms": device_ms(fn, 20),
                        "wall_ms": host_ms(fn, 20)}
    report["card"] = smi
    return launches, report


def rbe_report(launches: dict, err: float, dev, smi: str) -> tuple:
    """Kernel C's row of the ``kernels`` line at the pipeline's shapes
    (the three launches of one int8 KeyNet forward at 4 ROIs, summed),
    and the per-shape readings, at 256 ROIs too."""
    import torch

    from repro_torch.kernels import rbe_matmul as R

    def library(args):
        # torch._int_mm: the int8 product alone (no dequant epilogue).
        try:
            fn = lambda: torch._int_mm(args[0], args[1])  # noqa: E731
            fn()
        except RuntimeError:
            return None
        return device_ms(fn, 50)

    shapes = []
    for rois, reps in ((PIPELINE_BATCH, 50), (BIG_ROIS, 20)):
        for name, m, k, n in keynet_int8_shapes(rois):
            if rois == BIG_ROIS and name != "b4.pw":
                continue
            args = rbe_operands(m, k, n, 30, False, dev)
            nbytes, ops = int8_work(m, k, n)
            b_ms, b_by = int8_bound(nbytes, ops)
            shapes.append({
                "layer": name, "rois": rois, "m": m, "k": k, "n": n,
                "bytes": nbytes, "ops": ops,
                "ms": device_ms(lambda: R.rbe_matmul_raw(*args), reps),
                "wall_ms": host_ms(lambda: R.rbe_matmul_raw(*args), reps),
                "plain_ms": device_ms(lambda: R.rbe_matmul_ref(*args), reps),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library(args)})
    main = [r for r in shapes if r["rois"] == PIPELINE_BATCH]
    lib = [r["library_ms"] for r in main]
    b_ms, b_by = int8_bound(sum(r["bytes"] for r in main),
                            sum(r["ops"] for r in main))
    row = {"name": "rbe_matmul_raw", "route": "cuda",
           "source": "src/repro_torch/kernels/rbe_matmul/csrc/rbe_matmul.cu",
           "replaces": "src/repro/kernels/rbe_matmul/kernel.py:27",
           "launches": launches["C"], "max_abs_err": err,
           "ms": sum(r["ms"] for r in main),
           "plain_ms": sum(r["plain_ms"] for r in main),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None if None in lib else sum(lib)}
    return row, {"rbe_shapes": shapes, "card": smi}


def run(dev, grid_big, smi: str) -> None:
    """Phases 2-7 on ``dev`` with ``grid_big`` as the stream's grid."""
    from repro_torch.core import stream as ST
    from repro_torch.core.grids import (ANCHOR_10M, REFERENCE_GRID,
                                        stream_grid_axes)

    err = phase_kernels(dev, grid_big, REFERENCE_GRID)
    phase_dense(REFERENCE_GRID, dev)
    res, launches = phase_stream(grid_big, stream_grid_axes(10_000_000),
                                 ANCHOR_10M, dev)
    err["C"] = phase_rbe(dev)
    ht_launches, ht = phase_pipeline(dev, smi)
    rows, host = kernel_report(res, launches, err, grid_big, dev)
    row_c, shapes = rbe_report(ht_launches, err["C"], dev, smi)
    rows.append(row_c)
    print(json.dumps({"host_ms_per_call": host, "card": smi}))
    stats = {k: res.stats[k] for k in ("n_configs", "n_chunks", "total_s",
                                       "configs_per_s", "first_chunk_s",
                                       "dispatch_s", "device_wait_s",
                                       "host_merge_s", "fallback_chunks")}
    # The device's busy share of the main path, from one profiled run of
    # the same sweep: its device time over its own wall time (the
    # profiler's host overhead is in that wall time, so the share is a
    # lower bound on the unprofiled run's).
    profiled = []
    busy = device_busy(
        lambda: profiled.append(ST.stream_grid(**grid_big, device=dev)))
    total = sum(busy.values())
    stats["profiled_total_s"] = profiled[0].stats["total_s"]
    stats["device_busy_s"] = total
    stats["device_busy_share"] = total / stats["profiled_total_s"]
    stats["device_s_by_kernel"] = dict(sorted(
        busy.items(), key=lambda kv: -kv[1])[:8])
    print(json.dumps({"stream": stats, "card": smi}))
    print(json.dumps(shapes))
    print(json.dumps({"handtracking": ht}))
    print(json.dumps({"kernels": rows}))


def build(libs) -> None:
    """Build every kernel library (one nvcc each, all started together)
    and print the time and the compiler's register/spill report."""
    from repro_torch.kernels._build import build_all

    t0 = time.perf_counter()
    build_all(libs)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(libs)} libraries in parallel")
    for lib in libs:
        lib.load()
        print(f"build {lib.name}: {lib.info.get('seconds', 0.0):.1f} s nvcc")
        for line in lib.info.get("ptxas", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {lib.name}: {line.strip()}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.core.grids import stream_grid_axes
    from repro_torch.kernels.rbe_matmul import kernel as R
    from repro_torch.kernels.sweep_grid import kernel as K

    smi = card()
    print(f"card: {smi}")
    build((K.LIBRARY, R.LIBRARY))
    run(torch.device("cuda"), stream_grid_axes(100_000_000), smi)
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
