"""Runs the JAX reference package for the PyTorch-port parity tests.

The port's tests (``tests/test_torch_*.py``) compare it with the JAX
package ``repro`` on the same inputs.  The reference runs here, in a
child process, and hands its results back as a pickle of numpy arrays
and plain Python values:

    python tests/_jax_reference.py TASK PARAMS_JSON OUT_PICKLE

A child process keeps JAX and ``repro`` out of the test process, so the
port's tests cannot change what any other test file imports, and lets
this script adapt to the installed JAX: the reference imports
``jax.experimental.enable_x64``, which newer JAX releases provide only
as ``jax.enable_x64``; the shim below maps the one onto the other in the
child alone.  Pallas kernels run in interpret mode, as the reference's
own tests run them on the CPU.

Each task returns what the tests compare; see the ``task_*`` functions.
"""

from __future__ import annotations

import json
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def run(task: str, timeout: float = 600, **params) -> dict:
    """Run one reference task in a child process; returns its result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "ref.pkl"
        proc = subprocess.run(
            [sys.executable, __file__, task, json.dumps(params), str(out)],
            env=env, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"reference task {task!r} failed:\n"
                               f"{proc.stderr[-4000:]}")
        return pickle.loads(out.read_bytes())


def assert_close(a, b, rtol=1e-12, what=""):
    """Same shape, identical NaN pattern, every other entry within
    ``rtol`` relative (infinities equal)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    na, nb = np.isnan(a), np.isnan(b)
    assert np.array_equal(na, nb), f"{what}: NaN patterns differ"
    np.testing.assert_allclose(a[~na], b[~nb], rtol=rtol, atol=0,
                               err_msg=what)


# ---------------------------------------------------------------------------
# Child side
# ---------------------------------------------------------------------------


def _import_reference():
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = (
            lambda new_val=True: jax.enable_x64(new_val))
    import repro.core  # noqa: F401
    return jax


def _fields(obj, prefix="") -> dict:
    """Every ndarray field of a (nested) table dataclass, dotted names."""
    import dataclasses
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, np.ndarray):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(_fields(v, prefix + f.name + "."))
        elif isinstance(v, (tuple, int, float, str)):
            out[prefix + f.name] = v
    return out


def task_arrays(p):
    from repro.core import arrays as A
    from repro.core.handtracking import build_detnet, build_keynet
    det, key = build_detnet(), build_keynet()
    return {
        "model": _fields(A.model_arrays()),
        "stack": _fields(A.stack_model_arrays((A.model_arrays(),))),
        "stacked2": _fields(A.stacked_model_arrays(
            ((det, key), (det.scaled(0.5), key)))),
    }


def task_sweep(p):
    from repro.core import sweep
    from repro.core.handtracking import build_detnet, build_keynet
    dense = sweep.evaluate_grid(**p["grid"])
    det, key = build_detnet(), build_keynet()
    stacked = sweep.evaluate_grid(models=((det, key), (det.scaled(0.5), key)),
                                  detnet_fps=(10.0, 30.0))
    cons = {name: sweep.parse_constraints(spec)
            for name, spec in p["constraints"].items()}
    budget = p["budget"]
    masked = dense.constrain(budget)
    return {
        "shape": dense.shape,
        "dense": dict(dense.data),
        "argmin": {f: dense.argmin(f) for f in sweep.FIELDS},
        "stacked": dict(stacked.data),
        "stacked_argmin": {f: stacked.argmin(f) for f in sweep.FIELDS},
        "parsed": cons,
        "constrained": dict(masked.data),
        "decode": [np.asarray(c) for c in sweep.decode_flat_index(
            tuple(p["big_shape"]), np.asarray(p["big_flat"], np.int64))],
    }


def _chunk_inputs(p, jax):
    """ChunkSpec, axis values and aux of one chunk case, built the way
    the reference executor builds them (filter from a real front)."""
    import jax.numpy as jnp

    from repro.core import backend as B
    from repro.core import pareto, sweep
    S, axis_vals, _ = sweep.build_axes(**p["grid"])
    shape = tuple(a.size for a in axis_vals)
    n_total = int(np.prod(shape))
    objectives = tuple(p["objectives"])
    maximize = tuple(p.get("maximize", ()))
    cons = sweep.parse_constraints(p.get("constraints"))
    fields = objectives + tuple(dict.fromkeys(
        f for f in tuple(p.get("track", ())) + tuple(f for f, _, _ in cons)
        if f not in objectives))
    sign = np.where([o in maximize for o in objectives], -1.0, 1.0)
    d = len(objectives)
    chunk = p["chunk"]
    spec = B.ChunkSpec(
        S=S, shape=shape, n_total=n_total, chunk=chunk, fields=fields, d=d,
        k=p.get("k", 4), sign=tuple(float(s) for s in sign),
        cons_static=tuple((fields.index(f), op) for f, op, _ in cons),
        hist_bins=p.get("hist_bins", 0),
        survivor_cap=min(p.get("cap", 16384), chunk),
        small_index=n_total + chunk < 2**31)
    if p.get("front", True):
        dense = sweep.evaluate_grid(**p["grid"]).constrain(cons)
        front = pareto.pareto_front(dense, objectives, maximize)
        front_sg = front.values * sign
    else:
        front_sg = np.empty((0, d))
    filt = pareto.build_dominance_filter(front_sg, d, spec.filter_rows,
                                         spec.filter_bins)
    aux_np = {"filter": filt}
    if cons:
        aux_np["cons"] = np.asarray([v for _, _, v in cons], np.float64)
    if spec.hist_bins:
        aux_np["hist_edges"] = np.stack([
            np.linspace(p["hist_lo"][i], p["hist_hi"][i],
                        spec.hist_bins + 1) for i in range(d)])
    to_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    return spec, axis_vals, aux_np, to_j


def task_chunk(p):
    """Kernel A's reference: per case, the XLA and Pallas-interpret
    partials, the folded carry and survivors; plus kernel B's reference
    at ``eval_flat`` (:func:`task_eval`)."""
    jax = _import_reference()
    import jax.numpy as jnp

    from repro.core import backend as B
    from repro.kernels import sweep_grid
    out = {"eval": task_eval({"grid": p["eval_grid"],
                              "flat": p["eval_flat"]})}
    with jax.enable_x64(True):
        for name, case in p["cases"].items():
            spec, axis_vals, aux_np, to_j = _chunk_inputs(case, jax)
            axvals = tuple(map(jnp.asarray, axis_vals))
            aux = to_j(aux_np)
            start = jnp.int64(case["start"])
            xla = jax.jit(B.get_backend("xla").build_chunk_eval(spec))(
                axvals, aux, start)
            pallas = sweep_grid.build_chunk_call(spec, interpret=True)(
                axvals, aux, start)
            carry0 = B.init_carry(spec)
            carry, surv = jax.jit(
                lambda c, q: B.fold_chunk(spec, c, q, aux, start))(
                    to_j(carry0), xla)
            out[name] = {
                "spec": dict(fields=spec.fields, d=spec.d, k=spec.k,
                             sign=spec.sign, cons_static=spec.cons_static,
                             hist_bins=spec.hist_bins, chunk=spec.chunk,
                             survivor_cap=spec.survivor_cap,
                             small_index=spec.small_index,
                             n_total=spec.n_total, shape=spec.shape),
                "aux": aux_np,
                "xla": {k: np.asarray(v) for k, v in xla.items()},
                "pallas": {k: np.asarray(v) for k, v in pallas.items()},
                "carry": {k: np.asarray(v) for k, v in carry.items()},
                "surv": tuple(np.asarray(x) for x in surv),
            }
    return out


def task_eval(p):
    jax = _import_reference()
    import jax.numpy as jnp

    from repro.core import sweep
    from repro.kernels import sweep_grid
    S, axis_vals, _ = sweep.build_axes(**p["grid"])
    shape = tuple(a.size for a in axis_vals)
    flat = np.asarray(p["flat"], np.int64)
    with jax.enable_x64(True):
        axvals = tuple(map(jnp.asarray, axis_vals))
        pallas = sweep_grid.sweep_grid_eval(S, shape, sweep.FIELDS, axvals,
                                            jnp.asarray(flat),
                                            interpret=True)
        xla = sweep_grid.sweep_grid_eval_ref(S, shape, sweep.FIELDS, axvals,
                                             jnp.asarray(flat))
    return {"pallas": {k: np.asarray(v) for k, v in pallas.items()},
            "xla": {k: np.asarray(v) for k, v in xla.items()}}


def _stream_summary(res) -> dict:
    return {
        "argmin": {f: res.argmin(f) for f in res.min_val
                   if res.finite_counts[f]},
        "min_idx": dict(res.min_idx),
        "min_val": dict(res.min_val),
        "finite": dict(res.finite_counts),
        "bounds": {f: (res.channel_min[f], res.channel_max[f])
                   for f in res.min_val},
        "top_k": {o: res.top_k(o) for o in res.objectives},
        "topk_idx": np.asarray(res.topk_idx),
        "topk_val": np.asarray(res.topk_val),
        "front_idx": np.asarray(res.pareto_front().indices),
        "front_val": np.asarray(res.pareto_front().values),
        "hist": ({f: np.asarray(h) for f, (h, _) in res.hist.items()}
                 if res.hist else None),
    }


def task_stream(p):
    from repro.core import pareto, stream, sweep
    grid = p["grid"]
    dense = sweep.evaluate_grid(**grid)
    out = {"runs": {}, "dense_front": {}}
    for name, kw in p["runs"].items():
        res = stream.stream_grid(**grid, **kw)
        out["runs"][name] = _stream_summary(res)
        cons = kw.get("constraints")
        front = pareto.pareto_front(
            dense.constrain(cons) if cons else dense,
            kw.get("objectives", pareto.DEFAULT_OBJECTIVES),
            kw.get("maximize", ()))
        out["dense_front"][name] = (np.asarray(front.indices),
                                    np.asarray(front.values))
    return out


def task_pareto(p):
    from repro.core import pareto, sweep
    dense = sweep.evaluate_grid(**p["grid"])
    out = {}
    for name, kw in p["fronts"].items():
        fr = pareto.pareto_front(dense, **kw)
        out[name] = {"indices": np.asarray(fr.indices),
                     "values": np.asarray(fr.values),
                     "hypervolume": fr.hypervolume(),
                     "knee": fr.knee()}
    rng = np.random.default_rng(p["seed"])
    pts = rng.random((p["n_points"], 3))
    out["random"] = {"points": pts,
                     "mask": pareto.non_dominated_mask(pts),
                     "hv": pareto.hypervolume(pts[pareto.non_dominated_mask(
                         pts)], (1.1, 1.1, 1.1)),
                     "knee": pareto.knee_point(pts)}
    return out


def task_anchor(p):
    from repro.core import stream
    res = stream.stream_grid(**p["grid"])
    return {"n_configs": res.n_configs,
            "argmin_idx": res.min_idx["avg_power"],
            "best_avg_power": res.min_val["avg_power"],
            "topk_idx": np.asarray(res.topk_idx),
            "finite": res.finite_counts["avg_power"],
            "front_idx": np.asarray(res.front_indices)}


# ---------------------------------------------------------------------------
# Hand-tracking slice: inputs made with numpy from a seed, on both sides
# ---------------------------------------------------------------------------


def rbe_inputs(m: int, k: int, n: int, seed: int, saturate: bool = False):
    """int8 operands and positive float32 scales of one raw-kernel case
    (``saturate``: every entry +-127)."""
    rng = np.random.default_rng(seed)
    if saturate:
        x_q = rng.choice(np.asarray([-127, 127], np.int8), (m, k))
        w_q = rng.choice(np.asarray([-127, 127], np.int8), (k, n))
    else:
        x_q = rng.integers(-127, 128, (m, k)).astype(np.int8)
        w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    sx = (np.abs(rng.standard_normal(m)) + 0.1).astype(np.float32)
    sw = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
    return x_q, w_q, sx, sw


def float_inputs(shape, seed: int, scale: float = 1.0) -> np.ndarray:
    """float32 standard-normal values, rows scaled over several decades
    (so per-row quantization scales differ widely)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * scale
    x *= np.exp(rng.uniform(-3, 3, (shape[0],) + (1,) * (len(shape) - 1)))
    return x.astype(np.float32)


def frames(batch: int, seed: int) -> np.ndarray:
    """Synthetic camera frames in [0, 1): (batch, 240, 320, 1) float32."""
    rng = np.random.default_rng(seed)
    return rng.random((batch, 240, 320, 1), dtype=np.float32)


def task_rbe(p):
    """The Pallas kernel (interpret mode) and its oracle on the raw
    cases; ``quantize_rowwise`` and ``rbe_matmul`` as the reference's
    jitted ``rbe_matmul`` runs them, on the float cases."""
    jax = _import_reference()
    import jax.numpy as jnp

    from repro.kernels.rbe_matmul import (quantize_rowwise, rbe_matmul,
                                          rbe_matmul_raw, rbe_matmul_ref)
    out = {"raw": [], "quant": [], "float": []}
    for case in p["raw"]:
        args = tuple(map(jnp.asarray, rbe_inputs(*case)))
        out["raw"].append({"kernel": np.asarray(rbe_matmul_raw(*args)),
                           "ref": np.asarray(rbe_matmul_ref(*args))})
    quant = jax.jit(quantize_rowwise, static_argnames="axis")
    for shape, seed, axis in p["quant"]:
        q, s = quant(jnp.asarray(float_inputs(tuple(shape), seed)),
                     axis=axis)
        out["quant"].append({"q": np.asarray(q), "s": np.asarray(s)})
    for m, k, n, seed in p["float"]:
        x = float_inputs((m, k), seed)
        w = float_inputs((k, n), seed + 1)
        out["float"].append(np.asarray(rbe_matmul(jnp.asarray(x),
                                                  jnp.asarray(w))))
    return out


def _hand_cnn(net: str):
    from repro.models.cnn import HandCNN
    return HandCNN.detnet() if net == "detnet" else HandCNN.keynet()


def task_cnn(p):
    """One net's reference parameters (``HandCNN.init`` from a seed), an
    input batch, and its float (and, for ``int8``, RBE int8) outputs."""
    jax = _import_reference()
    import jax.numpy as jnp

    cnn = _hand_cnn(p["net"])
    params = cnn.init(jax.random.key(p["seed"]))
    h, w = cnn.input_hw
    x = float_inputs((p["batch"], h, w, 1), p["seed"], 0.5)
    out = {"params": [{k: np.asarray(v) for k, v in lp.items()}
                      for lp in params],
           "x": x,
           "float": np.asarray(cnn.apply(params, jnp.asarray(x))),
           "macs": cnn.traced_macs(), "n_weights": sum(
               int(lp["w"].size) for lp in params)}
    if p.get("int8"):
        out["int8"] = np.asarray(cnn.apply(params, jnp.asarray(x),
                                           use_rbe_int8=True))
    return out


def task_pipeline(p):
    """``examples/handtracking_pipeline.py``'s logic, frame by frame, on
    numpy frames: the ROI origin, KeyNet's float and int8 keypoints,
    their relative error, and the pricing lines."""
    jax = _import_reference()
    import jax.numpy as jnp

    from repro.core import latency, system
    from repro.models.cnn import HandCNN
    det, keynet = HandCNN.detnet(), HandCNN.keynet()
    det_params = det.init(jax.random.key(p["seed"]))
    key_params = keynet.init(jax.random.key(p["seed"] + 1))
    fr = frames(p["batch"], p["seed"])
    out = {"frames": fr, "origins": [], "kp_f32": [], "kp_int8": [],
           "rel_err": [],
           "det_params": [{k: np.asarray(v) for k, v in lp.items()}
                          for lp in det_params],
           "key_params": [{k: np.asarray(v) for k, v in lp.items()}
                          for lp in key_params]}
    for i in range(p["batch"]):
        frame = jnp.asarray(fr[i:i + 1])
        det_out = det.apply(det_params, frame)
        grid = det_out[0, :20 * 15 * 6].reshape(20, 15, 6)
        idx = jnp.unravel_index(jnp.argmax(grid[..., 0]), (20, 15))
        cy = int(idx[1]) * 16
        cx = int(idx[0]) * 16
        y0 = max(0, min(240 - 96, cy - 48))
        x0 = max(0, min(320 - 96, cx - 48))
        roi = jax.lax.dynamic_slice(frame, (0, y0, x0, 0), (1, 96, 96, 1))
        kp_f32 = keynet.apply(key_params, roi)
        kp_int8 = keynet.apply(key_params, roi, use_rbe_int8=True)
        err = float(jnp.linalg.norm(kp_f32 - kp_int8)
                    / jnp.maximum(jnp.linalg.norm(kp_f32), 1e-9))
        out["origins"].append((y0, x0))
        out["kp_f32"].append(np.asarray(kp_f32[0]))
        out["kp_int8"].append(np.asarray(kp_int8[0]))
        out["rel_err"].append(err)
    out["pricing"] = _pricing(system, latency)
    return out


def _pricing(system, latency) -> dict:
    return {"centralized_avg_power":
            system.build_centralized("7nm").avg_power,
            "distributed_avg_power":
            system.build_distributed("7nm", "7nm").avg_power,
            "latency": latency.latency_comparison()}


def _report(rep) -> dict:
    return {"name": rep.name, "avg_power": rep.avg_power,
            "breakdown": rep.breakdown(),
            "modules": [(m.name, m.group, m.energy_per_frame, m.fps)
                        for m in rep.modules]}


def point_summary(pt) -> dict:
    """Every field of a ``PartitionPoint`` as plain values."""
    return {"cut": pt.cut, "label": pt.label, "avg_power": pt.avg_power,
            "mipi_bytes_per_s": pt.mipi_bytes_per_s,
            "sensor_macs_per_s": pt.sensor_macs_per_s,
            "latency": pt.latency, "report": _report(pt.report),
            "trace": pt.trace, "session": pt.session}


def task_scalar(p):
    """The scalar model: system builders, breakdowns, the Fig. 5
    comparisons and the latency models."""
    from repro.core import latency, system
    out = {"pricing": _pricing(system, latency),
           "fig5a": system.fig5a_comparison(),
           "fig5b": system.fig5b_comparison(),
           "fig5b_16nm_30": system.fig5b_comparison("16nm", 30.0),
           "latency_16": latency.latency_comparison(agg_node="16nm",
                                                    detnet_every=1),
           "cut_latency": [dataclasses_dict(latency.cut_latency(c))
                           for c in range(0, 34, 3)]}
    for name, kw in p["systems"].items():
        builder = (system.build_centralized if name.startswith("cen")
                   else system.build_distributed)
        out[name] = _report(builder(**kw))
    return out


def dataclasses_dict(obj) -> dict:
    import dataclasses
    d = dataclasses.asdict(obj)
    d["total"] = obj.total
    return d


def task_partition(p):
    """``evaluate_cut``, ``sweep_partitions``, ``optimal_partition`` and
    ``sweep.evaluate_one`` on the given calls (``STREAM_THRESHOLD`` set
    to ``threshold``)."""
    from repro.core import partition, sweep
    partition.STREAM_THRESHOLD = p.get("threshold", partition.STREAM_THRESHOLD)
    out = {"one": {name: sweep.evaluate_one(cut, **kw)
                   for name, (cut, kw) in p.get("one", {}).items()},
           "cuts": {name: [point_summary(partition.evaluate_cut(c, **kw))
                           for c in p.get("cuts", ())]
                    for name, kw in p.get("evaluate", {}).items()},
           "sweeps": {name: [point_summary(pt)
                             for pt in partition.sweep_partitions(**kw)]
                      for name, kw in p.get("sweeps", {}).items()},
           "optimal": {}}
    for name, kw in p["optimal"].items():
        out["optimal"][name] = point_summary(
            partition.optimal_partition(**kw))
    return out


TASKS = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("task_")}


def _main(argv):
    task, params, out = argv[1], json.loads(argv[2]), argv[3]
    _import_reference()
    result = TASKS[task](params)
    pathlib.Path(out).write_bytes(pickle.dumps(result))


if __name__ == "__main__":
    _main(sys.argv)

