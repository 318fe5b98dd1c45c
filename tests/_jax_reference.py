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


TASKS = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("task_")}


def _main(argv):
    task, params, out = argv[1], json.loads(argv[2]), argv[3]
    _import_reference()
    result = TASKS[task](params)
    pathlib.Path(out).write_bytes(pickle.dumps(result))


if __name__ == "__main__":
    _main(sys.argv)

