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

import dataclasses
import json
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile

import numpy as np

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"


def run(task: str, timeout: float = 600, host_devices: int | None = None,
        **params) -> dict:
    """Run one reference task in a child process; returns its result.
    ``host_devices`` gives the child's JAX that many CPU devices (the
    reference's multi-device path), in the child's environment only."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    if host_devices is not None:
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + f" --xla_force_host_"
                            f"platform_device_count={host_devices}").strip()
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


def deliverables(res) -> tuple:
    """Everything a stream result reduces, as exact values (floats by
    their bits): two results are bitwise equal iff these are."""
    def bits(a):
        return np.asarray(a, np.float64).tobytes()
    hist = (tuple((f, c.tobytes(), e.tobytes())
                  for f, (c, e) in sorted(res.hist.items()))
            if res.hist else None)
    return (tuple(sorted(res.min_idx.items())),
            bits([res.min_val[f] for f in res.min_val]),
            tuple(sorted(res.finite_counts.items())),
            bits([res.channel_min[f] for f in res.channel_min]),
            bits([res.channel_max[f] for f in res.channel_max]),
            res.topk_idx.tobytes(), bits(res.topk_val),
            res.front_indices.tobytes(), bits(res.front_values), hist)


def assert_matches_reference(res, want) -> None:
    """A port stream result against a reference summary (the child's
    ``_stream_summary``): argmin indices, counts, top-k and front index
    sets exactly, values within 1e-12 relative, NaN patterns equal."""
    assert res.min_idx == want["min_idx"]
    assert res.finite_counts == want["finite"]
    for f in res.min_val:
        assert_close(res.min_val[f], want["min_val"][f], what=f)
        assert_close((res.channel_min[f], res.channel_max[f]),
                     want["bounds"][f], what=f)
    assert np.array_equal(res.topk_idx, want["topk_idx"])
    assert_close(res.topk_val, want["topk_val"], what="topk")
    front = res.pareto_front()
    assert np.array_equal(front.indices, want["front_idx"])
    assert_close(front.values, want["front_val"], what="front")
    if want["hist"] is not None:
        for f, (counts, _) in res.hist.items():
            assert np.array_equal(counts, want["hist"][f]), f


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


def _grid(g):
    """A grid of the params: ``camera_n`` widens the camera-rate axis to
    that many values (a grid that is only planned, never evaluated)."""
    g = dict(g)
    n = g.pop("camera_n", None)
    if n is not None:
        g["camera_fps"] = tuple(np.linspace(20.0, 60.0, n))
    return g


def task_stream_pipeline(p):
    """The reference's ``stream_grid`` at each run's arguments (scan
    fusion, prefetch, chunk): the summary, ``result_to_json`` and the
    stats; its ``plan_stream`` geometry of each plan; ``flat_range``
    halves + ``merge_results``; and the messages of its range errors."""
    from repro.core import stream
    grid = p["grid"]
    out = {"runs": {}, "plans": {}, "errors": {}}
    for name, kw in p["runs"].items():
        res = stream.stream_grid(**grid, **kw)
        out["runs"][name] = dict(_stream_summary(res),
                                 json=stream.result_to_json(res),
                                 stats=dict(res.stats))
    for name, (g, kw) in p["plans"].items():
        plan = stream.plan_stream(**_grid(g), **kw)
        again = stream.plan_stream(**_grid(g), **kw)
        out["plans"][name] = dict(
            n_total=plan.n_total, chunk=plan.chunk, scan=plan.scan,
            survivor_cap=plan.spec.survivor_cap,
            small_index=plan.spec.small_index,
            stable=plan.signature == again.signature)
    kw, cut = p["ranges"]["kw"], p["ranges"]["cut"]
    n = stream.plan_stream(**grid).n_total
    parts = [stream.stream_grid(**grid, **kw, flat_range=r)
             for r in ((cut, n), (0, cut))]
    out["merged"] = _stream_summary(stream.merge_results(parts))
    out["parts"] = [_stream_summary(r) for r in parts]

    def error(fn):
        try:
            fn()
        except ValueError as e:
            return str(e)
        return None

    out["errors"] = {
        "outside": error(lambda: stream.stream_grid(
            **grid, **kw, flat_range=(0, n + 1))),
        "quantum": error(lambda: stream.stream_grid(
            **grid, **kw, flat_range=(0, cut + 1))),
        "gap": error(lambda: stream.merge_results(parts[:1])),
    }
    return out


def task_checkpoint(p):
    """The reference writes the checkpoints of a stream run into
    ``p["write"]`` (a snapshot every dispatch, all kept) and reads every
    step of ``p["read"]`` (written by the port): each step's
    ``restore_items`` and metadata, and the run's summary.  With
    ``n_devices`` the runs shard over that many of the child's devices
    (``run(..., host_devices=...)``)."""
    import jax

    from repro.checkpoint import CheckpointManager
    from repro.core import stream

    def read(root):
        mgr = CheckpointManager(root, keep=10**6)
        return {step: {"items": mgr.restore_items(step),
                       "meta": mgr.metadata(step)}
                for step in mgr.all_steps()}

    from repro.core import scenario as SC
    kw = dict(p["kw"])
    if p.get("n_devices"):
        kw["devices"] = jax.devices()[:p["n_devices"]]
    if kw.get("scenarios") is not None:
        kw["scenarios"] = scenario_set(SC, kw["scenarios"])
    res = stream.stream_grid(**p["grid"], **kw,
                             checkpoint_dir=p["write"],
                             checkpoint_every_steps=1,
                             checkpoint_keep=10**6)
    out = {"written": read(p["write"]), "read": read(p["read"]),
           "summary": _stream_summary(res),
           "signature": stream.plan_stream(**p["grid"], **{
               k: v for k, v in kw.items() if k != "prefetch"}).signature}
    if p.get("resume"):
        # Resume in the reference from the port's checkpoints: the
        # newest as they stand, and (a copy cut back to) an early step.
        import shutil
        import tempfile
        resumed = {}
        for tag, keep_upto in p["resume"].items():
            with tempfile.TemporaryDirectory() as tmp:
                root = pathlib.Path(tmp) / "c"
                shutil.copytree(p["read"], root)
                for d in root.iterdir():
                    if d.name.startswith("step_") and keep_upto is not None \
                            and int(d.name[5:]) > keep_upto:
                        shutil.rmtree(d)
                r = stream.stream_grid(**p["grid"], **kw,
                                       checkpoint_dir=str(root))
                resumed[tag] = dict(_stream_summary(r), stats=dict(r.stats))
        out["resumed"] = resumed
    return out


def task_stream_devices(p):
    """The reference's ``stream_grid`` sharded over the child's host
    devices (``run(..., host_devices=4)``): each run of ``p["runs"]``
    (``n_devices``: the first that many devices; ``lose_device``: an
    injected device loss) with its summary, device count, chunk and
    resilience counters; the dense path's deliverables over the same
    grid; the geometry and signature of each plan of ``p["plans"]``
    (``[name, device count, kw]``); and the ``flat_range`` quantum error
    of a four-device run of ``p["quantum_kw"]``."""
    import jax

    from repro.core import pareto, stream, sweep
    from repro.runtime import FaultInjector, FaultPlan
    grid = p["grid"]
    dense = sweep.evaluate_grid(**grid)
    front = pareto.pareto_front(dense)
    out = {"n_host_devices": len(jax.devices()), "runs": {}, "plans": {},
           "dense": {"argmin": {f: dense.argmin(f) for f in sweep.FIELDS},
                     "top_k": {f: dense.top_k(f, 4) for f in sweep.FIELDS},
                     "finite": {f: int(np.isfinite(dense.data[f]).sum())
                                for f in sweep.FIELDS},
                     "front_idx": np.asarray(front.indices),
                     "front_val": np.asarray(front.values)}}
    for name, run_p in p["runs"].items():
        kw = dict(run_p["kw"])
        kw["devices"] = jax.devices()[:run_p["n_devices"]]
        inj = None
        if run_p.get("lose_device") is not None:
            inj = FaultInjector(FaultPlan(
                lose_device=tuple(run_p["lose_device"])))
        res = stream.stream_grid(**grid, **kw, fault_injector=inj)
        out["runs"][name] = dict(
            _stream_summary(res), n_devices=res.n_devices,
            chunk_size=res.chunk_size, stats=dict(res.stats),
            device_lost=inj.injected["device_lost"] if inj else 0)
    for name, n_dev, kw in p["plans"]:
        plan = stream.plan_stream(**grid, **kw,
                                  devices=jax.devices()[:n_dev])
        out["plans"][name] = dict(chunk=plan.chunk, scan=plan.scan,
                                  small_index=plan.spec.small_index,
                                  signature=plan.signature)
    try:
        stream.stream_grid(**grid, **p["quantum_kw"], flat_range=(0, 1000),
                           devices=jax.devices()[:4])
        out["quantum_error"] = None
    except ValueError as e:
        out["quantum_error"] = str(e)
    return out


def task_optimize(p):
    """The reference's knob optimizer: ``gradient`` at each point of
    ``p["points"]`` (objective, knobs, config), ``evaluate_fields`` at
    each, ``optimize_knobs`` and ``grid_argmin`` for each search, and the
    messages of the refusals in ``p["errors"]``."""
    from repro.core import optimize
    out = {"points": [], "searches": {}, "grids": {}, "errors": {}}
    for obj, knobs, cfg in p["points"]:
        v, g = optimize.gradient(obj, knobs, **cfg)
        out["points"].append({"value": v, "grad": g,
                              "fields": optimize.evaluate_fields(knobs,
                                                                 **cfg)})
    for name, (bounds, obj, kw) in p["searches"].items():
        bounds = {k: tuple(b) for k, b in bounds.items()}
        res = optimize.optimize_knobs(bounds, obj, **kw)
        out["searches"][name] = {
            "knobs": res.knobs, "objective": res.objective,
            "weights": res.weights, "fields": res.fields,
            "trajectory": np.asarray(res.trajectory), "steps": res.steps}
    for name, (bounds, obj, kw) in p["grids"].items():
        bounds = {k: tuple(b) for k, b in bounds.items()}
        out["grids"][name] = optimize.grid_argmin(bounds, obj, **kw)
    for name, (fn, args, kw) in p["errors"].items():
        try:
            getattr(optimize, fn)(*args, **kw)
            out["errors"][name] = None
        except ValueError as e:
            out["errors"][name] = str(e)
    return out


def task_adamw(p):
    """The reference's ``repro.optim.adamw``, eagerly, on numpy trees:
    ``cosine_lr`` at each step of each config, ``clip_by_global_norm`` of
    each tree, and ``n_steps`` of ``apply`` from ``init`` with the given
    gradients; every result with its dtype.  Trees arrive as
    ``{name: (values, dtype)}``."""
    import jax.numpy as jnp
    from jax.experimental import enable_x64

    from repro.optim import adamw

    def tree(t):
        return {k: jnp.asarray(np.asarray(v), jnp.dtype(dt))
                for k, (v, dt) in t.items()}

    def host(t):
        return {k: (np.asarray(v.astype(jnp.float32)
                               if v.dtype == jnp.bfloat16 else v),
                    str(v.dtype)) for k, v in t.items()}

    out = {"lr": [], "clip": [], "apply": []}
    with enable_x64():
        for cfg_kw, steps in p["lr"]:
            cfg = adamw.AdamWConfig(**cfg_kw)
            vals = [adamw.cosine_lr(cfg, jnp.asarray(s, jnp.int32))
                    for s in steps]
            out["lr"].append((np.asarray([float(v) for v in vals]),
                              str(vals[0].dtype)))
        for t, max_norm in p["clip"]:
            clipped, norm = adamw.clip_by_global_norm(tree(t), max_norm)
            out["clip"].append((host(clipped), float(norm), str(norm.dtype)))
        for cfg_kw, params, grads in p["apply"]:
            cfg = adamw.AdamWConfig(**cfg_kw)
            x = tree(params)
            st = adamw.init(cfg, x)
            hist = []
            for g in grads:
                x, st, m = adamw.apply(cfg, x, tree(g), st)
                hist.append({"params": host(x), "mu": host(st.mu),
                             "nu": host(st.nu), "step": int(st.step),
                             "step_dtype": str(st.step.dtype),
                             "lr": float(m["lr"]),
                             "grad_norm": float(m["grad_norm"])})
            out["apply"].append(hist)
    return out


def task_adamw_checkpoint(p):
    """The reference's ``CheckpointManager`` saves ``{"params": params,
    "opt": adamw.init(cfg, params)}`` (the training driver's state) for
    the numpy parameters ``p["params"]`` at step 1 into ``p["write"]``,
    and restores ``p["read"]`` (the port's checkpoint of the same
    structure, its step ``p["read_step"]``); returns the manifest
    paths it wrote and what it restored, as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import CheckpointManager
    from repro.optim import adamw

    params = {k: jnp.asarray(np.asarray(v, np.float32))
              for k, v in p["params"].items()}
    state = {"params": params,
             "opt": adamw.init(adamw.AdamWConfig(), params)}
    CheckpointManager(p["write"]).save(1, state)
    with open(pathlib.Path(p["write"]) / "step_000000001" /
              "manifest.json") as f:
        paths = [leaf["path"] for leaf in json.load(f)["leaves"]]
    got = CheckpointManager(p["read"]).restore(p["read_step"], state)
    return {"paths": paths,
            "restored": {"params": {k: np.asarray(v) for k, v in
                                    got["params"].items()},
                         "step": np.asarray(got["opt"].step),
                         "mu": jax.tree.map(np.asarray, got["opt"].mu),
                         "nu": jax.tree.map(np.asarray, got["opt"].nu)}}


def task_dense(p):
    """The reference's dense ``evaluate_grid`` over ``grid``: every
    channel (flat, C order) and its Pareto front's flat indices (default
    objectives)."""
    from repro.core import pareto, sweep
    dense = sweep.evaluate_grid(**p["grid"])
    return {"data": {f: np.asarray(v).ravel() for f, v in dense.data.items()},
            "front_idx": np.asarray(pareto.pareto_front(dense).indices)}


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
# Scenario engine: scenario sets described in JSON, built on both sides
# ---------------------------------------------------------------------------


def scenario_set(SC, spec):
    """A ``ScenarioSet`` of the module ``SC`` (the reference's
    ``repro.core.scenario`` or the port's) from a JSON-able spec: a
    profile name or list of names (``as_scenario_set``), or a dict with
    ``traces`` (``[name, [[duration, det, key, cam, active], ...]]`` or a
    profile name each) and optional ``battery`` / ``thermal`` field
    overrides, ``steps_per_phase`` and ``throttle``; None for None."""
    import dataclasses
    if spec is None:
        return None
    if not isinstance(spec, dict):
        return SC.as_scenario_set(spec if isinstance(spec, str)
                                  else tuple(spec))
    traces = []
    for t in spec["traces"]:
        if isinstance(t, str):
            traces.append(SC.PROFILES[t])
        else:
            name, phases = t
            traces.append(SC.ScenarioTrace(name, tuple(
                SC.Phase(*map(float, ph)) for ph in phases)))
    kw = {}
    base = SC.ScenarioSet(traces=tuple(traces))
    for key in ("battery", "thermal"):
        if key in spec:
            kw[key] = dataclasses.replace(getattr(base, key), **spec[key])
    for key in ("steps_per_phase", "throttle"):
        if key in spec:
            kw[key] = spec[key]
    return dataclasses.replace(base, **kw)


def task_scenario(p):
    """The reference's scenario engine on the given calls: ``dense``
    (``evaluate_grid(scenarios=...)``: every channel, flat), ``streams``
    (``stream_grid`` summaries), ``sims`` (``simulate_session``),
    ``signatures`` (``plan_stream(...).signature``), ``optimal``
    (``optimal_partition``, each at its ``STREAM_THRESHOLD``, None for
    the default) and ``errors`` (the type and message of each failing
    call)."""
    from repro.core import partition, pareto, scenario as SC, stream, sweep
    out = {"dense": {}, "streams": {}, "sims": {}, "signatures": {},
           "optimal": {}, "errors": {}}
    for name, (grid, spec, fronts) in p.get("dense", {}).items():
        res = sweep.evaluate_grid(scenarios=scenario_set(SC, spec), **grid)
        out["dense"][name] = {
            "shape": res.shape, "trace": res.axes.get("trace"),
            "data": {f: np.asarray(v).ravel() for f, v in res.data.items()},
            "fronts": {fn: np.asarray(pareto.pareto_front(
                res, objectives=tuple(o), maximize=tuple(m)).indices)
                for fn, (o, m) in fronts.items()}}
    for name, (grid, spec, kw) in p.get("streams", {}).items():
        res = stream.stream_grid(scenarios=scenario_set(SC, spec), **grid,
                                 **kw)
        out["streams"][name] = dict(_stream_summary(res),
                                    json=stream.result_to_json(res))
    for name, (spec, kw) in p.get("sims", {}).items():
        out["sims"][name] = SC.simulate_session(
            scenarios=scenario_set(SC, spec), **kw)
    for name, (grid, spec, kw) in p.get("signatures", {}).items():
        out["signatures"][name] = stream.plan_stream(
            scenarios=scenario_set(SC, spec), **grid, **kw).signature
    default = partition.STREAM_THRESHOLD
    for name, (spec, kw, threshold) in p.get("optimal", {}).items():
        partition.STREAM_THRESHOLD = threshold or default
        out["optimal"][name] = point_summary(partition.optimal_partition(
            scenarios=scenario_set(SC, spec), **kw))
    calls = {"evaluate_grid": sweep.evaluate_grid,
             "stream_grid": stream.stream_grid,
             "optimal_partition": partition.optimal_partition,
             "parse_constraints": sweep.parse_constraints,
             "as_scenario_set": SC.as_scenario_set,
             "only": lambda name, spec: scenario_set(SC, spec).only(name)}
    for name, (fn, args, kw) in p.get("errors", {}).items():
        if "scenarios" in kw and kw["scenarios"] is not None:
            kw = dict(kw, scenarios=scenario_set(SC, kw["scenarios"]))
        try:
            calls[fn](*args, **kw)
        except (ValueError, KeyError, TypeError) as e:
            out["errors"][name] = (type(e).__name__, str(e))
        else:
            out["errors"][name] = None
    return out


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


def rbe_wrap_inputs(m: int, k: int, n: int, seed: int):
    """int8 operands over the whole range [-128, 127] with x's row 0 and
    w's column 0 all -128, so that output (0, 0) sums 128² K (beyond
    int32 for K > 131,071), and float32 scales of 1."""
    rng = np.random.default_rng(seed)
    x_q = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w_q = rng.integers(-128, 128, (k, n)).astype(np.int8)
    x_q[0], w_q[:, 0] = -128, -128
    return x_q, w_q, np.ones(m, np.float32), np.ones(n, np.float32)


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
    cases; the oracle alone on the ``wrap`` cases (:func:`rbe_wrap_inputs`);
    ``quantize_rowwise`` and ``rbe_matmul`` as the reference's jitted
    ``rbe_matmul`` runs them, on the float cases."""
    jax = _import_reference()
    import jax.numpy as jnp

    from repro.kernels.rbe_matmul import (quantize_rowwise, rbe_matmul,
                                          rbe_matmul_raw, rbe_matmul_ref)
    out = {"raw": [], "quant": [], "float": [], "wrap": []}
    for case in p["raw"]:
        args = tuple(map(jnp.asarray, rbe_inputs(*case)))
        out["raw"].append({"kernel": np.asarray(rbe_matmul_raw(*args)),
                           "ref": np.asarray(rbe_matmul_ref(*args))})
    for case in p.get("wrap", ()):
        args = tuple(map(jnp.asarray, rbe_wrap_inputs(*case)))
        out["wrap"].append(np.asarray(rbe_matmul_ref(*args)))
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


def task_service(p):
    """The reference's ``SweepService`` in process: each request of
    ``p["requests"]`` (``SweepRequest`` keyword dicts) served alone, its
    summary and ``result_to_json``; the requests of ``p["fused"]``
    submitted while the service is paused, so they fuse, with the
    executions that took; and each request's ``to_json`` and plan
    signature."""
    from repro.core import stream
    from repro.core.service import SweepRequest, SweepService, plan_kwargs
    reqs = {n: SweepRequest(**kw) for n, kw in p["requests"].items()}
    out = {"served": {}, "fused": {}, "json": {}, "signature": {}}
    with SweepService(capacity=64) as svc:
        for name, req in reqs.items():
            res = svc.submit(req).result(timeout=600)
            out["served"][name] = dict(_stream_summary(res),
                                       json=stream.result_to_json(res))
        if p.get("fused"):
            svc.pause()
            tickets = {n: svc.submit(SweepRequest(**kw))
                       for n, kw in p["fused"].items()}
            before = svc.counters["executions"]
            svc.resume()
            for n, t in tickets.items():
                out["fused"][n] = _stream_summary(t.result(timeout=600))
            out["fused_executions"] = svc.counters["executions"] - before
    for name, req in reqs.items():
        out["json"][name] = req.to_json()
        out["signature"][name] = stream.plan_stream(
            **plan_kwargs(req)).signature
    return out


def task_worker_drain(p):
    """The reference's worker path in process: ``dispatch_job`` of
    ``p["request"]`` into a fresh spool with ``p["n_leases"]`` leases,
    drained by ``worker_loop(once=True)`` (``run_lease`` a lease); the
    fold's summary, its part count, the lease ranges and the job's
    signature."""
    from repro.core.service import SweepRequest
    from repro.runtime import workers as wk
    with tempfile.TemporaryDirectory() as spool:
        handle = wk.dispatch_job(spool, SweepRequest(**p["request"]),
                                 n_leases=p["n_leases"])
        rc = wk.worker_loop(spool, wid="w-ref", once=True)
        res = handle.result()
        leases = [(ls["start"], ls["stop"])
                  for ls in handle.board.read()["leases"]]
        job = handle.board.job()
    return dict(_stream_summary(res), rc=rc, n_parts=res.stats["n_parts"],
                leases=leases, signature=handle.signature,
                chunk=job["chunk"], scan=job["scan"])


def task_spool(p):
    """The reference's ``SweepService`` journals two requests into the
    spool ``p["spool"]``: ``p["done"]`` served to completion (its result
    journaled), then ``p["queued"]`` submitted while paused and left
    queued by a close.  Returns the served result, the solo
    ``stream_grid`` of the queued request, and the queued request's
    ``to_json`` and plan signature."""
    from repro.core import stream
    from repro.core.service import SweepRequest, SweepService, plan_kwargs
    done, queued = SweepRequest(**p["done"]), SweepRequest(**p["queued"])
    svc = SweepService(spool_dir=p["spool"], capacity=8)
    res = svc.submit(done, client_id="ref-done").result(timeout=600)
    svc.pause()
    svc.submit(queued, client_id="ref-queued")
    svc.close(drain=False)
    kw = plan_kwargs(queued.normalized())
    return {"done": _stream_summary(res),
            "queued_solo": _stream_summary(stream.stream_grid(**kw)),
            "queued_json": queued.to_json(),
            "queued_signature": stream.plan_stream(**kw).signature}


def task_service_bench(p):
    """The reference service benchmark's workload
    (``benchmarks/service_bench.py``): its big and warm-up grids, its
    worker counts, and the tenant requests its ``_tenant_latencies``
    submits (recorded by a stand-in service), each as ``(tenant, grid,
    track)``."""
    sys.path.insert(0, str(SRC.parent))
    from benchmarks import service_bench as SB
    from benchmarks.stream_bench import _grid_for

    seen = []

    class _Ticket:
        def result(self, timeout=None):
            return None

    class _Service:
        def submit(self, req):
            seen.append((req.tenant, dict(req.grid), req.track))
            return _Ticket()

    SB._tenant_latencies(_Service(), _grid_for(100_000))
    return {"big": _grid_for(SB.N_BIG), "warm": _grid_for(0),
            "workers": tuple(SB.WORKER_COUNTS), "n_tenants": SB.N_TENANTS,
            "tenants": sorted(seen, key=lambda x: x[0])}


def sample_hlo() -> str:
    """``SAMPLE_HLO`` of the reference's ``tests/test_hlo_analysis.py``,
    read from its source (the file imports ``repro.core``)."""
    import ast

    path = SRC.parent / "tests" / "test_hlo_analysis.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "SAMPLE_HLO" for t in node.targets):
            return ast.literal_eval(node.value)
    raise LookupError("SAMPLE_HLO")


def collective_fields(s) -> dict:
    """A ``CollectiveSummary`` as plain values."""
    return {"ops": [(o.opcode, o.payload_bytes, o.group_size, o.wire_bytes)
                    for o in s.ops],
            "total_payload_bytes": s.total_payload_bytes,
            "total_wire_bytes": s.total_wire_bytes,
            "by_opcode": s.by_opcode(), "by_group_size": s.by_group_size()}


def hlo_cost_fields(c) -> dict:
    """An ``HLOCost`` as plain values, field for field."""
    return {"flops": c.flops, "bytes": c.bytes,
            "collectives": collective_fields(c.collectives),
            "flops_by_op": dict(c.flops_by_op),
            "bytes_by_op": dict(c.bytes_by_op),
            "unrolled_whiles": c.unrolled_whiles,
            "unknown_trip_whiles": c.unknown_trip_whiles}


def roofline_cases(H, roofline, tpu_energy, dosc, chip) -> dict:
    """The cases of the reference's ``tests/test_hlo_analysis.py`` (its
    ``TestRoofline``, ``TestTPUEnergy``, ``TestDOSCAdvisor``) as plain
    values, through the given package's modules and chip."""
    s = H.parse_collectives(sample_hlo())
    cost = {"flops": 1e12, "bytes accessed": 1e9}
    terms = roofline.build_terms("testarch", "train_4k", "16x16", 256, cost,
                                 s, model_flops_global=200e12, chip=chip)
    spread = roofline.build_terms("a", "s", "m", 4, cost, s, 2e14,
                                  chip=chip, per_device_cost=False)
    out = {"terms": terms.to_dict(), "spread": spread.to_dict(),
           "table": roofline.format_table([terms, spread]),
           "split16": tpu_energy.split_tiers(s, intra_pod_chips=16),
           "split4": tpu_energy.split_tiers(s, intra_pod_chips=4)}
    t = roofline.build_terms("a", "s", "m", 256, cost, s, 2e14, chip=chip)
    for key, kw in (("energy", {}), ("energy_t", {"t_step": 0.05})):
        e = tpu_energy.step_energy(t, s, intra_pod_chips=256, chip=chip,
                                   **kw)
        out[key] = {"fields": dataclasses.asdict(e), "total": e.total,
                    "avg_power_w": e.avg_power_w,
                    "breakdown": e.breakdown(),
                    "system_w": tpu_energy.system_power_w(e, 256)}
    for pods in (1, 2):
        for objective in ("time", "energy"):
            out[f"advise_{pods}_{objective}"] = [
                (c.plan.name, c.t_comm_s, c.e_comm_j, c.ici_bytes,
                 c.dcn_bytes, c.dcn_edge_bytes)
                for c in dosc.advise(grad_elems_per_chip=50e6, pods=pods,
                                     intra_pod_chips=256,
                                     objective=objective, chip=chip)]
    out["plans"] = [dataclasses.asdict(pl) for pl in dosc.DEFAULT_PLANS]
    out["grad_reduce"] = [dataclasses.asdict(dosc.grad_reduce_cost(
        pl, 1.25e6, 2, 8, grad_dtype_bytes=2, chip=chip))
        for pl in dosc.DEFAULT_PLANS]
    return out


def task_roofline(p):
    """The reference's roofline, energy and advisor cases under
    ``TPU_V5E`` (``roofline_cases``)."""
    from repro.core import dosc, hlo_analysis, roofline, tpu_energy
    from repro.core.constants import TPU_V5E

    return roofline_cases(hlo_analysis, roofline, tpu_energy, dosc, TPU_V5E)


def hlo_programs(jax, jnp) -> dict:
    """The five programs of the reference's ``tests/test_hlo_cost.py``
    (a matmul, a scan of 8 matmuls, nested scans, a depthwise conv, an
    elementwise chain), compiled: name -> (compiled, sizes)."""
    def compile_(fn, *specs):
        return jax.jit(fn).lower(*specs).compile()

    f32 = jnp.float32
    S = jax.ShapeDtypeStruct
    out = {"matmul": compile_(lambda a, b: a @ b, S((128, 512), f32),
                              S((512, 256), f32))}

    def scan(a, bs):
        def body(x, b):
            return x @ b, ()
        y, _ = jax.lax.scan(body, a, bs)
        return y
    out["scan"] = compile_(scan, S((128, 128), f32), S((8, 128, 128), f32))

    def nested(a, bs):
        def outer(x, b_outer):
            def inner(y, _):
                return y @ b_outer, ()
            y, _ = jax.lax.scan(inner, x, None, length=5)
            return y, ()
        y, _ = jax.lax.scan(outer, a, bs)
        return y
    out["nested"] = compile_(nested, S((64, 64), f32), S((3, 64, 64), f32))

    def conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1,), "VALID", dimension_numbers=("NWC", "WIO", "NWC"),
            feature_group_count=32)
    out["conv"] = compile_(conv, S((1, 64, 32), f32), S((4, 1, 32), f32))
    out["elementwise"] = compile_(lambda a: jnp.tanh(a) * 2 + 1,
                                  S((128, 128), f32))
    return out


def task_hlo_cost(p):
    """The reference's text analysis on ``SAMPLE_HLO`` and on the texts
    of the five compiled programs of its ``tests/test_hlo_cost.py``
    (each text with its ``analyze`` fields, plain and with
    ``vmem_credit_depth`` 1 and 2), and the dot and convolution flops of
    a reduced float32 LM forward (``p["arch"]`` cut to ``p["layers"]``
    layers, on (``p["batch"]``, ``p["seq"]``) tokens), compiled."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.core import hlo_analysis as H
    from repro.core import hlo_cost
    from repro.models import transformer as T

    sample = sample_hlo()
    out = {"sample": {"collectives": collective_fields(
        H.parse_collectives(sample)),
        "count_op": {op: H.count_op(sample, op) for op in
                     ("fusion", "all-reduce", "copy", "parameter")},
        "analyze": hlo_cost_fields(hlo_cost.analyze(sample))},
        "empty": hlo_cost_fields(hlo_cost.analyze("")),
        "programs": {}}
    for name, c in hlo_programs(jax, jnp).items():
        text = c.as_text()
        out["programs"][name] = {
            "text": text,
            "analyze": {depth: hlo_cost_fields(hlo_cost.analyze(
                text, vmem_credit_depth=depth)) for depth in (None, 1, 2)},
            "top": hlo_cost.top_bytes_breakdown(hlo_cost.analyze(text), 3)}
    cfg = get_reduced_config(p["arch"], num_layers=p["layers"],
                             dtype="float32")
    params = T.init_params(cfg, jax.random.key(0))
    tokens = jnp.zeros((p["batch"], p["seq"]), jnp.int32)
    text = jax.jit(lambda pr, t: T.forward(cfg, pr, T.Batch(tokens=t))) \
        .lower(params, tokens).compile().as_text()
    lm = hlo_cost.analyze(text)
    out["lm"] = {"dot": lm.flops_by_op.get("dot", 0.0),
                 "convolution": lm.flops_by_op.get("convolution", 0.0)}
    return out


def task_vmem_credit(p):
    """Each reduced arch of ``p["archs"]`` (``p["reduced"]``'s
    overrides) stepping on each shape of ``p["shapes"]`` ((name,
    seq_len, global_batch, mode)), compiled unsharded: its flops by op
    and its bytes by op under ``analyze`` plain and with
    ``vmem_credit_depth=2``, the dry-run's ``--vmem-credit``."""
    import jax

    from repro.configs import InputShape, get_reduced_config
    from repro.core import hlo_cost
    from repro.launch import specs, steps
    from repro.optim import adamw

    out = {}
    for arch in p["archs"]:
        cfg = get_reduced_config(arch, **p["reduced"])
        params = specs.params_specs(cfg)
        for shape in (InputShape(*s) for s in p["shapes"]):
            batch = specs.input_specs(cfg, shape)
            if shape.mode == "train":
                opt_cfg = adamw.AdamWConfig(
                    moment_dtype=specs.moment_dtype_for(cfg))
                lowered = jax.jit(steps.make_train_step(cfg, opt_cfg)).lower(
                    params, specs.opt_specs(opt_cfg, params), batch)
            elif shape.mode == "prefill":
                lowered = jax.jit(steps.make_prefill_step(cfg)).lower(
                    params, batch)
            else:
                lowered = jax.jit(steps.make_serve_step(cfg)).lower(
                    params, specs.cache_specs(cfg, shape), batch,
                    specs.pos_spec())
            text = lowered.compile().as_text()
            out[arch, shape.name] = {
                credit: {"flops_by_op": dict(c.flops_by_op),
                         "bytes_by_op": dict(c.bytes_by_op)}
                for credit, c in ((False, hlo_cost.analyze(text)),
                                  (True, hlo_cost.analyze(
                                      text, vmem_credit_depth=2)))}
            out[arch, shape.name]["block_io_parts"] = _block_io_parts(
                hlo_cost, text)
    return out


def _block_io_parts(hlo_cost, text: str, depth: int = 2) -> dict:
    """The reference's ``vmem-block-io`` (``analyze(text,
    vmem_credit_depth=depth)``) split by what it charges in each fusion
    at ``while`` depth >= ``depth``: the outputs of its ``dynamic-slice``
    and ``gather`` operations (``"loads"``), the updates of its
    ``dynamic-update-slice`` operations (``"stores"``) and those
    operations' outputs, each the whole buffer updated
    (``"updated_buffers"``).  The walk is ``analyze``'s (trip counts,
    fusion bodies walked as well as charged)."""
    comps, entry, shapes = hlo_cost._parse_computations(text)
    parts = {"loads": 0.0, "stores": 0.0, "updated_buffers": 0.0}

    def nbytes(shape: str) -> int:
        return hlo_cost._shape_elems_bytes(shape)[1]

    def walk(name: str, mult: float, level: int) -> None:
        comp = comps.get(name)
        for ins in comp.instrs if comp is not None else ():
            if ins.opcode == "while":
                tm = hlo_cost._TRIP.search(ins.line)
                for rx in (hlo_cost._BODY, hlo_cost._COND):
                    m = rx.search(ins.line)
                    if m:
                        walk(m.group(1), mult * (int(tm.group(1)) if tm
                                                 else 1), level + 1)
            elif ins.opcode in ("fusion", "call", "conditional",
                                "async-start"):
                cm = (hlo_cost._CALLS.search(ins.line)
                      or hlo_cost._TO_APPLY.search(ins.line))
                if not cm:
                    continue
                walk(cm.group(1), mult, level)
                body = comps.get(cm.group(1))
                if ins.opcode != "fusion" or level < depth or body is None:
                    continue
                for b in body.instrs:
                    if b.opcode in ("dynamic-slice", "gather"):
                        parts["loads"] += nbytes(b.out_shape) * mult
                    elif b.opcode == "dynamic-update-slice":
                        parts["updated_buffers"] += nbytes(b.out_shape) * mult
                        if len(b.operands) > 1:
                            parts["stores"] += nbytes(
                                shapes.get(b.operands[1], "")) * mult
    walk(entry, 1.0, 0)
    return parts


def _spec_tuple(spec) -> tuple:
    """A ``PartitionSpec`` as a tuple: one entry a dim, ``None``, an axis
    name or a tuple of them."""
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _paths(jax, tree, fn) -> dict:
    """``{path: fn(leaf)}`` over a pytree, paths as the reference's
    partitioning prints them."""
    from repro.launch.partitioning import _path_str

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: x is None)[0]:
        if leaf is not None:
            out[_path_str(path)] = fn(leaf)
    return out


def task_sharding_rules(p):
    """The reference's sharding rules and state stand-ins for the
    (arch x shape x mesh) cells of ``p``: each arch's config (full, or
    reduced with ``p["reduced"]``'s overrides), each shape of
    ``p["shapes"]`` ((name, seq_len, global_batch, mode); ``SHAPES`` by
    default) that ``cell_is_runnable`` passes, each mesh of
    ``p["meshes"]`` ({name: {axis: size}}, as an abstract mesh).  For
    each: every parameter's spec (``param_spec``), shape and dtype; the
    optimizer state's; each runnable cell's input specs and shapes
    (``batch_pspec``, ``input_specs``), decode cache specs and shapes
    (``cache_spec``, ``cache_specs``), and the dry-run's analytic state
    bytes a device (``_analytic_state_bytes`` as ``lower_cell`` sums
    it)."""
    import jax

    from repro.configs import SHAPES, InputShape, cell_is_runnable
    from repro.configs import get_config, get_reduced_config
    from repro.launch import partitioning as pt
    from repro.launch import specs
    from repro.launch.dryrun import _analytic_state_bytes
    from repro.optim import adamw

    def sd(leaf):
        return (tuple(leaf.shape), str(leaf.dtype))

    meshes = {name: jax.sharding.AbstractMesh(tuple(ax.values()),
                                              tuple(ax))
              for name, ax in p["meshes"].items()}
    shapes = ([InputShape(*s) for s in p["shapes"]] if p.get("shapes")
              else list(SHAPES.values()))
    out = {}
    for arch in p["archs"]:
        cfg = (get_reduced_config(arch, **p["reduced"])
               if p.get("reduced") is not None else get_config(arch))
        p_shapes = specs.params_specs(cfg)
        opt_cfg = adamw.AdamWConfig(moment_dtype=specs.moment_dtype_for(cfg))
        o_shapes = specs.opt_specs(opt_cfg, p_shapes)
        a = out[arch] = {"params": _paths(jax, p_shapes, sd),
                         "opt": _paths(jax, o_shapes, sd),
                         "param_specs": {}, "cells": {}}
        for mname, mesh in meshes.items():
            a["param_specs"][mname] = _paths(
                jax, jax.tree_util.tree_map_with_path(
                    lambda path, leaf: pt.param_spec(mesh, path, leaf),
                    p_shapes), _spec_tuple)
        for shape in shapes:
            if not cell_is_runnable(arch, shape.name)[0]:
                continue
            batch = specs.input_specs(cfg, shape)
            cell = a["cells"][shape.name] = {
                "batch": _paths(jax, batch, sd), "batch_specs": {},
                "cache_specs": {}, "state_bytes": {}}
            if shape.mode == "decode":
                c_shapes = specs.cache_specs(cfg, shape)
                cell["cache"] = _paths(jax, c_shapes, sd)
            for mname, mesh in meshes.items():
                cell["batch_specs"][mname] = _paths(
                    jax, pt.batch_pspec(mesh, batch), _spec_tuple)
                p_shard = pt.params_shardings(mesh, p_shapes)
                chips = mesh.size
                state = _analytic_state_bytes(p_shard, p_shapes, chips)
                if shape.mode == "train":
                    state += 2 * _analytic_state_bytes(p_shard, o_shapes.mu,
                                                       chips)
                elif shape.mode == "decode":
                    c_shard = pt.cache_spec(mesh, c_shapes,
                                            shape.global_batch)
                    cell["cache_specs"][mname] = _paths(
                        jax, c_shard, lambda s: _spec_tuple(s.spec))
                    state += _analytic_state_bytes(c_shard, c_shapes, chips)
                cell["state_bytes"][mname] = state
    return out


def task_shapes_table(p):
    """The reference's ``configs.shapes``: ``SHAPES``, each (arch x
    shape) cell's ``cell_is_runnable`` and ``all_cells()``."""
    import dataclasses

    from repro.configs import ARCH_IDS, SHAPES, shapes

    return {"shapes": {k: dataclasses.astuple(v) for k, v in SHAPES.items()},
            "runnable": {(a, s): shapes.cell_is_runnable(a, s)
                         for a in ARCH_IDS for s in SHAPES},
            "all_cells": shapes.all_cells(),
            "long_context": sorted(shapes.LONG_CONTEXT_ARCHS),
            "skip_reasons": dict(shapes.SKIP_REASONS)}


def task_sharded_loss(p):
    """The reference's sharded loss (``tests/test_dryrun_small.py``'s
    program: the loss under ``jit`` with the rules' shardings on the
    (2, 4) debug mesh of 8 host devices) for each arch of ``p["archs"]``
    reduced to ``p["reduced"]`` in ``p["dtype"]``, on the anchors' numpy
    weights (each leaf in the dtype the reference's init gives it) and
    ``p["tokens"]`` as tokens and labels; with its unsharded loss."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.launch import partitioning as pt
    from repro.launch.mesh import make_debug_mesh
    from repro.models import transformer as T
    from repro_torch.configs import get_reduced_config as port_config
    from repro_torch.models import anchors as A

    assert len(jax.devices()) == 8
    mesh = make_debug_mesh(data=2, model=4)
    toks = jnp.asarray(np.asarray(p["tokens"], np.int32))
    batch = T.Batch(tokens=toks, labels=toks)
    out = {}
    for arch in p["archs"]:
        cfg = get_reduced_config(arch, dtype=p["dtype"], **p["reduced"])
        pcfg = port_config(arch, dtype=p["dtype"], **p["reduced"])
        shapes = jax.eval_shape(lambda: T.init_params(cfg, jax.random.key(0)))
        params = jax.tree.map(lambda a, s: jnp.asarray(a).astype(s.dtype),
                              A.jax_layout_params(pcfg), shapes)
        ref = float(T.loss_fn(cfg, params, batch))
        with jax.set_mesh(mesh):
            p_shapes = jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
            p_shard = pt.params_shardings(mesh, p_shapes)
            b_shard = pt.batch_spec(mesh, jax.tree.map(
                lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), batch))
            params_s = jax.tree.map(jax.device_put, params, p_shard)
            batch_s = jax.tree.map(jax.device_put, batch, b_shard)
            fn = jax.jit(lambda pr, b: T.loss_fn(cfg, pr, b),
                         in_shardings=(p_shard, b_shard))
            got = float(fn(params_s, batch_s))
        out[arch] = {"unsharded": ref, "sharded": got}
    return out


def task_seq_parallel_forward(p):
    """The reference's forward with ``seq_parallel=True`` (no mesh) on
    the anchors' weights and inputs, for each reduced float32 arch of
    ``p["archs"]``: its logits at ``ANCHOR_ROWS``, eagerly."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config
    from repro.models import transformer as T
    from repro_torch.configs import get_reduced_config as port_config
    from repro_torch.models import anchors as A

    out = {}
    for arch in p["archs"]:
        pcfg = port_config(arch, dtype="float32")
        cfg = dataclasses.replace(get_reduced_config(arch, dtype="float32"),
                                  seq_parallel=True)
        params = jax.tree.map(jnp.asarray, A.jax_layout_params(pcfg))
        if pcfg.frontend_stub:
            embeds, positions = A.anchor_embeds(pcfg)[:2]
            batch = T.Batch(embeds=jnp.asarray(embeds),
                            positions=None if positions is None
                            else jnp.asarray(positions))
        else:
            batch = T.Batch(tokens=jnp.asarray(A.anchor_tokens(pcfg)[0]))
        logits = np.asarray(T.forward(cfg, params, batch))
        out[arch] = np.stack([logits[b, s] for b, s in A.ANCHOR_ROWS])
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

