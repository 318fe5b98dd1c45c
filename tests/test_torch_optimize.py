"""The port's knob optimizer (``repro_torch.core.optimize``) against the
JAX reference's ``repro.core.optimize`` (run in a child through
``tests/_jax_reference.py``) on the CPU.

* Values and gradients (float64 autograd against ``jax.value_and_grad``)
  within 1e-12 relative at the reference test's points and more, with
  equal NaN patterns (an untaken ``where`` branch over an MRAM table
  with no test vehicle poisons the rate gradients in both), and at a
  kink: the sensor's ``t_proc = min(1, cycles / f_clk)`` clamp exactly
  at 1, where both split each tie's gradient in half.
* Against float64 central differences at the reference test's
  ``rel=1e-5``, and the Eq. 5 MIPI-slope identity.
* ``optimize_knobs`` on the reference's searches (``examples/
  partition_study.py``'s and ``tests/test_optimize.py``'s): knobs,
  objective and trajectory within 1e-6 relative (the Adam state is
  float32 in both, and XLA contracts and approximates some float32
  operations that the port rounds one by one; the worst measured on
  these searches is 7.5e-8 on a trajectory, 2.7e-8 on the
  partition_study one, and the knobs are equal).  ``grid_argmin``: the
  same knobs exactly, the value within 1e-12.
* Every refusal, with the reference's message.
"""

import numpy as np
import pytest
import torch

from _jax_reference import assert_close, run
from repro_torch.core import arrays as A
from repro_torch.core import optimize, sweep
from repro_torch.core.grids import ANCHOR_OPTIMIZE, OPTIMIZE_SEARCH
from repro_torch.core.handtracking import build_detnet, build_keynet

N_DET = len(build_detnet().layers)
N_ALL = N_DET + len(build_keynet().layers)
CONFIG = dict(cut=N_DET, agg_node="7nm", sensor_node="16nm",
              weight_mem="sram")
WEIGHTED = {"avg_power": 1.0, "latency": 10.0}
SEARCH_RTOL = 1e-6


def kink_detnet_fps() -> float:
    """The DetNet rate at which the 16nm sensor's cycles a second equal
    its clock exactly at cut ``N_DET`` (``t_proc`` sits on its clamp)."""
    M = A.model_arrays()
    c = M.det.c_cycles_sensor[N_DET]
    f = M.f_clk[M.node_index("16nm")]
    x = f / c
    for cand in (x, np.nextafter(x, 0.0), np.nextafter(x, np.inf)):
        if (c * cand) / f == 1.0:
            return float(cand)
    raise AssertionError("no float64 DetNet rate puts t_proc at 1")


KINK = kink_detnet_fps()
POINTS = [
    ("avg_power", {"mipi_energy_scale": 1.0}, CONFIG),
    ("avg_power", {"detnet_fps": 10.0}, CONFIG),
    ("avg_power", {"keynet_fps": 30.0}, CONFIG),
    ("avg_power", {"camera_fps": 30.0}, CONFIG),
    (WEIGHTED, {"camera_fps": 30.0}, CONFIG),
    ("avg_power", None, dict(cut=N_DET, detnet_fps=15.0)),
    (WEIGHTED, None, OPTIMIZE_SEARCH["config"]),
    ("latency", None, CONFIG),
    ({"mipi": 2.0, "sensor_memory": -1.0, "agg_compute": 3.0}, None,
     dict(cut=5, agg_node="16nm", num_cameras=4)),
    (WEIGHTED, None, dict(cut=0)),
    (WEIGHTED, None, dict(cut=N_ALL, sensor_node="16nm",
                          weight_mem="mram")),
    # MRAM has no 7nm test vehicle: harmless at cut 0 (no sensor site),
    # but the untaken branch's NaN reaches the rate gradients
    (WEIGHTED, None, dict(cut=0, sensor_node="7nm", weight_mem="mram")),
    # the kink, and one float64 step either side of it
    ("avg_power", {"detnet_fps": KINK}, CONFIG),
    ("avg_power", {"detnet_fps": float(np.nextafter(KINK, 0.0))}, CONFIG),
    ("avg_power", {"detnet_fps": float(np.nextafter(KINK, np.inf))},
     CONFIG),
]
SEARCHES = {
    "partition_study": (OPTIMIZE_SEARCH["bounds"],
                        OPTIMIZE_SEARCH["objective"],
                        dict(OPTIMIZE_SEARCH["config"],
                             steps=OPTIMIZE_SEARCH["steps"])),
    "monotone_detnet": ({"detnet_fps": (5.0, 30.0)}, "avg_power",
                        dict(CONFIG, steps=120)),
    "two_knobs_250": ({"detnet_fps": (5.0, 30.0), "camera_fps": (20.0, 60.0)},
                      WEIGHTED, dict(CONFIG, steps=250)),
    "camera_only": ({"camera_fps": (20.0, 60.0)}, WEIGHTED,
                    dict(CONFIG, steps=100)),
    "init_projected": ({"detnet_fps": (5.0, 30.0)}, "avg_power",
                       dict(CONFIG, steps=5, init={"detnet_fps": 500.0})),
    "four_knobs": ({"detnet_fps": (5.0, 30.0), "keynet_fps": (15.0, 30.0),
                    "mipi_energy_scale": (0.5, 2.0),
                    "camera_fps": (20.0, 60.0)},
                   {"latency": 1.0, "mipi": 50.0},
                   dict(cut=N_DET + 4, sensor_node="16nm", steps=60,
                        init={"detnet_fps": 29.0, "keynet_fps": 16.0,
                              "mipi_energy_scale": 0.6,
                              "camera_fps": 21.0})),
}
GRIDS = {
    "partition_study": (OPTIMIZE_SEARCH["bounds"],
                        OPTIMIZE_SEARCH["objective"],
                        dict(OPTIMIZE_SEARCH["config"],
                             n=OPTIMIZE_SEARCH["n"])),
    "monotone_detnet": ({"detnet_fps": (5.0, 30.0)}, "avg_power",
                        dict(CONFIG, n=26)),
    "camera_only": ({"camera_fps": (20.0, 60.0)}, WEIGHTED,
                    dict(CONFIG, n=17)),
    "four_knobs": ({"detnet_fps": (5.0, 30.0), "keynet_fps": (15.0, 30.0),
                    "mipi_energy_scale": (0.5, 2.0),
                    "camera_fps": (20.0, 60.0)},
                   {"latency": 1.0, "mipi": 50.0},
                   dict(cut=N_DET + 4, sensor_node="16nm", n=5)),
}
ERRORS = {
    "unknown_knob": ("optimize_knobs", [{"warp_factor": (0, 1)}],
                     dict(cut=N_DET)),
    "bad_channel": ("objective_fn", ["speed_of_light"], dict(cut=N_DET)),
    "unknown_config": ("objective_fn", ["avg_power"],
                       dict(cut=N_DET, sensor_mem="x")),
    "cut_range": ("objective_fn", ["avg_power"], dict(cut=N_ALL + 5)),
    "no_cut": ("objective_fn", ["avg_power"], dict(sensor_node="7nm")),
    # a list, as the child receives it (the message prints the bounds)
    "degenerate": ("optimize_knobs", [{"detnet_fps": [5.0, 5.0]}],
                   dict(cut=N_DET)),
    "no_bounds": ("optimize_knobs", [{}], dict(cut=N_DET)),
    "grid_no_bounds": ("grid_argmin", [{}], dict(cut=N_DET)),
    "mram": ("objective_fn", ["avg_power"],
             dict(cut=N_DET, sensor_node="7nm", weight_mem="mram")),
    "weight_mem": ("objective_fn", ["avg_power"],
                   dict(cut=N_DET, weight_mem="dram")),
    "cameras": ("objective_fn", ["avg_power"],
                dict(cut=N_DET, num_cameras=2.5)),
    "grid_unknown_knob": ("grid_argmin", [{"warp_factor": (0, 1)}],
                          dict(cut=N_DET)),
}


def _json(obj):
    """Tuples as lists, for the child's JSON parameters."""
    if isinstance(obj, dict):
        return {k: _json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json(v) for v in obj]
    return obj


@pytest.fixture(scope="module")
def ref():
    return run("optimize", points=_json(POINTS), searches=_json(SEARCHES),
               grids=_json(GRIDS), errors=_json(ERRORS))


@pytest.mark.parametrize("i", range(len(POINTS)))
def test_value_and_gradient_match_reference(ref, i):
    obj, knobs, cfg = POINTS[i]
    want = ref["points"][i]
    v, g = optimize.gradient(obj, knobs, device="cpu", **cfg)
    assert_close(v, want["value"], what="value")
    assert sorted(g) == sorted(want["grad"])
    for k in g:
        assert_close(g[k], want["grad"][k], what=k)
    fields = optimize.evaluate_fields(knobs, device="cpu", **cfg)
    for k in sweep.FIELDS:
        assert_close(fields[k], want["fields"][k], what=k)


def test_untaken_branch_nan_pattern_is_the_reference_s(ref):
    g = ref["points"][11]["grad"]
    assert np.isnan(g["detnet_fps"]) and np.isnan(g["keynet_fps"])
    assert np.isfinite(g["camera_fps"]) and np.isfinite(
        g["mipi_energy_scale"])
    assert np.isfinite(ref["points"][11]["value"])


def test_kink_gradient_is_the_reference_s(ref):
    """On the clamp the gradient is neither one-sided derivative: both
    packages split a tie of ``minimum``/``maximum`` in half (``t_proc``'s
    clamp, and ``t_idle = max(0, 1 - t_proc)`` at 0 behind it), and the
    port's equals the reference's there."""
    at, below, above = (ref["points"][i]["grad"]["detnet_fps"]
                        for i in (12, 13, 14))
    for side in (below, above):
        assert abs(at - side) > 1e-6 * abs(at)
    _, g = optimize.gradient("avg_power", {"detnet_fps": KINK},
                             device="cpu", **CONFIG)
    assert_close(g["detnet_fps"], at, what="kink")


def central_diff(objective, knob, x0, eps, **config):
    hi = optimize.evaluate(objective, {knob: x0 + eps}, device="cpu",
                           **config)
    lo = optimize.evaluate(objective, {knob: x0 - eps}, device="cpu",
                           **config)
    return (hi - lo) / (2 * eps)


@pytest.mark.parametrize("objective,knob,x0,eps", [
    ("avg_power", "mipi_energy_scale", 1.0, 1e-4),
    ("avg_power", "detnet_fps", 10.0, 1e-3),
    ("avg_power", "keynet_fps", 30.0, 1e-3),
    ("avg_power", "camera_fps", 30.0, 1e-3),
    (WEIGHTED, "camera_fps", 30.0, 1e-3),
])
def test_gradient_matches_central_differences(objective, knob, x0, eps):
    _, g = optimize.gradient(objective, {knob: x0}, device="cpu", **CONFIG)
    fd = central_diff(objective, knob, x0, eps, **CONFIG)
    assert g[knob] == pytest.approx(fd, rel=1e-5, abs=1e-18)


def test_mipi_power_gradient_is_eq5_slope():
    """d P / d mipi_energy_scale is exactly the MIPI power at scale 1
    (Eq. 5 is linear in the energy a byte)."""
    v, g = optimize.gradient("avg_power", {"mipi_energy_scale": 1.0},
                             device="cpu", **CONFIG)
    fields = optimize.evaluate_fields({"mipi_energy_scale": 1.0},
                                      device="cpu", **CONFIG)
    assert g["mipi_energy_scale"] == pytest.approx(fields["mipi"], rel=1e-9)
    assert g["mipi_energy_scale"] > 0
    assert v == pytest.approx(fields["avg_power"], rel=1e-12)


def test_evaluate_matches_grid_engine_and_pinned_knobs():
    v = optimize.evaluate("avg_power", {"detnet_fps": 12.5}, device="cpu",
                          **CONFIG)
    want = sweep.evaluate_one(N_DET, sensor_node="16nm", detnet_fps=12.5,
                              device="cpu")["avg_power"]
    assert v == pytest.approx(want, rel=1e-12)
    v, _ = optimize.gradient("avg_power", device="cpu", cut=N_DET,
                             detnet_fps=15.0)
    assert v == optimize.evaluate("avg_power", device="cpu", cut=N_DET,
                                  detnet_fps=15.0)


def test_raw_objective_fn_is_differentiable_float64():
    f = optimize.objective_fn("avg_power", device="cpu", **CONFIG)
    s = torch.tensor(1.0, dtype=torch.float64, requires_grad=True)
    v = f({"mipi_energy_scale": s})
    (g,) = torch.autograd.grad(v, [s])
    assert v.dtype == g.dtype == torch.float64 and v.shape == ()
    assert np.isfinite(float(g))
    assert torch.get_default_dtype() == torch.float32


@pytest.mark.parametrize("name", list(SEARCHES))
def test_optimize_knobs_matches_reference(ref, name):
    bounds, obj, kw = SEARCHES[name]
    want = ref["searches"][name]
    res = optimize.optimize_knobs(bounds, obj, device="cpu", **kw)
    assert res.steps == want["steps"] and res.weights == want["weights"]
    assert res.trajectory.shape == want["trajectory"].shape
    assert_close(res.trajectory, want["trajectory"], rtol=SEARCH_RTOL,
                 what="trajectory")
    assert_close(res.objective, want["objective"], rtol=SEARCH_RTOL)
    assert sorted(res.knobs) == sorted(want["knobs"])
    for k, v in res.knobs.items():
        assert_close(v, want["knobs"][k], rtol=SEARCH_RTOL, what=k)
        assert bounds[k][0] <= v <= bounds[k][1]
    for k in sweep.FIELDS:
        assert_close(res.fields[k], want["fields"][k], rtol=SEARCH_RTOL,
                     what=k)
    assert res.objective <= res.trajectory[0]


@pytest.mark.parametrize("name", list(GRIDS))
def test_grid_argmin_matches_reference(ref, name):
    bounds, obj, kw = GRIDS[name]
    knobs, value = optimize.grid_argmin(bounds, obj, device="cpu", **kw)
    want_knobs, want_value = ref["grids"][name]
    assert knobs == want_knobs
    assert_close(value, want_value, what="value")


def test_search_lands_within_a_grid_step_of_grid_argmin():
    """The reference test's acceptance criterion, on the port alone."""
    bounds, obj, kw = SEARCHES["two_knobs_250"]
    res = optimize.optimize_knobs(bounds, obj, device="cpu", **kw)
    n = 41
    gk, gv = optimize.grid_argmin(bounds, obj, n=n, device="cpu", **CONFIG)
    for k in bounds:
        assert abs(res.knobs[k] - gk[k]) <= (bounds[k][1] - bounds[k][0]) \
            / (n - 1)
    assert res.objective <= gv * (1 + 1e-9)


@pytest.mark.parametrize("name", list(ERRORS))
def test_refusals_match_reference(ref, name):
    fn, args, kw = ERRORS[name]
    want = ref["errors"][name]
    assert want is not None
    with pytest.raises(ValueError) as e:
        getattr(optimize, fn)(*args, device="cpu", **kw)
    assert str(e.value) == want


def test_cut_zero_mram_is_not_refused():
    optimize.objective_fn("avg_power", device="cpu", cut=0,
                          sensor_node="7nm", weight_mem="mram")


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize.gradient("avg_power", cut=N_DET)


def test_anchor_is_the_port_on_the_cpu():
    """``ANCHOR_OPTIMIZE`` (frozen from the JAX package; re-derived in
    ``test_torch_anchors.py``) is what the port computes on the CPU."""
    s, a = OPTIMIZE_SEARCH, ANCHOR_OPTIMIZE
    v, g = optimize.gradient(s["objective"], device="cpu", **s["config"])
    assert_close(v, a["gradient_value"])
    for k in optimize.KNOBS:
        assert_close(g[k], a["gradient"][k], what=k)
    res = optimize.optimize_knobs(s["bounds"], s["objective"], device="cpu",
                                  steps=s["steps"], **s["config"])
    assert_close(res.trajectory, a["trajectory"], rtol=SEARCH_RTOL)
    assert res.knobs == a["knobs"] and res.objective == a["objective"]
    knobs, value = optimize.grid_argmin(s["bounds"], s["objective"],
                                        n=s["n"], device="cpu",
                                        **s["config"])
    assert knobs == a["grid_knobs"]
    assert_close(value, a["grid_value"])
