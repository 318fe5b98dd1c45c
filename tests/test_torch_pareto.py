"""The port's Pareto analysis against the reference: the same fronts,
hypervolumes and knees on the 10,880-config grid, the exact dominance
mask on random points, and the torch dominance pre-filter against its
numpy original."""

import numpy as np
import pytest
import torch

from _jax_reference import assert_close, run
from repro_torch.core import pareto, sweep
from repro_torch.core.grids import REFERENCE_GRID

FRONTS = {
    "default": {},
    "power_latency": {"objectives": ["avg_power", "latency"]},
    "maximize": {"objectives": ["avg_power", "sensor_macs_per_s"],
                 "maximize": ["sensor_macs_per_s"]},
}
SEED, N_POINTS = 5, 1500


@pytest.fixture(scope="module")
def ref():
    return run("pareto", grid=REFERENCE_GRID, fronts=FRONTS, seed=SEED,
               n_points=N_POINTS)


@pytest.fixture(scope="module")
def dense():
    return sweep.evaluate_grid(**REFERENCE_GRID, device="cpu")


@pytest.mark.parametrize("name", sorted(FRONTS))
def test_front_hypervolume_knee(dense, ref, name):
    fr = pareto.pareto_front(dense, **FRONTS[name])
    want = ref[name]
    assert np.array_equal(fr.indices, want["indices"])
    assert_close(fr.values, want["values"], what="values")
    assert_close(fr.hypervolume(), want["hypervolume"], what="hv")
    knee = fr.knee()
    assert knee.keys() == want["knee"].keys()
    for k, v in want["knee"].items():
        if isinstance(v, float) and k in fr.objectives:
            assert_close(knee[k], v, what=k)
        else:
            assert knee[k] == v, k


def test_random_points(ref):
    pts = np.random.default_rng(SEED).random((N_POINTS, 3))
    want = ref["random"]
    assert np.array_equal(pts, want["points"])
    mask = pareto.non_dominated_mask(pts)
    assert np.array_equal(mask, want["mask"])
    assert pareto.hypervolume(pts[mask], (1.1, 1.1, 1.1)) == want["hv"]
    assert pareto.knee_point(pts) == want["knee"]


@pytest.mark.parametrize("d", [1, 2, 3])
def test_torch_dominance_filter_matches_numpy(d):
    rng = np.random.default_rng(d)
    front = rng.random((200, d))
    front = front[pareto.non_dominated_mask(front)]
    state = pareto.build_dominance_filter(front, d, 24, 256)
    pts = rng.random((d, 5000)) * 1.2
    pts[:, ::97] = np.inf                      # masked lanes never survive
    pts[:, 1::89] = front[:1].T                # exact front twins survive
    want = pareto.dominance_filter_mask(state, pts, xp=np)
    got = pareto.dominance_filter_mask_torch(
        {k: torch.as_tensor(v) for k, v in state.items()},
        torch.as_tensor(pts))
    assert np.array_equal(got.numpy(), want)
    assert 0 < want.sum() < want.size
