"""The port's hand-tracking CNNs (``repro_torch.models.cnn``) and
pipeline (``repro_torch.handtracking_pipeline``) against the reference's
``repro.models.cnn`` and ``examples/handtracking_pipeline.py`` logic.

The reference makes its weights (``HandCNN.init`` from a ``jax.random``
key) and the inputs (numpy seeds) in its child process; the port takes
the same weights through ``params_from_jax``.  Tolerances:

* float outputs: rtol 1e-5, atol 1e-6 — float32 convolutions summed in
  another order (XLA's and PyTorch's CPU kernels);
* int8 outputs: relative L2 1e-3 — the int8 layers are bitwise equal on
  equal inputs (``test_torch_rbe_matmul_kernel.py``), but an ulp of
  difference in a float activation can flip an int8 rounding at a tie;
* MACs, parameter counts, ROI origins and the pricing: exact.
"""

import numpy as np
import pytest
import torch

from _jax_reference import run
from repro_torch import handtracking_pipeline as HP
from repro_torch.core.grids import PRICING_ANCHOR
from repro_torch.core.handtracking import build_detnet, build_keynet
from repro_torch.models import cnn
from repro_torch.models.cnn import HandCNN, params_from_jax

FLOAT_TOL = dict(rtol=1e-5, atol=1e-6)
INT8_REL_L2 = 1e-3


def rel_l2(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def detnet_ref():
    return run("cnn", net="detnet", batch=1, seed=3)


@pytest.fixture(scope="module")
def keynet_ref():
    return run("cnn", net="keynet", batch=2, seed=4, int8=True)


@pytest.fixture(scope="module")
def pipeline_ref():
    return run("pipeline", batch=2, seed=5)


def _model(net, params):
    m = (HandCNN.detnet if net == "detnet" else HandCNN.keynet)(device="cpu")
    m.load_params(params_from_jax(params))
    return m


@pytest.mark.parametrize("net, table", [("detnet", build_detnet),
                                        ("keynet", build_keynet)])
def test_geometry_matches_table(net, table):
    m = getattr(HandCNN, net)(device="cpu")
    assert m.traced_macs() == table().total_macs
    assert m.traced_macs(batch=3) == 3 * table().total_macs
    assert sum(w.numel() for w in m.weights) == table().total_weight_bytes
    assert m.param_bytes() == table().total_weight_bytes


@pytest.mark.parametrize("fixture", ["detnet_ref", "keynet_ref"])
def test_counts_match_reference(request, fixture):
    ref = request.getfixturevalue(fixture)
    m = _model("detnet" if fixture == "detnet_ref" else "keynet",
               ref["params"])
    assert m.traced_macs() == ref["macs"]
    assert sum(w.numel() for w in m.weights) == ref["n_weights"]


def test_detnet_float_matches_reference(detnet_ref):
    m = _model("detnet", detnet_ref["params"])
    got = m(torch.as_tensor(detnet_ref["x"])).numpy()
    assert got.shape == (1, 20 * 15 * (6 + 24))
    np.testing.assert_allclose(got, detnet_ref["float"], **FLOAT_TOL)


def test_keynet_float_matches_reference(keynet_ref):
    m = _model("keynet", keynet_ref["params"])
    got = m(torch.as_tensor(keynet_ref["x"])).numpy()
    assert got.shape == (2, 21 * 3)
    np.testing.assert_allclose(got, keynet_ref["float"], **FLOAT_TOL)


def test_keynet_int8_matches_reference(keynet_ref):
    m = _model("keynet", keynet_ref["params"])
    x = torch.as_tensor(keynet_ref["x"])
    got = m(x, use_rbe_int8=True).numpy()
    assert rel_l2(got, keynet_ref["int8"]) <= INT8_REL_L2
    # the int8 path stays at 8-bit error of the float path
    assert rel_l2(got, keynet_ref["float"]) < 0.15


@pytest.mark.parametrize("net, routed", [
    ("keynet", ["b4.pw", "b5.pw", "b6.pw"]), ("detnet", [])])
def test_int8_routes_exactly_the_reference_layers(monkeypatch, net, routed):
    m = getattr(HandCNN, net)(device="cpu")
    assert [s.name for s in m.workload.layers if cnn.rbe_routed(s)] == routed
    shapes = []

    def spy(x, w):
        shapes.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w)

    real = cnn.rbe_matmul
    monkeypatch.setattr(cnn, "rbe_matmul", spy)
    h, w = m.input_hw
    x = torch.rand((2, h, w, 1), generator=torch.Generator().manual_seed(0))
    m(x, use_rbe_int8=True)
    want = [((2 * s.in_act_bytes // s.cin, s.cin), (s.cin, s.cout))
            for s in m.workload.layers if s.name in routed]
    assert shapes == want
    m(x)
    assert len(shapes) == len(want)          # the float path never routes


@pytest.mark.parametrize("size, k, stride, want", [
    (240, 3, 2, (0, 1)), (320, 3, 2, (0, 1)), (30, 3, 2, (0, 1)),
    (96, 3, 2, (0, 1)), (15, 3, 1, (1, 1)), (12, 1, 1, (0, 0)),
    (7, 3, 2, (1, 1))])
def test_same_padding_as_xla(size, k, stride, want):
    x = torch.zeros((1, 1, size, size))
    y = cnn._same_pad(x, k, stride)
    assert y.shape[-1] == size + sum(want)
    lo = want[0]
    y[..., lo:lo + size, lo:lo + size] = 1
    assert y.sum() == size * size


def test_params_from_jax_layouts():
    rng = np.random.default_rng(0)
    conv = rng.standard_normal((3, 3, 4, 5)).astype(np.float32)
    dw = rng.standard_normal((3, 3, 1, 6)).astype(np.float32)
    fc = rng.standard_normal((7, 2)).astype(np.float32)
    out = params_from_jax([{"w": conv, "b": np.zeros(5, np.float32)},
                           {"w": dw, "b": np.zeros(6, np.float32)},
                           {"w": fc, "b": np.zeros(2, np.float32)}])
    assert out[0]["w"].shape == (5, 4, 3, 3)
    assert out[0]["w"][1, 2, 0, 1] == conv[0, 1, 2, 1]
    assert out[1]["w"].shape == (6, 1, 3, 3)
    assert out[1]["w"][4, 0, 2, 0] == dw[2, 0, 0, 4]
    assert torch.equal(out[2]["w"], torch.as_tensor(fc))


def test_load_params_checks_shapes():
    m = HandCNN.keynet(device="cpu")
    bad = [{"w": w, "b": b} for w, b in zip(m.weights, m.biases)]
    bad[0] = {"w": torch.zeros(3, 3), "b": bad[0]["b"]}
    with pytest.raises(ValueError, match="stem.w"):
        m.load_params(bad)


def test_init_is_seeded_by_its_generator():
    a = HandCNN.keynet(torch.Generator().manual_seed(1), device="cpu")
    b = HandCNN.keynet(torch.Generator().manual_seed(1), device="cpu")
    c = HandCNN.keynet(torch.Generator().manual_seed(2), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.weights, b.weights))
    assert not torch.equal(a.weights[0], c.weights[0])
    assert all(not b.any() for b in a.biases)


def test_pipeline_matches_reference_example(pipeline_ref):
    ref = pipeline_ref
    out = HP.run_pipeline(ref["frames"], params_from_jax(ref["det_params"]),
                          params_from_jax(ref["key_params"]), device="cpu")
    assert out["origins"] == [tuple(o) for o in ref["origins"]]
    np.testing.assert_allclose(out["kp_f32"].numpy(),
                               np.stack(ref["kp_f32"]), **FLOAT_TOL)
    assert rel_l2(out["kp_int8"].numpy(),
                  np.stack(ref["kp_int8"])) <= INT8_REL_L2
    # |err_port - err_ref| <= |kp_int8 difference| / |kp_f32| (triangle
    # inequality): within the int8 bound, doubled for the float terms.
    np.testing.assert_allclose(out["rel_err"], ref["rel_err"], rtol=0,
                               atol=2 * INT8_REL_L2)
    assert out["pricing"] == ref["pricing"] == PRICING_ANCHOR


def test_roi_origins_reproduce_the_reference_reshape():
    """The class block is read as (20, 15, 6), as the reference example
    reads it: anchor (i0, i1) of that view sets x from i0 and y from
    i1, and the first maximum wins."""
    det_out = torch.zeros((3, 9000))
    det_out[0, 6 * (15 * 4 + 7)] = 1.0            # i0 = 4, i1 = 7
    det_out[1, 6 * (15 * 19 + 14)] = 2.0          # the far corner
    det_out[2, 0] = det_out[2, 6 * 5] = 1.0       # tie: the first wins
    assert HP.roi_origins(det_out) == [(7 * 16 - 48, 4 * 16 - 48),
                                       (144, 224), (0, 0)]


def test_one_int8_tie_flip_exceeds_1e3():
    """Why the card and the CPU cannot agree on the int8 keypoints to
    1e-3 (``chip_smoke.py``'s pipeline phase holds them to 5e-3): on the
    pipeline's frames and weights there, scaling the ROIs by 1 + 1e-7
    noise — the size of the float layers' card-vs-CPU differences —
    flips an int8 rounding at a tie in some draws, which moves the
    keypoints by more than 1e-3 but less than 5e-3; the float keypoints
    move by ~1e-6."""
    frames = torch.as_tensor(np.random.default_rng(7).random(
        (4, 240, 320, 1), dtype=np.float32))
    det = HandCNN.detnet(torch.Generator().manual_seed(0), device="cpu")
    key = HandCNN.keynet(torch.Generator().manual_seed(1), device="cpu")
    out = HP.pipeline_forward(frames, det, key)
    g = torch.Generator().manual_seed(2)
    moves, float_moves = [], []
    for _ in range(40):
        rois = out["rois"] * (1 + 1e-7 * torch.randn(out["rois"].shape,
                                                    generator=g))
        moves.append(rel_l2(key(rois, use_rbe_int8=True), out["kp_int8"]))
        float_moves.append(rel_l2(key(rois), out["kp_f32"]))
    flipped = [m for m in moves if m > 1e-3]
    print(f"{len(flipped)} of {len(moves)} draws flip: {sorted(flipped)}")
    assert flipped and max(moves) < 5e-3
    assert max(float_moves) < 1e-5
