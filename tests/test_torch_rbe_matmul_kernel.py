"""The port's RBE int8 matmul (``repro_torch.kernels.rbe_matmul``)
against the reference's Pallas kernel, run in interpret mode in the
reference's child process.

Inputs are made from numpy seeds by the helpers of
``tests/_jax_reference.py`` on both sides.  Tolerances:

* the raw product: the reference's own rtol of 1e-6
  (``tests/test_kernels.py``), and bitwise is what both compute (an
  exact int32 sum, then the same two float32 multiplies in the same
  order);
* ``quantize_rowwise``: bitwise, scales and int8 values, against the
  reference as its jitted ``rbe_matmul`` runs it (XLA multiplies by the
  float32 reciprocal of 127 there);
* the float-in ``rbe_matmul``: bitwise (it is the two above composed).
"""

import numpy as np
import pytest
import torch

from _jax_reference import float_inputs, rbe_inputs, rbe_wrap_inputs, run
from repro_torch.kernels import rbe_matmul as R

#: (m, k, n, seed): the reference test's three shapes, KeyNet's three
#: int8 shapes at 4 ROIs, and ragged ones (no dimension a multiple of
#: the Pallas blocks), and saturated operands (every entry +-127).
RAW_CASES = ((128, 128, 128, 0), (256, 512, 384, 1), (512, 256, 128, 2),
             (576, 128, 128, 3), (144, 128, 256, 4), (144, 256, 256, 5),
             (97, 130, 61, 6), (1, 3, 5, 7), (256, 2048, 64, 8, True))
#: (shape, seed, axis) of the quantization cases.
QUANT_CASES = (((576, 128), 10, -1), ((128, 256), 11, 0), ((33, 7), 12, -1),
               ((5, 300), 13, 0))
#: (m, k, n, seed) of the cases past int32: -128 operands at K 133,000,
#: output (0, 0) summing 128² K = 2,179,072,000 (the reference's int32
#: product wraps it to -2,115,895,296), the other cells in range.
WRAP_CASES = ((3, 133_000, 4, 30),)
#: (m, k, n, seed) of the float-in cases.
FLOAT_CASES = ((256, 256, 256, 20), (576, 128, 128, 21), (97, 130, 61, 22))


@pytest.fixture(scope="module")
def ref():
    return run("rbe", raw=RAW_CASES, quant=QUANT_CASES, float=FLOAT_CASES,
               wrap=WRAP_CASES)


def _t(*arrays):
    return tuple(torch.as_tensor(a) for a in arrays)


@pytest.mark.parametrize("i", range(len(RAW_CASES)),
                         ids=[f"{c[0]}x{c[1]}x{c[2]}" for c in RAW_CASES])
def test_raw_matches_pallas_kernel(ref, i):
    got = R.rbe_matmul_raw(*_t(*rbe_inputs(*RAW_CASES[i]))).numpy()
    want = ref["raw"][i]
    np.testing.assert_allclose(got, want["kernel"], rtol=1e-6, atol=0)
    assert np.array_equal(got, want["kernel"])
    assert np.array_equal(got, want["ref"])


def test_plain_version_is_exact_against_int64_numpy():
    x_q, w_q, sx, sw = rbe_inputs(300, 1000, 70, 8)
    acc = x_q.astype(np.int64) @ w_q.astype(np.int64)
    want = acc.astype(np.float32) * sx[:, None] * sw[None, :]
    got = R.rbe_matmul_ref(*_t(x_q, w_q, sx, sw)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("i", range(len(QUANT_CASES)),
                         ids=[f"{s[0]}x{s[1]}-axis{a}"
                              for s, _, a in QUANT_CASES])
def test_quantize_rowwise_bitwise(ref, i):
    shape, seed, axis = QUANT_CASES[i]
    q, s = R.quantize_rowwise(torch.as_tensor(float_inputs(shape, seed)),
                              axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), ref["quant"][i]["q"])
    assert np.array_equal(s.numpy(), ref["quant"][i]["s"])


def test_quantize_scale_is_the_reciprocal_multiply():
    """The scale is amax * float32(1/127), not amax / 127: the two
    differ for some amax, and the reference (under jit) computes the
    former."""
    amax = torch.as_tensor(np.random.default_rng(0).random(100_000,
                                                           np.float32) * 9)
    _, s = R.quantize_rowwise(amax[:, None])
    assert torch.equal(s, amax * np.float32(1.0 / 127.0))
    assert not torch.equal(s, amax / 127.0)


def test_int8_saturation():
    q, s = R.quantize_rowwise(torch.tensor([[1e6, -1e6, 0.5]]))
    assert int(q.max()) == 127 and int(q.min()) == -127
    x_q = torch.full((3, 4096), 127, dtype=torch.int8)
    w_q = torch.full((4096, 2), -127, dtype=torch.int8)
    out = R.rbe_matmul_raw(x_q, w_q, torch.ones(3), torch.ones(2))
    assert torch.equal(out, torch.full((3, 2), float(-127 * 127 * 4096)))


def test_round_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, s = R.quantize_rowwise(x)
    assert float(s[0]) == np.float32(127.0) * np.float32(1.0 / 127.0)
    want = torch.round(x / s[0])
    assert torch.equal(q, want.to(torch.int8))
    assert q[0, :5].tolist() == [0, 2, 2, 0, -2]


@pytest.mark.parametrize("i", range(len(FLOAT_CASES)),
                         ids=[f"{m}x{k}x{n}" for m, k, n, _ in FLOAT_CASES])
def test_float_in_rbe_matmul_matches_reference(ref, i):
    m, k, n, seed = FLOAT_CASES[i]
    x = torch.as_tensor(float_inputs((m, k), seed))
    w = torch.as_tensor(float_inputs((k, n), seed + 1))
    got = R.rbe_matmul(x, w).numpy()
    assert np.array_equal(got, ref["float"][i])
    # and stays at the 8-bit level of the float product
    dense = R.dequant_matmul_ref(x, w).numpy()
    assert np.linalg.norm(got - dense) / np.linalg.norm(dense) < 0.02


def test_wrapper_takes_the_plain_version_on_cpu():
    before = R.rbe_matmul_raw.launches
    args = _t(*rbe_inputs(64, 64, 64, 9))
    assert torch.equal(R.rbe_matmul_raw(*args), R.rbe_matmul_ref(*args))
    R.rbe_matmul(torch.randn(8, 16), torch.randn(16, 4))
    assert R.rbe_matmul_raw.launches == before


@pytest.mark.parametrize("bad, match", [
    (lambda a: (a[0].float(), *a[1:]), "dtype"),
    (lambda a: (a[0], a[1], a[2].double(), a[3]), "dtype"),
    (lambda a: (a[0], a[1][:, :3], a[2], a[3]), "contiguous"),
    (lambda a: (a[0], a[1], a[2][:5], a[3]), "shape"),
    (lambda a: (a[0], a[1][:8].contiguous(), a[2], a[3]), "shape"),
    (lambda a: (a[0].t(), a[1], a[2], a[3]), "contiguous"),
    (lambda a: (a[0], a[1], a[2], a[3].to("meta")), "meta"),
], ids=["x-float", "sx-double", "w-strided", "sx-short", "w-short-k",
        "x-transposed", "mixed-devices"])
def test_wrapper_checks_its_operands(bad, match):
    args = _t(*rbe_inputs(16, 24, 8, 10))
    with pytest.raises((TypeError, ValueError), match=match):
        R.rbe_matmul_raw(*bad(args))


def test_k_beyond_exact_int32_sums_is_refused():
    """The card's route refuses K past :data:`MAX_K` (checked on CUDA
    tensors, before any launch); CPU tensors take the plain version,
    which wraps as the reference does, at any K."""
    k = R.kernel.MAX_K + 1
    with pytest.raises(ValueError, match="overflow"):
        R.kernel.check_k(k)
    R.kernel.check_k(k - 1)
    out = R.rbe_matmul_raw(torch.full((1, k), -128, dtype=torch.int8),
                           torch.full((k, 1), -128, dtype=torch.int8),
                           torch.ones(1), torch.ones(1))
    assert out.item() == float(128 * 128 * k - 2**32)


def test_max_k_is_the_largest_exact_int32_sum_of_int8():
    assert R.kernel.MAX_K == 131_071
    assert 128 * 128 * R.kernel.MAX_K <= 2**31 - 1
    assert 128 * 128 * (R.kernel.MAX_K + 1) > 2**31 - 1


@pytest.mark.parametrize("i", range(len(WRAP_CASES)),
                         ids=[f"{c[0]}x{c[1]}x{c[2]}" for c in WRAP_CASES])
@pytest.mark.parametrize("fn", ["rbe_matmul_ref", "rbe_matmul_raw"])
def test_sums_past_int32_wrap_as_the_reference(ref, i, fn):
    """The plain version (and the wrapper on CPU tensors) equals the
    reference's int32 product bit for bit past int32's range."""
    got = getattr(R, fn)(*_t(*rbe_wrap_inputs(*WRAP_CASES[i]))).numpy()
    want = ref["wrap"][i]
    k = WRAP_CASES[i][1]
    assert want[0, 0] == np.float32(128 * 128 * k - 2**32) == -2_115_895_296
    assert np.array_equal(got, want)
    assert np.abs(want[1:, 1:]).max() < 2**31     # the ordinary cells
