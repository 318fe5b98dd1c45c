"""Kernel D's function (RMSNorm) in the port against the JAX package.

The port's plain version (``repro_torch.kernels.rmsnorm.rmsnorm_ref``),
its public wrapper on CPU tensors (which runs that plain version) and the
LM layer ``repro_torch.models.layers.rmsnorm`` are held against the
reference's Pallas kernel in interpret mode
(``repro.kernels.rmsnorm.rmsnorm``), its oracle and its LM layer, on the
same numpy inputs.  Tolerances are the reference's own
(``tests/test_kernels.py``): 1e-5 for float32 (float32 sums in another
order), 2e-2 for bfloat16 outputs (one bf16 ulp at |y| < 2 is 2^-7 / 2^-6).
The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.rmsnorm import rmsnorm_ref as jax_rmsnorm_ref
from repro.models import layers as JL
from repro_torch.kernels import rmsnorm as D
from repro_torch.models import layers as TL

F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _inputs(shape, seed, scale_std=0.1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) * scale_std).astype(np.float32)
    return x, scale


@pytest.mark.parametrize("shape,block_rows", [
    ((4, 64, 256), 64),
    ((2, 128, 512), 256),
    ((16, 896), 8),
    ((3, 7, 384), 4),      # rows not a power of two
    ((997, 130), 1),       # ragged rows and width
])
def test_matches_pallas_kernel_and_oracle(shape, block_rows):
    x, scale = _inputs(shape, 0)
    want_kernel = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(scale),
                                         block_rows=block_rows))
    want_ref = np.asarray(jax_rmsnorm_ref(jnp.asarray(x), jnp.asarray(scale)))
    xt, st = torch.as_tensor(x), torch.as_tensor(scale)
    for got in (D.rmsnorm_ref(xt, st), D.rmsnorm(xt, st)):
        assert got.shape == shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want_kernel, **F32_TOL)
        np.testing.assert_allclose(got.numpy(), want_ref, **F32_TOL)


def test_bfloat16():
    x, _ = _inputs((64, 256), 1)
    scale = np.zeros(256, np.float32)
    want = np.asarray(jax_rmsnorm(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(scale)).astype(jnp.float32))
    got = D.rmsnorm(torch.as_tensor(x).bfloat16(), torch.as_tensor(scale))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_model_layer(dtype):
    x, scale = _inputs((8, 32, 128), 2)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(JL.rmsnorm({"scale": jnp.asarray(scale)}, jx,
                                 1e-6).astype(jnp.float32))
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    got = TL.rmsnorm({"scale": torch.as_tensor(scale)}, tx, 1e-6)
    assert got.dtype == tx.dtype
    tol = F32_TOL if dtype == "float32" else dict(atol=2e-2, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_cpu_tensors_take_the_plain_version_without_counting():
    x, scale = _inputs((5, 48), 3)
    xt, st = torch.as_tensor(x), torch.as_tensor(scale)
    before = D.rmsnorm_fused.launches
    assert torch.equal(D.rmsnorm_fused(xt, st), D.rmsnorm_ref(xt, st))
    assert D.rmsnorm_fused.launches == before


@pytest.mark.parametrize("x, scale, exc", [
    (torch.zeros(4, 8, dtype=torch.float16), torch.zeros(8), TypeError),
    (torch.zeros(4, 8), torch.zeros(7), ValueError),
    (torch.zeros(4, 8), torch.zeros(8, dtype=torch.float64), ValueError),
    (torch.zeros(8, 4).T, torch.zeros(8), ValueError),    # not contiguous
    (torch.zeros(2, 4, 8), torch.zeros(8), ValueError),   # not 2-D
    # meta tensors are shapes to count (an empty result, no launch), but
    # not beside a scale on a device
    (torch.zeros(4, 8, device="meta"), torch.zeros(8), ValueError),
], ids=["float16", "scale-width", "scale-dtype", "strided", "3-D", "meta"])
def test_wrapper_refuses_what_the_kernel_does_not_take(x, scale, exc):
    with pytest.raises(exc):
        D.rmsnorm_fused(x, scale)
