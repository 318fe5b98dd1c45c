"""The plain-Python plans of kernels D and E, and the arithmetic that
kernel E's bf16 route rests on.

Kernel E (``repro_torch.kernels.flash_attention.plan``): bf16 inputs take
the tensor-core route and float32 inputs the CUDA-core one; the shared
memory fits a block, two bf16 blocks fit an SM, and the grid covers every
row of the folded (Sq x g) query matrix.  The three-way bf16 split of a
float32 p (hi = bf16(p), mid = bf16(p - hi), lo = bf16(p - hi - mid)) is
checked in numpy: the pieces sum to p bit for bit, and p @ v through the
pieces, accumulated in float32, is within 1e-6 relative of the exact
product, where p rounded to one bf16 is not.

Kernel D (``repro_torch.kernels.rmsnorm.plan``): 16-byte vectors a warp a
row where d and every pointer allow it, several warps a row for rows too
wide for one warp's registers, the strided fallback otherwise.

The kernels themselves run only on the card (``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as E
from repro_torch.kernels import rmsnorm as D
from repro_torch.kernels.flash_attention import kernel as EK

# ---------------------------------------------------------------------------
# Kernel E's plan


@pytest.mark.parametrize("d", EK.HEAD_DIMS)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "simt")])
def test_flash_route_by_dtype_and_shared_memory_fits(d, dtype, route):
    p = E.plan(1, 8192, 8, 4, d, dtype)
    assert p.route == route
    assert 0 < p.smem_bytes <= EK.SMEM_PER_BLOCK
    assert p.blocks_per_sm >= 1
    if route == "mma":
        assert p.stages in (2, 3)
        assert p.keys == (32 if d == 256 else 64)
        # q, then stages x (K + V), rows padded by 16 bytes
        assert p.smem_bytes == 2 * (d + 8) * (64 + 2 * p.stages * p.keys)
    else:   # today's CUDA-core tiling, unchanged
        assert (p.keys, p.stages) == (32, 1)
        assert p.smem_bytes == 4 * (64 * d + 32 * (d + 4) + 32 * d)


@pytest.mark.parametrize("d", EK.HEAD_DIMS)
def test_flash_bf16_route_fits_two_blocks_an_sm(d):
    p = E.plan(1, 8192, 8, 4, d, torch.bfloat16)
    assert p.blocks_per_sm >= 2
    assert 2 * (p.smem_bytes + EK.SMEM_RESERVED) <= EK.SMEM_PER_SM
    if d == 256:    # q 33 KB + 2 stages x (K + V) 33 KB
        assert (p.keys, p.stages, p.smem_bytes) == (32, 2, 101_376)


@pytest.mark.parametrize("b,sq,h,kvh", [
    (1, 8192, 8, 4),      # gemma2-2b, g 2
    (1, 4096, 14, 2),     # qwen2, g 7
    (1, 1000, 6, 2),      # Sq g not a multiple of 64
    (2, 1, 8, 8),         # one query, MHA
    (3, 33, 4, 1),        # MQA, ragged
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_grid_covers_every_folded_row(b, sq, h, kvh, dtype):
    p = E.plan(b, sq, h, kvh, 128, dtype)
    rows = sq * (h // kvh)
    assert p.grid[1:] == (kvh, b)
    assert p.grid[0] * p.rows >= rows > (p.grid[0] - 1) * p.rows


@pytest.mark.parametrize("d,dtype,exc", [
    (96, torch.bfloat16, ValueError), (16, torch.float32, ValueError),
    (64, torch.float16, TypeError)])
def test_flash_plan_refuses_what_no_kernel_is_built_for(d, dtype, exc):
    with pytest.raises(exc):
        E.plan(1, 64, 4, 2, d, dtype)


# ---------------------------------------------------------------------------
# The three-way bf16 split of p (kernel E's exact p @ v on bf16 inputs)


def bf16_rn(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 (ties to even), held in float32."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32)


def split3(p: np.ndarray) -> tuple:
    """The kernel's split, step for step in float32."""
    p = np.asarray(p, np.float32)
    hi = bf16_rn(p)
    r = p - hi
    mid = bf16_rn(r)
    lo = bf16_rn(r - mid)
    return hi, mid, lo


def _probabilities() -> np.ndarray:
    rng = np.random.default_rng(0)
    powers = np.ldexp(np.float32(1.0), -np.arange(0, 127)).astype(np.float32)
    uniform = (1.0 - rng.random(100_000)).astype(np.float32)   # (0, 1]
    softmax = np.exp(-rng.exponential(8.0, 100_000)).astype(np.float32)
    return np.concatenate([[0.0, 1.0], powers, uniform, softmax]) \
        .astype(np.float32)


def test_bf16_rn_matches_torch_rounding():
    p = _probabilities()
    want = torch.as_tensor(p).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(bf16_rn(p), want)


def test_split3_sums_to_p_bit_for_bit():
    """Exact for 0, 1, every 2^-k and wherever lo's bits stay within
    bf16's range: p >= 2^-110 (p's float32 ulp >= 2^-133, bf16's least
    subnormal), which holds every uniform draw in (0, 1] and any p that
    moves a float32 sum whose largest term is 1 (softmax: the row max's
    p).  Below, the pieces miss p by less than 2^-133."""
    p = _probabilities()
    hi, mid, lo = split3(p)
    for piece in (hi, mid, lo):     # each piece is a bf16
        assert not (piece.view(np.uint32) & 0xFFFF).any()
    exact = hi.astype(np.float64) + mid.astype(np.float64) \
        + lo.astype(np.float64)
    normal = (p == 0) | (p >= 2.0 ** -110)
    normal[:129] = True             # 0, 1, 2^-k: bf16 already
    assert normal[129:100_129].all()
    np.testing.assert_array_equal(exact[normal],
                                  p[normal].astype(np.float64))
    np.testing.assert_array_equal((hi + (mid + lo))[normal].view(np.uint32),
                                  p[normal].view(np.uint32))
    assert (np.abs(exact - p.astype(np.float64)) < 2.0 ** -133).all()
    # 0, 1 and powers of two are bf16 already
    np.testing.assert_array_equal(hi[:129], p[:129])
    assert not mid[:129].any() and not lo[:129].any()


def test_split3_pv_is_the_f32_product():
    """p (16 rows x 64 keys, a softmax tile) @ v (bf16): the three pieces'
    products are exact in float32, so their float32 sum is within 1e-6
    relative of the exact product; p rounded to one bf16 is not."""
    rng = np.random.default_rng(1)
    s = rng.standard_normal((16, 64)).astype(np.float32) * 4.0
    p = np.exp(s - s.max(axis=1, keepdims=True)).astype(np.float32)
    v = bf16_rn(rng.standard_normal((64, 256)).astype(np.float32))
    exact = p.astype(np.float64) @ v.astype(np.float64)
    mag = np.abs(p).astype(np.float64) @ np.abs(v).astype(np.float64)
    hi, mid, lo = split3(p)
    acc = np.zeros((16, 256), np.float32)
    for piece in (hi, mid, lo):
        acc += piece @ v
    assert (np.abs(acc - exact) <= 1e-6 * mag).all()
    one = (hi @ v).astype(np.float64)
    assert (np.abs(one - exact) > 1e-4 * mag).any()


# ---------------------------------------------------------------------------
# Kernel D's plan


@pytest.mark.parametrize("d,itemsize,vectors", [
    (2304, 2, 9),       # gemma2-2b, bf16: 288 vectors over 32 lanes
    (1024, 4, 8),       # kernel_bench, float32
    (1024, 2, 4),
    (4096, 2, 16),      # the widest row one warp holds, bf16
    (2048, 4, 16),      # and float32
])
def test_rmsnorm_vector_route_a_warp_a_row(d, itemsize, vectors):
    p = D.plan(8192, d, itemsize, 0, 256, 4096)
    assert (p.route, p.vectors, p.warps_per_row) == ("vector", vectors, 1)
    assert (p.rows_per_block, p.grid) == (8, 1024)


@pytest.mark.parametrize("d,itemsize,vectors", [(7168, 2, 4), (4104, 2, 3),
                                                (2052, 4, 3)])
def test_rmsnorm_wide_rows_take_several_warps(d, itemsize, vectors):
    p = D.plan(8192, d, itemsize, 0, 0, 0)
    assert (p.route, p.vectors, p.warps_per_row) == ("vector", vectors, 8)
    assert (p.rows_per_block, p.grid) == (1, 8192)


@pytest.mark.parametrize("rows,d,itemsize,vectors", [
    (4, 2304, 2, 2),        # gemma2-2b decode, batch 4
    (1023, 2304, 2, 2),
    (64, 1024, 4, 1)])
def test_rmsnorm_few_rows_spread_a_row_over_a_block(rows, d, itemsize,
                                                    vectors):
    p = D.plan(rows, d, itemsize, 0, 0, 0)
    assert (p.route, p.vectors, p.warps_per_row) == ("vector", vectors, 8)
    assert (p.rows_per_block, p.grid) == (1, rows)
    assert D.plan(D.kernel.FEW_ROWS, d, itemsize, 0, 0, 0) \
        .warps_per_row == 1


@pytest.mark.parametrize("rows", [3, 8192])
def test_rmsnorm_vectors_cover_the_row_with_the_fewest_a_lane(rows):
    for d in range(8, 8 * 16 * 32 * 8 + 1, 8 * 37):
        p = D.plan(rows, d, 2, 0, 0, 0)
        lanes = 32 * p.warps_per_row
        assert p.vectors * lanes * 8 >= d > (p.vectors - 1) * lanes * 8
        assert 1 <= p.vectors <= D.kernel.MAX_VECTORS
        assert p.grid * p.rows_per_block >= rows
    assert D.plan(rows, 8 * 16 * 32 * 8 + 8, 2, 0, 0, 0).route == "strided"


@pytest.mark.parametrize("d,itemsize,ptrs", [
    (130, 4, (0, 0, 0)), (130, 2, (0, 0, 0)),     # ragged d
    (2304, 2, (2, 0, 0)),                          # x one element in
    (2304, 2, (0, 8, 0)),                          # scale on 8 bytes
    (2304, 2, (0, 0, 4)),
])
def test_rmsnorm_strided_fallback(d, itemsize, ptrs):
    p = D.plan(997, d, itemsize, *ptrs)
    assert (p.route, p.grid) == ("strided", 997)


def test_rmsnorm_misaligned_tensor_plans_the_fallback():
    buf = torch.zeros(4 * 2304 + 1, dtype=torch.bfloat16)
    x, scale = buf[1:].view(4, 2304), torch.zeros(2304)
    assert x.is_contiguous() and x.data_ptr() % 16
    p = D.plan(4, 2304, 2, x.data_ptr(), scale.data_ptr())
    assert p.route == "strided"
    # and the CPU wrapper still computes the function on it
    assert torch.equal(D.rmsnorm_fused(x, scale), D.rmsnorm_ref(x, scale))
