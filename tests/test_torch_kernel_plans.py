"""The plain-Python plans of kernels A, C, D and E, and the index maps
and arithmetic that the tensor-core kernels (C, E) rest on.

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

Kernel C (``repro_torch.kernels.rbe_matmul.plan``): the grid covers every
output tile, the shared memory fits a block and holds all of K at the
pipeline's shapes, 32 x 32 tiles where 64 x 64 ones would not fill the
card.  Its operand packing is emulated in numpy from the source: the
``__byte_perm`` calls of ``transpose4`` (read from ``csrc/rbe_matmul.cu``)
turn w's row-major 4 x 4 byte blocks into the words of the ``col``
B fragment, and a warp's tile through the ldmatrix A fragments, those B
fragments, the PTX ``m16n8k32`` layouts and the epilogue's column map is
x @ w exactly; w's shared-memory swizzle keeps 16-byte pieces whole and
a warp's reads on 32 banks.

Kernel A (``repro_torch.kernels.sweep_grid.kernel.chunk_plan``): one block
and one set of partials per 512-lane ``ChunkSpec.block``, every lane of
it served once by ``lanes`` x ``threads``, the stream's 256 blocks
resident at once, and its shared memory sized as the kernel lays it out.

Kernel B (``repro_torch.kernels.sweep_grid.kernel.eval_plan``): every
index served once by ``configs`` x ``threads`` x ``blocks``, the probe's
4,096 spread over the SMs in 32-thread blocks, the dense sizes at
``EVAL_CONFIGS`` indices a thread with every SM's blocks resident, and
the 32-bit decode below 2³¹ configurations.  Its multiply-high division
(``div_magic``, ``fast_div`` in the .cu) is emulated in numpy as the
kernel computes it and held against ``//`` and ``%`` on every stride and
size of the 10⁶, 10⁷ and 10⁸ grids and random ones.

The kernels themselves run only on the card (``chip_smoke.py``).
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.core import backend as B
from repro_torch.core import sweep as SW
from repro_torch.kernels import flash_attention as E
from repro_torch.kernels import rmsnorm as D
from repro_torch.kernels.flash_attention import kernel as EK
from repro_torch.kernels.rbe_matmul import kernel as RK
from repro_torch.kernels.sweep_grid import kernel as AK

# ---------------------------------------------------------------------------
# Kernel E's plan


def _dims_id(dims) -> str:
    """A head-dim pair's test id: the one dim where q·k and v agree."""
    return str(dims[0]) if dims[0] == dims[1] else f"{dims[0]}x{dims[1]}"


@pytest.mark.parametrize("dims", EK.HEAD_DIMS, ids=_dims_id)
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "mma"),
                                         (torch.float32, "simt")])
def test_flash_route_by_dtype_and_shared_memory_fits(dims, dtype, route):
    d, dv = dims
    p = E.plan(1, 8192, 8, 4, d, dtype, dv)
    assert p.route == route
    assert 0 < p.smem_bytes <= EK.SMEM_PER_BLOCK
    assert p.blocks_per_sm >= 1
    if route == "mma":
        assert p.stages in (2, 3)
        assert p.keys == (32 if d == 256 else 64)
        # q, then stages x (K + V), rows padded by 16 bytes
        assert p.smem_bytes == 2 * ((d + 8) * 64
                                    + p.stages * p.keys * (d + dv + 16))
    else:   # today's CUDA-core tiling, unchanged
        assert (p.keys, p.stages) == (32, 1)
        assert p.smem_bytes == 4 * (64 * d + 32 * (d + 4) + 32 * dv)


@pytest.mark.parametrize("dims", EK.HEAD_DIMS, ids=_dims_id)
def test_flash_bf16_route_fits_two_blocks_an_sm(dims):
    d, dv = dims
    p = E.plan(1, 8192, 8, 4, d, torch.bfloat16, dv)
    assert p.blocks_per_sm >= 2
    assert 2 * (p.smem_bytes + EK.SMEM_RESERVED) <= EK.SMEM_PER_SM
    if d == 256:    # q 33 KB + 2 stages x (K + V) 33 KB
        assert (p.keys, p.stages, p.smem_bytes) == (32, 2, 101_376)
    if (d, dv) == (192, 128):   # q 25.6 KB + 2 x (K 25.6 + V 17.4 KB)
        assert (p.keys, p.stages, p.smem_bytes) == (64, 2, 111_616)


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
    (64, torch.float16, TypeError), (192, torch.bfloat16, ValueError)])
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


# ---------------------------------------------------------------------------
# Kernel C's plan (repro_torch.kernels.rbe_matmul.plan)

#: (m, k, n): KeyNet's int8 layers at 4 and 256 ROIs, the saturated and
#: reference-test shapes, and ragged ones (chip_smoke.py's cases).
RBE_SHAPES = [(576, 128, 128), (144, 128, 256), (144, 256, 256),
              (36864, 128, 128), (9216, 128, 256), (9216, 256, 256),
              (333, 4096, 65), (256, 2048, 64), (256, 512, 384),
              (997, 130, 200), (1, 7, 3), (97, 130, 61), (5000, 200, 300),
              (144, 80, 256), (100, 520, 72), (37, 64, 30), (1, 256, 256),
              (3, 0, 5)]


@pytest.mark.parametrize("m,k,n", RBE_SHAPES)
def test_rbe_grid_covers_every_output_tile_and_smem_fits(m, k, n):
    p = RK.plan(m, k, n)
    assert (p.bm, p.bn, p.threads) == RK.TILES[p.tile][:3]
    assert p.grid[0] * p.bm >= m > (p.grid[0] - 1) * p.bm
    assert p.grid[1] * p.bn >= n > (p.grid[1] - 1) * p.bn
    # a warp takes 16 or 32 rows by 32 columns
    assert p.threads == 32 * (p.bm // (16 if p.tile == "small" else 32)) \
        * (p.bn // 32)
    # K in stages of kc bytes, a multiple of the mma depth (32); one stage
    # holds all of K up to 256 bytes
    assert p.kc % 32 == 0 and 32 <= p.kc <= RK.KC_MAX
    assert p.stages == (1 if k <= p.kc else RK.STAGES)
    assert p.kc >= min(k, RK.KC_MAX)
    assert p.smem_bytes == p.stages * (p.bm * (p.kc + 16) + p.kc * p.bn)
    assert 0 < p.smem_bytes <= RK.SMEM_PER_BLOCK


@pytest.mark.parametrize("rois,tiles,blocks", [
    (4, ("small",) * 3, (72, 40, 40)),
    (256, ("large",) * 3, (1152, 576, 576))])
def test_rbe_pipeline_shapes_fill_the_card_with_blocks(rois, tiles, blocks):
    shapes = [(rois * 144, 128, 128), (rois * 36, 128, 256),
              (rois * 36, 256, 256)]
    plans = [RK.plan(*s) for s in shapes]
    assert tuple(p.tile for p in plans) == tiles
    assert tuple(p.grid[0] * p.grid[1] for p in plans) == blocks
    # all of K in one copy at the pipeline's K
    assert all(p.stages == 1 for p in plans)


def test_rbe_plan_refuses_a_grid_too_wide():
    with pytest.raises(ValueError, match="column tiles"):
        RK.plan(1, 8, 65536 * 64)
    with pytest.raises(ValueError):
        RK.plan(0, 8, 8)


# ---------------------------------------------------------------------------
# Kernel C's operand packing, emulated in numpy from csrc/rbe_matmul.cu

RBE_CU = pathlib.Path(RK.__file__).resolve().parent / "csrc" / "rbe_matmul.cu"
_PERM = re.compile(r"(\w+(?:\[\d\])?) = __byte_perm\((\w+(?:\[\d\])?), "
                   r"(\w+(?:\[\d\])?), (0x[0-9a-fA-F]+)\)")


def byte_perm(x, y, s: int):
    """CUDA's __byte_perm on uint32 arrays: byte n of the result is byte
    (s >> 4n) & 7 of the eight bytes of x (0-3) and y (4-7)."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + \
        [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(s >> (4 * n)) & 7] << (8 * n) for n in range(4))


def transpose4(r: list) -> list:
    """transpose4 of the .cu, its __byte_perm calls read from the source
    and run in order."""
    src = RBE_CU.read_text()
    body = src[src.index("void transpose4("):]
    ops = _PERM.findall(body[:body.index("\n}\n")])
    assert len(ops) == 8
    env = {f"r[{i}]": r[i] for i in range(4)}
    for out, x, y, sel in ops:
        env[out] = byte_perm(env[x], env[y], int(sel, 16))
    return [env[f"s[{j}]"] for j in range(4)]


def words(b: np.ndarray) -> np.ndarray:
    """Little-endian uint32 words of the last axis' groups of 4 bytes."""
    b = b.astype(np.uint8).astype(np.uint64)
    return (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24)


def col_group(g):
    """The 4-column group of a warp's 32 whose w bytes thread g (lane //
    4) transposes (cg in the .cu): fragment column g of n8 tile j is real
    column 4 cg + j."""
    return (g >> 1) + 4 * (g & 1)


def test_transpose4_turns_rows_into_columns():
    rng = np.random.default_rng(0)
    blk = rng.integers(0, 256, (10_000, 4, 4))        # [sample, row, column]
    s = transpose4([words(blk[:, i, :]) for i in range(4)])
    for j in range(4):
        assert np.array_equal(s[j], words(blk[:, :, j]))


def b_fragments(w: np.ndarray) -> np.ndarray:
    """The kernel's B registers of a warp for one k32 step of a (32, 32)
    int8 w tile: [lane, K half h, n8 tile j], from four 32-bit reads of
    rows 16h + 4t + i at column 4 cg and transpose4."""
    out = np.zeros((32, 2, 4), np.uint64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        c0 = 4 * col_group(g)
        for h in range(2):
            r = [words(w[16 * h + 4 * t + i, c0:c0 + 4]) for i in range(4)]
            out[lane, h] = transpose4(r)
    return out


def test_b_operand_packing_gives_the_col_fragment():
    """mma.m16n8k32 .col B: register h of thread (g, t) holds rows 16h +
    4t .. 16h + 4t + 3 of fragment column g; with column g of tile j at
    real column 4 cg + j, the transposed words are those bytes of w."""
    w = np.random.default_rng(1).integers(-128, 128, (32, 32)).astype(np.int8)
    got = b_fragments(w)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for h in range(2):
            for j in range(4):
                k0 = 16 * h + 4 * t
                col = w[k0:k0 + 4, 4 * col_group(g) + j]
                assert got[lane, h, j] == words(col)


def a_fragments(x: np.ndarray) -> np.ndarray:
    """The kernel's ldmatrix.x4 A registers of a warp for a (16, 32) x
    tile: lane l gives the address of row l & 15, byte 16 (l >> 4), so
    matrix q is rows 8 (q & 1) .. + 7, bytes 16 (q >> 1) .. + 15, and lane
    l receives row l >> 2, bytes 4 (l & 3) .. + 3 of each."""
    addr = [((lane & 15), 16 * (lane >> 4)) for lane in range(32)]
    out = np.zeros((32, 4), np.uint64)
    for lane in range(32):
        for q in range(4):
            row, byte = addr[8 * q + (lane >> 2)]
            out[lane, q] = words(x[row, byte + 4 * (lane & 3):
                                   byte + 4 * (lane & 3) + 4])
    return out


def unpack(word) -> np.ndarray:
    return np.array([(int(word) >> (8 * i)) & 0xFF for i in range(4)],
                    np.uint8).view(np.int8).astype(np.int64)


def mma_s8(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 on a warp's fragments (a:
    [lane, 4], b: [lane, 2]) per the PTX ISA layouts; returns the
    accumulator fragments [lane, 4]."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for q in range(4):          # a_q: row g (+8 if q odd), k 4t (+16)
            A[g + 8 * (q & 1), 4 * t + 16 * (q >> 1):][:4] = unpack(a[lane, q])
        for h in range(2):          # b_h: column g, k 4t (+16)
            B[16 * h + 4 * t:16 * h + 4 * t + 4, g] = unpack(b[lane, h])
    D = A @ B
    out = np.zeros((32, 4), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for e in range(4):          # c_e: row g (+8 if e >= 2), col 2t + e % 2
            out[lane, e] = D[g + 8 * (e >> 1), 2 * t + (e & 1)]
    return out


def test_warp_tile_through_the_fragments_is_the_product():
    """A warp's 16 x 32 output tile over one k32 step, through the
    kernel's A and B fragments and its epilogue's map (accumulator e of
    the row pair h in tile j is row g + 8h, real column 4t + 16 (e % 2) +
    j): exactly x @ w."""
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (16, 32)).astype(np.int8)
    w = rng.integers(-127, 128, (32, 32)).astype(np.int8)
    a, b = a_fragments(x), b_fragments(w)
    acc = np.stack([mma_s8(a, b[:, :, j]) for j in range(4)], axis=1)
    out = np.full((16, 32), -1 << 40, np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for j in range(4):
            for h in range(2):
                for e in range(2):
                    out[g + 8 * h, 4 * t + 16 * e + j] = \
                        acc[lane, j, 2 * h + e]
    assert np.array_equal(out, x.astype(np.int64) @ w.astype(np.int64))


def w_off(r, o, bn: int):
    """The byte of (row r, byte o) in a stage's w tile (w_off in the
    .cu): the 32-byte blocks of each 128-byte line XOR-swizzled by bits
    2-3 of r."""
    return (r * bn + o) ^ (((r >> 2) & 3) << 5)


def test_w_swizzle_is_the_source_s():
    assert "return (r * BN + o) ^ (((r >> 2) & 3) << 5);" in RBE_CU.read_text()


@pytest.mark.parametrize("bn", [32, 64])
@pytest.mark.parametrize("kc", [32, 128, 160, 256])
def test_w_swizzle_keeps_pieces_whole_and_reads_conflict_free(bn, kc):
    r, o = np.meshgrid(np.arange(kc), np.arange(bn), indexing="ij")
    off = w_off(r, o, bn)
    # a bijection of the tile that keeps each 16-byte piece contiguous
    assert np.array_equal(np.sort(off.ravel()), np.arange(kc * bn))
    assert np.array_equal(off[:, 1:16] - off[:, :1],
                          np.broadcast_to(np.arange(1, 16), (kc, 15)))
    # a warp's 32-bit reads of one (k step, half, i) hit 32 distinct banks
    lanes = np.arange(32)
    g, t = lanes >> 2, lanes & 3
    for ks in range(kc // 32):
        for h in range(2):
            for i in range(4):
                for wc in range(0, bn, 32):
                    banks = w_off(32 * ks + 16 * h + 4 * t + i,
                                  wc + 4 * col_group(g), bn) // 4 % 32
                    assert len(set(banks.tolist())) == 32


@pytest.mark.parametrize("kc", range(32, 257, 32))
def test_x_rows_padded_by_16_bytes_read_conflict_free(kc):
    # an ldmatrix phase reads 8 rows of 16 bytes: 8 distinct bank groups
    for byte in (0, 16):
        groups = (np.arange(8) * (kc + 16) + byte) // 16 % 8
        assert len(set(groups.tolist())) == 8


# ---------------------------------------------------------------------------
# Kernel A's plan (repro_torch.kernels.sweep_grid.kernel.chunk_plan)


def chunk_spec(chunk: int, d: int = 3, nf: int = 3, rows: int = 24,
               bins: int = 256):
    fields = SW.FIELDS[:nf]
    return B.ChunkSpec(S=None, shape=(100_096_000,), n_total=100_096_000,
                       chunk=chunk, fields=fields, d=d, k=4,
                       sign=(1.0,) * d, cons_static=(), hist_bins=0,
                       survivor_cap=chunk, small_index=True,
                       filter_rows=rows, filter_bins=bins)


@pytest.mark.parametrize("chunk", [131072, 4096, 997, 512, 100, 10, 1])
def test_chunk_plan_serves_every_lane_of_each_512_lane_block_once(chunk):
    spec = chunk_spec(chunk)
    p = AK.chunk_plan(spec)
    # one block, and one set of partials, per ChunkSpec.block lanes
    assert spec.block == min(512, chunk) and p.blocks == spec.n_blocks
    assert p.lanes == AK.CHUNK_LANES
    assert p.threads % 32 == 0 and p.threads <= 512 // p.lanes
    served = [t + j * p.threads for t in range(p.threads)
              for j in range(p.lanes) if t + j * p.threads < spec.block]
    assert sorted(served) == list(range(spec.block))
    # the fewest whole warps that do
    assert (p.threads - 32) * p.lanes < spec.block <= p.threads * p.lanes


def test_chunk_plan_keeps_the_stream_chunk_resident_in_one_wave():
    p = AK.chunk_plan(chunk_spec(131072))
    assert (p.threads, p.blocks) == (256, 256)
    # the register cap of __launch_bounds__(256, 2): 128 a thread, so two
    # blocks an SM and all 256 blocks on 132 SMs at once
    assert p.registers == 128 and p.blocks_per_sm >= AK.CHUNK_MIN_BLOCKS
    assert p.blocks_per_sm * 132 >= p.blocks


@pytest.mark.parametrize("d,nf,rows,bins", [
    (3, 3, 24, 256), (1, 2, 24, 256), (3, 4, 24, 256), (11, 11, 64, 256),
    (2, 2, 0, 16)])
def test_chunk_plan_shared_memory_holds_the_filter_and_lane_values(
        d, nf, rows, bins):
    p = AK.chunk_plan(chunk_spec(131072, d, nf, rows, bins))
    warps = p.threads // 32
    edges = (d - 1) * (bins + 1) if 2 <= d <= 3 else 0
    assert p.smem_bytes == (8 * (rows * d + edges + nf * 512
                                 + 3 * (nf + d) * warps)
                            + 4 * (nf + d) * warps)
    assert p.smem_bytes <= AK.SMEM_PER_BLOCK
    assert p.blocks_per_sm >= 1


# ---------------------------------------------------------------------------
# Kernel B's plan and its fast division


#: Kernel B's staged bytes at the stream grids: the 447-double table
#: buffer and the axis values (144 at 10^6).
STAGE_1M = 8 * (447 + 144)


@pytest.mark.parametrize("n,n_total,threads,configs,bits,blocks", [
    (1, None, 32, 1, 32, 1),
    (4096, 100_096_000, 32, 1, 32, 128),     # the stream's probe
    (10_880, None, 64, 1, 32, 170),          # the reference grid
    (1_000_960, None, 128, 2, 32, 396),      # the dense engine's 10^6 grid
    (100_096_000, None, 128, 2, 32, 396),
    (2**31 + 5, None, 128, 2, 64, 396),
])
def test_eval_plan_at_both_sizes(n, n_total, threads, configs, bits, blocks):
    p = AK.eval_plan(n, 11, n_total, STAGE_1M)
    assert (p.threads, p.configs, p.index_bits) == (threads, configs, bits)
    assert p.blocks == blocks
    assert p.threads % 32 == 0 and p.threads <= AK.EVAL_THREADS
    assert p.registers == AK.eval_registers()
    tiles = -(-n // (threads * configs))
    if configs == 1:
        # a block a tile, tables read where they lie, no idle block
        assert p.smem_bytes == 0 and p.blocks == tiles
    else:
        # the tables staged once by each of the blocks the SMs hold
        assert p.smem_bytes == STAGE_1M
        assert p.blocks == min(tiles, AK.SMS * AK.EVAL_MIN_BLOCKS)


def test_eval_plan_spreads_the_probe_and_fills_the_card_at_dense_size():
    probe = AK.eval_plan(4096, 11, 100_096_000, STAGE_1M)
    assert probe.blocks >= AK.SMS // 2 and probe.blocks * 32 >= 4096
    dense = AK.eval_plan(1_000_960, 11, None, STAGE_1M)
    assert dense.blocks == AK.SMS * AK.EVAL_MIN_BLOCKS
    # the register cap and the staged tables leave EVAL_MIN_BLOCKS blocks
    # an SM
    per_warp = -(-dense.registers * 32 // 256) * 256
    assert AK.SM_REGISTERS // (per_warp * dense.threads // 32) \
        >= AK.EVAL_MIN_BLOCKS
    assert AK.EVAL_MIN_BLOCKS * (dense.smem_bytes + AK.SMEM_RESERVED) \
        <= AK.SMEM_PER_SM


def test_eval_plan_reads_tables_too_big_to_stage_in_place():
    big = AK.EVAL_STAGE_MAX + 8
    p = AK.eval_plan(1_000_960, 11, None, big)
    assert p.smem_bytes == 0 and p.blocks == -(-1_000_960 // (128 * 2))
    assert AK.eval_plan(1_000_960, 11).smem_bytes == 0


@pytest.mark.parametrize("n,nf,n_total", [(0, 11, None), (5, 0, None),
                                          (5, 12, None), (5, 11, 0)])
def test_eval_plan_refuses_empty_or_unknown_work(n, nf, n_total):
    with pytest.raises(ValueError, match="no plan"):
        AK.eval_plan(n, nf, n_total)


def _fast_divmod(n, d: int, bits: int):
    """(q, r) of n by d as the kernel computes them: q = d == 1 ? n :
    umulhi(n, mul) >> shr (the high half of the 2·bits-bit product), r =
    n - q·d."""
    mul, shr = AK.div_magic(d, bits)
    if bits == 32:
        n = np.asarray(n, np.uint64)
        q = n if mul == 0 else (n * np.uint64(mul)) >> np.uint64(32 + shr)
        return q, n - q * np.uint64(d)
    q = [x if mul == 0 else (x * mul) >> (64 + shr) for x in map(int, n)]
    return q, [x - y * d for x, y in zip(map(int, n), q)]


def _grid_divisors():
    from repro_torch.core.grids import stream_grid_axes
    out = set()
    for n in (10**6, 10**7, 10**8):
        _, ax, _ = SW.build_axes(**stream_grid_axes(n))
        shape = [a.size for a in ax]
        out |= set(shape)
        out |= {int(np.prod(shape[i + 1:])) for i in range(len(shape))}
        out.add(int(np.prod(shape)))
    return sorted(out)


GRID_DIVISORS = _grid_divisors()


def test_grid_divisors_cover_the_stream_grids():
    assert {1, 2, 34, 92, 1_000_960, 100_096_000, 2_944_000} \
        <= set(GRID_DIVISORS)


@pytest.mark.parametrize("bits", [32, 64])
def test_fast_division_is_exact_on_the_grids_and_random_divisors(bits):
    """Every stride and size of the 10^6/10^7/10^8 grids and random
    divisors, at 0, 1, d - 1, d, n - 1 and 2^31 - 1 (2^63 - 1 in 64
    bits) and random indices below 2^(bits - 1)."""
    rng = np.random.default_rng(7)
    top = 2**(bits - 1) - 1
    divisors = GRID_DIVISORS + [int(x) for x in rng.integers(1, 2**31, 40)]
    divisors += [2**k for k in range(31)] + [2**k + 1 for k in range(1, 31)]
    if bits == 64:
        divisors += [int(x) for x in rng.integers(2**31, 2**62, 20)]
    for d in divisors:
        idx = [0, 1, d - 1, d, min(d + 1, top), top, top - 1, 2**31 - 1]
        idx += [int(x) for x in rng.integers(0, top, 200, dtype=np.int64)]
        q, r = _fast_divmod(idx, d, bits)
        assert [int(x) for x in q] == [x // d for x in idx], d
        assert [int(x) for x in r] == [x % d for x in idx], d


@pytest.mark.parametrize("n_total", [1_000_960, 10_009_600, 100_096_000])
def test_fast_decode_is_the_grid_coordinates(n_total):
    """The kernel's decode, (flat / stride) % size on each axis by two
    fast divisions, equals numpy's unravel_index at 0, n - 1 and random
    flat indices of the grid."""
    from repro_torch.core.grids import stream_grid_axes
    _, ax, _ = SW.build_axes(**stream_grid_axes(n_total))
    shape = tuple(a.size for a in ax)
    assert int(np.prod(shape)) == n_total
    rng = np.random.default_rng(n_total % 97)
    flat = np.concatenate([[0, n_total - 1],
                           rng.integers(0, n_total, 5000)]).astype(np.uint64)
    want = np.unravel_index(flat.astype(np.int64), shape)
    for x, size in enumerate(shape):
        stride = int(np.prod(shape[x + 1:]))
        q, _ = _fast_divmod(flat, stride, 32)
        _, c = _fast_divmod(q, size, 32)
        assert np.array_equal(c.astype(np.int64), want[x]), x


@pytest.mark.parametrize("d,bits", [(1, 32), (2, 32), (3, 32), (92, 32),
                                    (2**31 - 1, 32), (1, 64), (3, 64),
                                    (2**62 + 1, 64)])
def test_div_magic_multipliers_fit_their_width(d, bits):
    mul, shr = AK.div_magic(d, bits)
    assert 0 <= mul < 2**bits and 0 <= shr < bits
    assert (mul == 0) == (d == 1)


@pytest.mark.parametrize("bits", [32, 64])
def test_decode_args_are_the_launchers_int64s(bits):
    """Strides then sizes, (mul, shr) each; a 64-bit multiplier at or
    above 2^63 reaches the launcher's int64 array as its bits."""
    shape = (1, 34, 2, 2, 2, 5, 2, 2, 2, 92)
    args = AK.decode_args(shape, bits)
    a = np.asarray(args, np.int64)
    strides = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    for i, d in enumerate(strides + list(shape)):
        mul, shr = AK.div_magic(d, bits)
        assert int(a[2 * i:2 * i + 1].view(np.uint64)[0]) == mul
        assert a[2 * i + 1] == shr
    assert (a < 0).any() == (bits == 64)
