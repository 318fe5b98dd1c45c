// RBE int8 matmul for Hopper (sm_90a): (M,K) int8 @ (K,N) int8 -> exact
// int32 sums -> f32 out[m][n] = (float)acc * sx[m] * sw[n].
//
// Replaces the reference's Pallas kernel
// repro/kernels/rbe_matmul/kernel.py::_rbe_matmul_kernel (called by
// rbe_matmul_raw): what it computes, not how it tiles.
//
// What bounds it on an H100: bytes, and below them latency.  The
// pipeline's shapes (KeyNet's b4.pw, b5.pw and b6.pw at 4 ROIs: M =
// 576/144/144, K = 128/128/256, N = 128/256/256) move 0.2-0.4 MB each,
// 0.06-0.12 us at 3.35 TB/s, and need 2MNK int8 operations, 0.01-0.02 us
// on the int8 tensor cores (1,979e12/s): far below a launch, so a call's
// time is the launch plus one block's chain of loads, products and
// stores.  At 256 ROIs (M = 36,864 for b4.pw) the f32 output dominates
// the bytes and the bound is a few microseconds.
//
// The design, for that:
// - Tensor cores: mma.sync m16n8k32 s8 x s8 -> s32 (no .satfinite).  The
//   int32 sums are exact (|acc| <= 128^2 K < 2^31 for K <= 131,071, which
//   the wrapper checks), so any tiling or summation order gives the same
//   bits; the epilogue runs once on the whole sum, the reference's two f32
//   multiplies in its order, so the result equals the plain version bit
//   for bit.
// - One copy: a stage holds KC (<= 256) bytes of K for the block's x rows
//   and w columns, brought in by 16-byte cp.async copies and one barrier;
//   the pipeline's K fits one stage.  Larger K runs a two-stage ring.
//   Rows that do not start on 16 bytes (K or N not a multiple of 16) and
//   the ragged edges load byte by byte, zero past the edge, so bytes past
//   M, N or K count as 0.
// - x, the A operand, is row-major with K contiguous, as the `row` A
//   fragment wants it: ldmatrix.x4 from rows padded by 16 bytes (no bank
//   conflicts).  w, the B operand, is (K, N) with N contiguous, but the
//   `col` fragment wants four K bytes of one column a register: a thread
//   reads a 4 x 4 byte block (four K rows, four columns) as four 32-bit
//   words and transposes it with eight __byte_perm (selectors 0x5140,
//   0x7362, then 0x5410, 0x7632).  The four words it gets are one column
//   each, and serve as the same fragment column g of four n8 tiles: real
//   column 4 cg + j of a warp's 32 is column g of tile j, where cg =
//   g / 2 + 4 (g % 2).  The w rows sit in shared memory with their
//   32-byte blocks XOR-swizzled by bits 2-3 of the row, so the warp's
//   four-row reads hit 32 distinct banks.  In the accumulators thread
//   (g, t) then holds columns 4t .. 4t + 3 and 16 + 4t .. 16 + 4t + 3 of
//   its rows, so a warp's float4 stores cover 64 contiguous bytes a row.
// - More blocks: a 32 x 32 tile (2 warps, 16 x 32 each) while the grid
//   of 64 x 64 tiles would not fill the 132 SMs, so the pipeline's shapes
//   launch 72, 40 and 40 blocks (18, 12 and 12 before); 64 x 64 (4 warps,
//   32 x 32 each) at large M.  kernel.py::plan picks the tile, the stage
//   depth and the shared memory; the launcher refuses any other plan.
// ptxas (CUDA 12, sm_90a): 48 registers (32 x 32 tile) and 64 (64 x 64),
// no spills.
//
// Host interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() after the launch (or a negative code for arguments
// or a plan it refuses before launching).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KC_MAX = 256;       // bytes of K a stage at most
constexpr int STAGES = 2;         // ring depth when K takes several stages
constexpr int SMEM_STATIC_MAX = 48 * 1024;

constexpr int ERR_RANGE = -2;     // argument outside the kernel's limits
constexpr int ERR_PLAN = -3;      // a plan this build does not run

// A block tile: WM x WN warps, each 16 MT rows x 32 columns.
template <int MT_, int WM_, int WN_>
struct Tile {
  static constexpr int MT = MT_, WM = WM_, WN = WN_;
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 32 * WN;
  static constexpr int THREADS = 32 * WM * WN;
};
using Small = Tile<1, 2, 1>;      // 32 x 32, 64 threads
using Large = Tile<2, 2, 2>;      // 64 x 64, 128 threads
constexpr int TILE_SMALL = 0, TILE_LARGE = 1;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 16 bytes at dst: src[0 .. valid) then zeros (byte loads, any alignment).
__device__ __forceinline__ void copy_edge(unsigned char* dst,
                                          const int8_t* src, int valid) {
  unsigned w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < valid)
      w[b >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(src[b]))
                   << (8 * (b & 3));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void zero16(unsigned char* dst) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
}

// Byte offset of (row r, byte o) in a stage's w tile of BN-byte rows: the
// 32-byte blocks of each 128-byte line are XOR-swizzled by bits 2-3 of r.
template <int BN>
__device__ __forceinline__ int w_off(int r, int o) {
  return (r * BN + o) ^ (((r >> 2) & 3) << 5);
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 in, exact int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Transpose the 4 x 4 byte block r[i] = row i, byte j = column j into
// s[j] = column j, byte i = row i.
__device__ __forceinline__ void transpose4(const unsigned (&r)[4],
                                           unsigned (&s)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned t1 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t2 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  s[0] = __byte_perm(t0, t2, 0x5410);
  s[1] = __byte_perm(t0, t2, 0x7632);
  s[2] = __byte_perm(t1, t3, 0x5410);
  s[3] = __byte_perm(t1, t3, 0x7632);
}

template <int MT, int WM, int WN>
__global__ void __launch_bounds__(Tile<MT, WM, WN>::THREADS)
rbe_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  float* __restrict__ out, int M, int K, int N, int kc) {
  using L = Tile<MT, WM, WN>;
  constexpr int BM = L::BM, BN = L::BN, THREADS = L::THREADS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int xs_stride = kc + 16;
  const int x_bytes = BM * xs_stride;
  const int stage_bytes = x_bytes + kc * BN;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // The 4-column group of the warp's 32 whose w bytes thread g transposes:
  // fragment column g of tile j is real column 4 cg + j.
  const int cg = (g >> 1) + 4 * (g & 1);
  const int wr = (warp % WM) * 16 * MT;   // warp's first row in the tile
  const int wc = (warp / WM) * 32;        // and first column
  const bool x_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;

  auto load = [&](int c, int s) {
    const int k0 = c * kc;
    unsigned char* xs = smem + s * stage_bytes;
    unsigned char* ws = xs + x_bytes;
    const int xp = kc / 16;
    for (int i = tid; i < BM * xp; i += THREADS) {
      const int r = i / xp, p = i % xp;
      const int m = m0 + r, k = k0 + 16 * p;
      unsigned char* dst = xs + r * xs_stride + 16 * p;
      const int8_t* src = x + static_cast<long long>(m) * K + k;
      if (m < M && k + 16 <= K && x_vec) cp_async16(dst, src);
      else if (m < M && k < K) copy_edge(dst, src, K - k);
      else zero16(dst);
    }
    constexpr int wp = BN / 16;
    for (int i = tid; i < kc * wp; i += THREADS) {
      const int r = i / wp, p = i % wp;
      const int k = k0 + r, n = n0 + 16 * p;
      unsigned char* dst = ws + w_off<BN>(r, 16 * p);
      const int8_t* src = w + static_cast<long long>(k) * N + n;
      if (k < K && n + 16 <= N && w_vec) cp_async16(dst, src);
      else if (k < K && n < N) copy_edge(dst, src, N - n);
      else zero16(dst);
    }
  };

  int acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int chunks = (K + kc - 1) / kc;
  if (chunks > 0) load(0, 0);
  cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) load(c + 1, (c + 1) % STAGES);
    cp_async_commit();
    cp_async_wait1();              // chunk c's copies, this thread's
    __syncthreads();               // and everyone's
    const unsigned char* xs = smem + (c % STAGES) * stage_bytes;
    const unsigned char* ws = xs + x_bytes;
    const int steps = (min(kc, K - c * kc) + 31) / 32;
    for (int ks = 0; ks < steps; ++ks) {
      unsigned a[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a[i], smem_u32(xs + (wr + 16 * i + (lane & 15)) * xs_stride +
                               32 * ks + 16 * (lane >> 4)));
      unsigned b[2][4];            // [K half][n8 tile]
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r[i] = *reinterpret_cast<const unsigned*>(
              ws + w_off<BN>(32 * ks + 16 * h + 4 * t + i, wc + 4 * cg));
        transpose4(r, b[h]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[0][j], b[1][j]);
    }
    if (c + 1 < chunks) __syncthreads();   // before the stage is refilled
  }

  // Epilogue: (f32(acc) * sx[m]) * sw[n], the reference's order.  Thread
  // (g, t) holds rows g and g + 8 of each 16-row tile; accumulator e of
  // its pair in tile j is fragment column 2t + e, real column 4t + 16e + j
  // of the warp's 32 (cg of 2t and 2t + 1 is t and t + 4), so a warp's
  // float4 stores cover 64 contiguous bytes of each row.
  const int nb = n0 + wc + 4 * t;
  const bool o_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  float swv[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = nb + 16 * e + j;
      swv[e][j] = n < N ? sw[n] : 0.0f;
    }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wr + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const float s = sx[m];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = static_cast<float>(acc[i][j][2 * h + e]) * s * swv[e][j];
        const int n = nb + 16 * e;
        float* o = out + static_cast<long long>(m) * N + n;
        if (o_vec && n + 4 <= N) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) o[j] = v[j];
        }
      }
    }
}

template <class L>
constexpr long long stage_bytes(int kc) {
  return static_cast<long long>(L::BM) * (kc + 16) +
         static_cast<long long>(kc) * L::BN;
}

template <class L>
int launch(const void* x, const void* w, const void* sx, const void* sw,
           void* out, int M, int K, int N, int kc, long long smem,
           long long gx, long long gy, cudaStream_t stream) {
  const int chunks = (K + kc - 1) / kc;
  const long long stages = chunks > 1 ? STAGES : 1;
  if (gx != (M + L::BM - 1) / L::BM || gy != (N + L::BN - 1) / L::BN ||
      gx > 0x7fffffffLL || gy > 65535 || smem != stages * stage_bytes<L>(kc))
    return ERR_PLAN;
  auto* kern = rbe_matmul_kernel<L::MT, L::WM, L::WN>;
  if (smem > SMEM_STATIC_MAX) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
         L::THREADS, static_cast<size_t>(smem), stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<float*>(out), M, K, N, kc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The plan (kernel.py::plan): tile, bytes of K a stage, dynamic shared
// memory, grid (M tiles, N tiles).
int rbe_matmul_launch(const void* x, const void* w, const void* sx,
                      const void* sw, void* out, int M, int K, int N,
                      int tile, int kc, long long smem, long long grid_x,
                      long long grid_y, int device, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return ERR_RANGE;
  int want_kc = (K + 31) / 32 * 32;   // K in 32-byte mma steps, 32..KC_MAX
  if (want_kc < 32) want_kc = 32;
  if (want_kc > KC_MAX) want_kc = KC_MAX;
  if (kc != want_kc) return ERR_PLAN;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile == TILE_SMALL)
    return launch<Small>(x, w, sx, sw, out, M, K, N, kc, smem, grid_x,
                         grid_y, s);
  if (tile == TILE_LARGE)
    return launch<Large>(x, w, sx, sw, out, M, K, N, kc, smem, grid_x,
                         grid_y, s);
  return ERR_PLAN;
}

const char* rbe_matmul_error_string(int code) {
  if (code == ERR_RANGE) return "argument outside the kernel's limits";
  if (code == ERR_PLAN) return "a launch plan this build does not run";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
