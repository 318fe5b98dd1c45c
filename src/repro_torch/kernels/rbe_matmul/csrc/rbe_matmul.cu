// RBE int8 matmul for Hopper (sm_90a): (M,K) int8 @ (K,N) int8 -> exact
// int32 sums -> f32 out[m][n] = (float)acc * sx[m] * sw[n].
//
// Replaces the reference's Pallas kernel
// repro/kernels/rbe_matmul/kernel.py::_rbe_matmul_kernel (called by
// rbe_matmul_raw): what it computes, not how it tiles.  The Pallas grid
// (M/bm, N/bn) with whole-K blocks and sizes shrunk to divide M, N and K
// is a TPU shape; here each block of 256 threads owns a 64 x 64 output
// tile and walks K in steps of 32 bytes.  A step loads the x tile
// (64 rows x 32 bytes) and the w tile (32 x 64), packs four int8 values
// along K into each 32-bit word and keeps w's tile transposed in shared
// memory (one row of words per output column), so both operands of
// __dp4a are words of one shared row.  Each thread holds a 4 x 4 block of
// int32 accumulators in registers.  The kernel masks ragged M, N and K
// itself (bytes past an edge load as 0), so every shape works.  The sums
// are exact (|acc| <= 127^2 K < 2^31 for K <= 133,144, which the wrapper
// checks) and the epilogue is the reference's two f32 multiplies in its
// order, so the result equals the plain version bit for bit.
//
// What bounds it on an H100: bytes.  The pipeline's shapes (KeyNet's
// b4.pw, b5.pw and b6.pw at 4 ROIs: M = 576/144/144, K = 128/128/256,
// N = 128/256/256) move 0.2-0.4 MB each, 0.06-0.12 us at 3.35 TB/s, and
// need 2MNK int8 operations, 0.01-0.02 us at 1,979e12/s.  All three sit
// far below a launch's few microseconds, and the kernel runs far above
// them: 12-18 blocks on 132 SMs each walk 4-8 K steps, every step a
// chain of global loads and two barriers, so at these shapes its time is
// that latency chain plus the launch.  The design does nothing about it
// yet; more blocks (split K, smaller tiles), wider loads, tensor-core
// tiles (mma.sync s8, wgmma) and TMA are for later work.
//
// Host interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() after the launch (or a negative code for arguments
// it refuses before launching).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 64;            // output rows of a block
constexpr int BN = 64;            // output columns of a block
constexpr int BK = 32;            // bytes of K a step
constexpr int KW = BK / 4;        // packed words of K a step
constexpr int TY = 16, TX = 16;   // threads: 16 x 16
constexpr int THREADS = TY * TX;
constexpr int RM = BM / TY;       // accumulator rows a thread
constexpr int RN = BN / TX;       // accumulator columns a thread

constexpr int ERR_RANGE = -2;     // argument outside the kernel's limits

// Four int8 values p[0], p[s], p[2s], p[3s] packed little-endian into
// one word; the ones at or past `valid` are 0.
__device__ __forceinline__ int pack4(const int8_t* p, long long s,
                                     int valid) {
  unsigned w = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (b < valid)
      w |= static_cast<unsigned>(static_cast<uint8_t>(p[b * s])) << (8 * b);
  return static_cast<int>(w);
}

__global__ void __launch_bounds__(THREADS)
rbe_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ sx, const float* __restrict__ sw,
                  float* __restrict__ out, int M, int K, int N) {
  // +1 word a row: the 16 columns a warp reads fall in 16 banks.
  __shared__ int xs[BM][KW + 1];
  __shared__ int ws[BN][KW + 1];
  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: word (r, c) = x[m0 + r][k0 + 4c .. 4c + 3]; neighbouring
    // threads read neighbouring bytes of a row.
    for (int i = tid; i < BM * KW; i += THREADS) {
      const int r = i / KW, c = i % KW;
      const int m = m0 + r, k = k0 + 4 * c;
      xs[r][c] = (m < M && k < K)
                     ? pack4(x + static_cast<long long>(m) * K + k, 1, K - k)
                     : 0;
    }
    // w tile, transposed: word (col, c) = w[k0 + 4c .. 4c + 3][n0 + col];
    // neighbouring threads read neighbouring columns.
    for (int i = tid; i < BN * KW; i += THREADS) {
      const int c = i / BN, col = i % BN;
      const int n = n0 + col, k = k0 + 4 * c;
      ws[col][c] = (n < N && k < K)
                       ? pack4(w + static_cast<long long>(k) * N + n, N, K - k)
                       : 0;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < KW; ++c) {
      int a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = xs[ty + TY * i][c];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = ws[tx + TX * j][c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: (f32(acc) * sx[m]) * sw[n], the reference's order.
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= M) continue;
    const float s = sx[m];
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx + TX * j;
      if (n < N)
        out[static_cast<long long>(m) * N + n] =
            static_cast<float>(acc[i][j]) * s * sw[n];
    }
  }
}

}  // namespace

extern "C" {

int rbe_matmul_launch(const void* x, const void* w, const void* sx,
                      const void* sw, void* out, int M, int K, int N,
                      int device, void* stream) {
  if (M <= 0 || N <= 0 || K < 0) return ERR_RANGE;
  const long long grid_y = (static_cast<long long>(M) + BM - 1) / BM;
  if (grid_y > 65535) return ERR_RANGE;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((N + BN - 1) / BN, static_cast<unsigned>(grid_y));
  rbe_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

const char* rbe_matmul_error_string(int code) {
  if (code == ERR_RANGE) return "argument outside the kernel's limits";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
