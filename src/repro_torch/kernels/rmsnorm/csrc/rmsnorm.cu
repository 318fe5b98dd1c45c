// RMSNorm for Hopper (sm_90a): each row of x (rows, d), f32 or bf16,
// becomes x * rsqrt(mean(x^2) + eps) * (1 + scale), f32 math, written in
// x's dtype; scale is f32 (d,).
//
// Replaces the reference's Pallas kernel
// repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel (called by
// rmsnorm_fused), whose function the reference's LM computes in every
// norm of every block (repro/models/layers.py::rmsnorm).  The Pallas grid
// walks blocks of rows through VMEM; here a warp owns a row.
//
// What bounds it on an H100: bytes.  Each element is read once and
// written once (a gemma2-2b prompt of 8192 tokens: 8192 x 2304 bf16 in
// and out, 75.5 MB, 22.5 us at 3.35 TB/s) against ~4 operations an
// element.  So the design keeps enough 16-byte loads in flight to cover
// HBM's latency and touches each byte once:
// - vec::rmsnorm_kernel, the rule: one warp a row, 8 warps (8 rows) a
//   block.  A lane loads its share of the row as 16-byte vectors (8 bf16
//   or 4 f32), V of them, all issued before the first is used, and keeps
//   them in registers (gemma2-2b's 2304: 9 vectors, 36 registers), so x
//   is read from memory once.  The sum of x^2 is a warp shuffle tree, with
//   no shared memory and no __syncthreads; scale is read as float4.  Rows
//   wider than 16 vectors a lane (d > 4096 bf16 or 2048 f32, arctic's
//   7168) take W = 8 warps a row, whose sums meet once in shared memory.
// - rmsnorm_kernel, the fallback for a d or a pointer that breaks 16-byte
//   alignment (the ragged d 130): one 256-thread block a row, strided
//   scalar loads, a shared-memory reduction, and a second pass that
//   rereads the row from L1/L2.
// kernel.py's plan picks the route, V and W in plain Python; the launcher
// refuses a plan it was not built for.
//
// Numerics: the reference's order, (x * r) * (1 + scale) with r =
// rsqrtf(sum / d + eps).  The sum runs in another order than the plain
// version's (per-lane partial sums, then a tree), and CUDA's rsqrtf is
// within 2 ulp of 1/sqrt, so f32 results are a few ulp from the plain
// version and bf16 results at most one bf16 ulp from it.
//
// Host interface: plain C, called through ctypes; the launcher returns
// cudaGetLastError() after the launch (or a negative code for arguments
// it refuses before launching).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

constexpr int ERR_RANGE = -2;     // argument outside the kernel's limits
constexpr int ERR_DTYPE = -3;     // dtype code not 0 (f32) or 1 (bf16)
constexpr int ERR_PLAN = -4;      // a plan the library was not built for

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, int d, float eps) {
  __shared__ float warp_sums[WARPS];
  __shared__ float inv_rms;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const T* row = x + base;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;

  float ss = 0.0f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float v = to_f32(row[i]);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float s = lane < WARPS ? warp_sums[lane] : 0.0f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) inv_rms = rsqrtf(s / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  T* orow = out + base;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float y = to_f32(row[i]) * r;
    put(orow + i, y * (1.0f + scale[i]));
  }
}

// ---------------------------------------------------------------------------
// The vector route: a warp (or W warps) a row, the row in registers.
namespace vec {

constexpr int MAX_V = 16;         // 16-byte vectors a lane, at most
constexpr int WIDE_W = 8;         // warps a row for the widest rows

// A 16-byte vector of x's dtype as f32 values and back.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static void unpack(const uint4& u, float (&f)[E]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[E]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void unpack(const uint4& u, float (&f)[E]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // low half: the lower element
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static unsigned pair(float a, float b) {
    return static_cast<unsigned>(
               __bfloat16_as_ushort(__float2bfloat16_rn(a))) |
           (static_cast<unsigned>(
                __bfloat16_as_ushort(__float2bfloat16_rn(b)))
            << 16);
  }
  __device__ static uint4 pack(const float (&f)[E]) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

// Row `row` is owned by W warps; lane `lane` of its warp `part` holds
// vectors (i W + part) 32 + lane, i < V, of the row's d / E.  With
// several warps a row (few rows, whose time is latency) and a small share
// of scale (V E <= 32 floats), scale is loaded beside x, before the
// reduction, so a call waits for one memory round trip and not two.
template <typename T, int V, int W>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ out, long long rows, int d, float eps) {
  constexpr int E = Vec<T>::E;
  constexpr int RPB = WARPS / W;    // rows a block
  constexpr bool EARLY = W > 1 && V * E <= 32;
  constexpr int NS = EARLY ? V * E / 4 : 1;
  __shared__ float part_sums[WARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int part = warp % W;
  const long long row = static_cast<long long>(blockIdx.x) * RPB + warp / W;
  if (row >= rows) return;          // a whole block's warps alike if W > 1
  const int nv = d / E;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const float4* sr = reinterpret_cast<const float4*>(scale);

  uint4 buf[V];
  float4 sbuf[NS];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = (i * W + part) * 32 + lane;
    if (vi < nv) buf[i] = __ldg(xr + vi);
  }
  if (EARLY) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int vi = (i * W + part) * 32 + lane;
#pragma unroll
      for (int c = 0; c < E / 4; ++c)
        if (vi < nv) sbuf[EARLY ? i * (E / 4) + c : 0] =
            __ldg(sr + vi * (E / 4) + c);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = (i * W + part) * 32 + lane;
    if (vi < nv) {
      float f[E];
      Vec<T>::unpack(buf[i], f);
#pragma unroll
      for (int e = 0; e < E; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (W > 1) {
    if (lane == 0) part_sums[warp] = ss;
    __syncthreads();
    ss = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) ss += part_sums[warp - part + w];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  uint4* orow = reinterpret_cast<uint4*>(out + row * d);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int vi = (i * W + part) * 32 + lane;
    if (vi < nv) {
      float f[E];
      Vec<T>::unpack(buf[i], f);
#pragma unroll
      for (int c = 0; c < E / 4; ++c) {
        const float4 s4 = EARLY ? sbuf[EARLY ? i * (E / 4) + c : 0]
                                : __ldg(sr + vi * (E / 4) + c);
        const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = f[4 * c + e] * r;
          f[4 * c + e] = y * (1.0f + sc[e]);
        }
      }
      orow[vi] = Vec<T>::pack(f);
    }
  }
}

template <typename T, int V, int W>
int launch(const void* x, const void* scale, void* out, long long rows,
           int d, float eps, unsigned grid, cudaStream_t s) {
  rmsnorm_kernel<T, V, W><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int W>
int launch_v(int v, const void* x, const void* scale, void* out,
             long long rows, int d, float eps, unsigned grid,
             cudaStream_t s) {
  switch (v) {
#define RMSNORM_V(n) \
  case n:            \
    return launch<T, n, W>(x, scale, out, rows, d, eps, grid, s);
    RMSNORM_V(1) RMSNORM_V(2) RMSNORM_V(3) RMSNORM_V(4)
    RMSNORM_V(5) RMSNORM_V(6) RMSNORM_V(7) RMSNORM_V(8)
    RMSNORM_V(9) RMSNORM_V(10) RMSNORM_V(11) RMSNORM_V(12)
    RMSNORM_V(13) RMSNORM_V(14) RMSNORM_V(15) RMSNORM_V(16)
#undef RMSNORM_V
    default:
      return ERR_PLAN;
  }
}

// Whether (v, w, grid) is the vector plan of kernel.py for these
// arguments: every vector of the row covered, the least V that does, and
// 16-byte aligned pointers.
template <typename T>
bool plan_ok(int v, int w, long long grid, const void* x, const void* scale,
             const void* out, long long rows, int d) {
  constexpr int E = Vec<T>::E;
  const unsigned long long a = reinterpret_cast<unsigned long long>(x) |
                               reinterpret_cast<unsigned long long>(scale) |
                               reinterpret_cast<unsigned long long>(out);
  const long long nv = d / E, lanes = 32LL * w;
  return (w == 1 || w == WIDE_W) && v >= 1 && v <= MAX_V && d % E == 0 &&
         a % 16 == 0 && static_cast<long long>(v) * lanes >= nv &&
         static_cast<long long>(v - 1) * lanes < nv &&
         grid == (rows + WARPS / w - 1) / (WARPS / w);
}

template <typename T>
int launch_vw(int v, int w, long long grid, const void* x,
              const void* scale, void* out, long long rows, int d, float eps,
              cudaStream_t s) {
  if (!plan_ok<T>(v, w, grid, x, scale, out, rows, d)) return ERR_PLAN;
  const unsigned g = static_cast<unsigned>(grid);
  return w == 1 ? launch_v<T, 1>(v, x, scale, out, rows, d, eps, g, s)
                : launch_v<T, WIDE_W>(v, x, scale, out, rows, d, eps, g, s);
}

}  // namespace vec

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out alike).  route 0: the
// strided kernel, a block a row (grid = rows); route 1: the vector
// kernel with `vectors` 16-byte vectors a lane and `warps_per_row` warps
// a row (kernel.py's plan).
int rmsnorm_launch(const void* x, const void* scale, void* out,
                   long long rows, int d, float eps, int dtype, int route,
                   int vectors, int warps_per_row, long long grid,
                   int device, void* stream) {
  if (rows <= 0 || d <= 0 || rows > 2147483647LL) return ERR_RANGE;
  if (dtype != 0 && dtype != 1) return ERR_DTYPE;
  if (route != 0 && route != 1) return ERR_PLAN;
  if (route == 0 && grid != rows) return ERR_PLAN;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1)
    return dtype == 0
               ? vec::launch_vw<float>(vectors, warps_per_row, grid, x,
                                       scale, out, rows, d, eps, s)
               : vec::launch_vw<__nv_bfloat16>(vectors, warps_per_row, grid,
                                               x, scale, out, rows, d, eps,
                                               s);
  const dim3 g(static_cast<unsigned>(rows));
  if (dtype == 0)
    rmsnorm_kernel<float><<<g, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), d, eps);
  else
    rmsnorm_kernel<__nv_bfloat16><<<g, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* rmsnorm_error_string(int code) {
  if (code == ERR_RANGE) return "argument outside the kernel's limits";
  if (code == ERR_DTYPE) return "dtype code must be 0 (f32) or 1 (bf16)";
  if (code == ERR_PLAN) return "the plan is not one this library was built "
                               "for";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
