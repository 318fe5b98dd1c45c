// RMSNorm for Hopper (sm_90a): each row of x (rows, d), f32 or bf16,
// becomes x * rsqrt(mean(x^2) + eps) * (1 + scale), f32 math, written in
// x's dtype; scale is f32 (d,).
//
// Replaces the reference's Pallas kernel
// repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel (called by
// rmsnorm_fused), whose function the reference's LM computes in every
// norm of every block (repro/models/layers.py::rmsnorm).  The Pallas grid
// walks blocks of rows through VMEM; here one block of 256 threads owns a
// row: the threads stride over it reading x in its dtype and summing x^2
// in f32 (a warp shuffle tree, then the eight warp sums through shared
// memory), one thread takes rsqrtf(sum / d + eps), and a second pass
// reads the row again (from L1/L2: gemma2-2b's 2304-wide bf16 row is
// 4.5 KB) and writes (x * r) * (1 + scale), the reference's order.  Any
// number of rows and any d work: the strided loops end at d.
//
// Numerics: the sum runs in another order than the plain version's
// (per-thread strided partial sums, then a tree), and CUDA's rsqrtf is
// within 2 ulp of 1/sqrt, so f32 results are a few ulp from the plain
// version and bf16 results at most one bf16 ulp from it.
//
// What bounds it on an H100: bytes.  Each element is read once and
// written once (a gemma2-2b prompt of 8192 tokens: 8192 x 2304 bf16 in
// and out, 75.5 MB, 22.5 us at 3.35 TB/s) against ~4 operations an
// element.  The second pass's reread is served by the caches; a block
// a row keeps the reduction inside the block with no second launch.
// Vector loads and several rows a block for narrow d are later work.
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and out alike).
int rmsnorm_launch(const void* x, const void* scale, void* out,
                   long long rows, int d, float eps, int dtype, int device,
                   void* stream) {
  if (rows <= 0 || d <= 0 || rows > 2147483647LL) return ERR_RANGE;
  if (dtype != 0 && dtype != 1) return ERR_DTYPE;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(static_cast<unsigned>(rows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rmsnorm_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(out), d, eps);
  else
    rmsnorm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), d, eps);
  return static_cast<int>(cudaGetLastError());
}

const char* rmsnorm_error_string(int code) {
  if (code == ERR_RANGE) return "argument outside the kernel's limits";
  if (code == ERR_DTYPE) return "dtype code must be 0 (f32) or 1 (bf16)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
