// Sweep-grid kernels for Hopper (sm_90a), float64.
//
// Kernel A (chunk_kernel) replaces the reference's fused Pallas chunk
// kernel, repro/kernels/sweep_grid/kernel.py::build_chunk_call: one
// thread block per 512-lane block of a chunk, one lane per thread.  Each
// lane decodes its flat index, evaluates Eq. 1-11 (eval_config), applies
// the constraint predicates and the Pareto dominance pre-filter and writes
// its lane outputs; shared-memory tree reductions then write the block's
// min, first-min flat index, valid count, max and signed min.  No atomics
// and no state across blocks: the partials are deterministic and keep the
// layout of repro_torch.core.backend.chunk_partials, which folds them.
//
// Kernel B (eval_kernel) replaces the evaluate-only Pallas variant,
// kernel.py::_flat_call / sweep_grid_eval: one thread per flat index,
// writing the requested channels as an (n_fields, n) matrix.
//
// What bounds them on an H100: per configuration ~270 float64
// instructions of Eq. 1-11, ten IEEE divide sequences included (kernel A
// adds ~180 for the dominance filter and the reductions at d = 3),
// against the lane outputs written (kernel A: Fd, Fsg, valid and keep,
// ~57 bytes a lane at d = 3; kernel B: 8 bytes per channel).  With no
// FMA formed, the float64 pipe issues 64 instructions per SM per clock:
// for a 131,072-lane chunk kernel A needs ~3.5 us of float64 work
// against ~2.2 us of memory traffic, so arithmetic bounds it; kernel B
// at the probe's 4,096 indices is bound by its bytes.  Both sit well
// above their bounds: they are latency-bound, at ~100 registers a thread
// one 512-thread block fits an SM.  The model tables
// (a few KB) stay in L1/L2; kernel A keeps the filter rows in shared
// memory and reads the edges and the prefix-min table (up to 257^2
// doubles) from global memory through the cache.  Simple and right
// first: one lane per thread, per-field tree reductions, no tuning yet.
// Kernel A decodes in int32 whenever the index space allows it; kernel
// B, which takes arbitrary flat indices off the chunk path, in int64.
//
// Host interface: plain C, called through ctypes.  Every argument reaches
// the launcher as one int64 array (scalars and device pointers) and one
// float64 array, read in the order repro_torch/kernels/sweep_grid/
// kernel.py writes them; a count mismatch is refused before any launch.
// The launchers return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <climits>

#include "sweep_grid.cuh"

using namespace sweep_grid;

namespace {

constexpr int MAX_W = 512;      // lanes per block (ChunkSpec.block)
constexpr int MAX_CONS = 8;     // constraint predicates
constexpr int MAX_ROWS = 64;    // explicit dominance-filter rows
constexpr int EVAL_THREADS = 256;

constexpr int ERR_ARGS = -1;    // argument count mismatch
constexpr int ERR_RANGE = -2;   // argument outside the kernel's limits

struct ChunkArgs {
  Tables T;
  Consts C;
  Grid G;
  long long start, chunk, padded;
  int W, n_blocks, small_index;
  int nf, d;
  int field[N_FIELDS];          // tracked channel -> index in FIELDS
  double sign[N_FIELDS];        // +1 minimize / -1 maximize per objective
  int n_cons;
  int cons_field[MAX_CONS];     // index into the tracked channels
  int cons_op[MAX_CONS];        // 0 <=, 1 >=, 2 <, 3 >
  const double* cons_bound;
  int n_rows;
  const double* rows;           // (n_rows, d) signed front rows
  int table_dims;               // 0, or d - 1 for the prefix-min table
  int bins;                     // table and edge rows hold bins + 1
  const double* edges;          // (d - 1, bins + 1)
  const double* table;          // (bins + 1,) * (d - 1)
  double* Fd;                   // (d, padded)
  double* Fsg;                  // (d, padded)
  bool* valid;                  // (d, padded)
  bool* keep;                   // (padded,)
  double* bmin;                 // (nf, n_blocks)
  long long* bidx;              // (nf, n_blocks)
  int* cnt;                     // (nf, n_blocks)
  double* bmax;                 // (nf, n_blocks)
  double* sgmin;                // (d, n_blocks)
};

struct EvalArgs {
  Tables T;
  Consts C;
  Grid G;
  const long long* flat;
  long long n;
  int nf;
  int field[N_FIELDS];
  double* out;                  // (nf, n)
};

__device__ __forceinline__ bool cons_ok(int op, double v, double b) {
  switch (op) {
    case 0: return v <= b;
    case 1: return v >= b;
    case 2: return v < b;
    default: return v > b;
  }
}

// searchsorted(e[0:n], x, side="right"): the number of entries <= x.
// Duplicate and +inf edges count like any other value.
__device__ __forceinline__ int upper_bound(const double* e, int n, double x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (e[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(MAX_W) chunk_kernel(const ChunkArgs a) {
  __shared__ double s_rows[MAX_ROWS * N_FIELDS];
  __shared__ double s_v[MAX_W];
  __shared__ long long s_i[MAX_W];
  __shared__ int s_c[MAX_W];
  __shared__ double s_x[MAX_W];

  const int tid = threadIdx.x;
  const int blk = blockIdx.x;
  for (int i = tid; i < a.n_rows * a.d; i += blockDim.x) s_rows[i] = a.rows[i];

  const bool is_lane = tid < a.W;               // blockDim may exceed W
  const long long g = static_cast<long long>(blk) * a.W + tid;
  const bool real = is_lane && g < a.chunk;     // not block padding
  const long long flat = a.start + g;
  const bool inchunk = real && flat < a.G.n_total;

  double out[N_FIELDS];
  bool feas = false;
  if (real) {
    long long c[N_AXES];
    decode(a.G, flat, a.small_index != 0, c);
    eval_config(a.T, a.C, a.G, c, out);
    feas = inchunk;
    for (int ci = 0; ci < a.n_cons; ++ci)
      feas = feas && cons_ok(a.cons_op[ci], out[a.field[a.cons_field[ci]]],
                             a.cons_bound[ci]);
  }

  // Lane outputs: the objectives, signed and masked, then the filter.
  double q[N_FIELDS];
  bool fin = true;
  for (int c = 0; c < a.d; ++c) {
    const double v = real ? out[a.field[c]] : NAN;
    const bool ok = real && feas && isfinite(v);
    q[c] = ok ? v * a.sign[c] : INFINITY;
    fin = fin && isfinite(q[c]);
    if (is_lane) {
      const long long o = c * a.padded + g;
      a.Fd[o] = v;
      a.Fsg[o] = q[c];
      a.valid[o] = ok;
    }
  }
  __syncthreads();                               // s_rows loaded
  if (is_lane) {
    bool dom = false;
    for (int r = 0; r < a.n_rows; ++r) {
      bool le = true, lt = false;
      for (int c = 0; c < a.d; ++c) {
        const double rc = s_rows[r * a.d + c];
        le = le && rc <= q[c];
        lt = lt || rc < q[c];
      }
      dom = dom || (le && lt);
    }
    if (a.table_dims > 0) {
      // Strictly-lower bin of each trailing objective, clipped into the
      // table; the lookup proves domination only when every bin >= 0.
      bool ok = true;
      long long t = 0;
      for (int c = 1; c < a.d; ++c) {
        const int b =
            upper_bound(a.edges + (c - 1) * (a.bins + 1), a.bins + 1, q[c]) -
            2;
        ok = ok && b >= 0;
        t = t * (a.bins + 1) + (b < 0 ? 0 : (b > a.bins ? a.bins : b));
      }
      dom = dom || (ok && a.table[t] <= q[0]);
    }
    a.keep[g] = real && fin && !dom;
  }

  // Block partials of every tracked channel: (min, first-min index) as
  // one lexicographic reduction, valid count, max.  Padding lanes take
  // the reference's fills (+inf, n_total, 0, -inf); threads beyond W are
  // neutral.
  for (int f = 0; f < a.nf; ++f) {
    double v = INFINITY, x = -INFINITY;
    long long ix = LLONG_MAX;
    int n = 0;
    if (is_lane) {
      ix = real ? flat : a.G.n_total;
      if (real) {
        const double y = out[a.field[f]];
        if (feas && isfinite(y)) { v = y; x = y; n = 1; }
      }
    }
    s_v[tid] = v; s_i[tid] = ix; s_c[tid] = n; s_x[tid] = x;
    __syncthreads();
    for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
      if (tid < s) {
        const double v2 = s_v[tid + s];
        const long long i2 = s_i[tid + s];
        if (v2 < s_v[tid] || (v2 == s_v[tid] && i2 < s_i[tid])) {
          s_v[tid] = v2;
          s_i[tid] = i2;
        }
        s_c[tid] += s_c[tid + s];
        s_x[tid] = fmax(s_x[tid], s_x[tid + s]);
      }
      __syncthreads();
    }
    if (tid == 0) {
      const long long o = static_cast<long long>(f) * a.n_blocks + blk;
      a.bmin[o] = s_v[0];
      a.bidx[o] = s_i[0];
      a.cnt[o] = s_c[0];
      a.bmax[o] = s_x[0];
    }
    __syncthreads();
  }
  for (int c = 0; c < a.d; ++c) {
    s_v[tid] = is_lane ? q[c] : INFINITY;
    __syncthreads();
    for (int s = blockDim.x >> 1; s > 0; s >>= 1) {
      if (tid < s) s_v[tid] = fmin(s_v[tid], s_v[tid + s]);
      __syncthreads();
    }
    if (tid == 0) a.sgmin[static_cast<long long>(c) * a.n_blocks + blk] = s_v[0];
    __syncthreads();
  }
}

__global__ void eval_kernel(const EvalArgs a) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  long long c[N_AXES];
  decode(a.G, a.flat[i], false, c);
  double out[N_FIELDS];
  eval_config(a.T, a.C, a.G, c, out);
  for (int f = 0; f < a.nf; ++f) a.out[f * a.n + i] = out[a.field[f]];
}

template <typename T>
struct Reader {
  const T* p;
  int n;
  int pos;
  bool bad;
  T next() {
    if (pos >= n) { bad = true; return T(0); }
    return p[pos++];
  }
  bool done() const { return !bad && pos == n; }
};

template <typename P>
P* as_ptr(long long v) { return reinterpret_cast<P*>(static_cast<intptr_t>(v)); }

void read_common(Reader<long long>& r, Reader<double>& dr, Tables& T,
                 Consts& C, Grid& G) {
  T.p = as_ptr<const double>(r.next());
  for (int t = 0; t < N_TABLES; ++t) T.off[t] = r.next();
  for (int t = 0; t < N_TABLES; ++t) T.w[t] = r.next();
  for (int x = 0; x < N_AXES; ++x) G.ax[x] = as_ptr<const void>(r.next());
  for (int x = 0; x < N_AXES; ++x) G.size[x] = r.next();
  for (int x = 0; x < N_AXES; ++x) G.stride[x] = r.next();
  G.n_total = r.next();
  C.sense_w = dr.next();
  C.read_w = dr.next();
  C.idle_w = dr.next();
  C.t_sense = dr.next();
  C.mipi_e = dr.next();
  C.mipi_bw = dr.next();
  C.utsv_e = dr.next();
  C.utsv_bw = dr.next();
  C.full_frame = dr.next();
  C.l1_scale = dr.next();
  C.sensor_l1 = dr.next();
  C.agg_l1 = dr.next();
}

}  // namespace

extern "C" {

int sweep_grid_chunk_launch(const long long* iargs, int n_i,
                            const double* dargs, int n_d, int device,
                            void* stream) {
  Reader<long long> r{iargs, n_i, 0, false};
  Reader<double> dr{dargs, n_d, 0, false};
  ChunkArgs a;
  read_common(r, dr, a.T, a.C, a.G);
  a.start = r.next();
  a.chunk = r.next();
  a.padded = r.next();
  a.W = static_cast<int>(r.next());
  a.n_blocks = static_cast<int>(r.next());
  a.small_index = static_cast<int>(r.next());
  a.nf = static_cast<int>(r.next());
  a.d = static_cast<int>(r.next());
  if (a.nf < 1 || a.nf > N_FIELDS || a.d < 1 || a.d > a.nf) return ERR_RANGE;
  for (int f = 0; f < a.nf; ++f) a.field[f] = static_cast<int>(r.next());
  for (int c = 0; c < a.d; ++c) a.sign[c] = dr.next();
  a.n_cons = static_cast<int>(r.next());
  if (a.n_cons < 0 || a.n_cons > MAX_CONS) return ERR_RANGE;
  for (int i = 0; i < a.n_cons; ++i) a.cons_field[i] = static_cast<int>(r.next());
  for (int i = 0; i < a.n_cons; ++i) a.cons_op[i] = static_cast<int>(r.next());
  a.cons_bound = as_ptr<const double>(r.next());
  a.n_rows = static_cast<int>(r.next());
  a.rows = as_ptr<const double>(r.next());
  a.table_dims = static_cast<int>(r.next());
  a.bins = static_cast<int>(r.next());
  a.edges = as_ptr<const double>(r.next());
  a.table = as_ptr<const double>(r.next());
  a.Fd = as_ptr<double>(r.next());
  a.Fsg = as_ptr<double>(r.next());
  a.valid = as_ptr<bool>(r.next());
  a.keep = as_ptr<bool>(r.next());
  a.bmin = as_ptr<double>(r.next());
  a.bidx = as_ptr<long long>(r.next());
  a.cnt = as_ptr<int>(r.next());
  a.bmax = as_ptr<double>(r.next());
  a.sgmin = as_ptr<double>(r.next());
  if (!r.done() || !dr.done()) return ERR_ARGS;
  if (a.W < 1 || a.W > MAX_W || a.n_blocks < 1 || a.n_rows < 0 ||
      a.n_rows > MAX_ROWS || (a.table_dims != 0 && a.table_dims != a.d - 1))
    return ERR_RANGE;
  for (int f = 0; f < a.nf; ++f)
    if (a.field[f] < 0 || a.field[f] >= N_FIELDS) return ERR_RANGE;
  for (int i = 0; i < a.n_cons; ++i)
    if (a.cons_field[i] < 0 || a.cons_field[i] >= a.nf || a.cons_op[i] < 0 ||
        a.cons_op[i] > 3)
      return ERR_RANGE;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  int threads = 1;
  while (threads < a.W) threads <<= 1;
  chunk_kernel<<<a.n_blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int sweep_grid_eval_launch(const long long* iargs, int n_i,
                           const double* dargs, int n_d, int device,
                           void* stream) {
  Reader<long long> r{iargs, n_i, 0, false};
  Reader<double> dr{dargs, n_d, 0, false};
  EvalArgs a;
  read_common(r, dr, a.T, a.C, a.G);
  a.flat = as_ptr<const long long>(r.next());
  a.n = r.next();
  a.nf = static_cast<int>(r.next());
  if (a.nf < 1 || a.nf > N_FIELDS) return ERR_RANGE;
  for (int f = 0; f < a.nf; ++f) a.field[f] = static_cast<int>(r.next());
  a.out = as_ptr<double>(r.next());
  if (!r.done() || !dr.done()) return ERR_ARGS;
  for (int f = 0; f < a.nf; ++f)
    if (a.field[f] < 0 || a.field[f] >= N_FIELDS) return ERR_RANGE;
  if (a.n <= 0) return ERR_RANGE;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long blocks = (a.n + EVAL_THREADS - 1) / EVAL_THREADS;
  eval_kernel<<<static_cast<unsigned>(blocks), EVAL_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* sweep_grid_error_string(int code) {
  if (code == ERR_ARGS) return "argument count mismatch";
  if (code == ERR_RANGE) return "argument outside the kernel's limits";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
