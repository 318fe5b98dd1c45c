// Sweep-grid kernels for Hopper (sm_90a), float64.
//
// Kernel A (chunk_kernel) replaces the reference's fused Pallas chunk
// kernel, repro/kernels/sweep_grid/kernel.py::build_chunk_call: each
// lane decodes its flat index, evaluates Eq. 1-11 (eval_config), applies
// the constraint predicates and the Pareto dominance pre-filter and
// writes its lane outputs; each 512-lane block of the chunk
// (ChunkSpec.block) then writes its min, first-min flat index, valid
// count, max and signed min.  No atomics and no state across blocks: the
// partials are deterministic and keep the layout of
// repro_torch.core.backend.chunk_partials, which folds them.
//
// Kernel B (eval_kernel) replaces the evaluate-only Pallas variant,
// kernel.py::_flat_call / sweep_grid_eval: Eq. 1-11 at explicit flat
// indices, writing the requested channels as an (n_fields, n) matrix.
//
// Kernel F (fold_kernel, fold.cuh, with its note) folds kernel A's
// partials into the chunk step's carry and compacts the survivors: one
// launch a chunk (a block for each independent part), right after A in
// the step's graph.
//
// What bounds them on an H100: per configuration ~270 float64
// instructions of Eq. 1-11, ten IEEE divide sequences included (kernel A
// adds ~180 for the dominance filter and the reductions at d = 3),
// against the lane outputs written (kernel A: Fd, Fsg, valid and keep,
// ~57 bytes a lane at d = 3; kernel B: 8 bytes per channel).  With no
// FMA formed, the float64 pipe issues 64 instructions per SM per clock:
// for a 131,072-lane chunk kernel A needs ~3.5 us of float64 work
// against ~2.2 us of memory traffic, so arithmetic bounds it; kernel B
// at the probe's 4,096 indices is bound by its bytes.  Both run far above
// those bounds: a lane is a long chain of dependent table gathers and
// divide sequences, so the time is set by how many lanes an SM keeps in
// flight and by what the block does besides Eq. 1-11.
//
// Kernel A's design, for that: (1) a block of CHUNK_THREADS threads
// serves one 512-lane partial block, CHUNK_LANES lanes a thread (lane
// tid + j * blockDim), so at the register cap of __launch_bounds__
// (CHUNK_MIN_BLOCKS blocks an SM) the 256 blocks of a 131,072-lane chunk
// are all resident at once instead of running in two waves of one
// 512-thread block an SM.  (2) One reduction pass: each lane's tracked
// values go to shared memory (thread-private slots, so no barrier), each
// thread folds its lanes, a warp combines (min, first-min index), count,
// max and the signed mins with shuffles, and one warp a reduction folds
// the warps' partials: two barriers a block instead of ~70.  (3) The
// filter runs only for lanes that can be kept, scans its rows until one
// dominates the lane and only then reads the prefix-min table (either
// proof decides alone, so the mask is the reference's); the rows and the
// table's edges sit in shared memory.  (4) No local arrays: the tracked
// channels are picked out of eval_config's outputs by selects.  Min, the
// lexicographic first min, the integer count and max are exact in any
// order, so the partials equal the plain version bit for bit.
// eval_config (sweep_grid.cuh) is shared with kernel B; decode there is
// kernel A's alone.  ptxas (CUDA 12, sm_90a, as built by kernel.py):
// chunk_kernel 128 registers, the cap of two 256-thread blocks an SM, no
// spills (a cap of 80 for three blocks spills 248 bytes and runs slower);
// eval_kernel's instances at most 168, their cap, with no stack frame.
//
// Kernel A decodes in int32 whenever the index space allows it.
//
// Kernel B's design.  It runs at two sizes: the stream's probe (4,096
// indices) and the dense engine (evaluate_grid, evaluate_one and
// optimal_partition below its stream threshold: up to 2^20 indices,
// 1,000,960 for the reference's 10^6 grid), where it is bound by its
// bytes (the 8-byte index and 8 bytes a channel: 96 a configuration at
// all eleven, 28.7 us at 3.35 TB/s) ahead of its ~270 float64
// instructions a configuration (~16 us at the float64 pipe's rate).  What
// it issues besides is integer work: Eq. 1-11's ~75 table gathers each
// form a 64-bit offset (off + row * width + col), and the first version
// decoded with twenty software int64 divisions a configuration, so its
// instructions, not its bytes, set its time.
// (1) Decode: the flat index is divided by each axis's stride and size
// with a multiply-high by a multiplier the host precomputes
// (Granlund-Montgomery, the scheme of CUTLASS's FastDivmod): __umulhi
// and a shift in 32-bit integers whenever the grid has fewer than 2^31
// configurations (every grid of the repo), __umul64hi at or above.
// (2) No local arrays: each channel eval_config writes goes to its
// output row through an unrolled loop over the eleven FIELDS with a
// per-field row (-1: not requested), so every index is known at compile
// time and the values stay in registers (ptxas: no stack frame).
// (3) Shared coordinates: a thread takes EVAL_CONFIGS consecutive
// indices; where they run along the grid's last axis (as the dense
// engine's arange does) they differ in that coordinate alone, so they
// are decoded once and handed to eval_config with the same values for
// the other nine, and the compiler evaluates everything that does not
// depend on the last axis (every gather but one, most of Eq. 1-11) once
// for the group.  Each of its rows then goes out as 16-byte stores where
// aligned.  Other indices (the probe's, the overflow fallback's) are
// evaluated one at a time.
// (4) Staging: at the dense size the packed tables and the axis values
// (a few KB) are copied to shared memory with cp.async, so the gathers
// are shared-memory loads with 32-bit addresses (fewer instructions than
// 64-bit global ones); as many blocks as the SMs hold stage them once
// each and step over the tiles.  (5) A launch plan (kernel.py::
// eval_plan) for both sizes: below a full card's worth of work, small
// blocks of one index a thread spread over the SMs, the tables read where
// they lie (staging a block cost more than it saved at the probe); at the
// dense size EVAL_THREADS-thread blocks under __launch_bounds__(
// EVAL_THREADS, EVAL_MIN_BLOCKS), a register cap that leaves
// EVAL_MIN_BLOCKS blocks an SM without spills.  eval_config is shared
// with kernel A and unchanged, so B still equals A and the plain version
// to the bit.
//
// Host interface: plain C, called through ctypes.  Every argument reaches
// the launcher as one int64 array (scalars and device pointers) and one
// float64 array, read in the order repro_torch/kernels/sweep_grid/
// kernel.py writes them; a count mismatch is refused before any launch,
// and so is a launch plan (kernel.py::chunk_plan) this build does not
// run.  The launchers return cudaGetLastError() after the launch.

#include <cuda_runtime.h>

#include <climits>

#include "fold.cuh"
#include "sweep_grid.cuh"

// Lanes a thread and resident blocks an SM of kernel A: set by the build
// (kernel.py passes them as -D flags, from the constants its plan uses).
#if !defined(CHUNK_LANES) || !defined(CHUNK_MIN_BLOCKS)
#error "build with -DCHUNK_LANES=<n> -DCHUNK_MIN_BLOCKS=<n> (see kernel.py)"
#endif
// Kernel B's block size at most, consecutive indices a thread on its
// dense plan, and resident blocks an SM: set by the build alike.
#if !defined(EVAL_THREADS) || !defined(EVAL_CONFIGS) || \
    !defined(EVAL_MIN_BLOCKS)
#error "build with -DEVAL_THREADS=<n> -DEVAL_CONFIGS=<n> -DEVAL_MIN_BLOCKS=<n>"
#endif

using namespace sweep_grid;

namespace {

constexpr int MAX_W = 512;      // lanes per block (ChunkSpec.block)
constexpr int CHUNK_THREADS = MAX_W / CHUNK_LANES;   // threads at most
constexpr int MAX_CONS = 8;     // constraint predicates
constexpr int MAX_ROWS = 64;    // explicit dominance-filter rows
constexpr unsigned FULL = 0xffffffffu;

static_assert(CHUNK_LANES >= 1 && MAX_W % (32 * CHUNK_LANES) == 0,
              "CHUNK_LANES must divide 16");
static_assert(EVAL_THREADS % 32 == 0 && EVAL_THREADS <= 1024 &&
                  (EVAL_CONFIGS == 2 || EVAL_CONFIGS == 4),
              "EVAL_THREADS: whole warps; EVAL_CONFIGS: 2 or 4");

constexpr int ERR_ARGS = -1;    // argument count mismatch
constexpr int ERR_RANGE = -2;   // argument outside the kernel's limits
constexpr int ERR_PLAN = -3;    // a launch plan this build does not run

struct ChunkArgs {
  Tables T;
  Consts C;
  Grid G;
  long long start, chunk, padded;
  // The dispatch's first flat index on the device, or null: the chunk is
  // [*base + start, *base + start + chunk).  A captured CUDA graph holds
  // its launches' arguments, so the stream's graph-replayed step keeps
  // the index that changes between replays here (written before each
  // replay) and a fixed offset in start.
  const long long* base;
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
  const long long* flat;        // (n,) in [0, G.n_total)
  long long n;
  int row[N_FIELDS];            // FIELDS channel -> output row, -1: none
  // Fast division by each axis's stride ([0]) and size ([1]): see
  // fast_div; mul 0 marks a divisor of 1.
  unsigned long long mul[2][N_AXES];
  int shr[2][N_AXES];
  long long n_buf;              // doubles of the table buffer T.p
  double* out;                  // (rows, n)
};

// Kernel A's dynamic shared memory, in this order: the filter rows
// (n_rows x d), its edges (edge_len), each tracked channel's lane values
// (nf x W), and the warps' partials of the nf + d reductions (value, max,
// index, count; warps each).  kernel.py::chunk_plan sizes it alike.
__host__ __device__ inline long long chunk_smem_bytes(int n_rows, int d,
                                                      int edge_len, int nf,
                                                      int W, int warps) {
  const long long parts = static_cast<long long>(nf + d) * warps;
  return 8LL * (static_cast<long long>(n_rows) * d + edge_len +
                static_cast<long long>(nf) * W + 3 * parts) +
         4 * parts;
}

__device__ __forceinline__ bool cons_ok(int op, double v, double b) {
  switch (op) {
    case 0: return v <= b;
    case 1: return v >= b;
    case 2: return v < b;
    default: return v > b;
  }
}

// out[i] for a runtime i in [0, N_FIELDS), by selects: indexing out with
// a runtime value would put the whole array in local memory.
__device__ __forceinline__ double pick(const double (&out)[N_FIELDS], int i) {
  double v = out[0];
#pragma unroll
  for (int k = 1; k < N_FIELDS; ++k) v = (i == k) ? out[k] : v;
  return v;
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

// One lane of the chunk (block-local lane l, chunk lane g): Eq. 1-11,
// constraints, lane outputs, filter; its tracked values, +inf where not
// valid, go to s_val[f * W + l].
__device__ __forceinline__ void chunk_lane(const ChunkArgs& a, int l,
                                           long long g, long long start,
                                           const double* s_rows,
                                           const double* s_edges,
                                           double* s_val) {
  const bool real = g < a.chunk;                 // not block padding
  const long long flat = start + g;
  double out[N_FIELDS];
  bool feas = false;
  if (real) {
    long long c[N_AXES];
    decode(a.G, flat, a.small_index != 0, c);
    eval_config(a.T, a.C, a.G, c, out);
    feas = flat < a.G.n_total;
    for (int ci = 0; ci < a.n_cons; ++ci)
      feas = feas && cons_ok(a.cons_op[ci], pick(out, a.field[a.cons_field[ci]]),
                             a.cons_bound[ci]);
  }
  for (int f = 0; f < a.nf; ++f) {
    const double y = real ? pick(out, a.field[f]) : NAN;
    s_val[f * a.W + l] = (feas && isfinite(y)) ? y : INFINITY;
  }

  // The objectives, signed and masked: lane outputs, and the first three
  // kept for the filter.
  bool fin = true;
  double q0 = INFINITY, q1 = INFINITY, q2 = INFINITY;
  for (int c = 0; c < a.d; ++c) {
    const double v = real ? pick(out, a.field[c]) : NAN;
    const bool ok = feas && isfinite(v);
    const double q = ok ? v * a.sign[c] : INFINITY;
    fin = fin && isfinite(q);
    q0 = c == 0 ? q : q0;
    q1 = c == 1 ? q : q1;
    q2 = c == 2 ? q : q2;
    const long long o = c * a.padded + g;
    a.Fd[o] = v;
    a.Fsg[o] = q;
    a.valid[o] = ok;
  }

  // The filter, for lanes that can be kept: the explicit rows until one
  // dominates, then the prefix-min table.  Either proof alone decides, so
  // stopping at the first gives the reference's mask; most lanes of a
  // sweep fall to an early row.
  bool dom = !(real && fin);
  for (int r = 0; r < a.n_rows && !dom; ++r) {
    // row r dominates: <= the lane in every objective, < in one.  Past the
    // third, an objective's signed value is its lane value (finite here)
    // times its sign.
    const double* row = s_rows + r * a.d;
    bool le = row[0] <= q0, lt = row[0] < q0;
    if (a.d > 1) { le = le && row[1] <= q1; lt = lt || row[1] < q1; }
    if (a.d > 2) { le = le && row[2] <= q2; lt = lt || row[2] < q2; }
    for (int c = 3; c < a.d; ++c) {
      const double q = s_val[c * a.W + l] * a.sign[c];
      le = le && row[c] <= q;
      lt = lt || row[c] < q;
    }
    dom = le && lt;
  }
  if (!dom && a.table_dims > 0) {
    // Strictly-lower bin of each trailing objective, clipped into the
    // table; the lookup proves domination only when every bin >= 0.
    bool ok = true;
    long long t = 0;
    for (int c = 1; c < a.d; ++c) {
      const int b = upper_bound(s_edges + (c - 1) * (a.bins + 1), a.bins + 1,
                                c == 1 ? q1 : q2) - 2;
      ok = ok && b >= 0;
      t = t * (a.bins + 1) + (b < 0 ? 0 : (b > a.bins ? a.bins : b));
    }
    dom = ok && a.table[t] <= q0;
  }
  a.keep[g] = !dom;
}

// (v, i) <- the lexicographic min of (v, i) and (v2, i2); n and x sum and
// max.  Exact in any order.
__device__ __forceinline__ void fold(double& v, long long& i, int& n,
                                     double& x, double v2, long long i2,
                                     int n2, double x2) {
  if (v2 < v || (v2 == v && i2 < i)) { v = v2; i = i2; }
  n += n2;
  x = fmax(x, x2);
}

__device__ __forceinline__ void warp_fold(double& v, long long& i, int& n,
                                          double& x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    fold(v, i, n, x, __shfl_xor_sync(FULL, v, o), __shfl_xor_sync(FULL, i, o),
         __shfl_xor_sync(FULL, n, o), __shfl_xor_sync(FULL, x, o));
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__global__ void __launch_bounds__(CHUNK_THREADS, CHUNK_MIN_BLOCKS)
chunk_kernel(const ChunkArgs a) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nw = nt >> 5;
  const int nr = a.nf + a.d;                     // reductions
  const int edge_len = a.table_dims * (a.bins + 1);
  double* s_rows = smem;
  double* s_edges = s_rows + a.n_rows * a.d;
  double* s_val = s_edges + edge_len;
  double* s_pv = s_val + a.nf * a.W;
  double* s_px = s_pv + nr * nw;
  long long* s_pi = reinterpret_cast<long long*>(s_px + nr * nw);
  int* s_pn = reinterpret_cast<int*>(s_pi + nr * nw);

  const long long start = a.start + (a.base ? *a.base : 0LL);
  for (int i = tid; i < a.n_rows * a.d; i += nt) s_rows[i] = a.rows[i];
  for (int i = tid; i < edge_len; i += nt) s_edges[i] = a.edges[i];
  __syncthreads();

  const long long base = static_cast<long long>(blockIdx.x) * a.W;
#pragma unroll 1
  for (int j = 0; j < CHUNK_LANES; ++j) {
    const int l = tid + j * nt;
    if (l < a.W) chunk_lane(a, l, base + l, start, s_rows, s_edges, s_val);
  }

  // Reductions nf .. nf + d - 1 are the signed objectives' mins; padding
  // lanes take the reference's index fill n_total.  Each thread reads
  // back only the slots it wrote.
  for (int f = 0; f < nr; ++f) {
    const bool sg = f >= a.nf;
    const int c = sg ? f - a.nf : f;
    double v = INFINITY, x = -INFINITY;
    long long ix = LLONG_MAX;
    int n = 0;
    for (int j = 0; j < CHUNK_LANES; ++j) {
      const int l = tid + j * nt;
      if (l >= a.W) break;
      const double y = s_val[c * a.W + l];
      const bool ok = isfinite(y);
      if (sg) {
        v = fmin(v, ok ? y * a.sign[c] : INFINITY);
      } else {
        const long long g = base + l;
        fold(v, ix, n, x, y, g < a.chunk ? start + g : a.G.n_total,
             ok ? 1 : 0, ok ? y : -INFINITY);
      }
    }
    if (sg) {
      v = warp_min(v);
    } else {
      warp_fold(v, ix, n, x);
    }
    if (lane == 0) {
      s_pv[f * nw + warp] = v;
      s_px[f * nw + warp] = x;
      s_pi[f * nw + warp] = ix;
      s_pn[f * nw + warp] = n;
    }
  }
  __syncthreads();
  for (int f = warp; f < nr; f += nw) {
    const bool has = lane < nw;
    double v = has ? s_pv[f * nw + lane] : INFINITY;
    if (f >= a.nf) {
      v = warp_min(v);
      if (lane == 0)
        a.sgmin[static_cast<long long>(f - a.nf) * a.n_blocks + blockIdx.x] = v;
      continue;
    }
    double x = has ? s_px[f * nw + lane] : -INFINITY;
    long long ix = has ? s_pi[f * nw + lane] : LLONG_MAX;
    int n = has ? s_pn[f * nw + lane] : 0;
    warp_fold(v, ix, n, x);
    if (lane == 0) {
      const long long o = static_cast<long long>(f) * a.n_blocks + blockIdx.x;
      a.bmin[o] = v;
      a.bidx[o] = ix;
      a.cnt[o] = n;
      a.bmax[o] = x;
    }
  }
}

// n / d by a multiply-high (Granlund & Montgomery, as CUTLASS's
// FastDivmod): mul = ceil(2^p / d) with p = bits - 1 + ceil(log2 d) and
// shr = p - bits, exact for 0 <= n < 2^(bits - 1); mul 0 stands for d = 1
// (kernel.py::div_magic computes both).
__device__ __forceinline__ uint32_t fast_div(uint32_t n,
                                             unsigned long long mul,
                                             int shr) {
  return mul ? __umulhi(n, static_cast<uint32_t>(mul)) >> shr : n;
}

__device__ __forceinline__ uint64_t fast_div(uint64_t n,
                                             unsigned long long mul,
                                             int shr) {
  return mul ? __umul64hi(n, mul) >> shr : n;
}

// decode()'s coordinates, (flat / stride) % size on every axis, in I
// (uint32_t below 2^31 configurations, uint64_t at or above).
template <typename I>
__device__ __forceinline__ void eval_decode(const EvalArgs& a, I flat,
                                            long long* c) {
#pragma unroll
  for (int x = 0; x < N_AXES; ++x) {
    const I q = fast_div(flat, a.mul[0][x], a.shr[0][x]);
    const I r = q - fast_div(q, a.mul[1][x], a.shr[1][x]) *
                        static_cast<I>(a.G.size[x]);
    c[x] = static_cast<long long>(r);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One thread's CONFIGS consecutive positions i0, i0 + 1, ...  Where
// their indices run along the grid's last axis (flat[i0 + j] = flat[i0] +
// j, and the last coordinate stays in range), the configurations share
// every coordinate but the last: they are decoded once and handed to
// eval_config with the same values, so the compiler evaluates what does
// not depend on the last axis (every table gather but one, most of Eq.
// 1-11) once for all of them; each row's values go out in 16-byte stores
// where aligned.  Otherwise (and at the ragged end) one position at a
// time, each decoded on its own.
template <typename I, int CONFIGS>
__device__ __forceinline__ void eval_thread(const EvalArgs& a,
                                            const Tables& T, const Grid& G,
                                            long long i0) {
  if constexpr (CONFIGS > 1) {
    if (i0 + CONFIGS <= a.n) {
      long long f[CONFIGS];
      if (aligned16(a.flat + i0)) {
#pragma unroll
        for (int j = 0; j < CONFIGS; j += 2) {
          const longlong2 q =
              *reinterpret_cast<const longlong2*>(a.flat + i0 + j);
          f[j] = q.x;
          f[j + 1] = q.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < CONFIGS; ++j) f[j] = a.flat[i0 + j];
      }
      bool run = true;
#pragma unroll
      for (int j = 1; j < CONFIGS; ++j) run = run && f[j] == f[0] + j;
      long long c0[N_AXES];
      eval_decode<I>(a, static_cast<I>(f[0]), c0);
      if (run && c0[N_AXES - 1] + CONFIGS <= a.G.size[N_AXES - 1]) {
        double v[CONFIGS][N_FIELDS];
#pragma unroll
        for (int j = 0; j < CONFIGS; ++j) {
          long long c[N_AXES];
#pragma unroll
          for (int x = 0; x < N_AXES; ++x) c[x] = c0[x];
          c[N_AXES - 1] += j;
          eval_config(T, a.C, G, c, v[j]);
        }
#pragma unroll
        for (int k = 0; k < N_FIELDS; ++k) {
          const int r = a.row[k];
          if (r < 0) continue;
          double* o = a.out + static_cast<long long>(r) * a.n + i0;
          if (aligned16(o)) {
#pragma unroll
            for (int j = 0; j < CONFIGS; j += 2)
              *reinterpret_cast<double2*>(o + j) =
                  make_double2(v[j][k], v[j + 1][k]);
          } else {
#pragma unroll
            for (int j = 0; j < CONFIGS; ++j) o[j] = v[j][k];
          }
        }
        return;
      }
    }
  }
#pragma unroll 1
  for (int j = 0; j < CONFIGS; ++j) {
    const long long i = i0 + j;
    if (i >= a.n) break;
    long long c[N_AXES];
    eval_decode<I>(a, static_cast<I>(a.flat[i]), c);
    double v[N_FIELDS];
    eval_config(T, a.C, G, c, v);
#pragma unroll
    for (int k = 0; k < N_FIELDS; ++k)
      if (a.row[k] >= 0)
        a.out[static_cast<long long>(a.row[k]) * a.n + i] = v[k];
  }
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}

// Kernel B: CONFIGS consecutive flat indices a thread, decoded in I, in
// tiles of blockDim.x * CONFIGS indices.  Without STAGE a block serves
// the tile of its index.  STAGE: the table buffer, then each axis's
// values, are copied to shared memory (n_buf + the axis sizes, in
// doubles) and read there, and the block serves the tiles from its index
// in steps of the grid, so that a grid of as many blocks as the SMs hold
// stages them once each.
template <typename I, int CONFIGS, bool STAGE>
__global__ void __launch_bounds__(EVAL_THREADS, EVAL_MIN_BLOCKS)
eval_kernel(const EvalArgs a) {
  const long long per_block = static_cast<long long>(blockDim.x) * CONFIGS;
  const long long lane0 = static_cast<long long>(threadIdx.x) * CONFIGS;
  if constexpr (STAGE) {
    const long long tiles = (a.n + per_block - 1) / per_block;
    extern __shared__ double s_tab[];
    for (long long i = threadIdx.x; i < a.n_buf; i += blockDim.x)
      cp_async8(s_tab + i, a.T.p + i);
    Tables T = a.T;
    Grid G = a.G;
    T.p = s_tab;
    double* s_ax = s_tab + a.n_buf;
#pragma unroll
    for (int x = 0; x < N_AXES; ++x) {
      const double* src = static_cast<const double*>(a.G.ax[x]);
      for (long long i = threadIdx.x; i < a.G.size[x]; i += blockDim.x)
        cp_async8(s_ax + i, src + i);
      G.ax[x] = s_ax;
      s_ax += a.G.size[x];
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x)
      if (t * per_block + lane0 < a.n)
        eval_thread<I, CONFIGS>(a, T, G, t * per_block + lane0);
  } else {
    const long long i0 = blockIdx.x * per_block + lane0;
    if (i0 < a.n) eval_thread<I, CONFIGS>(a, a.T, a.G, i0);
  }
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

template <typename I, int CONFIGS, bool STAGE>
cudaError_t launch_eval(const EvalArgs& a, long long blocks, int threads,
                        long long smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        eval_kernel<I, CONFIGS, STAGE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  eval_kernel<I, CONFIGS, STAGE>
      <<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
         static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_eval(const EvalArgs& a, long long blocks, int threads,
                        int configs, long long smem, void* stream) {
  if (configs == 1)
    return smem ? launch_eval<I, 1, true>(a, blocks, threads, smem, stream)
                : launch_eval<I, 1, false>(a, blocks, threads, 0, stream);
  return smem
             ? launch_eval<I, EVAL_CONFIGS, true>(a, blocks, threads, smem,
                                                  stream)
             : launch_eval<I, EVAL_CONFIGS, false>(a, blocks, threads, 0,
                                                   stream);
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
  a.base = as_ptr<const long long>(r.next());
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
  const long long threads = r.next();           // the plan
  const long long lanes = r.next();
  const long long smem = r.next();
  if (!r.done() || !dr.done()) return ERR_ARGS;
  if (a.W < 1 || a.W > MAX_W || a.n_blocks < 1 || a.n_rows < 0 ||
      a.n_rows > MAX_ROWS || a.table_dims < 0 || a.table_dims > 2 ||
      (a.table_dims != 0 && a.table_dims != a.d - 1) || a.bins < 0)
    return ERR_RANGE;
  for (int f = 0; f < a.nf; ++f)
    if (a.field[f] < 0 || a.field[f] >= N_FIELDS) return ERR_RANGE;
  for (int i = 0; i < a.n_cons; ++i)
    if (a.cons_field[i] < 0 || a.cons_field[i] >= a.nf || a.cons_op[i] < 0 ||
        a.cons_op[i] > 3)
      return ERR_RANGE;
  // The plan: CHUNK_LANES lanes a thread, whole warps, every lane served.
  const long long per_lane = (a.W + CHUNK_LANES - 1) / CHUNK_LANES;
  if (lanes != CHUNK_LANES || threads != (per_lane + 31) / 32 * 32 ||
      threads > CHUNK_THREADS ||
      smem < chunk_smem_bytes(a.n_rows, a.d, a.table_dims * (a.bins + 1),
                              a.nf, a.W, static_cast<int>(threads / 32)))
    return ERR_PLAN;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(chunk_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  chunk_kernel<<<a.n_blocks, static_cast<int>(threads), static_cast<size_t>(smem),
                 static_cast<cudaStream_t>(stream)>>>(a);
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
  for (int k = 0; k < N_FIELDS; ++k) a.row[k] = static_cast<int>(r.next());
  for (int w = 0; w < 2; ++w)
    for (int x = 0; x < N_AXES; ++x) {
      a.mul[w][x] = static_cast<unsigned long long>(r.next());
      a.shr[w][x] = static_cast<int>(r.next());
    }
  a.n_buf = r.next();
  a.out = as_ptr<double>(r.next());
  const long long threads = r.next();            // the plan
  const long long configs = r.next();
  const long long blocks = r.next();
  const long long index_bits = r.next();
  const long long smem = r.next();
  if (!r.done() || !dr.done()) return ERR_ARGS;
  // Each requested channel has its own row, and they are rows 0 .. rows-1.
  unsigned seen = 0;
  int rows = 0;
  for (int k = 0; k < N_FIELDS; ++k) {
    if (a.row[k] < -1 || a.row[k] >= N_FIELDS) return ERR_RANGE;
    if (a.row[k] < 0) continue;
    if ((seen >> a.row[k]) & 1u) return ERR_RANGE;
    seen |= 1u << a.row[k];
    ++rows;
  }
  if (seen != (1u << rows) - 1) return ERR_RANGE;
  for (int w = 0; w < 2; ++w)
    for (int x = 0; x < N_AXES; ++x)
      if (a.shr[w][x] < 0 || a.shr[w][x] > 63) return ERR_RANGE;
  if (a.n <= 0 || rows < 1 || a.n_buf < 0) return ERR_RANGE;
  // The plan: whole warps up to EVAL_THREADS, one or EVAL_CONFIGS indices
  // a thread, the index width the grid needs, and either no shared memory
  // and a block a tile, or exactly the staged tables and axes and at most
  // a block a tile (the blocks step over the tiles): every index served.
  long long staged = a.n_buf;
  for (int x = 0; x < N_AXES; ++x) staged += a.G.size[x];
  const long long per_block = threads * configs;
  const long long tiles = (a.n + per_block - 1) / per_block;
  if (threads < 32 || threads > EVAL_THREADS || threads % 32 != 0 ||
      (configs != 1 && configs != EVAL_CONFIGS) || blocks < 1 ||
      blocks > tiles || (smem == 0 && blocks != tiles) || blocks > INT_MAX ||
      index_bits != (a.G.n_total < (1LL << 31) ? 32 : 64) ||
      (smem != 0 && smem != 8 * staged))
    return ERR_PLAN;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int t = static_cast<int>(threads), c = static_cast<int>(configs);
  e = index_bits == 32
          ? launch_eval<uint32_t>(a, blocks, t, c, smem, stream)
          : launch_eval<uint64_t>(a, blocks, t, c, smem, stream);
  return static_cast<int>(e);
}

int sweep_grid_fold_launch(const long long* iargs, int n_i,
                           const double* dargs, int n_d, int device,
                           void* stream) {
  Reader<long long> r{iargs, n_i, 0, false};
  Reader<double> dr{dargs, n_d, 0, false};
  FoldArgs a;
  a.off = r.next();
  a.base = as_ptr<const long long>(r.next());
  a.chunk = r.next();
  a.padded = r.next();
  a.cap = r.next();
  a.n_blocks = static_cast<int>(r.next());
  a.W = static_cast<int>(r.next());
  a.nf = static_cast<int>(r.next());
  a.d = static_cast<int>(r.next());
  a.k = static_cast<int>(r.next());
  a.nb = static_cast<int>(r.next());
  a.bins = static_cast<int>(r.next());
  a.bmin = as_ptr<const double>(r.next());
  a.bidx = as_ptr<const long long>(r.next());
  a.cnt = as_ptr<const int>(r.next());
  a.bmax = as_ptr<const double>(r.next());
  a.sgmin = as_ptr<const double>(r.next());
  a.Fsg = as_ptr<const double>(r.next());
  a.Fd = as_ptr<const double>(r.next());
  a.valid = as_ptr<const bool>(r.next());
  a.keep = as_ptr<const unsigned char>(r.next());
  a.edges = as_ptr<const double>(r.next());
  a.min_val = as_ptr<double>(r.next());
  a.min_idx = as_ptr<long long>(r.next());
  a.finite = as_ptr<long long>(r.next());
  a.fmin = as_ptr<double>(r.next());
  a.fmax = as_ptr<double>(r.next());
  a.topk_val = as_ptr<double>(r.next());
  a.topk_idx = as_ptr<long long>(r.next());
  a.hist = as_ptr<long long>(r.next());
  a.flat = as_ptr<long long>(r.next());
  a.vals = as_ptr<double>(r.next());
  a.count = as_ptr<long long>(r.next());
  const long long threads = r.next();           // the plan
  const long long blocks = r.next();
  const long long lists = r.next();
  const long long smem = r.next();
  if (!r.done() || !dr.done()) return ERR_ARGS;
  if (a.n_blocks < 1 || a.W < 1 || a.W > MAX_W ||
      a.padded != static_cast<long long>(a.n_blocks) * a.W ||
      a.chunk < 1 || a.chunk > a.padded || a.nf < 1 || a.nf > N_FIELDS ||
      a.d < 1 || a.d > a.nf || a.k < 1 || a.k > FOLD_MAX_K ||
      a.nb != (a.k < a.n_blocks ? a.k : a.n_blocks) || a.bins < 0 ||
      a.bins > FOLD_MAX_BINS ||
      (a.bins > 0 && (a.edges == nullptr || a.hist == nullptr)) ||
      a.cap < 1 || (reinterpret_cast<uintptr_t>(a.keep) & 15) != 0)
    return ERR_RANGE;
  // The plan: a block of FOLD_THREADS threads for each part of the fold,
  // fold_lists(k) pairs a lane in the selections, and the shared memory
  // the warps' lists (or the histogram's counters) take.
  if (threads != FOLD_THREADS || blocks != fold_blocks(a.d, a.bins) ||
      lists != fold_lists(a.k) || smem != fold_smem_bytes(a.k, a.bins))
    return ERR_PLAN;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = lists == 1 ? fold_kernel<1> : fold_kernel<2>;
  // Raised once per larger size, so a launch recorded into a CUDA graph
  // after a warm-up launch sets no attribute.
  static long long smem_set[2] = {48 * 1024, 48 * 1024};
  if (smem > smem_set[lists - 1]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[lists - 1] = smem;
  }
  kernel<<<fold_blocks(a.d, a.bins), FOLD_THREADS, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* sweep_grid_error_string(int code) {
  if (code == ERR_ARGS) return "argument count mismatch";
  if (code == ERR_RANGE) return "argument outside the kernel's limits";
  if (code == ERR_PLAN) return "a launch plan this build does not run";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
