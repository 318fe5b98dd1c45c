// The chunk fold on the card: folds one chunk's block partials (kernel
// A's outputs) into the chunk step's running carry, in place, and
// compacts the chunk's survivors into one row of the step's outputs.
//
// It replaces no TPU kernel: the reference folds with jnp ops after its
// Pallas chunk kernel (repro/core/backend.py's fold, lowered by XLA), and
// the port's plain version is repro_torch/core/backend.py::fold_chunk,
// whose torch ops it replaces on the "cuda" backend.  It computes what
// fold_chunk computes, bit for bit: the fold only selects, compares and
// counts, so no float64 arithmetic is involved.
//
// What bounds it: a 131,072-lane chunk's fold reads ~170 KB (the keep
// mask, the partials of 256 blocks, the lanes of the k best blocks),
// 0.05 us at the card's bandwidth.  Its work is a few dependent steps
// over small data, so its time is latency: chains of L2 reads (about 1
// us each from one SM of an H100, by clock64 stamps), shuffles and
// barriers.  The torch version spent ~190 us a chunk on library sorts,
// gathers and scans sized for large inputs.
// Here one launch runs its independent parts side by side, a block each
// (blockIdx.x: the top-k of objective c < d; the argmin; the survivors;
// the histogram of objective c, when there are bins), each issuing all
// the loads of a step before it waits for any:
// - the argmin, counts and bounds of the nf tracked channels: a warp a
//   channel folds the blocks' (min, first-min index), count and max with
//   shuffles;
// - the top-k of an objective: the k best (value, index) pairs among the
//   carry's k and the lanes of its nb = min(k, n_blocks) best blocks by
//   (signed block min, block index).  Those lanes hold the k best of the
//   whole chunk, so any superset of those blocks gives the same answer,
//   and where every block min exceeds every carry value no lane can
//   enter: the carry, sorted, is the answer (on an argmin sweep, most
//   chunks once its first ones are folded).  Otherwise two selections of
//   the m smallest pairs (the nb blocks, then the k pairs): every warp
//   keeps a sorted list of the 32 R >= m smallest pairs it has seen in
//   registers (R a lane) and folds in a batch of 32 R candidates by a
//   bitonic sort of the batch and a bitonic merge (lexicographic
//   compare-exchanges by shuffles), skipping a batch with nothing below
//   its list's m-th pair; the warps' lists then merge pairwise through
//   shared memory;
// - the survivors: each warp counts the keep bytes of its own stretch of
//   the mask, read in coalesced 16-byte words (four bytes a popcount);
//   the warps' counts place each warp's kept lanes, which a warp with any
//   then writes in ascending flat order by a shuffle prefix;
// - a histogram: a counter a bin in shared memory, integer atomics, added
//   to the carry's int64 bins (exact in any order).
//
// Rows of the survivor outputs past min(count, cap) are left unwritten:
// readers take the first count rows, and a count above the cap sends the
// chunk to the overflow fallback, which reads none.
#pragma once

#include <climits>
#include <cmath>
#include <cstdint>

#include "sweep_grid.cuh"

#if !defined(FOLD_THREADS)
#error "build with -DFOLD_THREADS=<n> (see kernel.py)"
#endif

namespace sweep_grid {

// The largest top-k table and histogram the fold kernel serves; a step
// whose spec asks for more keeps fold_chunk's torch ops (kernel.py::
// fold_runs reads both from here).
constexpr int FOLD_MAX_K = 64;
constexpr int FOLD_MAX_BINS = 16384;
constexpr int FOLD_WARPS = FOLD_THREADS / 32;
constexpr unsigned FOLD_FULL = 0xffffffffu;

static_assert(FOLD_THREADS % 32 == 0 && FOLD_THREADS <= 1024 &&
                  (FOLD_WARPS & (FOLD_WARPS - 1)) == 0,
              "FOLD_THREADS: a power of two of whole warps");
static_assert(FOLD_MAX_K <= 64, "a warp's list holds at most 64 pairs");

struct FoldArgs {
  long long off;                // the chunk's first flat index is
  const long long* base;        // off + *base (base may be null)
  long long chunk, padded, cap;
  int n_blocks, W, nf, d, k, nb, bins;
  const double* bmin;           // (nf, n_blocks)
  const long long* bidx;        // (nf, n_blocks)
  const int* cnt;               // (nf, n_blocks)
  const double* bmax;           // (nf, n_blocks)
  const double* sgmin;          // (d, n_blocks)
  const double* Fsg;            // (d, padded)
  const double* Fd;             // (d, padded)
  const bool* valid;            // (d, padded)
  const unsigned char* keep;    // (padded,), 16-byte aligned
  const double* edges;          // (d, bins + 1), or null
  double* min_val;              // the carry, updated in place: (nf,)
  long long* min_idx;           // (nf,)
  long long* finite;            // (nf,)
  double* fmin;                 // (nf,)
  double* fmax;                 // (nf,)
  double* topk_val;             // (d, k)
  long long* topk_idx;          // (d, k)
  long long* hist;              // (d, bins), or null
  long long* flat;              // this chunk's survivor row: (cap,)
  double* vals;                 // (cap, d)
  long long* count;             // ()
};

// Pairs a lane holds in a selection: 1 for k <= 32, 2 up to 64.
__host__ __device__ inline int fold_lists(int k) { return k <= 32 ? 1 : 2; }

// Blocks of a launch: the top-k of each objective, the argmin, the
// survivors, and the histogram of each objective where there are bins.
__host__ __device__ inline int fold_blocks(int d, int bins) {
  return d + 2 + (bins > 0 ? d : 0);
}

// Kernel F's dynamic shared memory: a list of 32 R (value, index) pairs
// a warp, or the histogram's bin counters where those take more.
// kernel.py::fold_smem_bytes sizes it alike.
__host__ __device__ inline long long fold_smem_bytes(int k, int bins) {
  const long long lists = 16LL * FOLD_WARPS * 32 * fold_lists(k);
  const long long counters = 4LL * bins;
  return lists > counters ? lists : counters;
}

// (v, i) < (v2, i2), lexicographically.  The pairs hold no NaN (signed
// objectives are +inf where invalid), and -0.0 == +0.0 as in the sort the
// torch fold runs.
__device__ __forceinline__ bool pair_less(double v, long long i, double v2,
                                          long long i2) {
  return v < v2 || (v == v2 && i < i2);
}

// One compare-exchange stage of a bitonic network over a warp's 32 R
// pairs (element e = 32 r + lane), partners j apart: ascending where
// (e & size) == 0.  Pairs that compare equal are equal to the bit.
template <int R>
__device__ __forceinline__ void exchange(double (&v)[R], long long (&x)[R],
                                         int size, int j) {
  const int lane = threadIdx.x & 31;
  if (j >= 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = r ^ (j >> 5);
      if (q <= r) continue;
      const bool asc = ((32 * r + lane) & size) == 0;
      if (asc ? pair_less(v[q], x[q], v[r], x[r])
              : pair_less(v[r], x[r], v[q], x[q])) {
        const double tv = v[r];
        const long long tx = x[r];
        v[r] = v[q];
        x[r] = x[q];
        v[q] = tv;
        x[q] = tx;
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const double pv = __shfl_xor_sync(FOLD_FULL, v[r], j);
    const long long px = __shfl_xor_sync(FOLD_FULL, x[r], j);
    const bool asc = ((32 * r + lane) & size) == 0;
    const bool take_min = ((lane & j) == 0) == asc;
    if (take_min ? pair_less(pv, px, v[r], x[r])
                 : pair_less(v[r], x[r], pv, px)) {
      v[r] = pv;
      x[r] = px;
    }
  }
}

// (av, ax) <- the 32 R smallest of the sorted lists A and B, sorted: the
// elementwise min of A and reversed B is bitonic; one merge sorts it.
template <int R>
__device__ __forceinline__ void merge_lists(double (&av)[R],
                                            long long (&ax)[R],
                                            const double (&bv)[R],
                                            const long long (&bx)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const double rv = __shfl_xor_sync(FOLD_FULL, bv[R - 1 - r], 31);
    const long long rx = __shfl_xor_sync(FOLD_FULL, bx[R - 1 - r], 31);
    if (pair_less(rv, rx, av[r], ax[r])) {
      av[r] = rv;
      ax[r] = rx;
    }
  }
#pragma unroll
  for (int j = 16 * R; j > 0; j >>= 1) exchange<R>(av, ax, 64 * R, j);
}

// The m <= 32 R smallest of candidates 0..n-1 (cand(i, v, x) gives
// candidate i), ascending: put(e, v, x) for e < m, called by warp 0.
// Every thread of the block calls it; it ends with a block barrier.
// s_v, s_x: a list of 32 R pairs a warp.
template <int R, typename Cand, typename Put>
__device__ void select_smallest(long long n, int m, Cand cand, Put put,
                                double* s_v, long long* s_x) {
  constexpr int N = 32 * R;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long batches = (n + N - 1) / N;
  int nw = FOLD_WARPS;          // warps taking batches: a power of two
  while (nw > 1 && nw / 2 >= batches) nw >>= 1;
  double av[R], bv[R];
  long long ax[R], bx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    av[r] = INFINITY;
    ax[r] = LLONG_MAX;
  }
  auto load = [&](long long b, double (&v)[R], long long (&x)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = b * N + 32 * r + lane;
      if (i < n) {
        cand(i, v[r], x[r]);
      } else {
        v[r] = INFINITY;
        x[r] = LLONG_MAX;
      }
    }
  };
  // G batches a warp loaded at once, then folded in turn
  constexpr int G = 8 / R;
  if (warp < nw)
    for (long long b0 = warp; b0 < batches; b0 += G * nw) {
      double gv[G][R];
      long long gx[G][R];
#pragma unroll
      for (int g = 0; g < G; ++g) load(b0 + g * nw, gv[g], gx[g]);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // the list's m-th pair: a batch with nothing below it changes
        // none of the m smallest
        double tv = av[0];
        long long tx = ax[0];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const double sv = __shfl_sync(FOLD_FULL, av[r], (m - 1) & 31);
          const long long sx = __shfl_sync(FOLD_FULL, ax[r], (m - 1) & 31);
          if (r == (m - 1) >> 5) {
            tv = sv;
            tx = sx;
          }
        }
        bool below = false;
#pragma unroll
        for (int r = 0; r < R; ++r)
          below = below || pair_less(gv[g][r], gx[g][r], tv, tx);
        if (!__any_sync(FOLD_FULL, below)) continue;
#pragma unroll
        for (int size = 2; size <= N; size <<= 1)
#pragma unroll
          for (int j = size >> 1; j > 0; j >>= 1)
            exchange<R>(gv[g], gx[g], size, j);
        merge_lists<R>(av, ax, gv[g], gx[g]);
      }
    }
  // the warps' lists, merged pairwise: each warp writes its slot once
  for (int s = 1; s < nw; s <<= 1) {
    if (warp < nw && warp % (2 * s) == s)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s_v[warp * N + 32 * r + lane] = av[r];
        s_x[warp * N + 32 * r + lane] = ax[r];
      }
    __syncthreads();
    if (warp < nw && warp % (2 * s) == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        bv[r] = s_v[(warp + s) * N + 32 * r + lane];
        bx[r] = s_x[(warp + s) * N + 32 * r + lane];
      }
      merge_lists<R>(av, ax, bv, bx);
    }
  }
  if (warp == 0)
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (32 * r + lane < m) put(32 * r + lane, av[r], ax[r]);
  __syncthreads();
}

// The bytes of 16-byte word w of the keep mask (zero past its end).
__device__ __forceinline__ uint4 keep_word(const unsigned char* keep,
                                           long long padded, long long w) {
  const long long p = 16 * w;
  if (p + 16 <= padded) return *reinterpret_cast<const uint4*>(keep + p);
  unsigned u[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (p + i < padded)
      u[i >> 2] |= static_cast<unsigned>(keep[p + i]) << (8 * (i & 3));
  return make_uint4(u[0], u[1], u[2], u[3]);
}

__device__ __forceinline__ int kept_in(uint4 u) {
  return __popc(u.x & 0x01010101u) + __popc(u.y & 0x01010101u) +
         __popc(u.z & 0x01010101u) + __popc(u.w & 0x01010101u);
}

// searchsorted(e[0:n], x, side="right"), exactly as torch's binary search
// steps (so any edge row, sorted or not, gives torch's bin).
__device__ __forceinline__ int torch_upper_bound(const double* e, int n,
                                                 double x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(e[mid] > x)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The argmin, valid count and bounds of the tracked channels: a warp a
// channel.  A block's min is never NaN (invalid lanes are +inf in it).
__device__ __forceinline__ void fold_argmin(const FoldArgs& a) {
  const int lane = threadIdx.x & 31;
  for (int f = threadIdx.x >> 5; f < a.nf; f += FOLD_WARPS) {
    // the carry's entries, loaded beside the partials
    double mv = 0.0, fl = 0.0, fh = 0.0;
    long long mi = 0, fn = 0;
    if (lane == 0) {
      mv = a.min_val[f];
      mi = a.min_idx[f];
      fn = a.finite[f];
      fl = a.fmin[f];
      fh = a.fmax[f];
    }
    double v = INFINITY, x = -INFINITY;
    long long ix = LLONG_MAX, n = 0;
    const long long row = static_cast<long long>(f) * a.n_blocks;
#pragma unroll 8
    for (int b = lane; b < a.n_blocks; b += 32) {
      const double v2 = a.bmin[row + b];
      const long long i2 = a.bidx[row + b];
      if (pair_less(v2, i2, v, ix)) { v = v2; ix = i2; }
      n += a.cnt[row + b];
      x = fmax(x, a.bmax[row + b]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double v2 = __shfl_xor_sync(FOLD_FULL, v, o);
      const long long i2 = __shfl_xor_sync(FOLD_FULL, ix, o);
      if (pair_less(v2, i2, v, ix)) { v = v2; ix = i2; }
      n += __shfl_xor_sync(FOLD_FULL, n, o);
      x = fmax(x, __shfl_xor_sync(FOLD_FULL, x, o));
    }
    if (lane == 0) {
      // isfinite guard: an all-invalid chunk ties at inf == inf and must
      // not swap the sentinel index for an invalid configuration's.
      if (v < mv || (v == mv && isfinite(v) && ix < mi)) {
        a.min_val[f] = v;
        a.min_idx[f] = ix;
      }
      a.finite[f] = fn + n;
      a.fmin[f] = nan_min(fl, v);
      a.fmax[f] = nan_max(fh, x);
    }
  }
}

// The top-k of objective c, its carry rows updated in place.
template <int R>
__device__ void fold_topk(const FoldArgs& a, int c, long long start,
                          double* s_v, long long* s_x, int* s_sel,
                          double* s_min) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int k = a.k, W = a.W;
  const double* sg = a.sgmin + static_cast<long long>(c) * a.n_blocks;
  double* tv = a.topk_val + static_cast<long long>(c) * k;
  long long* ti = a.topk_idx + static_cast<long long>(c) * k;
  // every block min against every carry value, and whether the carry is
  // sorted
  double low = INFINITY, high = -INFINITY;
  for (int b = t; b < a.n_blocks; b += FOLD_THREADS) low = fmin(low, sg[b]);
#pragma unroll 8
  for (int i = 0; i < k; ++i) high = fmax(high, tv[i]);
  const bool sorted =
      t + 1 >= k || !pair_less(tv[t + 1], ti[t + 1], tv[t], ti[t]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    low = fmin(low, __shfl_xor_sync(FOLD_FULL, low, o));
  if (lane == 0) s_min[warp] = low;
  const bool all_sorted = __syncthreads_and(sorted);
#pragma unroll
  for (int w = 0; w < FOLD_WARPS; ++w) low = fmin(low, s_min[w]);
  if (low > high) {
    // no lane enters: the answer is the carry, sorted (it is already,
    // unless it was loaded unsorted)
    if (all_sorted) return;
    select_smallest<R>(
        k, k, [&](long long i, double& v, long long& x) {
          v = tv[i];
          x = ti[i];
        },
        [&](int e, double v, long long x) {
          tv[e] = v;
          ti[e] = x;
        },
        s_v, s_x);
    return;
  }
  select_smallest<R>(
      a.n_blocks, a.nb,
      [&](long long i, double& v, long long& x) { v = sg[i]; x = i; },
      [&](int e, double, long long x) { s_sel[e] = static_cast<int>(x); },
      s_v, s_x);
  const double* fsg = a.Fsg + static_cast<long long>(c) * a.padded;
  select_smallest<R>(
      k + static_cast<long long>(a.nb) * W, k,
      [&](long long i, double& v, long long& x) {
        if (i < k) {
          v = tv[i];
          x = ti[i];
        } else {
          const int j = static_cast<int>(i - k);
          const long long pos =
              static_cast<long long>(s_sel[j / W]) * W + j % W;
          v = fsg[pos];
          x = start + pos;
        }
      },
      [&](int e, double v, long long x) {
        tv[e] = v;
        ti[e] = x;
      },
      s_v, s_x);
}

// The histogram of objective c: the torch fold's clamp, searchsorted and
// index_add_, counted in shared memory.
__device__ void fold_hist(const FoldArgs& a, int c, unsigned* s_cnt) {
  const int t = threadIdx.x;
  for (int b = t; b < a.bins; b += FOLD_THREADS) s_cnt[b] = 0u;
  __syncthreads();
  const double* e = a.edges + static_cast<long long>(c) * (a.bins + 1);
  const double lo = e[0], hi = e[a.bins];
  const long long row = static_cast<long long>(c) * a.padded;
  for (long long p = t; p < a.padded; p += FOLD_THREADS) {
    if (!a.valid[row + p]) continue;
    const double col = fmin(fmax(a.Fd[row + p], lo), hi);
    int b = torch_upper_bound(e, a.bins + 1, col) - 1;
    b = b < 0 ? 0 : (b > a.bins - 1 ? a.bins - 1 : b);
    atomicAdd(s_cnt + b, 1u);
  }
  __syncthreads();
  long long* h = a.hist + static_cast<long long>(c) * a.bins;
  for (int b = t; b < a.bins; b += FOLD_THREADS) h[b] += s_cnt[b];
}

// The survivors: the kept lanes in ascending order.  Warp w takes words
// [w0, w1) of the mask, 32 at a time.
__device__ void fold_survivors(const FoldArgs& a, long long start,
                               int* s_warp) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const long long words = (a.padded + 15) / 16;
  const long long per_warp =
      (words + 32LL * FOLD_WARPS - 1) / (32LL * FOLD_WARPS) * 32;
  const long long w0 = warp * per_warp;
  const long long w1 = w0 + per_warp < words ? w0 + per_warp : words;
  int mine = 0;
#pragma unroll 16
  for (long long w = w0 + lane; w < w1; w += 32)
    mine += kept_in(keep_word(a.keep, a.padded, w));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(FOLD_FULL, mine, o);
  if (lane == 0) s_warp[warp] = mine;
  __syncthreads();
  long long before = 0, total = 0;
#pragma unroll
  for (int i = 0; i < FOLD_WARPS; ++i) {
    const int n = s_warp[i];
    total += n;
    before += i < warp ? n : 0;
  }
  if (t == 0) *a.count = total;
  if (mine > 0 && before < a.cap)
    for (long long w = w0; w < w1 && before < a.cap; w += 32) {
      const uint4 u = w + lane < w1 ? keep_word(a.keep, a.padded, w + lane)
                                    : make_uint4(0u, 0u, 0u, 0u);
      const int n = kept_in(u);
      int incl = n;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FOLD_FULL, incl, o);
        if (lane >= o) incl += y;
      }
      if (n) {
        long long r = before + incl - n;
        const unsigned wd[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          if (!((wd[b >> 2] >> (8 * (b & 3))) & 0xffu)) continue;
          if (r < a.cap) {
            const long long p = 16 * (w + lane) + b;
            a.flat[r] = start + p;
            for (int c = 0; c < a.d; ++c)
              a.vals[r * a.d + c] =
                  a.Fd[static_cast<long long>(c) * a.padded + p];
          }
          ++r;
        }
      }
      before += __shfl_sync(FOLD_FULL, incl, 31);
    }
}

// Kernel F: fold_blocks(d, bins) blocks of FOLD_THREADS threads fold one
// chunk, a part a block; R pairs a lane in the top-k selections
// (fold_lists(k)).
template <int R>
__global__ void __launch_bounds__(FOLD_THREADS, 1)
fold_kernel(const FoldArgs a) {
  extern __shared__ double f_smem[];
  __shared__ int s_sel[FOLD_MAX_K];
  __shared__ int s_warp[FOLD_WARPS];
  __shared__ double s_min[FOLD_WARPS];
  const long long start = a.off + (a.base ? *a.base : 0LL);
  const int part = blockIdx.x;
  if (part < a.d) {
    double* s_v = f_smem;
    long long* s_x =
        reinterpret_cast<long long*>(s_v + FOLD_WARPS * 32 * R);
    fold_topk<R>(a, part, start, s_v, s_x, s_sel, s_min);
  } else if (part == a.d) {
    fold_argmin(a);
  } else if (part == a.d + 1) {
    fold_survivors(a, start, s_warp);
  } else {
    fold_hist(a, part - a.d - 2, reinterpret_cast<unsigned*>(f_smem));
  }
}

}  // namespace sweep_grid
