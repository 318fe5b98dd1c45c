// Eq. 1-11 of the DOSC power model for one configuration, in float64.
//
// eval_config() is the one device function both sweep-grid kernels call
// (kernel A, the fused chunk step, and kernel B, the evaluate-only dense
// variant; see sweep_grid.cu), so dense, probe, fallback and chunk values
// agree to the bit on the card.  It computes the eleven FIELDS of
// repro_torch/core/sweep.py in exactly the operation order of
// config_eval() there (and of the reference's _make_config_fn): built
// with --fmad=false and IEEE division, every multiply, add and divide
// rounds where the plain PyTorch version's does.
#pragma once

#include <cmath>
#include <cstdint>

namespace sweep_grid {

constexpr int N_AXES = 10;     // model, cut, agg, sensor, wmem + 5 knobs
constexpr int N_INDEX_AXES = 5;
constexpr int N_FIELDS = 11;   // sweep.FIELDS

// Tables the model reads, in the order of kernel.KERNEL_TABLES.  The
// per-network prefix-sum tables sit in the same order for DetNet and
// KeyNet, so T_DET_MACS + j and T_KEY_MACS + j name the same table.
enum Table {
  T_DET_NL, T_KEY_NL, T_DET_IN,
  T_DET_MACS, T_DET_WB, T_DET_WS, T_DET_ACT, T_DET_CYS, T_DET_CYA,
  T_DET_PKP, T_DET_PKS,
  T_KEY_MACS, T_KEY_WB, T_KEY_WS, T_KEY_ACT, T_KEY_CYS, T_KEY_CYA,
  T_KEY_PKP, T_KEY_PKS,
  T_E_MAC, T_F_CLK, T_SRAM_ER, T_SRAM_EW, T_SRAM_LON, T_SRAM_LRET,
  T_WM_ER, T_WM_LON, T_WM_LRET,
  T_PAY_CAM, T_PAY_DET, T_PAY_KEY, T_PAY_MAX,
  N_TABLES
};

// The packed float64 table buffer: table t starts at off[t]; a 2-D table
// has rows of w[t] entries.  Every index the model forms stays inside its
// table (sweep.build_axes validates the index axes against these
// extents, cuts are clipped to each model's layer counts, padding lanes
// decode in range), so no read is clamped here.
struct Tables {
  const double* p;
  long long off[N_TABLES];
  long long w[N_TABLES];
};

// Physical constants of the camera and the two links, from
// repro_torch/core/arrays.py (passed in so the two sides cannot drift).
struct Consts {
  double sense_w, read_w, idle_w, t_sense, mipi_e, mipi_bw, utsv_e, utsv_bw,
      full_frame, l1_scale, sensor_l1, agg_l1;
};

// Grid geometry: C-order mixed-radix decode of a flat index, and the
// per-axis value arrays (int64 for the index axes, float64 for the knobs).
struct Grid {
  long long size[N_AXES];
  long long stride[N_AXES];
  const void* ax[N_AXES];
  long long n_total;
};

__device__ __forceinline__ double tab1(const Tables& T, int t, long long i) {
  return T.p[T.off[t] + i];
}

__device__ __forceinline__ double tab2(const Tables& T, int t, long long r,
                                       long long c) {
  return T.p[T.off[t] + r * T.w[t] + c];
}

// min/max that propagate NaN, as jnp.minimum and torch.minimum do (fmin
// and fmax drop it, and invalid MRAM corners carry NaN through here).
__device__ __forceinline__ double nan_min(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmin(a, b);
}

__device__ __forceinline__ double nan_max(double a, double b) {
  return (isnan(a) || isnan(b)) ? a + b : fmax(a, b);
}

// Coordinates of one flat index; int32 arithmetic when the index space
// allows it (int64 division is several times slower on the card).
__device__ __forceinline__ void decode(const Grid& G, long long flat,
                                       bool small, long long* c) {
  if (small) {
    const int f = static_cast<int>(flat);
#pragma unroll
    for (int a = 0; a < N_AXES; ++a)
      c[a] = (f / static_cast<int>(G.stride[a])) %
             static_cast<int>(G.size[a]);
  } else {
#pragma unroll
    for (int a = 0; a < N_AXES; ++a) c[a] = (flat / G.stride[a]) % G.size[a];
  }
}

// Eqs. 7-11 for one processor site (reference sweep._site_power).
__device__ __forceinline__ void site_power(
    double macs, double w_read, double act, double cycles, double f_clk,
    double e_mac, double wm_e_read, double wm_leak_on, double wm_leak_ret,
    double sram_e_read, double sram_e_write, double sram_leak_on,
    double sram_leak_ret, double cap_w, double cap_a, double l1_bytes,
    double l1_scale, double* p_comp, double* p_mem) {
  const double p_compute = macs * e_mac;
  const double act_read = act / 2.0;
  const double act_write = act / 2.0;
  const double l1_traffic = w_read + act_read + act_write;
  const double p_l2w = w_read * wm_e_read;
  const double p_l2a = act_read * sram_e_read + act_write * sram_e_write;
  const double p_l1 = l1_traffic / 2.0 * (l1_scale * sram_e_read) +
                      l1_traffic / 2.0 * (l1_scale * sram_e_write);
  const double t_proc = nan_min(1.0, cycles / f_clk);
  const double t_idle = nan_max(0.0, 1.0 - t_proc);
  const double p_leak =
      cap_w * (wm_leak_on * t_proc + wm_leak_ret * t_idle) +
      cap_a * (sram_leak_on * t_proc + sram_leak_ret * t_idle) +
      l1_bytes * (sram_leak_on * t_proc + sram_leak_ret * t_idle);
  *p_comp = p_compute;
  *p_mem = p_l2w + p_l2a + p_l1 + p_leak;
}

// The model at grid coordinates c[0..N_AXES): writes out[N_FIELDS] in
// sweep.FIELDS order.
__device__ __forceinline__ void eval_config(const Tables& T, const Consts& C,
                                            const Grid& G, const long long* c,
                                            double* out) {
#define IAX(a) static_cast<const long long*>(G.ax[a])[c[a]]
#define FAX(a) static_cast<const double*>(G.ax[a])[c[a]]
  const long long m = IAX(0);
  const long long cut = IAX(1);
  const long long agg = IAX(2);
  const long long sen = IAX(3);
  const long long wm = IAX(4);
  const double det_fps = FAX(5);
  const double key_fps = FAX(6);
  const double ncam = FAX(7);
  const double mipi_scale = FAX(8);
  const double cam_fps = FAX(9);
#undef IAX
#undef FAX

  const long long n_det = static_cast<long long>(tab1(T, T_DET_NL, m));
  const long long n_key = static_cast<long long>(tab1(T, T_KEY_NL, m));
  const long long n_all = n_det + n_key;
  const long long cd = cut < 0 ? 0 : (cut > n_det ? n_det : cut);
  const long long ck0 = cut - n_det;
  const long long ck = ck0 < 0 ? 0 : (ck0 > n_key ? n_key : ck0);
  const bool has_sensor = cut > 0;
  const bool has_agg = cut < n_all;
  const double f_sen = tab1(T, T_F_CLK, sen);
  const double f_agg = tab1(T, T_F_CLK, agg);

  // ---- Eq. 3/4: cameras (readout window set by camera-side link) ----
  const double t_comm_cam =
      C.full_frame / (has_sensor ? C.utsv_bw : C.mipi_bw);
  const double t_off = nan_max(0.0, 1.0 / cam_fps - C.t_sense - t_comm_cam);
  const double e_cam = C.sense_w * C.t_sense + C.read_w * t_comm_cam +
                       C.idle_w * t_off;
  const double p_camera = e_cam * cam_fps * ncam;

  // ---- Eq. 5: uTSV readout link (distributed only) ----
  const double p_utsv =
      has_sensor ? C.full_frame * C.utsv_e * cam_fps * ncam : 0.0;

  // ---- Eq. 5: MIPI payload plan for this cut ----
  const double bps_per_cam = tab2(T, T_PAY_CAM, m, cut) * cam_fps +
                             tab2(T, T_PAY_DET, m, cut) * det_fps +
                             tab2(T, T_PAY_KEY, m, cut) * key_fps;
  const double p_mipi = bps_per_cam * (C.mipi_e * mipi_scale) * ncam;
  const double mipi_bps = bps_per_cam * ncam;

  // ---- on-sensor site (x ncam replicas) ----
#define DET(t, i) tab2(T, T_DET_##t, m, i)
#define KEY(t, i) tab2(T, T_KEY_##t, m, i)
  const double macs_s = DET(MACS, cd) * det_fps + KEY(MACS, ck) * key_fps;
  const double w_read_s = DET(WS, cd) * det_fps + KEY(WS, ck) * key_fps;
  const double act_s = DET(ACT, cd) * det_fps + KEY(ACT, ck) * key_fps;
  const double cyc_s = DET(CYS, cd) * det_fps + KEY(CYS, ck) * key_fps;
  const double cap_w_s = DET(WB, cd) + KEY(WB, ck);
  const double cap_a_s =
      nan_max(DET(PKP, cd), KEY(PKP, ck)) + tab1(T, T_DET_IN, m);
  double p_comp_s, p_mem_s;
  site_power(macs_s, w_read_s, act_s, cyc_s, f_sen, tab1(T, T_E_MAC, sen),
             tab2(T, T_WM_ER, sen, wm), tab2(T, T_WM_LON, sen, wm),
             tab2(T, T_WM_LRET, sen, wm), tab1(T, T_SRAM_ER, sen),
             tab1(T, T_SRAM_EW, sen), tab1(T, T_SRAM_LON, sen),
             tab1(T, T_SRAM_LRET, sen), cap_w_s, cap_a_s, C.sensor_l1,
             C.l1_scale, &p_comp_s, &p_mem_s);
  const double p_sensor_compute = has_sensor ? p_comp_s * ncam : 0.0;
  const double p_sensor_memory = has_sensor ? p_mem_s * ncam : 0.0;

  // ---- aggregator site (suffix of each network, rate x ncam) ----
#define SUFFIX(t)                                                  \
  ((DET(t, n_det) - DET(t, cd)) * (det_fps * ncam) +               \
   (KEY(t, n_key) - KEY(t, ck)) * (key_fps * ncam))
  const double macs_a = SUFFIX(MACS);
  const double w_read_a = SUFFIX(WS);
  const double act_a = SUFFIX(ACT);
  const double cyc_a = SUFFIX(CYA);
#undef SUFFIX
  const double cap_w_a =
      (DET(WB, n_det) - DET(WB, cd)) + (KEY(WB, n_key) - KEY(WB, ck));
  const double cap_a_a = nan_max(DET(PKS, cd), KEY(PKS, ck)) +
                         tab2(T, T_PAY_MAX, m, cut) * ncam;
  double p_comp_a, p_mem_a;
  // the aggregator's weight memory is always its node SRAM
  site_power(macs_a, w_read_a, act_a, cyc_a, f_agg, tab1(T, T_E_MAC, agg),
             tab1(T, T_SRAM_ER, agg), tab1(T, T_SRAM_LON, agg),
             tab1(T, T_SRAM_LRET, agg), tab1(T, T_SRAM_ER, agg),
             tab1(T, T_SRAM_EW, agg), tab1(T, T_SRAM_LON, agg),
             tab1(T, T_SRAM_LRET, agg), cap_w_a, cap_a_a, C.agg_l1,
             C.l1_scale, &p_comp_a, &p_mem_a);
  const double p_agg_compute = has_agg ? p_comp_a : 0.0;
  const double p_agg_memory = has_agg ? p_mem_a : 0.0;

  // ---- end-to-end result latency (cut_latency, lowered: Eq. 6/9) ----
  const double det_amort = nan_min(1.0, det_fps / cam_fps);
  const double t_det_sen = DET(CYS, cd) / f_sen * det_amort;
  const double t_det_agg = (DET(CYA, n_det) - DET(CYA, cd)) / f_agg * det_amort;
  const double t_key_sen = KEY(CYS, ck) / f_sen;
  const double t_key_agg = (KEY(CYA, n_key) - KEY(CYA, ck)) / f_agg;
#undef DET
#undef KEY
  const double t_comm_cut =
      (tab2(T, T_PAY_DET, m, cut) * det_amort + tab2(T, T_PAY_KEY, m, cut)) /
      C.mipi_bw;
  const double latency = C.t_sense + t_comm_cam + t_det_sen + t_det_agg +
                         t_comm_cut + (ncam - 1.0) * (t_det_agg + t_key_agg) +
                         t_key_sen + t_key_agg;

  // Invalid (node, weight-mem) corners poison every channel; a cut beyond
  // this model's own range (stacked models) too (+0.0 when in range).
  const double pad = cut <= n_all ? 0.0 : NAN;
  const double invalid =
      (has_sensor ? tab2(T, T_WM_ER, sen, wm) * 0.0 : 0.0) + pad;

  const double total = p_camera + p_utsv + p_mipi + p_sensor_compute +
                       p_sensor_memory + p_agg_compute + p_agg_memory;
  out[0] = total + pad;                      // avg_power
  out[1] = p_camera + pad;                   // camera
  out[2] = p_utsv + pad;                     // utsv
  out[3] = p_mipi + pad;                     // mipi
  out[4] = p_sensor_compute + pad;           // sensor_compute
  out[5] = p_sensor_memory + pad;            // sensor_memory
  out[6] = p_agg_compute + pad;              // agg_compute
  out[7] = p_agg_memory + pad;               // agg_memory
  out[8] = mipi_bps + invalid;               // mipi_bytes_per_s
  out[9] = (has_sensor ? macs_s * ncam : 0.0) + invalid;  // sensor_macs_per_s
  out[10] = latency + invalid;               // latency
}

}  // namespace sweep_grid
