"""The rig's Eq. 1-11 and its session model, over lanes of configurations.

A frozen copy of the plain evaluation (the reference repo's
``sweep.config_eval`` and ``scenario.session_eval``), written once
against an operations object ``X`` so that the same expression runs on
tensors (:class:`TorchOps`, in any float dtype: float64 is the reference,
float32 the control) and on symbols (:mod:`.opcount` counts it).  Every
quotient is an IEEE division of two tensors, in the reference's order of
operations.

``T`` maps a table name of :func:`.rig.rig_tables` to something indexed
by lane tensors; ``n_det`` and ``n_key`` are the networks' layer counts.
"""

from __future__ import annotations

import torch

from . import rig as R

STEP_COLUMNS = ("dt", "det_scale", "key_scale", "cam_scale", "cams_active")


class TorchOps:
    """Tensor operations in one float dtype; a Python number operand
    becomes a full tensor of that dtype before the operation."""

    def __init__(self, dtype=torch.float64):
        self.dtype = dtype

    def _t(self, a, like):
        if isinstance(a, torch.Tensor):
            return a
        return torch.full(like.shape, a, dtype=self.dtype,
                          device=like.device)

    def div(self, a, b):
        like = b if isinstance(b, torch.Tensor) else a
        return torch.div(self._t(a, like), self._t(b, like))

    def minimum(self, a, b):
        return torch.minimum(a, self._t(b, a))

    def maximum(self, a, b):
        return torch.maximum(a, self._t(b, a))

    def where(self, cond, a, b):
        return torch.where(cond, self._t(a, cond), self._t(b, cond))

    def exp(self, a):
        return torch.exp(a)

    def isfinite(self, a):
        return torch.isfinite(a)

    def pow(self, a, p: float):
        return a ** p

    def clamp_int(self, a, lo: int, hi: int):
        return torch.clamp(a, lo, hi)

    def full_like(self, like, v: float):
        return torch.full(like.shape, v, dtype=self.dtype,
                          device=like.device)


def _site_power(X, macs, w_read, act, cycles, f_clk, e_mac, wm_e_read,
                wm_leak_on, wm_leak_ret, sram_e_read, sram_e_write,
                sram_leak_on, sram_leak_ret, cap_w, cap_a, l1_bytes):
    """Eq. 7-11 for one processor site: compute, L2-weight, L2-activation
    and L1 access energy, On/Retention leakage of the three memories."""
    p_compute = macs * e_mac
    act_read = act / 2
    act_write = act / 2
    l1_traffic = w_read + act_read + act_write
    p_l2w = w_read * wm_e_read
    p_l2a = act_read * sram_e_read + act_write * sram_e_write
    p_l1 = (l1_traffic / 2 * (R.L1_ENERGY_SCALE * sram_e_read)
            + l1_traffic / 2 * (R.L1_ENERGY_SCALE * sram_e_write))
    t_proc = X.minimum(X.div(cycles, f_clk), 1.0)
    t_idle = X.maximum(1.0 - t_proc, 0.0)
    p_leak = (cap_w * (wm_leak_on * t_proc + wm_leak_ret * t_idle)
              + cap_a * (sram_leak_on * t_proc + sram_leak_ret * t_idle)
              + l1_bytes * (sram_leak_on * t_proc + sram_leak_ret * t_idle))
    return p_compute, p_l2w + p_l2a + p_l1 + p_leak


def config_eval(X, T, n_det: int, n_key: int, cut, agg, sen, wm, det_fps,
                key_fps, ncam, mipi_scale, cam_fps) -> dict:
    """Eq. 1-11 for every lane: the eleven channels of the rig (power and
    its seven parts, MIPI bytes/s, sensor MAC/s, latency).  The index
    lanes are integer tensors, the knob lanes float tensors."""
    n_all = n_det + n_key
    cd = X.clamp_int(cut, 0, n_det)
    ck = X.clamp_int(cut - n_det, 0, n_key)
    has_sensor = cut > 0
    has_agg = cut < n_all
    f_sen, f_agg = T["f_clk"][sen], T["f_clk"][agg]

    def det(name, i):
        return T["det." + name][i]

    def key(name, i):
        return T["key." + name][i]

    # Eq. 3/4: cameras; the readout window is set by the camera-side link
    t_comm_cam = X.where(has_sensor, R.FULL_FRAME / R.UTSV_BW,
                         R.FULL_FRAME / R.MIPI_BW)
    t_off = X.maximum(X.div(1.0, cam_fps) - R.T_SENSE - t_comm_cam, 0.0)
    e_cam = (R.CAMERA_SENSE_W * R.T_SENSE + R.CAMERA_READ_W * t_comm_cam
             + R.CAMERA_IDLE_W * t_off)
    p_camera = e_cam * cam_fps * ncam
    # Eq. 5: the uTSV readout link (distributed only) and the MIPI payloads
    p_utsv = X.where(has_sensor,
                     R.FULL_FRAME * R.UTSV_E_PER_BYTE * cam_fps * ncam, 0.0)
    bps_per_cam = (T["pay_cam_rate"][cut] * cam_fps
                   + T["pay_det_rate"][cut] * det_fps
                   + T["pay_key_rate"][cut] * key_fps)
    p_mipi = bps_per_cam * (R.MIPI_E_PER_BYTE * mipi_scale) * ncam
    mipi_bps = bps_per_cam * ncam

    # on-sensor site (x ncam replicas)
    macs_s = det("c_macs", cd) * det_fps + key("c_macs", ck) * key_fps
    w_read_s = (det("c_weight_stream", cd) * det_fps
                + key("c_weight_stream", ck) * key_fps)
    act_s = (det("c_act_traffic", cd) * det_fps
             + key("c_act_traffic", ck) * key_fps)
    cyc_s = (det("c_cycles_sensor", cd) * det_fps
             + key("c_cycles_sensor", ck) * key_fps)
    cap_w_s = det("c_weight_bytes", cd) + key("c_weight_bytes", ck)
    cap_a_s = (X.maximum(det("peak_prefix", cd), key("peak_prefix", ck))
               + T["det.input_bytes"])
    p_comp_s, p_mem_s = _site_power(
        X, macs_s, w_read_s, act_s, cyc_s, f_sen, T["e_mac"][sen],
        T["wm_e_read"][sen, wm], T["wm_leak_on"][sen, wm],
        T["wm_leak_ret"][sen, wm], T["sram_e_read"][sen],
        T["sram_e_write"][sen], T["sram_leak_on"][sen],
        T["sram_leak_ret"][sen], cap_w_s, cap_a_s, R.SENSOR_L1_BYTES)
    p_sensor_compute = X.where(has_sensor, p_comp_s * ncam, 0.0)
    p_sensor_memory = X.where(has_sensor, p_mem_s * ncam, 0.0)

    # aggregator site (each network's suffix, rate x ncam)
    def suffix(name):
        return ((det(name, n_det) - det(name, cd)) * (det_fps * ncam)
                + (key(name, n_key) - key(name, ck)) * (key_fps * ncam))

    cap_w_a = ((det("c_weight_bytes", n_det) - det("c_weight_bytes", cd))
               + (key("c_weight_bytes", n_key) - key("c_weight_bytes", ck)))
    cap_a_a = (X.maximum(det("peak_suffix", cd), key("peak_suffix", ck))
               + T["pay_max"][cut] * ncam)
    p_comp_a, p_mem_a = _site_power(
        X, suffix("c_macs"), suffix("c_weight_stream"),
        suffix("c_act_traffic"), suffix("c_cycles_agg"), f_agg,
        T["e_mac"][agg], T["sram_e_read"][agg], T["sram_leak_on"][agg],
        T["sram_leak_ret"][agg], T["sram_e_read"][agg],
        T["sram_e_write"][agg], T["sram_leak_on"][agg],
        T["sram_leak_ret"][agg], cap_w_a, cap_a_a, R.AGG_L1_BYTES)
    p_agg_compute = X.where(has_agg, p_comp_a, 0.0)
    p_agg_memory = X.where(has_agg, p_mem_a, 0.0)

    # end-to-end result latency (Eq. 6/9)
    det_amort = X.minimum(X.div(det_fps, cam_fps), 1.0)
    t_det_sen = X.div(det("c_cycles_sensor", cd), f_sen) * det_amort
    t_det_agg = X.div(det("c_cycles_agg", n_det) - det("c_cycles_agg", cd),
                      f_agg) * det_amort
    t_key_sen = X.div(key("c_cycles_sensor", ck), f_sen)
    t_key_agg = X.div(key("c_cycles_agg", n_key) - key("c_cycles_agg", ck),
                      f_agg)
    t_comm_cut = X.div(T["pay_det_rate"][cut] * det_amort
                       + T["pay_key_rate"][cut], R.MIPI_BW)
    latency = (R.T_SENSE + t_comm_cam + t_det_sen + t_det_agg
               + t_comm_cut + (ncam - 1.0) * (t_det_agg + t_key_agg)
               + t_key_sen + t_key_agg)

    # a weight memory the sensor node lacks (NaN tables) poisons a
    # configuration that puts layers on the sensor
    invalid = X.where(has_sensor, T["wm_e_read"][sen, wm] * 0.0, 0.0)
    total = (p_camera + p_utsv + p_mipi + p_sensor_compute
             + p_sensor_memory + p_agg_compute + p_agg_memory)
    return {
        "avg_power": total, "camera": p_camera, "utsv": p_utsv,
        "mipi": p_mipi, "sensor_compute": p_sensor_compute,
        "sensor_memory": p_sensor_memory, "agg_compute": p_agg_compute,
        "agg_memory": p_agg_memory,
        "mipi_bytes_per_s": mipi_bps + invalid,
        "sensor_macs_per_s": X.where(has_sensor, macs_s * ncam, 0.0)
        + invalid,
        "latency": latency + invalid,
    }


def session_eval(X, T, n_det: int, n_key: int, sess: dict, steps: dict,
                 cut, agg, sen, wm, det_fps, key_fps, ncam, mipi_scale,
                 cam_fps, trace) -> dict:
    """Every static field and the four session channels for every lane.

    ``sess`` holds the battery and thermal parameters (the configuration's
    ``battery`` and ``thermal``); ``steps`` maps each name of
    :data:`STEP_COLUMNS` to a ``(n_traces, n_steps)`` table indexed by
    ``[trace, step]``.  The static fields are evaluated once at the base
    knobs, then each step re-evaluates Eq. 1-11 at the phase's scaled
    knobs times the throttle factor and advances the battery's charge and
    the case's RC node by its exact step response.
    """
    bat, th = sess["battery"], sess["thermal"]
    base = (n_det, n_key, cut, agg, sen, wm)
    static = config_eval(X, T, *base, det_fps, key_fps, ncam, mipi_scale,
                         cam_fps)
    like = det_fps
    t = X.full_like(like, 0.0)
    soc = X.full_like(like, bat["soc0"])
    temp = X.full_like(like, th["ambient_c"])
    peak = X.full_like(like, th["ambient_c"])
    throttled = X.full_like(like, 0.0)
    energy = X.full_like(like, 0.0)
    tte = X.full_like(like, float("inf"))
    rc = th["r_th_k_per_w"] * th["c_th_j_per_k"]
    for s in range(steps["dt"].shape[-1]):
        dt, dsc, ksc, csc, act = (steps[c][trace, s] for c in STEP_COLUMNS)
        thr = X.minimum(X.maximum(
            1.0 - th["throttle_gain_per_c"] * X.maximum(
                temp - th["throttle_onset_c"], 0.0),
            th["throttle_floor"]), 1.0)
        power = config_eval(X, T, *base, det_fps * (dsc * thr),
                            key_fps * (ksc * thr), ncam * act, mipi_scale,
                            cam_fps * csc)["avg_power"]
        drain = power * X.pow(X.div(power, bat["p_ref_w"]),
                              bat["peukert"] - 1.0)
        soc_new = soc - X.div(drain * dt, bat["capacity_j"])
        t_ss = th["ambient_c"] + power * th["r_th_k_per_w"]
        temp_new = t_ss + (temp - t_ss) * X.exp(X.div(-dt, rc))
        live = dt > 0.0
        soc_new = X.where(live, soc_new, soc)
        temp_new = X.where(live, temp_new, temp)
        cross = (soc > 0.0) & (soc_new <= 0.0)
        tte = X.where(cross, t + X.div(soc * bat["capacity_j"], drain), tte)
        t, soc, temp = t + dt, soc_new, temp_new
        peak = X.maximum(peak, temp_new)
        throttled = throttled + dt * (thr < 1.0)
        energy = energy + power * dt
    # finalize: the static power poisons invalid configurations; with no
    # crossing in the session, the session's average drain is
    # extrapolated (sessions repeat back to back until empty)
    poison = static["avg_power"] * 0.0
    drained = bat["soc0"] - soc
    extrap = X.where(drained > 0.0, X.div(t * bat["soc0"], drained),
                     float("inf"))
    tte = X.where(X.isfinite(tte), tte, extrap)
    live = t > 0.0
    frac = X.where(live, X.div(throttled, X.where(live, t, 1.0)), 0.0)
    out = dict(static)
    out.update({"session_energy_j": energy + poison,
                "time_to_empty_s": tte + poison,
                "peak_case_temp_c": peak + poison,
                "throttle_fraction": frac + poison})
    return out
