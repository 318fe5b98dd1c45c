"""State-space and recurrent blocks of the port's LM: Mamba (Jamba) and
xLSTM (sLSTM + mLSTM) (the reference's ``repro/models/ssm.py``).

Training and prompt paths:

* **Mamba** — the selective scan as a loop over time with an
  O(B·d_inner·N) float32 carry, ``h = da·h + dbx`` then the ``C``
  contraction, in the reference's order.  The elementwise inputs of the
  recurrence (``da = exp(dt·A)``, ``dbx = dt·x·B``) are the reference's
  values made :data:`MAMBA_CHUNK` steps at a time before the steps run,
  and the ``C`` contraction runs once a chunk on the stacked states, so a
  step is one ``addcmul``.
* **mLSTM** — the stabilized parallel (quadratic) form of the xLSTM
  paper, blockwise like flash attention: a loop over the causal (query
  block, key block) pairs in the reference's order, with no (S, S) decay
  matrix.
* **sLSTM** — a true recurrence, a loop over time.  The input products
  ``x @ w_g`` of the four gates are one matmul over every step before
  the loop, and a step's four recurrent products one batched matmul.

Decode paths are O(1)-state single-step updates.  Every state is a new
tensor each step (none is updated in place), so states may be kept and
compared.  Dtypes follow the reference cast for cast: the projections
run in the compute dtype; Mamba's ``B``, ``C``, ``dt``, scan and skip,
the mLSTM gates, stabilizers and memories and the sLSTM cell run in
float32; ``A_log``, ``D``, ``dt_bias``, ``w_ig``, ``b_ig``, ``w_fg``,
``b_fg`` and the sLSTM biases are float32 in a bf16 model.  Mamba's
prompt conv takes the compute dtype (a float32 tap sum rounded once,
then the bias), its decode conv float32, as in the reference.

No Pallas kernel: the reference's scans are ``lax.scan`` over jnp and
its conv ``lax.conv_general_dilated``; these are torch ops on every
device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.loop_marks import fused_loop

from .common import ModelConfig
from .layers import normal
from .sharding import BATCH, MODEL, local_region, pointwise

NEG_INF = -2.0e38
#: Time steps of the Mamba scan whose ``da`` and ``dbx`` are made at once
#: (at jamba-v0.1-52b's d_inner 8192, N 16 and one sequence: 128 MB of
#: float32 each).
MAMBA_CHUNK = 256


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, exact for every x (torch's
    ``softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


# ===========================================================================
# Mamba
# ===========================================================================


class MambaState(NamedTuple):
    conv: torch.Tensor   # (B, W-1, d_inner) — last W-1 post-in_proj inputs
    ssm: torch.Tensor    # (B, d_inner, N) float32


def _mamba_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    di = cfg.ssm_expand * cfg.d_model
    return di, cfg.ssm_state_dim, cfg.ssm_conv_width, max(1, cfg.d_model // 16)


def mamba_init(cfg: ModelConfig, dtype, generator, device) -> dict:
    d = cfg.d_model
    di, n, w, dt_rank = _mamba_dims(cfg)
    f32 = torch.float32
    return {
        "in_proj": normal((d, 2 * di), d ** -0.5, dtype, generator, device),
        "conv_w": normal((w, di), w ** -0.5, dtype, generator, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "w_bcdt": normal((di, 2 * n + dt_rank), di ** -0.5, dtype,
                         generator, device),
        "dt_proj": normal((dt_rank, di), dt_rank ** -0.5, dtype, generator,
                          device),
        "dt_bias": torch.full((di,), math.log(math.e - 1), dtype=f32,
                              device=device),
        "A_log": torch.log(torch.arange(1, n + 1, dtype=f32, device=device)
                           ).expand(di, n).contiguous(),
        "D": torch.ones((di,), dtype=f32, device=device),
        "out_proj": normal((di, d), di ** -0.5, dtype, generator, device),
    }


def _mamba_conv_full(params: dict, xin: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv over (B, S, di) in ``xin``'s dtype: the W
    taps summed in float32 (tap 0 first) and rounded once, then the
    bias added in the dtype (the reference's ``conv_general_dilated``
    with ``feature_group_count = di``)."""
    w = params["conv_w"].shape[0]
    s = xin.shape[1]
    pad = F.pad(xin, (0, 0, w - 1, 0))
    taps = params["conv_w"].float()
    acc = pad[:, 0:s].float() * taps[0]
    for k in range(1, w):
        acc = acc + pad[:, k:k + s].float() * taps[k]
    return acc.to(xin.dtype) + params["conv_b"]


def _mamba_ssm_inputs(cfg: ModelConfig, params: dict, xc: torch.Tensor):
    """A (di, N), and B, C (B, S, N) and dt (B, S, di) in float32."""
    _, n, _, _ = _mamba_dims(cfg)
    bcdt = xc @ params["w_bcdt"]
    b_mat = bcdt[..., :n].float()
    c_mat = bcdt[..., n:2 * n].float()
    dt = _softplus(bcdt[..., 2 * n:].float() @ params["dt_proj"].float()
                   + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    return a, b_mat, c_mat, dt


def _mamba_scan(a, b_mat, c_mat, dt, x32) -> torch.Tensor:
    """The selective scan from a zero state: y_t = C_t · h_t with h_t =
    exp(dt_t·A)·h_{t-1} + dt_t·x_t·B_t, float32; returns (B, S, di)."""
    b, s, di = dt.shape
    h = torch.zeros((b, di, a.shape[1]), dtype=torch.float32,
                    device=dt.device)
    ys = []
    with fused_loop(s):     # the reference's scan body, at depth 2
        for t0 in range(0, s, MAMBA_CHUNK):
            # the chunk's block of each input (narrow: a slice even over
            # the whole sequence, which indexing would elide)
            dtc, xc, bc, cc = (t.narrow(1, t0, min(s, t0 + MAMBA_CHUNK)
                                        - t0).transpose(0, 1)
                               for t in (dt, x32, b_mat, c_mat))
            da = torch.exp(dtc[..., None] * a)                 # (T, B, di, N)
            dbx = (dtc * xc)[..., None] * bc[:, :, None, :]
            hs = []
            for da_t, dbx_t in zip(da.unbind(0), dbx.unbind(0)):
                h = torch.addcmul(dbx_t, da_t, h)              # da·h + dbx
                hs.append(h)
            ys.append(torch.einsum("tbdn,tbn->tbd", torch.stack(hs), cc))
    return torch.cat(ys).transpose(0, 1)


def mamba_forward(cfg: ModelConfig, params: dict,
                  x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    xz = x @ params["in_proj"]
    xin, z = xz.chunk(2, dim=-1)
    xc = F.silu(_mamba_conv_full(params, xin))
    a, b_mat, c_mat, dt = _mamba_ssm_inputs(cfg, params, xc)
    x32 = xc.float()
    # on local shards under a mesh: batch and channels split, S whole
    y = local_region(_mamba_scan, (a, b_mat, c_mat, dt, x32),
                     ((MODEL, None), (BATCH, None, None),
                      (BATCH, None, None), (BATCH, None, MODEL),
                      (BATCH, None, MODEL)),
                     (BATCH, None, MODEL), dt.shape) + params["D"] * x32
    y = y.to(x.dtype) * F.silu(z)
    return y @ params["out_proj"]


def mamba_init_state(cfg: ModelConfig, batch: int, dtype,
                     device) -> MambaState:
    di, n, w, _ = _mamba_dims(cfg)
    return MambaState(
        conv=torch.zeros((batch, w - 1, di), dtype=dtype, device=device),
        ssm=torch.zeros((batch, di, n), dtype=torch.float32, device=device))


def mamba_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                 state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """x: (B, 1, d); O(1) single-step update.  The conv runs in float32
    and is cast to the dtype after the SiLU, as in the reference (its
    prompt path rounds the conv to the dtype first)."""
    xz = x[:, 0] @ params["in_proj"]
    xin, z = xz.chunk(2, dim=-1)                               # (B, di)
    window = torch.cat([state.conv, xin[:, None]], dim=1)      # (B, W, di)
    xc = F.silu((window.float() * params["conv_w"].float()).sum(1)
                + params["conv_b"].float()).to(x.dtype)
    a, b_mat, c_mat, dt = _mamba_ssm_inputs(cfg, params, xc[:, None])
    bt, ct, dtt = b_mat[:, 0], c_mat[:, 0], dt[:, 0]
    x32 = xc.float()
    da = torch.exp(dtt[..., None] * a)
    dbx = (dtt * x32)[..., None] * bt[:, None, :]
    h = torch.addcmul(dbx, da, state.ssm)                      # da·h + dbx
    yt = torch.einsum("bdn,bn->bd", h, ct) + params["D"] * x32
    y = (yt.to(x.dtype) * F.silu(z)) @ params["out_proj"]
    return y[:, None], MambaState(conv=window[:, 1:], ssm=h)


# ===========================================================================
# mLSTM (xLSTM) — parallel blockwise training form + recurrent decode
# ===========================================================================


class MLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd, hd) matrix memory
    n: torch.Tensor   # (B, H, hd)
    m: torch.Tensor   # (B, H) stabilizer


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    di = 2 * cfg.d_model
    h = cfg.num_heads
    return di, h, di // h


def mlstm_init(cfg: ModelConfig, dtype, generator, device) -> dict:
    d = cfg.d_model
    di, h, _ = _mlstm_dims(cfg)
    s, si = d ** -0.5, di ** -0.5
    f32 = torch.float32
    return {
        "w_up": normal((d, 2 * di), s, dtype, generator, device),
        "w_q": normal((di, di), si, dtype, generator, device),
        "w_k": normal((di, di), si, dtype, generator, device),
        "w_v": normal((di, di), si, dtype, generator, device),
        "w_ig": normal((di, h), si, f32, generator, device),
        "b_ig": torch.zeros((h,), dtype=f32, device=device),
        "w_fg": normal((di, h), si, f32, generator, device),
        "b_fg": torch.full((h,), 3.0, dtype=f32, device=device),
        "w_down": normal((di, d), si, dtype, generator, device),
    }


def mlstm_parallel(q, k, v, log_i, log_f, q_block: int = 256,
                   kv_block: int = 256) -> torch.Tensor:
    """Stabilized parallel mLSTM (xLSTM eq. 19-27), blockwise.

    q/k/v: (B, S, H, hd); log_i/log_f: (B, S, H).
    D_ij = exp(F_i - F_j + log_i_j) for j <= i, F_t = cumsum(log_f).
    h_i = sum_j (q_i k_j / sqrt(hd)) D~_ij v_j / max(|den|, exp(-m_i)).
    S must be a multiple of both blocks (each capped at S), as the
    reference asserts; nothing is padded.
    """
    b, s, h, hd = q.shape
    q_block = min(q_block, s)
    kv_block = min(kv_block, s)
    if s % q_block or s % kv_block:
        raise ValueError(f"mlstm_parallel: S = {s} is not a multiple of "
                         f"the blocks ({q_block}, {kv_block})")
    scale = hd ** -0.5
    dev = q.device
    # (B, H, S, ...) layout: each block's products are batched matmuls
    qh, kh, vh = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    fh = torch.cumsum(log_f.float(), dim=1).permute(0, 2, 1)   # (B, H, S)
    ih = log_i.float().permute(0, 2, 1)
    rows = []
    with fused_loop((s // q_block) * (s // kv_block)):   # its pair scan
        for qi in range(s // q_block):
            rows.append(_mlstm_row_block(qh, kh, vh, fh, ih, qi, q_block,
                                         kv_block, scale))
    # normalised after the scan, as the reference does
    out = []
    for o, l, m in rows:
        m_safe = torch.where(m <= NEG_INF / 2, 0.0, m)
        den = torch.maximum(l.abs(), torch.exp(-m_safe))[..., None]
        out.append(o / den)
    return torch.cat(out, dim=2).permute(0, 2, 1, 3).to(q.dtype)


def _mlstm_row_block(qh, kh, vh, fh, ih, qi, q_block, kv_block, scale):
    """One q block of :func:`mlstm_parallel`: its kv blocks up to the
    causal limit, online; (o, l, m), o (B, H, q_block, hd) not yet
    normalised."""
    b, h, s, hd = qh.shape
    dev = qh.device
    qs = slice(qi * q_block, (qi + 1) * q_block)
    qpos = torch.arange(qs.start, qs.stop, device=dev)
    o = torch.zeros((b, h, q_block, hd), dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, q_block), dtype=torch.float32, device=dev)
    m = torch.full((b, h, q_block), NEG_INF, dtype=torch.float32,
                   device=dev)
    for kj in range(s // kv_block):
        if kj * kv_block > qs.stop - 1:
            break
        ks = slice(kj * kv_block, (kj + 1) * kv_block)
        kpos = torch.arange(ks.start, ks.stop, device=dev)
        # decay logits (B, H, qb, kb)
        logd = fh[:, :, qs, None] - fh[:, :, None, ks] + ih[:, :, None, ks]
        logd = torch.where(kpos[None, :] <= qpos[:, None], logd, NEG_INF)
        m_new = torch.maximum(m, logd.amax(-1))
        m_safe = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
        dmat = torch.exp(logd - m_safe[..., None])
        s_qk = (qh[:, :, qs] @ kh[:, :, ks].transpose(-1, -2)) * scale
        a = s_qk * dmat
        alpha = torch.where(m <= NEG_INF / 2, 0.0,
                            torch.exp(m - m_safe))
        l = l * alpha + a.sum(-1)
        o = o * alpha[..., None] + a @ vh[:, :, ks]
        m = m_new
    return o, l, m


def mlstm_block_forward(cfg: ModelConfig, params: dict,
                        x: torch.Tensor) -> torch.Tensor:
    b, s, _ = x.shape
    di, h, hd = _mlstm_dims(cfg)
    up = x @ params["w_up"]
    xin, gate = up.chunk(2, dim=-1)                           # (B, S, di)
    q = (xin @ params["w_q"]).view(b, s, h, hd)
    k = (xin @ params["w_k"]).view(b, s, h, hd)
    v = (xin @ params["w_v"]).view(b, s, h, hd)
    x32 = xin.float()
    log_i = x32 @ params["w_ig"] + params["b_ig"]             # (B, S, H)
    log_f = pointwise(F.logsigmoid, x32 @ params["w_fg"] + params["b_fg"])
    ht = mlstm_parallel(q, k, v, log_i, log_f)
    y = ht.reshape(b, s, di) * F.silu(gate)
    return y @ params["w_down"]


def mlstm_init_state(cfg: ModelConfig, batch: int, device) -> MLSTMState:
    _, h, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return MLSTMState(
        c=torch.zeros((batch, h, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, h, hd), dtype=f32, device=device),
        m=torch.full((batch, h), -1e30, dtype=f32, device=device))


def mlstm_block_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                       state: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    """x: (B, 1, d). Recurrent stabilized update (xLSTM eq. 19-27)."""
    b = x.shape[0]
    di, h, hd = _mlstm_dims(cfg)
    up = x[:, 0] @ params["w_up"]
    xin, gate = up.chunk(2, dim=-1)
    q = (xin @ params["w_q"]).view(b, h, hd).float()
    k = (xin @ params["w_k"]).view(b, h, hd).float()
    v = (xin @ params["w_v"]).view(b, h, hd).float()
    x32 = xin.float()
    log_i = x32 @ params["w_ig"] + params["b_ig"]             # (B, H)
    log_f = pointwise(F.logsigmoid, x32 @ params["w_fg"] + params["b_fg"])
    m_new = torch.maximum(log_f + state.m, log_i)
    f_sc = torch.exp(log_f + state.m - m_new)
    i_sc = torch.exp(log_i - m_new)
    c = f_sc[..., None, None] * state.c \
        + i_sc[..., None, None] * v[..., :, None] * k[..., None, :]
    n = f_sc[..., None] * state.n + i_sc[..., None] * k
    q = q * hd ** -0.5
    num = torch.einsum("bhvk,bhk->bhv", c, q)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, q).abs(),
                        torch.exp(-m_new))
    ht = (num / den[..., None]).reshape(b, di).to(x.dtype)
    y = ht * F.silu(gate)
    return (y @ params["w_down"])[:, None], MLSTMState(c, n, m_new)


# ===========================================================================
# sLSTM — sequential exponential-gated LSTM with per-head recurrence
# ===========================================================================

_GATES = ("z", "i", "f", "o")


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, hd)
    n: torch.Tensor   # (B, H, hd)
    h: torch.Tensor   # (B, H, hd)
    m: torch.Tensor   # (B, H, hd) stabilizer


def _slstm_dims(cfg: ModelConfig) -> tuple[int, int]:
    h = cfg.num_heads
    return h, cfg.d_model // h


def slstm_init(cfg: ModelConfig, dtype, generator, device) -> dict:
    d = cfg.d_model
    h, hd = _slstm_dims(cfg)
    p = {}
    for g in _GATES:
        p[f"w_{g}"] = normal((d, d), d ** -0.5, dtype, generator, device)
        p[f"r_{g}"] = normal((h, hd, hd), hd ** -0.5, dtype, generator,
                             device)
        p[f"b_{g}"] = torch.full((d,), 1.0 if g == "f" else 0.0,
                                 dtype=torch.float32, device=device)
    p["w_out"] = normal((d, d), d ** -0.5, dtype, generator, device)
    return p


def _slstm_cell(gz, gi, gf, go, state: SLSTMState
                ) -> tuple[torch.Tensor, SLSTMState]:
    """The exponential-gated update (xLSTM eqs. 8-18) from the gates'
    float32 pre-activations (biases added); elementwise, so any layout
    of the state's (B, H, hd) works."""
    z = torch.tanh(gz)
    log_f = pointwise(F.logsigmoid, gf)
    o = torch.sigmoid(go)
    lfm = log_f + state.m
    m_new = torch.maximum(lfm, gi)
    i_sc = torch.exp(gi - m_new)
    f_sc = torch.exp(lfm - m_new)
    c = torch.addcmul(f_sc * state.c, i_sc, z)       # f·c + i·z
    n = torch.addcmul(i_sc, f_sc, state.n)           # f·n + i
    h_new = o * c / torch.clamp_min(n, 1e-6)
    return h_new, SLSTMState(c, n, h_new, m_new)


def _slstm_step(params: dict, xt: torch.Tensor, state: SLSTMState
                ) -> tuple[torch.Tensor, SLSTMState]:
    """xt: (B, d). One step: each gate's ``xt @ w_g`` plus its recurrent
    product, summed in the compute dtype, then float32 plus the bias."""
    b = xt.shape[0]
    h_heads, hd = state.h.shape[1], state.h.shape[2]
    hb = state.h.to(xt.dtype)

    def gate(g):
        wx = (xt @ params[f"w_{g}"]).view(b, h_heads, hd)
        rh = torch.einsum("bhk,hkj->bhj", hb, params[f"r_{g}"])
        return (wx + rh) + params[f"b_{g}"].view(h_heads, hd)

    h_new, state = _slstm_cell(*(gate(g) for g in _GATES), state)
    return h_new.reshape(b, h_heads * hd), state


def _slstm_scan(wx: torch.Tensor, r_all: torch.Tensor, bias: torch.Tensor,
                state: SLSTMState) -> torch.Tensor:
    """The sLSTM recurrence over wx (S, H, B, 4, hd) (the gates' input
    products in the compute dtype), ``r_all`` (H, hd, 4·hd) the four
    recurrent matrices side by side, ``bias`` (H, 1, 4, hd) float32 and a
    state laid out (H, B, hd); returns every step's h (S, H, B, hd)."""
    hh, b = wx.shape[1], wx.shape[2]
    hs = []
    with fused_loop(wx.shape[0]):   # the reference's time scan
        for wxt in wx.unbind(0):
            rh = torch.bmm(state.h.to(wx.dtype), r_all).view(hh, b, 4, -1)
            g = (wxt + rh) + bias      # summed in the dtype, then float32
            h, state = _slstm_cell(g[:, :, 0], g[:, :, 1], g[:, :, 2],
                                   g[:, :, 3], state)
            hs.append(h)
    return torch.stack(hs)


def slstm_block_forward(cfg: ModelConfig, params: dict,
                        x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    hh, hd = _slstm_dims(cfg)
    w_all = torch.cat([params[f"w_{g}"] for g in _GATES], dim=1)
    r_all = torch.cat([params[f"r_{g}"] for g in _GATES], dim=-1)
    bias = torch.stack([params[f"b_{g}"] for g in _GATES]) \
        .view(4, hh, hd).transpose(0, 1)[:, None]
    wx = (x @ w_all).view(b, s, 4, hh, hd).permute(1, 3, 0, 2, 4) \
        .contiguous()

    def scan(wx, r_all, bias):
        zero = torch.zeros(wx[0, :, :, 0].shape, dtype=torch.float32,
                           device=wx.device)
        state = SLSTMState(zero, zero, zero, torch.full_like(zero, -1e30))
        return _slstm_scan(wx, r_all, bias, state)

    # on local shards under a mesh: heads and batch split, S whole
    hs = local_region(scan, (wx, r_all, bias),
                      ((None, MODEL, BATCH, None, None), (MODEL, None, None),
                       (MODEL, None, None, None)),
                      (None, MODEL, BATCH, None), (s, hh, b, hd))
    y = hs.permute(2, 0, 1, 3).reshape(b, s, d).to(x.dtype)
    return y @ params["w_out"]


def slstm_init_state(cfg: ModelConfig, batch: int, device) -> SLSTMState:
    """Zeros for c, n and h and -1e30 for m, each its own tensor (the
    reference passes one array as all three)."""
    hh, hd = _slstm_dims(cfg)

    def zeros():
        return torch.zeros((batch, hh, hd), dtype=torch.float32,
                           device=device)

    return SLSTMState(c=zeros(), n=zeros(), h=zeros(),
                      m=torch.full((batch, hh, hd), -1e30,
                                   dtype=torch.float32, device=device))


def slstm_block_decode(cfg: ModelConfig, params: dict, x: torch.Tensor,
                       state: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    y, state = _slstm_step(params, x[:, 0], state)
    return (y.to(x.dtype) @ params["w_out"])[:, None], state
