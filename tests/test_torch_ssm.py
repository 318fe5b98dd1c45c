"""The port's SSM blocks (``repro_torch.models.ssm``: Mamba, mLSTM,
sLSTM) against the reference's ``repro.models.ssm`` on the same weights
and inputs.

Weights are numpy arrays from ``anchors.jax_layout_params`` (the
reference's init values plus 0.1-scaled normals where the reference
starts from a constant), at the reference test's config
(``tests/test_moe_ssm.py``: d 32, 4 heads, N 8, conv width 4), cast to
the dtype of each leaf in the reference's init (``A_log``, ``D``,
``dt_bias``, the mLSTM gate weights and biases and the sLSTM biases stay
float32 in a bf16 block).  Inputs are numpy normals from a seed.

Tolerances: float32 forward and decode within atol 1e-5 / rtol 1e-4 of
the reference (measured ~1e-7 on outputs of |y| <= 0.7: float32 sums in
another order); bf16 within BF16_ATOL (two bf16 ulps at the outputs'
magnitude, 0.5-1; measured one to one and a half), since bf16 rounds at
other places in the two frameworks; gradients within 1e-5 of each
leaf's largest magnitude (measured 1e-7 to 7e-7), except where the
true gradient is 0 (:data:`ZERO_GRADS`).  The reference test's own
checks (decode matches the forward, causality, O(1) states, block-size
invariance) run on the port at the reference test's tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro.models.common import ModelConfig as JConfig
from repro_torch.models import anchors as A
from repro_torch.models import ssm as TS
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import _from_numpy

F32 = dict(atol=1e-5, rtol=1e-4)
BF16_ATOL = 4e-3
GRAD_REL = 1e-5
#: Leaves whose true gradient is 0: a constant shift of the sLSTM's
#: log_i scales c and n alike, so h = o·c/n does not move (b_i's reference
#: gradient is float32 rounding, 1.2e-7 against w_z's 6.9 at this config).
#: Both packages' gradients there are held under 1e-6 of the block's
#: largest.
ZERO_GRADS = {("slstm", "b_i")}
KINDS = ("mamba", "mlstm", "slstm")
B, S = 2, 16

#: Per kind: the reference's (init, forward, decode, init_state) and the
#: port's (forward, decode, init_state); init_state takes (cfg, batch,
#: dtype) in both, the dtype used by Mamba only.
JAX_FNS = {
    "mamba": (JS.mamba_init, JS.mamba_forward, JS.mamba_decode,
              JS.mamba_init_state),
    "mlstm": (JS.mlstm_init, JS.mlstm_block_forward, JS.mlstm_block_decode,
              lambda c, b, dt: JS.mlstm_init_state(c, b)),
    "slstm": (JS.slstm_init, JS.slstm_block_forward, JS.slstm_block_decode,
              lambda c, b, dt: JS.slstm_init_state(c, b)),
}
PORT_FNS = {
    "mamba": (TS.mamba_forward, TS.mamba_decode,
              lambda c, b, dt: TS.mamba_init_state(c, b, dt, "cpu")),
    "mlstm": (TS.mlstm_block_forward, TS.mlstm_block_decode,
              lambda c, b, dt: TS.mlstm_init_state(c, b, "cpu")),
    "slstm": (TS.slstm_block_forward, TS.slstm_block_decode,
              lambda c, b, dt: TS.slstm_init_state(c, b, "cpu")),
}


def _configs(kind, dtype="float32"):
    """The reference test's SSM config in both packages."""
    kw = dict(name="ssm-test", family="ssm", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=64,
              dtype=dtype, block_pattern=(kind,), ssm_state_dim=8,
              ssm_conv_width=4, ssm_expand=2)
    return JConfig(**kw), ModelConfig(**kw)


class Block:
    """One mixer's weights in both packages: repeat 0 of the numpy
    stack, each leaf in the dtype the reference's init gives it."""

    def __init__(self, kind, dtype="float32"):
        self.kind, self.dtype = kind, dtype
        self.jcfg, self.cfg = _configs(kind, dtype)
        leaves = A.jax_layout_params(self.cfg)["blocks"][0]["mixer"]
        want = jax.eval_shape(lambda k: JAX_FNS[kind][0](
            k, self.jcfg, jnp.dtype(dtype)), jax.random.key(0))
        assert sorted(want) == sorted(leaves)
        self.jparams = {k: jnp.asarray(v[0]).astype(want[k].dtype)
                        for k, v in leaves.items()}
        self.params = {k: _from_numpy(np.asarray(v))
                       for k, v in self.jparams.items()}

    def inputs(self, s=S, seed=1, scale=0.5):
        x = (np.random.default_rng(seed).standard_normal((B, s, 32))
             * scale).astype(np.float32)
        return (jnp.asarray(x).astype(self.dtype),
                torch.as_tensor(x).to(getattr(torch, self.dtype)))

    def jax_forward(self, jx):
        return JAX_FNS[self.kind][1](self.jcfg, self.jparams, jx)

    def port_forward(self, tx, params=None):
        return PORT_FNS[self.kind][0](self.cfg, params or self.params, tx)

    def jax_decode(self, jx):
        _, _, dec, init = JAX_FNS[self.kind]
        st = init(self.jcfg, B, jnp.dtype(self.dtype))
        ys = []
        for t in range(jx.shape[1]):
            y, st = dec(self.jcfg, self.jparams, jx[:, t:t + 1], st)
            ys.append(y)
        return jnp.concatenate(ys, axis=1), st

    def port_decode(self, tx):
        _, dec, init = PORT_FNS[self.kind]
        st = init(self.cfg, B, getattr(torch, self.dtype))
        ys = []
        for t in range(tx.shape[1]):
            y, st = dec(self.cfg, self.params, tx[:, t:t + 1], st)
            ys.append(y)
        return torch.cat(ys, dim=1), st


def _np(t):
    return np.asarray(t.astype(jnp.float32)) if isinstance(t, jax.Array) \
        else t.detach().float().numpy()


@pytest.fixture(scope="module", params=KINDS)
def block(request):
    return Block(request.param)


@pytest.fixture(scope="module", params=KINDS)
def block_bf16(request):
    return Block(request.param, "bfloat16")


def test_forward_matches_reference(block):
    jx, tx = block.inputs()
    got, want = block.port_forward(tx), block.jax_forward(jx)
    assert got.shape == (B, S, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_decode_and_states_match_reference(block):
    jx, tx = block.inputs()
    (got, gst), (want, wst) = block.port_decode(tx), block.jax_decode(jx)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    assert type(gst).__name__ == type(wst).__name__
    assert gst._fields == wst._fields
    for g, w, name in zip(gst, wst, gst._fields):
        assert tuple(g.shape) == w.shape and _np(g).dtype == np.float32 \
            or name == "conv", name
        np.testing.assert_allclose(_np(g), _np(w), **F32, err_msg=name)


def test_bfloat16_forward_and_decode_match_reference(block_bf16):
    blk = block_bf16
    for k in ("A_log", "D", "dt_bias", "w_ig", "b_ig", "w_fg", "b_fg",
              "b_z", "b_i", "b_f", "b_o"):
        if k in blk.params:
            assert blk.params[k].dtype == torch.float32, k
    jx, tx = blk.inputs()
    got = blk.port_forward(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(blk.jax_forward(jx)),
                               atol=BF16_ATOL, rtol=0)
    got, gst = blk.port_decode(tx)
    want, wst = blk.jax_decode(jx)
    np.testing.assert_allclose(_np(got), _np(want), atol=BF16_ATOL, rtol=0)
    for g, w, name in zip(gst, wst, gst._fields):
        assert g.dtype == getattr(torch, str(w.dtype)), name


@pytest.fixture(scope="module")
def grads(block):
    """The reference's ``jax.grad`` of sum(forward(x) * cotangent) by
    every weight and x, at float32."""
    jx, tx = block.inputs(seed=3)
    ct = np.random.default_rng(4).standard_normal((B, S, 32)) \
        .astype(np.float32)

    def loss(p, x):
        return jnp.sum(JAX_FNS[block.kind][1](block.jcfg, p, x) * ct)

    gp, gx = jax.grad(loss, argnums=(0, 1))(block.jparams, jx)
    return block, tx, ct, {**{k: np.asarray(v) for k, v in gp.items()},
                           "x": np.asarray(gx)}


def test_gradients_match_jax(grads):
    blk, tx, ct, want = grads
    params = {k: v.clone().requires_grad_() for k, v in blk.params.items()}
    x = tx.clone().requires_grad_()
    loss = (blk.port_forward(x, params) * torch.as_tensor(ct)).sum()
    loss.backward()
    got = {**{k: v.grad for k, v in params.items()}, "x": x.grad}
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        w = want[name]
        if (blk.kind, name) in ZERO_GRADS:
            assert float(np.abs(w).max()) <= 1e-6 * top
            assert float(g.abs().max()) <= 1e-6 * top, name
            continue
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()), (name, err)


# ---------------------------------------------------------------------------
# The reference test's checks (tests/test_moe_ssm.py), on the port
# ---------------------------------------------------------------------------


def test_mamba_decode_matches_forward():
    blk = Block("mamba")
    _, tx = blk.inputs(s=10, scale=0.3)
    full = blk.port_forward(tx)
    st = TS.mamba_init_state(blk.cfg, B, torch.float32, "cpu")
    for t in range(10):
        y, st = TS.mamba_decode(blk.cfg, blk.params, tx[:, t:t + 1], st)
        torch.testing.assert_close(y[:, 0], full[:, t], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("kind", ["mamba", "slstm"])
def test_causality(kind):
    """Future inputs do not move past outputs."""
    blk = Block(kind)
    _, tx = blk.inputs(s=12, scale=1.0)
    y1 = blk.port_forward(tx)
    x2 = tx.clone()
    x2[:, 8:] = 99.0 if kind == "mamba" else 5.0
    y2 = blk.port_forward(x2)
    torch.testing.assert_close(y1[:, :8], y2[:, :8], atol=1e-5, rtol=0)


def test_decode_states_are_o1():
    _, cfg = _configs("mamba")
    di = cfg.ssm_expand * cfg.d_model
    st = TS.mamba_init_state(cfg, 2, torch.float32, "cpu")
    assert st.ssm.shape == (2, di, cfg.ssm_state_dim)
    assert st.conv.shape == (2, cfg.ssm_conv_width - 1, di)
    _, cfg = _configs("mlstm")
    st = TS.mlstm_init_state(cfg, 2, "cpu")
    assert (st.c.shape, st.n.shape, st.m.shape) == ((2, 4, 16, 16),
                                                    (2, 4, 16), (2, 4))
    assert float(st.m.max()) == float(np.float32(-1e30))


def test_slstm_init_state_is_four_tensors():
    """The reference passes one zeros array as c, n and h; the port
    makes each its own, so writing one cannot move another."""
    _, cfg = _configs("slstm")
    st = TS.slstm_init_state(cfg, 2, "cpu")
    ptrs = {t.data_ptr() for t in st}
    assert len(ptrs) == 4
    st.c.add_(1.0)
    assert float(st.n.abs().max()) == float(st.h.abs().max()) == 0.0
    assert float(st.m.max()) == float(np.float32(-1e30))


def test_mlstm_decode_matches_parallel():
    blk = Block("mlstm")
    _, tx = blk.inputs(s=8, scale=0.3)
    full = blk.port_forward(tx)
    st = TS.mlstm_init_state(blk.cfg, B, "cpu")
    for t in range(8):
        y, st = TS.mlstm_block_decode(blk.cfg, blk.params, tx[:, t:t + 1],
                                      st)
        torch.testing.assert_close(y[:, 0], full[:, t], atol=1e-3, rtol=1e-3)


def _mlstm_inputs(blk, s):
    """q, k, v, log_i, log_f of the block at ``s`` steps, as the port's
    block forward makes them."""
    p = blk.params
    _, tx = blk.inputs(s=s, scale=0.3)
    di, h, hd = TS._mlstm_dims(blk.cfg)
    xin, _ = (tx @ p["w_up"]).chunk(2, dim=-1)
    q, k, v = ((xin @ p[w]).view(B, s, h, hd) for w in ("w_q", "w_k", "w_v"))
    li = xin @ p["w_ig"] + p["b_ig"]
    lf = torch.nn.functional.logsigmoid(xin @ p["w_fg"] + p["b_fg"])
    return q, k, v, li, lf


def test_mlstm_blockwise_block_size_invariance():
    blk = Block("mlstm")
    args = _mlstm_inputs(blk, 32)
    a = TS.mlstm_parallel(*args, q_block=8, kv_block=8)
    b = TS.mlstm_parallel(*args, q_block=32, kv_block=32)
    c = TS.mlstm_parallel(*args, q_block=8, kv_block=16)
    torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(c, b, atol=1e-4, rtol=1e-4)


def test_mlstm_parallel_refuses_a_length_off_the_blocks():
    """S = 300 is not a multiple of the 256-step blocks: the reference
    asserts, the port raises, neither pads."""
    blk = Block("mlstm")
    args = _mlstm_inputs(blk, 300)
    with pytest.raises(AssertionError):
        JS.mlstm_parallel(*(jnp.asarray(t.numpy()) for t in args))
    with pytest.raises(ValueError, match="S = 300"):
        TS.mlstm_parallel(*args)


def test_slstm_decode_matches_forward():
    blk = Block("slstm")
    _, tx = blk.inputs(s=8, scale=0.3)
    full = blk.port_forward(tx)
    st = TS.slstm_init_state(blk.cfg, B, "cpu")
    for t in range(8):
        y, st = TS.slstm_block_decode(blk.cfg, blk.params, tx[:, t:t + 1],
                                      st)
        torch.testing.assert_close(y[:, 0], full[:, t], atol=1e-4, rtol=1e-4)


def test_softplus_is_exact_above_torchs_threshold():
    """``jax.nn.softplus`` is log(1 + e^x) for every x; torch's
    ``softplus`` returns x above 20."""
    x = np.asarray([-30.0, -1.0, 0.0, 5.0, 19.0, 21.0, 40.0, 100.0],
                   np.float32)
    got = TS._softplus(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.softplus(x)),
                               rtol=1e-7, atol=0)


def test_mamba_prompt_conv_rounds_once_to_the_dtype():
    """The prompt path's conv in bf16: the float32 tap sum rounded once,
    then the bias added in bf16; decode takes the conv in float32."""
    blk = Block("mamba", "bfloat16")
    _, tx = blk.inputs()
    xin = (tx @ blk.params["in_proj"])[..., :64]
    got = TS._mamba_conv_full(blk.params, xin)
    w = blk.params["conv_w"].float()
    pad = torch.nn.functional.pad(xin.float(), (0, 0, 3, 0))
    acc = sum(pad[:, k:k + S] * w[k] for k in range(4))
    assert torch.equal(got, acc.to(torch.bfloat16) + blk.params["conv_b"])
