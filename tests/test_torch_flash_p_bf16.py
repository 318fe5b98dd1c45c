"""The bf16-probability attention route (``p_bf16``, the reference's
``ModelConfig.attn_p_bf16``) in the port against the JAX package.

The route rounds p = exp(s - m_run) and v to bf16 before p@v (float32
products and sums; m and l the statistics of the unrounded p), and in
the backward also ds, q, k, p and dout before their products.  On CPU
tensors the port's ``repro_torch.models.flash.flash_attention(...,
p_bf16=True)`` runs its blockwise pass and the kernel wrapper
``flash_attention_fwd(..., p_bf16=True)`` the same pass at the caller's
blocks; both are held against ``repro.models.flash.flash_attention(...,
p_bf16=True)`` and its ``_fwd_pass`` at the same blocks, on the same
numpy inputs.  Kernel E's route runs only on the card
(``chip_smoke.py``).

Tolerances.  The port's float32 scores differ from XLA's by a few float32
ulps, and where a p lies that close to a bf16 rounding tie its rounding
flips: that moves an output by up to one bf16 ulp of p times |v| / l.
So outputs are held to the float32 bound of ``test_torch_flash_kernel``
(5e-6, 5e-5 with the softcap; bf16 outputs one bf16 ulp + 1e-6) except
at such ties, which are counted (at most 1 % of the outputs) and each
held within the witness: the reference's own distance between its
``p_bf16`` and float32-probability results on the same inputs.
Gradients, whose ds is rounded too, are held to that witness
throughout.  m and l (float32, of the unrounded p) within 1e-5.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models import flash as JF
from repro.models import transformer as JT
from repro.models.attention import _block_pairs
from repro_torch.configs import get_reduced_config
from repro_torch.kernels import flash_attention as E
from repro_torch.launch import dryrun
from repro_torch.models import anchors as A
from repro_torch.models import flash as TF
from repro_torch.models import transformer as TT

F32, F32_CAP = 5e-6, 5e-5
BF16_ATOL = 1e-6
STATS_ATOL = 1e-5
TIE_SHARE = 0.01
MODEL_WITNESS_SHARE = 0.5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's thread a core makes each wait on the
    others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, sq, skv, h, kv, d, dv, seed) -> list:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, dv),
                      (b, sq, h, dv))]


def _base_tol(want: np.ndarray, dtype: str, cap: float) -> np.ndarray:
    """The bound away from ties: float32 absolute, or one bf16 ulp of
    |want| + 1e-6 on bf16 outputs."""
    if dtype == "float32":
        return np.full(want.shape, F32_CAP if cap else F32)
    _, e = np.frexp(want)
    return np.where(want == 0, 0.0, np.ldexp(1.0, e - 8)) + BF16_ATOL


def assert_close_but_ties(got, want, witness: float, base) -> int:
    """Every element within ``base`` but at most TIE_SHARE of them, each
    of those within ``witness``; returns how many were ties."""
    diff = np.abs(got - want)
    ties = int((diff > base).sum())
    assert ties <= TIE_SHARE * diff.size, (ties, diff.size)
    assert diff.max() <= witness, (diff.max(), witness)
    return ties


# (b, sq, skv, h, kv, d, dv, causal, window, softcap, q_block, kv_block)
CASES = {
    "gqa kv32": (2, 128, 128, 4, 2, 32, 32, True, 0, 0.0, 64, 32),
    "mla 48/32 kv64": (1, 256, 256, 4, 4, 48, 32, True, 0, 0.0, 64, 64),
    "non-causal softcap": (1, 128, 256, 4, 2, 64, 64, False, 0, 30.0,
                           128, 256),
    "window kv512": (1, 512, 512, 2, 2, 32, 32, True, 48, 0.0, 256, 512),
    "mqa causal sq<skv": (1, 64, 192, 4, 1, 32, 32, True, 0, 50.0, 64, 64),
}


def _jax(arrays, dtype):
    return [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]


def _torch(arrays, dtype):
    return [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_forward_matches_reference(name, dtype):
    b, sq, skv, h, kv, d, dv, causal, window, cap, bq, bk = CASES[name]
    q, k, v, _ = _inputs(b, sq, skv, h, kv, d, dv, 1)
    kw = dict(causal=causal, window=window, logit_softcap=cap)
    jq = _jax((q, k, v), dtype)
    want, plain = (np.asarray(JF.flash_attention(
        *jq, q_block=bq, kv_block=bk, p_bf16=pb, **kw).astype(jnp.float32))
        for pb in (True, False))
    tq = _torch((q, k, v), dtype)
    got = TF.flash_attention(*tq, q_block=bq, kv_block=bk, p_bf16=True,
                             **kw)
    assert got.dtype == tq[0].dtype and got.shape == (b, sq, h, dv)
    got = got.float().numpy()
    assert_close_but_ties(got, want, np.abs(want - plain).max(),
                          _base_tol(want, dtype, cap))
    # the kernel wrapper on the CPU is the same blockwise pass
    wrapped = E.flash_attention_fwd(*tq, blocks=(bq, bk), p_bf16=True, **kw)
    np.testing.assert_array_equal(wrapped.float().numpy(), got)


@pytest.mark.parametrize("name", ["gqa kv32", "non-causal softcap"])
def test_stats_match_reference_fwd_pass(name):
    """``_fwd_pass(p_bf16=True)``: out, and m and l of the unrounded p,
    against the reference's; the stats the route's kernel wrapper
    returns are those."""
    b, sq, skv, h, kv, d, dv, causal, window, cap, bq, bk = CASES[name]
    q, k, v, _ = _inputs(b, sq, skv, h, kv, d, dv, 2)
    pairs = _block_pairs(sq // bq, skv // bk, bq, bk, skv - sq, causal,
                         window)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_block=bq,
              kv_block=bk, scale=d ** -0.5, p_bf16=True)
    want = [np.asarray(a) for a in JF._fwd_pass(
        *_jax((q, k, v), "float32"), jnp.asarray(np.asarray(pairs)), **kw)]
    plain = np.asarray(JF._fwd_pass(
        *_jax((q, k, v), "float32"), jnp.asarray(np.asarray(pairs)),
        **{**kw, "p_bf16": False})[0])
    tq = _torch((q, k, v), "float32")
    got = [t.numpy() for t in TF._fwd_pass(*tq, pairs, **kw)]
    assert_close_but_ties(got[0], want[0], np.abs(want[0] - plain).max(),
                          _base_tol(want[0], "float32", cap))
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a, w, atol=STATS_ATOL, rtol=STATS_ATOL)
    out, m, l = E.flash_attention_fwd(*tq, causal=causal, window=window,
                                      logit_softcap=cap, blocks=(bq, bk),
                                      return_stats=True, p_bf16=True)
    np.testing.assert_array_equal(m.numpy(), got[1])
    np.testing.assert_array_equal(l.numpy(), got[2])


@pytest.mark.parametrize("dtype, name", [
    ("float32", "gqa kv32"), ("float32", "non-causal softcap"),
    ("bfloat16", "mla 48/32 kv64"), ("bfloat16", "window kv512")])
def test_gradients_match_reference_vjp(name, dtype):
    """(dq, dk, dv) through ``FlashAttentionFunction`` with ``p_bf16``
    against ``jax.vjp`` of the reference's ``p_bf16`` flash, each within
    the witness: the reference's own distance between its ``p_bf16``
    and float32-probability gradients on the same inputs."""
    b, sq, skv, h, kv, d, dv, causal, window, cap, bq, bk = CASES[name]
    arrays = _inputs(b, sq, skv, h, kv, d, dv, 3)
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_block=bq,
              kv_block=bk)
    jq = _jax(arrays, dtype)

    def jax_grads(p_bf16):
        _, vjp = jax.vjp(lambda a, b_, c: JF.flash_attention(
            a, b_, c, p_bf16=p_bf16, **kw), *jq[:3])
        return [np.asarray(g.astype(jnp.float32)) for g in vjp(jq[3])]

    want, plain = jax_grads(True), jax_grads(False)
    tq = [t.requires_grad_(i < 3) for i, t in
          enumerate(_torch(arrays, dtype))]
    y = TF.flash_attention(*tq[:3], p_bf16=True, **kw)
    assert type(y.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    got = torch.autograd.grad(y, tq[:3], tq[3])
    for n, g, w, p in zip("qkv", got, want, plain):
        assert g.dtype == tq[0].dtype
        diff = np.abs(g.float().numpy() - w).max()
        witness = np.abs(w - p).max()
        assert diff <= witness, (n, diff, witness)


def _reduced(arch: str):
    """The reduced float32 ``arch`` in both packages with
    ``attn_p_bf16`` on, on the anchors' numpy weights."""
    cfg = dataclasses.replace(get_reduced_config(arch, dtype="float32"),
                              attn_p_bf16=True)
    jcfg = dataclasses.replace(jax_config(arch, dtype="float32"),
                               attn_p_bf16=True)
    w = A.jax_layout_params(cfg)
    return cfg, jcfg, w


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v2-236b"])
def test_reduced_model_logits_match_reference(arch):
    """The reduced gemma2 (local and global layers, softcap) and
    deepseek-v2 (MLA, q·k 48 and v 32) forwards with ``attn_p_bf16``:
    the port's logits against the reference's on the same weights and
    tokens.  A tie's flip in one layer's attention reaches every later
    position through the next layers, so the logits are not held element
    by element: the largest difference within half the witness (the
    reference's distance to its float32-probability logits; measured
    0.17 and 0.004 of it) and every argmax equal."""
    cfg, jcfg, w = _reduced(arch)
    tokens, _ = A.anchor_tokens(cfg)
    jparams = jax.tree.map(jnp.asarray, w)
    want, plain = (np.asarray(JT.forward(
        dataclasses.replace(jcfg, attn_p_bf16=pb), jparams,
        JT.Batch(tokens=jnp.asarray(tokens)))) for pb in (True, False))
    params = TT.params_from_jax(cfg, w)
    with torch.no_grad():
        got = TT.forward(cfg, params, TT.Batch(
            tokens=torch.as_tensor(tokens))).numpy()
    witness = np.abs(want - plain).max()
    assert 0 < np.abs(got - want).max() <= MODEL_WITNESS_SHARE * witness
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_gradient_and_route_of_a_training_loss():
    """``loss_fn`` of the reduced gemma2 with ``attn_p_bf16`` backs
    through the route's recompute backward; the loss matches the
    reference's within the witness of the two routes' losses."""
    cfg, jcfg, w = _reduced("gemma2-2b")
    tokens, _ = A.anchor_tokens(cfg)
    tokens = tokens[:, :64]
    jparams = jax.tree.map(jnp.asarray, w)
    jb = JT.Batch(tokens=jnp.asarray(tokens), labels=jnp.asarray(tokens))
    want, plain = (float(JT.loss_fn(dataclasses.replace(
        jcfg, attn_p_bf16=pb), jparams, jb)) for pb in (True, False))
    params = TT.params_from_jax(cfg, w)
    leaves = [t.requires_grad_() for t in TT._leaves(params)
              if t.is_floating_point()]
    loss = TT.loss_fn(cfg, params, TT.Batch(
        tokens=torch.as_tensor(tokens), labels=torch.as_tensor(tokens)))
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert abs(loss.item() - want) <= max(abs(want - plain), 1e-6)


def test_dryrun_row_with_the_flag_is_ok(tmp_path):
    """``--attn-p-bf16`` on ``meta``: an ``ok`` row, kernel E credited
    with its ``p_bf16`` twin, whose dot flops are the baseline row's
    (the casts add ``elementwise`` converts, as the reference counts
    them)."""
    out = tmp_path / "rows.json"
    argv = ["--arch", "qwen2-0.5b", "--shape", "prefill_32k",
            "--mesh-shape", "2x4", "--out", str(out)]
    assert dryrun.main(argv + ["--tag", "base"]) == 0
    assert dryrun.main(argv + ["--attn-p-bf16", "--tag", "p_bf16"]) == 0
    rows = {r["tag"]: r for r in json.loads(out.read_text())}
    assert [r["status"] for r in rows.values()] == ["ok", "ok"]
    base, p16 = (rows[t]["cost_analysis"]["flops_by_op"]
                 for t in ("base", "p_bf16"))
    assert p16["dot"] == base["dot"] > 0
    assert p16["elementwise"] > base["elementwise"]


def _chip_smoke():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke

    return chip_smoke


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chip_smoke_p_bf16_checks_pass_on_the_plain_versions(dtype):
    """``chip_smoke.py``'s gates on the route, rehearsed on the CPU,
    where the kernel wrapper runs its plain version: the forward and
    stats at E's key tile, the gradient through the Function against
    the plain Function."""
    CS = _chip_smoke()
    dev = torch.device("cpu")
    q, k, v = CS.flash_inputs(2, 64, 64, 4, 2, 32, dtype, 5, dev)
    kw = dict(causal=True, window=24, logit_softcap=30.0)
    full = E.flash_attention_ref(q, k, v, **kw)
    res = CS.flash_p_bf16_check(q, k, v, kw, full, "cpu")
    assert res["ties"] == 0 and res["max_abs_err"] == 0.0
    assert 0 < res["witness"] < 0.05
    grad = CS.flash_p_bf16_grad_check(q, k, v, kw, 6, "cpu")
    assert all(g["max_abs_diff"] == 0.0 < g["witness"]
               for g in grad.values())


def test_chip_smoke_p_bf16_check_catches_unrounded_probabilities(
        monkeypatch):
    """A route that kept p in float32 differs from the rounded plain
    version at far more than the tie share of the outputs."""
    CS = _chip_smoke()
    dev = torch.device("cpu")
    q, k, v = CS.flash_inputs(1, 64, 64, 4, 2, 32, "float32", 7, dev)
    kw = dict(causal=True, window=0, logit_softcap=0.0)
    full = E.flash_attention_ref(q, k, v, **kw)
    real = E.flash_attention_fwd

    def unrounded(*a, p_bf16=False, **kw_):
        return real(*a, **kw_)

    unrounded.launches_p_bf16 = 0
    monkeypatch.setattr(E, "flash_attention_fwd", unrounded)
    with pytest.raises(CS.SmokeFailure, match="past the limit"):
        CS.flash_p_bf16_check(q, k, v, kw, full, "cpu")


def test_chip_smoke_bound_counts_the_route_p_at_v_once():
    """The route's operation bound on bf16 inputs: q·k and p@v one bf16
    tensor-core pass each (three for p@v with float32 p); float32
    inputs at the float32 rate either way.  At gemma2-2b's local +
    global pair it halves, 0.973 to 0.486 ms."""
    CS = _chip_smoke()
    work = [CS.flash_work(1, 8192, 8192, 8, 4, 256, True, w, 2)
            for w in (4096, 0)]
    nbytes, qk, pv = (sum(x) for x in zip(*work))
    f32p, _ = CS.flash_bound(nbytes, qk, pv, True)
    p16, by = CS.flash_bound(nbytes, qk, pv, True, p_bf16=True)
    assert by == "operations"
    assert p16 == pytest.approx((qk + pv) / CS.PEAK_BF16_OPS_PER_S * 1e3)
    assert f32p == pytest.approx((qk + 3 * pv) / CS.PEAK_BF16_OPS_PER_S
                                 * 1e3)
    assert round(f32p, 3) == 0.973 and round(p16, 3) == 0.486
    assert CS.flash_bound(nbytes, qk, pv, False, p_bf16=True) == \
        CS.flash_bound(nbytes, qk, pv, False)
