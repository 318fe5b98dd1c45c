"""The port's deepseek-v2-236b (MLA attention with a q LoRA, the dense
prologue, a fine-grained MoE with shared experts) against the
reference's ``repro.models.transformer`` on the same weights.

The weights are made with numpy (``repro_torch.models.anchors.
jax_layout_params``) in the reference's pytree layout, each leaf cast to
the dtype the reference's ``init_params`` gives it; the JAX reference
takes them as they are, the port through ``params_from_jax``.  The
reduced deepseek-v2 (3 layers: the dense prologue and 2 MoE layers; d
128, 4 heads, q LoRA 64, kv LoRA 32, q·k 32 + 16, v 32, 8 experts top-2
of d_ff 128 beside 2 shared experts) runs a forward at B 2, S 256, 8
teacher-forced decode steps naive and absorbed, 8 greedy tokens, the
loss and its gradients at B 2, S 32, and a bf16 forward.

Tolerances.  float32 logits within the other archs' bound, atol 2e-5 /
rtol 1e-5 (the forward reads 9.0e-6); routes, keep masks and greedy
tokens exactly (the smallest top-1/top-2 gap is 8.8e-3, the smallest
router gap 2.5e-5).  Gradients within 1e-5 of each leaf's largest
magnitude.  bf16: held to the reference's own float32-vs-bf16 witness,
as the SSM models are (``tests/test_torch_ssm_models.py``): the
largest logit difference at most 1.25 times the witness's, the shares
of equal argmaxes and routes at most 5 points below it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_routes import capacity_keep, min_gap, recorded_top_k
from repro.configs import get_reduced_config as jax_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_reduced_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps as S
from repro_torch.launch import token_serve
from repro_torch.models import anchors as A
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT

ARCH = "deepseek-v2-236b"
F32 = dict(atol=2e-5, rtol=1e-5)
GRAD_REL = 1e-5
BF16_WITNESS_RATIO, BF16_WITNESS_SHARE = 1.25, 0.05
LOSS_SHAPE = (2, 32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files side by side in worker
    processes, where torch's thread a core makes each wait on the
    others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_dtypes(jcfg, tree):
    """The numpy weights cast leaf by leaf to the dtypes of the
    reference's ``init_params`` for ``jcfg`` (norm scales, MLA's q_norm
    and kv_norm among them, and the MoE router stay float32 in a bf16
    model)."""
    want = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                          jax.random.key(0))
    leaves, treedef = jax.tree.flatten(tree)
    assert treedef == jax.tree.structure(want)
    return jax.tree.unflatten(treedef, [
        jnp.asarray(a).astype(w.dtype)
        for a, w in zip(leaves, jax.tree.leaves(want))])


class Case:
    def __init__(self, dtype="float32"):
        self.cfg = get_reduced_config(ARCH, dtype=dtype)
        self.jcfg = jax_config(ARCH, dtype=dtype)
        self.jparams = reference_dtypes(self.jcfg,
                                        A.jax_layout_params(self.cfg))
        self.params = TT.params_from_jax(
            self.cfg, jax.tree.map(np.asarray, self.jparams))
        self.fwd_tokens, self.prompt = A.anchor_tokens(self.cfg)
        self._jax = {}

    def jax_forward_routes(self):
        """The reference's forward logits (float32 numpy) and the top-k
        calls its MoE layers made; computed once."""
        if "fwd" not in self._jax:
            with recorded_top_k() as rec:
                out = JT.forward(self.jcfg, self.jparams, JT.Batch(
                    tokens=jnp.asarray(self.fwd_tokens)))
                out = np.asarray(out.astype(jnp.float32))
            self._jax["fwd"] = out, rec
        return self._jax["fwd"]

    def port_forward(self):
        with torch.no_grad(), A.record_routes() as rec:
            out = TT.forward(self.cfg, self.params, TT.Batch(
                tokens=torch.as_tensor(self.fwd_tokens)))
        return out.float().numpy(), rec

    def jax_greedy(self, absorb=False, steps=A.GREEDY_STEPS):
        """The reference's token-serve loop (prefill through a jitted
        decode_step, then argmax steps) with ``mla_absorb=absorb``:
        tokens, each step's logits and the MoE layers' top-k calls;
        computed once."""
        if ("greedy", absorb) in self._jax:
            return self._jax["greedy", absorb]
        step = jax.jit(lambda p, c, tok, pos: JT.decode_step(
            self.jcfg, p, c, JT.Batch(tokens=tok), pos, mla_absorb=absorb))
        b, plen = self.prompt.shape
        with recorded_top_k() as rec:
            cache = JT.init_cache(self.jcfg, b, plen + steps)
            for t in range(plen):
                lg, cache = step(self.jparams, cache,
                                 jnp.asarray(self.prompt[:, t:t + 1]),
                                 jnp.int32(t))
            toks, logits = [], [np.asarray(lg)]
            tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
            toks.append(tok)
            for i in range(steps - 1):
                lg, cache = step(self.jparams, cache, tok,
                                 jnp.int32(plen + i))
                logits.append(np.asarray(lg))
                tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
                toks.append(tok)
            toks = np.asarray(jnp.concatenate(toks, axis=1))
        self._jax["greedy", absorb] = toks, logits, rec
        return self._jax["greedy", absorb]


def jax_routes(jcfg, recs) -> list:
    """(top_e, keep) of each recorded top-k call of the reference's
    ``moe_apply``."""
    return [(te, capacity_keep(te, jcfg.moe.num_experts,
                               JM._capacity(te.shape[1], jcfg.moe)))
            for _, te in recs]


def check_routes(rec, jr):
    assert len(rec) == len(jr)
    for r, (te, keep) in zip(rec, jr):
        np.testing.assert_array_equal(r.top_e.numpy(), te)
        np.testing.assert_array_equal(r.keep.numpy(), keep)


@pytest.fixture(scope="module")
def case():
    return Case()


def test_forward_matches_reference(case):
    (got, rec), (want, jrec) = case.port_forward(), case.jax_forward_routes()
    assert got.shape == (*A.FORWARD_SHAPE, case.cfg.vocab_size)
    np.testing.assert_allclose(got, want, **F32)
    assert TT.layer_moe_flags(case.cfg) == [False, True, True]
    assert len(rec) == 2
    check_routes(rec, jax_routes(case.jcfg, jrec))
    assert all(not bool(r.keep.all()) for r in rec)   # drops happen


@pytest.mark.parametrize("absorb", [False, True], ids=["naive", "absorbed"])
def test_decode_steps_match_reference(case, absorb):
    """Teacher-forced: the prompt then the reference's greedy tokens of
    the same formulation, the logits of every step, every step's routes
    and keep masks (decode groups the batch: one slot an expert at batch
    2, so picks drop), and the compressed caches."""
    toks, want, jrec = case.jax_greedy(absorb)
    seq = np.concatenate([case.prompt, toks[:, :-1]], axis=1)
    cache = TT.init_cache(case.cfg, seq.shape[0], seq.shape[1] + 1,
                          device="cpu")
    plen = case.prompt.shape[1]
    with torch.no_grad(), A.record_routes() as rec:
        for t in range(seq.shape[1]):
            lg, cache = TT.decode_step(
                case.cfg, case.params, cache,
                TT.Batch(tokens=torch.as_tensor(seq[:, t:t + 1])), t,
                mla_absorb=absorb)
            if t >= plen - 1:
                np.testing.assert_allclose(lg.numpy(), want[t - plen + 1],
                                           **F32, err_msg=f"step {t}")
    check_routes(rec, jax_routes(case.jcfg, jrec))
    assert {type(c) for c in cache["layers"]} == {TA.MLACache}
    c = cache["layers"][0]
    assert tuple(c.c_kv.shape) == (2, seq.shape[1] + 1,
                                   case.cfg.kv_lora_rank)
    assert tuple(c.k_pe.shape) == (2, seq.shape[1] + 1,
                                   case.cfg.qk_rope_dim)


def test_greedy_tokens_match_reference(case):
    """token_serve.generate (naive decode, the reference's default)
    against the reference's tokens; the absorbed step serves the same
    tokens as the reference's absorbed run."""
    want, _, _ = case.jax_greedy()
    with torch.no_grad():
        got = token_serve.generate(case.cfg, case.params,
                                   torch.as_tensor(case.prompt),
                                   A.GREEDY_STEPS)
    np.testing.assert_array_equal(got["tokens"].numpy(), want)
    absorbed, _, _ = case.jax_greedy(True)
    np.testing.assert_array_equal(absorbed, want)


def test_decode_step_passes_mla_absorb_to_every_layer(case, monkeypatch):
    """``decode_step(mla_absorb=...)`` reaches every MLA layer, the
    prologue's ``pre_0`` included, as the reference's does;
    ``make_serve_step(cfg, mla_absorb=True)`` takes the absorbed step."""
    seen = []
    real = TA.mla_decode

    def spy(*args, absorb=False, **kw):
        seen.append(absorb)
        return real(*args, absorb=absorb, **kw)

    monkeypatch.setattr(TA, "mla_decode", spy)
    tok = TT.Batch(tokens=torch.as_tensor(case.prompt[:, :1]))
    for absorb in (False, True):
        seen.clear()
        cache = TT.init_cache(case.cfg, 2, 4, device="cpu")
        with torch.no_grad():
            TT.decode_step(case.cfg, case.params, cache, tok, 0,
                           mla_absorb=absorb)
        assert seen == [absorb] * case.cfg.num_layers
    seen.clear()
    step = S.make_serve_step(case.cfg, mla_absorb=True)
    step(case.params, TT.init_cache(case.cfg, 2, 4, device="cpu"), tok, 0)
    assert seen == [True] * case.cfg.num_layers


def test_gqa_ignores_mla_absorb():
    """A GQA model takes the flag and ignores it, as the reference's:
    the same logits and cache bitwise."""
    cfg = get_reduced_config("qwen2-0.5b")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tok = TT.Batch(tokens=torch.tensor([[3], [7]]))
    outs = []
    for absorb in (False, True):
        cache = TT.init_cache(cfg, 2, 4, device="cpu")
        with torch.no_grad():
            lg, cache = TT.decode_step(cfg, params, cache, tok, 0,
                                       mla_absorb=absorb)
        outs.append((lg, cache["layers"][0].k))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def _route_shares(rec, jrec) -> list:
    """The share of equal (token, choice) routes in each MoE layer of two
    forwards (numpy top-k calls or the port's ``Routes``)."""
    assert len(rec) == len(jrec)
    return [float((np.asarray(a.top_e if hasattr(a, "top_e") else a[1])
                   == b[1]).mean()) for a, b in zip(rec, jrec)]


def test_bfloat16_forward_matches_reference():
    """The bf16 forward against the reference's, no farther than the
    reference's float32 forward on the same weights is from it."""
    c = Case("bfloat16")
    mixer = c.params["layers"][0]["mixer"]
    assert mixer["w_uq"].dtype == torch.bfloat16
    assert mixer["q_norm"]["scale"].dtype == torch.float32
    assert mixer["kv_norm"]["scale"].dtype == torch.float32
    (got, rec), (want, jrec) = c.port_forward(), c.jax_forward_routes()
    with recorded_top_k() as wrec:
        wide = np.asarray(JT.forward(
            dataclasses.replace(c.jcfg, dtype="float32"),
            jax.tree.map(lambda a: a.astype(jnp.float32), c.jparams),
            JT.Batch(tokens=jnp.asarray(c.fwd_tokens))))
    diff, w_diff = np.abs(got - want).max(), np.abs(wide - want).max()
    assert diff <= BF16_WITNESS_RATIO * w_diff, (diff, w_diff)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    w_agree = (wide.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= w_agree - BF16_WITNESS_SHARE, (agree, w_agree)
    shares, w_shares = _route_shares(rec, jrec), _route_shares(wrec, jrec)
    assert len(shares) == 2
    for layer, (a, w) in enumerate(zip(shares, w_shares)):
        assert a >= w - BF16_WITNESS_SHARE, (layer, shares, w_shares)


def test_frozen_anchors_are_what_jax_computes(case):
    """``LM_ANCHORS["deepseek-v2-236b"]`` (which ``chip_smoke.py`` holds
    the card against) re-derived from the JAX reference: logits rows and
    sums, greedy tokens, the smallest top-1/top-2 gap, the forward's
    routes and the smallest router gap over the forward and the greedy
    run."""
    a = A.LM_ANCHORS[ARCH]
    logits, fwd_rec = case.jax_forward_routes()
    for (b, s), row, total in zip(A.ANCHOR_ROWS, a["logits"], a["row_sums"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row,
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(logits[b, s].astype(np.float64).sum(),
                                   total, atol=1e-4, rtol=1e-6)
    toks, steps, greedy_rec = case.jax_greedy()
    np.testing.assert_array_equal(toks, np.asarray(a["greedy"]))
    top2 = min(float(np.diff(np.sort(lg[:, -1].astype(np.float64),
                                     axis=-1)[:, -2:], axis=-1).min())
               for lg in steps)
    np.testing.assert_allclose(top2, a["min_top2_gap"], rtol=1e-6)
    routes = jax_routes(case.jcfg, fwd_rec)
    assert A.routes_digest(*zip(*routes)) == a["routes"]
    assert all(d > 0 for d in a["routes"]["dropped"])
    np.testing.assert_allclose(min_gap(fwd_rec + greedy_rec),
                               a["min_router_gap"], rtol=1e-6)


def test_port_matches_frozen_anchors(case):
    a = A.LM_ANCHORS[ARCH]
    logits, rec = case.port_forward()
    for (b, s), row in zip(A.ANCHOR_ROWS, a["logits"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row, **F32)
    assert A.routes_digest([r.top_e for r in rec],
                           [r.keep for r in rec]) == a["routes"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_match_the_reference(dtype):
    """The port's ``init_params`` makes the reference's leaves, counts
    and bytes (MLA's with a q LoRA); the numpy weights have the
    reference's layout."""
    cfg = get_reduced_config(ARCH, dtype=dtype)
    jcfg = jax_config(ARCH, dtype=dtype)
    want = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                          jax.random.key(0))
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert TT.param_count(params) == sum(w.size for w in
                                         jax.tree.leaves(want))
    assert TT.param_bytes(params) == sum(w.size * w.dtype.itemsize
                                         for w in jax.tree.leaves(want))
    got = A.jax_layout_params(cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == np.float32
    port = TT.params_from_jax(cfg, jax.tree.map(
        np.asarray, reference_dtypes(jcfg, got)))
    assert sorted(k for k, _ in _flatten(port)) \
        == sorted(k for k, _ in _flatten(params))
    for (k, p), (_, q) in zip(sorted(_flatten(port)),
                              sorted(_flatten(params))):
        assert p.shape == q.shape and p.dtype == q.dtype, k
    assert "w_uq" in params["layers"][0]["mixer"]


def test_token_serve_main_serves_on_cpu(capsys):
    out = token_serve.main(["--arch", ARCH, "--device", "cpu", "--reduced",
                            "--batch", "2", "--prompt-len", "8", "--gen",
                            "4"])
    assert out["tokens"].shape == (2, 4)
    assert out["prompts"].shape == (2, 8)
    assert "[serve]" in capsys.readouterr().out


@pytest.fixture(scope="module")
def mla_grads(case):
    """The reduced float32 model's loss and gradients from the reference
    (``jax.value_and_grad`` of its ``loss_fn``) at one ``SyntheticLM``
    batch of LOSS_SHAPE."""
    b, s = LOSS_SHAPE
    batch = SyntheticLM(case.cfg, DataConfig(seq_len=s, global_batch=b,
                                             seed=3)).batch_at(0)
    jb = JT.Batch(tokens=jnp.asarray(batch.tokens),
                  labels=jnp.asarray(batch.labels))
    loss, g = jax.value_and_grad(lambda p: JT.loss_fn(case.jcfg, p, jb))(
        case.jparams)
    grads = dict(_flatten(TT.params_from_jax(case.cfg,
                                             jax.tree.map(np.asarray, g))))
    tb = TT.Batch(tokens=torch.as_tensor(batch.tokens).long(),
                  labels=torch.as_tensor(batch.labels).long())
    return tb, float(loss), grads


def test_loss_and_gradients_match_jax(case, mla_grads):
    batch, want_loss, want = mla_grads
    params = S.trainable(TT.params_from_jax(
        case.cfg, jax.tree.map(np.asarray, case.jparams)))
    loss, g = S.value_and_grad(case.cfg, params, batch)
    np.testing.assert_allclose(float(loss), want_loss, **F32)
    got = dict(_flatten(g))
    assert sorted(got) == sorted(want)
    assert any("w_uq" in k for k in got) and any("kv_norm" in k for k in got)
    for path, t in got.items():
        w = want[path]
        assert t.shape == w.shape and t.dtype == torch.float32, path
        err = float((t - w).abs().max())
        assert err <= GRAD_REL * float(w.abs().max()), (path, err)
