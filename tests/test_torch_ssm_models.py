"""The port's SSM models — xlstm-350m (mLSTM and sLSTM blocks) and
jamba-v0.1-52b (Mamba and attention 7:1, MoE on every second layer,
sinusoidal positions) — against the reference's
``repro.models.transformer`` on the same weights.

The weights are made with numpy (``repro_torch.models.anchors.
jax_layout_params``) in the reference's stacked pytree layout, each leaf
cast to the dtype the reference's ``init_params`` gives it; the JAX
reference takes them as they are, the port through ``params_from_jax``.
The reduced xlstm-350m (4 layers, d 128, 4 heads, tied embeddings, no
FFN) and the reduced jamba (16 layers, d 128, 8 experts top-2 of 128 at
capacity factor 1.25, N 16, d_inner 256) run a forward at B 2, S 256,
8 teacher-forced decode steps and 8 greedy tokens, the loss and its
gradients at B 2, S 32, and a bf16 forward.

Tolerances.  Float32 logits within :data:`F32_SSM`, atol 1e-4 / rtol
1e-5: the other archs' bound (atol 2e-5) does not hold here, since the
recurrences carry float32 rounding from step to step and layer to
layer: the forward reads 6.9e-5 (xlstm) and 6.2e-5 (jamba) on logits of
|x| <= 5, each Mamba layer adding ~1e-5 on a residual stream of ~20, and
the mLSTM's normalizer, a sum of signed terms, amplifying the 2-ulp
differences of the two frameworks' cumulative sums of log f (XLA sums
them as a tree).  The frozen anchor rows read 1.8e-5 at most and hold
the other archs' bound.  Routes, keep masks and greedy tokens exactly:
the smallest top-1/top-2 logit gap is 6.4e-3 (xlstm) and 2.5e-2
(jamba), the smallest router gap 4.1e-6, above the float32 error of
the router probabilities.  Gradients within :data:`GRAD_REL_SSM` of each
leaf's largest magnitude (the other archs' 1e-5 does not hold: measured
1.3e-5 for xlstm and 6.8e-5 for jamba, through 4 and 16 layers of
recurrences), except where the true gradient is 0
(:data:`ZERO_GRAD_LEAVES`).

bf16: the transformer tests' bounds (0.125 on the logits, 95 % of the
argmaxes, 98 % of each MoE layer's routes) do not hold here, for the
reference against itself either.  Both frameworks round each op to
bf16, but XLA expands some ops into several rounded ones (its bf16
``silu`` rounds exp, 1 + e, 1 / (1 + e) and the product each; torch's
rounds once), so 30-50 % of a block's outputs differ by an ulp, and the
recurrences and 16 layers carry those ulps on; in jamba a flipped route
reaches every later token through the Mamba state, and with random
weights the routes are near ties from the first tokens on.  The
reference's own float32 forward on the same bf16 weights (the witness)
is as far from its bf16 forward: xlstm 0.457 at most and 95.5 % of the
argmaxes equal, jamba 3.06 and 78.3 %, its MoE layers' routes 98.5 %
falling to 84.3 %.  The port's bf16 forward is held to the witness
(:func:`test_bfloat16_forward_matches_reference`): measured xlstm 0.461
and 97.3 %, jamba 2.75 and 75.0 %, routes 98.8 % falling to 82.5 %.
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
from repro_torch.models import transformer as TT

ARCHS = ("xlstm-350m", "jamba-v0.1-52b")
F32_SSM = dict(atol=1e-4, rtol=1e-5)
F32 = dict(atol=2e-5, rtol=1e-5)
GRAD_REL_SSM = 2e-4
#: sLSTM input-gate biases: a constant shift of log_i scales c and n
#: alike, so h does not move and the true gradient is 0 (the reference's
#: reads 1e-10); held under 1e-6 of the model's largest gradient.
ZERO_GRAD_LEAVES = ("mixer/b_i",)
#: The port's bf16 forward against the reference's, beside the witness
#: (the reference's float32 forward against its bf16 one, same weights):
#: the largest logit difference at most BF16_WITNESS_RATIO times the
#: witness's, the shares of equal argmaxes and of each MoE layer's equal
#: routes at most BF16_WITNESS_SHARE below the witness's.
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
    reference's ``init_params`` for ``jcfg`` (norm scales, the MoE router
    and the SSM blocks' float32 leaves stay float32 in a bf16 model)."""
    want = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                          jax.random.key(0))
    leaves, treedef = jax.tree.flatten(tree)
    assert treedef == jax.tree.structure(want)
    return jax.tree.unflatten(treedef, [
        jnp.asarray(a).astype(w.dtype)
        for a, w in zip(leaves, jax.tree.leaves(want))])


class Case:
    def __init__(self, arch, dtype="float32"):
        self.cfg = get_reduced_config(arch, dtype=dtype)
        self.jcfg = jax_config(arch, dtype=dtype)
        self.jparams = reference_dtypes(self.jcfg,
                                        A.jax_layout_params(self.cfg))
        self.params = TT.params_from_jax(
            self.cfg, jax.tree.map(np.asarray, self.jparams))
        self.fwd_tokens, self.prompt = A.anchor_tokens(self.cfg)
        self._jax = {}

    def jax_forward_routes(self):
        """The reference's forward logits (float32 numpy) and the
        top-k calls its MoE layers made; computed once."""
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

    def jax_greedy(self, steps=A.GREEDY_STEPS):
        """The reference's token-serve loop (prefill through a jitted
        decode_step, then argmax steps): tokens, each step's logits and
        the MoE layers' top-k calls; computed once."""
        if "greedy" in self._jax:
            return self._jax["greedy"]
        step = jax.jit(lambda p, c, tok, pos: JT.decode_step(
            self.jcfg, p, c, JT.Batch(tokens=tok), pos))
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
        self._jax["greedy"] = toks, logits, rec
        return self._jax["greedy"]


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


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def test_forward_matches_reference(case):
    (got, rec), (want, jrec) = case.port_forward(), case.jax_forward_routes()
    assert got.shape == (*A.FORWARD_SHAPE, case.cfg.vocab_size)
    np.testing.assert_allclose(got, want, **F32_SSM)
    n_moe = sum(TT.layer_moe_flags(case.cfg))
    assert len(rec) == n_moe == (8 if case.cfg.moe else 0)
    check_routes(rec, jax_routes(case.jcfg, jrec))
    if n_moe:
        assert any(not bool(r.keep.all()) for r in rec)   # drops happen


def test_decode_steps_match_reference(case):
    """Teacher-forced: the prompt then the reference's greedy tokens,
    the logits of every step and, for jamba, every step's routes and
    keep masks (decode groups the batch: one slot an expert at batch 2,
    so picks drop)."""
    toks, want, jrec = case.jax_greedy()
    seq = np.concatenate([case.prompt, toks[:, :-1]], axis=1)
    cache = TT.init_cache(case.cfg, seq.shape[0], seq.shape[1] + 1,
                          device="cpu")
    plen = case.prompt.shape[1]
    with torch.no_grad(), A.record_routes() as rec:
        for t in range(seq.shape[1]):
            lg, cache = TT.decode_step(
                case.cfg, case.params, cache,
                TT.Batch(tokens=torch.as_tensor(seq[:, t:t + 1])), t)
            if t >= plen - 1:
                np.testing.assert_allclose(lg.numpy(), want[t - plen + 1],
                                           **F32_SSM, err_msg=f"step {t}")
    check_routes(rec, jax_routes(case.jcfg, jrec))
    kinds = {type(c).__name__ for c in cache["layers"]}
    assert kinds == ({"MLSTMState", "SLSTMState"} if case.cfg.moe is None
                     else {"MambaState", "KVCache"})


def test_greedy_tokens_match_reference(case):
    want, _, _ = case.jax_greedy()
    with torch.no_grad():
        got = token_serve.generate(case.cfg, case.params,
                                   torch.as_tensor(case.prompt),
                                   A.GREEDY_STEPS)
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


def _route_shares(rec, jrec) -> list:
    """The share of equal (token, choice) routes in each MoE layer of two
    forwards (numpy top-k calls or the port's ``Routes``)."""
    assert len(rec) == len(jrec)
    return [float((np.asarray(a.top_e if hasattr(a, "top_e") else a[1])
                   == b[1]).mean()) for a, b in zip(rec, jrec)]


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_forward_matches_reference(arch):
    """The bf16 forward against the reference's, no farther than the
    reference's float32 forward on the same weights is from it."""
    c = Case(arch, "bfloat16")
    layer0 = c.params["layers"][0]["mixer"]
    assert layer0["w_up" if "w_up" in layer0 else "in_proj"].dtype \
        == torch.bfloat16
    for k in ("A_log", "D", "dt_bias", "w_ig", "b_fg"):
        if k in layer0:
            assert layer0[k].dtype == torch.float32, k
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
    shares = _route_shares(rec, jrec)
    w_shares = _route_shares(wrec, jrec)
    assert len(shares) == (8 if c.cfg.moe else 0)
    for layer, (a, w) in enumerate(zip(shares, w_shares)):
        assert a >= w - BF16_WITNESS_SHARE, (layer, shares, w_shares)


@pytest.mark.parametrize("arch", ARCHS)
def test_frozen_anchors_are_what_jax_computes(arch):
    """``LM_ANCHORS`` (which ``chip_smoke.py`` holds the card against)
    re-derived from the JAX reference: logits rows and sums, greedy
    tokens, the smallest top-1/top-2 gap, and for jamba the forward's
    routes and the smallest router gap over the forward and the greedy
    run."""
    c, a = Case(arch), A.LM_ANCHORS[arch]
    logits, fwd_rec = c.jax_forward_routes()
    for (b, s), row, total in zip(A.ANCHOR_ROWS, a["logits"], a["row_sums"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row,
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(logits[b, s].astype(np.float64).sum(),
                                   total, atol=1e-4, rtol=1e-6)
    toks, steps, greedy_rec = c.jax_greedy()
    np.testing.assert_array_equal(toks, np.asarray(a["greedy"]))
    top2 = min(float(np.diff(np.sort(lg[:, -1].astype(np.float64),
                                     axis=-1)[:, -2:], axis=-1).min())
               for lg in steps)
    np.testing.assert_allclose(top2, a["min_top2_gap"], rtol=1e-6)
    if c.cfg.moe is None:
        assert not fwd_rec and not greedy_rec and "routes" not in a
        return
    routes = jax_routes(c.jcfg, fwd_rec)
    assert A.routes_digest(*zip(*routes)) == a["routes"]
    assert all(d > 0 for d in a["routes"]["dropped"])
    np.testing.assert_allclose(min_gap(fwd_rec + greedy_rec),
                               a["min_router_gap"], rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_matches_frozen_anchors(arch):
    c, a = Case(arch), A.LM_ANCHORS[arch]
    logits, rec = c.port_forward()
    for (b, s), row in zip(A.ANCHOR_ROWS, a["logits"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row, **F32)
    if "routes" in a:
        assert A.routes_digest([r.top_e for r in rec],
                               [r.keep for r in rec]) == a["routes"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_match_the_reference(arch, dtype):
    """The port's ``init_params`` makes the reference's leaves, counts
    and bytes; the numpy weights have the reference's layout."""
    cfg = get_reduced_config(arch, dtype=dtype)
    jcfg = jax_config(arch, dtype=dtype)
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


def test_xlstm_blocks_build_no_ffn_beside_them():
    """The reference's FFN rule: an mLSTM or sLSTM block takes no FFN
    even where d_ff > 0 (their projections live inside the blocks); a
    Mamba block beside them does."""
    cfg = dataclasses.replace(get_reduced_config("xlstm-350m"), d_ff=64,
                              block_pattern=("mlstm", "slstm", "mamba"),
                              num_layers=3)
    jcfg = dataclasses.replace(jax_config("xlstm-350m"), d_ff=64,
                               block_pattern=("mlstm", "slstm", "mamba"),
                               num_layers=3)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert ["ffn" in p for p in params["layers"]] == [False, False, True]
    want = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                          jax.random.key(0))
    assert ["ffn" in b for b in want["blocks"]] == [False, False, True]
    assert TT.param_count(params) == sum(w.size for w in
                                         jax.tree.leaves(want))


def test_sinusoidal_positions_match_reference():
    """Jamba's absolute positions: the reference's sines and cosines at
    positions up to 4096 within float32 rounding.  The frameworks round
    ``10000 ** (i / half)`` apart by an ulp at some i, which moves an
    angle at position 4096 by up to 4096 x 6e-8 = 2.4e-4 (measured
    2.4e-4); elsewhere they agree to 6e-8."""
    pos = np.arange(0, 4097, 7, dtype=np.int32).reshape(1, -1)
    want = np.asarray(JT._sinusoidal(jnp.asarray(pos), 4096))
    got = TT._sinusoidal(torch.as_tensor(pos), 4096).numpy()
    assert got.shape == want.shape == (1, pos.shape[1], 4096)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    # the first 64 frequencies round alike: there only sin/cos differ
    np.testing.assert_allclose(got[..., :64], want[..., :64], atol=1e-6,
                               rtol=0)


def test_decode_step_places_the_token_at_pos_without_rope():
    """Without RoPE and without positions, ``decode_step`` embeds the
    token at ``pos`` (the reference's ``full((B, 1), pos)``): the same
    logits as passing those positions."""
    c = Case("jamba-v0.1-52b")
    tok = torch.as_tensor(c.prompt[:, :1])
    outs = []
    for positions in (None, torch.full((2, 1), 5, dtype=torch.int32)):
        cache = TT.init_cache(c.cfg, 2, 8, device="cpu")
        with torch.no_grad():
            lg, _ = TT.decode_step(c.cfg, c.params, cache,
                                   TT.Batch(tokens=tok, positions=positions),
                                   5)
        outs.append(lg)
    assert torch.equal(outs[0], outs[1])
    cache = TT.init_cache(c.cfg, 2, 8, device="cpu")
    with torch.no_grad():
        at0, _ = TT.decode_step(c.cfg, c.params, cache, TT.Batch(tokens=tok),
                                0)
    assert not torch.equal(at0, outs[0])


@pytest.fixture(scope="module", params=ARCHS)
def ssm_grads(request):
    """The reduced float32 model's loss, aux and gradients from the
    reference (``jax.value_and_grad`` of its ``loss_fn``) at one
    ``SyntheticLM`` batch of LOSS_SHAPE."""
    case = Case(request.param)
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
    return case, tb, float(loss), grads


def test_loss_and_gradients_match_jax(ssm_grads):
    case, batch, want_loss, want = ssm_grads
    params = S.trainable(TT.params_from_jax(
        case.cfg, jax.tree.map(np.asarray, case.jparams)))
    loss, g = S.value_and_grad(case.cfg, params, batch)
    np.testing.assert_allclose(float(loss), want_loss, **F32)
    got = dict(_flatten(g))
    assert sorted(got) == sorted(want)
    top = max(float(w.abs().max()) for w in want.values())
    for path, t in got.items():
        w = want[path]
        assert t.shape == w.shape and t.dtype == torch.float32, path
        if path.endswith(ZERO_GRAD_LEAVES):
            assert float(w.abs().max()) <= 1e-6 * top
            assert float(t.abs().max()) <= 1e-6 * top, path
            continue
        err = float((t - w).abs().max())
        assert err <= GRAD_REL_SSM * float(w.abs().max()), (path, err)
