"""The port's LM serving path (``repro_torch.models.transformer`` and
``repro_torch.launch.token_serve``) against the reference's
``repro.models.transformer`` on the same weights.

The weights are made with numpy (``repro_torch.models.anchors.
jax_layout_params``) in the reference's stacked pytree layout; the JAX
reference takes them as they are, the port through ``params_from_jax``.
The reduced gemma2-2b (4 layers, d 128, 4/2 heads of 32, window 64,
softcaps 50 and 30, post-norms, scaled tied embeddings), the reduced
qwen2-0.5b (2 layers, QKV bias, theta 1e6) and the reduced arctic-480b
(2 MoE layers, 8 experts top-2 of 128 at capacity factor 1.25, a dense
residual FFN beside them) run a forward at B 2, S 256 (so the window
bites, and arctic drops picks at capacity), 8 decode steps and 8 greedy
tokens.  Arctic also runs with a dense prologue (``first_k_dense``),
with MoE on every second layer and with the reference's one-position
pattern that builds no MoE layer at all, and its loss and gradients.

Tolerances: float32 logits within atol 2e-5 / rtol 1e-5 (measured
~5e-6 on logits of |x| <= 7: float32 matmuls and reductions in another
order); bf16 logits within 0.125 absolute (one bf16 ulp at 16 <= |x| <
32; measured 0.055-0.063) with at least 95 % of the argmaxes equal
(measured 97-99 %), since bf16 rounds at other places in the two
frameworks.  In a bf16 MoE those roundings also flip a router's near
ties (the reduced arctic's smallest float32 router gap is 1.4e-5, far
below bf16's rounding), so a token can take another expert there: the
MoE case holds at least 98 % of each layer's routes equal (measured
99.9 and 98.5 %) and the logits to 0.125 at the tokens whose routes
agree in every layer (measured 0.119; elsewhere up to 2.1).  Routes,
keep masks and greedy tokens exactly in float32: the anchors' smallest
top-1/top-2 gap is 0.02, three orders above the float32 error, and
their smallest router gap 1.4e-5, two orders above it.
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

ARCHS = ("gemma2-2b", "qwen2-0.5b", "arctic-480b")
F32 = dict(atol=2e-5, rtol=1e-5)
BF16_ATOL, BF16_ARGMAX = 0.125, 0.95
BF16_ROUTES = 0.98
GRAD_REL = 1e-5


def _cast(tree, dtype):
    """The numpy weights in the compute dtype, norm scales and the MoE
    router float32 (as the reference's init makes them)."""
    def go(t, path):
        if isinstance(t, dict):
            return {k: go(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(go(v, path) for v in t)
        a = jnp.asarray(t)
        return a if {"scale", "router"} & set(path) else a.astype(dtype)
    return go(tree, ())


class Case:
    def __init__(self, arch, dtype="float32", every_k_layers=None,
                 **overrides):
        self.cfg = get_reduced_config(arch, dtype=dtype, **overrides)
        self.jcfg = jax_config(arch, dtype=dtype, **overrides)
        if every_k_layers:
            self.cfg, self.jcfg = (
                dataclasses.replace(c, moe=dataclasses.replace(
                    c.moe, every_k_layers=every_k_layers))
                for c in (self.cfg, self.jcfg))
        self.jparams = _cast(A.jax_layout_params(self.cfg), dtype)
        self.params = TT.params_from_jax(
            self.cfg, jax.tree.map(np.asarray, self.jparams))
        self.fwd_tokens, self.prompt = A.anchor_tokens(self.cfg)
        self.greedy = {}

    def jax_forward(self):
        out = JT.forward(self.jcfg, self.jparams,
                         JT.Batch(tokens=jnp.asarray(self.fwd_tokens)))
        return np.asarray(out.astype(jnp.float32))

    def port_forward(self):
        with torch.no_grad():
            out = TT.forward(self.cfg, self.params,
                             TT.Batch(tokens=torch.as_tensor(
                                 self.fwd_tokens)))
        return out.float().numpy()

    def forward_routes(self) -> tuple:
        """Both forwards' logits and routes: (port logits, [port
        Routes]), (reference logits, [(top_e, keep)]) by MoE layer."""
        with A.record_routes() as rec:
            got = self.port_forward()
        with recorded_top_k() as jrec:
            want = self.jax_forward()
        return (got, rec), (want, jax_routes(self.jcfg, jrec))


def jax_routes(jcfg, recs) -> list:
    """(top_e, keep) of each recorded top-k call of the reference's
    ``moe_apply``."""
    return [(te, capacity_keep(te, jcfg.moe.num_experts,
                               JM._capacity(te.shape[1], jcfg.moe)))
            for _, te in recs]


def jax_greedy(case, steps):
    """The reference's token-serve loop (prefill through a jitted
    decode_step, then argmax steps) on the given weights; returns the
    tokens and each step's logits.  Cached on ``case``."""
    if steps in case.greedy:
        return case.greedy[steps]
    step = jax.jit(lambda p, c, tok, pos: JT.decode_step(
        case.jcfg, p, c, JT.Batch(tokens=tok), pos))
    b, plen = case.prompt.shape
    cache = JT.init_cache(case.jcfg, b, plen + steps)
    for t in range(plen):
        lg, cache = step(case.jparams, cache,
                         jnp.asarray(case.prompt[:, t:t + 1]), jnp.int32(t))
    toks, logits = [], [np.asarray(lg)]
    tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
    toks.append(tok)
    for i in range(steps - 1):
        lg, cache = step(case.jparams, cache, tok, jnp.int32(plen + i))
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
        toks.append(tok)
    case.greedy[steps] = np.asarray(jnp.concatenate(toks, axis=1)), logits
    return case.greedy[steps]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def test_forward_matches_reference(case):
    got, want = case.port_forward(), case.jax_forward()
    assert got.shape == (*A.FORWARD_SHAPE, case.cfg.vocab_size)
    np.testing.assert_allclose(got, want, **F32)


def test_decode_steps_match_reference(case):
    """Teacher-forced: the prompt then the reference's greedy tokens, the
    logits of every step."""
    toks, want = jax_greedy(case, A.GREEDY_STEPS)
    seq = np.concatenate([case.prompt, toks[:, :-1]], axis=1)
    cache = TT.init_cache(case.cfg, seq.shape[0], seq.shape[1] + 1,
                          device="cpu")
    plen = case.prompt.shape[1]
    with torch.no_grad():
        for t in range(seq.shape[1]):
            lg, cache = TT.decode_step(
                case.cfg, case.params, cache,
                TT.Batch(tokens=torch.as_tensor(seq[:, t:t + 1])), t)
            if t >= plen - 1:
                np.testing.assert_allclose(lg.numpy(), want[t - plen + 1],
                                           **F32, err_msg=f"step {t}")


def test_greedy_tokens_match_reference(case):
    want, _ = jax_greedy(case, A.GREEDY_STEPS)
    with torch.no_grad():
        got = token_serve.generate(case.cfg, case.params,
                                   torch.as_tensor(case.prompt),
                                   A.GREEDY_STEPS)
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_forward_matches_reference(arch):
    c = Case(arch, "bfloat16")
    assert c.params["layers"][0]["mixer"]["w_q"].dtype == torch.bfloat16
    assert c.params["layers"][0]["norm1"]["scale"].dtype == torch.float32
    if c.cfg.moe:
        assert c.params["layers"][0]["ffn"]["router"].dtype == torch.float32
    (got, rec), (want, jr) = c.forward_routes()
    # the tokens whose routes and keep flags agree in every MoE layer
    # (every token in a dense model)
    ok = np.ones(got.shape[:2], bool)
    for r, (te, keep) in zip(rec, jr):
        agree = r.top_e.numpy() == te
        assert agree.mean() >= BF16_ROUTES, agree.mean()
        ok &= (agree & (r.keep.numpy() == keep)).reshape(
            *got.shape[:2], -1).all(-1)
    assert len(rec) == len(jr) == (c.cfg.num_layers if c.cfg.moe else 0)
    np.testing.assert_allclose(got[ok], want[ok], atol=BF16_ATOL, rtol=0)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= BF16_ARGMAX, agree


def _check_routes(rec, jr):
    assert len(rec) == len(jr)
    for r, (te, keep) in zip(rec, jr):
        np.testing.assert_array_equal(r.top_e.numpy(), te)
        np.testing.assert_array_equal(r.keep.numpy(), keep)


@pytest.mark.parametrize("arch", ARCHS)
def test_frozen_anchors_are_what_jax_computes(arch):
    """``LM_ANCHORS`` (which ``chip_smoke.py`` holds the card against)
    re-derived from the JAX reference; for MoE archs also the forward's
    routes, the smallest router gap over the forward and the greedy run,
    and the smallest top-1/top-2 logit gap of the greedy steps."""
    c, a = Case(arch), A.LM_ANCHORS[arch]
    with recorded_top_k() as fwd_rec:
        logits = c.jax_forward()
    for (b, s), row, total in zip(A.ANCHOR_ROWS, a["logits"], a["row_sums"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row,
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(logits[b, s].astype(np.float64).sum(),
                                   total, atol=1e-4, rtol=1e-6)
    with recorded_top_k() as greedy_rec:
        toks, steps = jax_greedy(c, A.GREEDY_STEPS)
    np.testing.assert_array_equal(toks, np.asarray(a["greedy"]))
    if c.cfg.moe is None:
        assert not fwd_rec and not greedy_rec
        return
    routes = jax_routes(c.jcfg, fwd_rec)
    assert A.routes_digest(*zip(*routes)) == a["routes"]
    assert all(d > 0 for d in a["routes"]["dropped"])
    np.testing.assert_allclose(min_gap(fwd_rec + greedy_rec),
                               a["min_router_gap"], rtol=1e-6)
    top2 = min(float(np.diff(np.sort(lg[:, -1].astype(np.float64),
                                     axis=-1)[:, -2:], axis=-1).min())
               for lg in steps)
    np.testing.assert_allclose(top2, a["min_top2_gap"], rtol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_matches_frozen_anchors(arch):
    c, a = Case(arch), A.LM_ANCHORS[arch]
    with A.record_routes() as rec:
        logits = c.port_forward()
    for (b, s), row in zip(A.ANCHOR_ROWS, a["logits"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row, **F32)
    if "routes" in a:
        assert A.routes_digest([r.top_e for r in rec],
                               [r.keep for r in rec]) == a["routes"]


def test_params_from_jax_takes_layer_i_from_repeat_i_div_p():
    c = Case("gemma2-2b")
    pat = len(c.cfg.block_pattern)
    assert len(c.params["layers"]) == c.cfg.num_layers == 4
    for i, layer in enumerate(c.params["layers"]):
        rep, posn = divmod(i, pat)
        src = c.jparams["blocks"][posn]
        np.testing.assert_array_equal(layer["mixer"]["w_q"].numpy(),
                                      np.asarray(src["mixer"]["w_q"][rep]))
        np.testing.assert_array_equal(layer["post_norm2"]["scale"].numpy(),
                                      np.asarray(src["post_norm2"]["scale"]
                                                 [rep]))
    with pytest.raises(ValueError, match="repeats"):
        bad = jax.tree.map(np.asarray, c.jparams)
        bad["blocks"] = tuple(jax.tree.map(lambda x: x[:1], b)
                              for b in bad["blocks"])
        TT.params_from_jax(c.cfg, bad)


@pytest.mark.parametrize("arch", ARCHS)
def test_numpy_weights_have_the_reference_layout(arch):
    cfg = get_reduced_config(arch, dtype="float32")
    want = jax.eval_shape(lambda k: JT.init_params(jax_config(
        arch, dtype="float32"), k), jax.random.key(0))
    got = A.jax_layout_params(cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype


@pytest.mark.parametrize("arch,dtype", [("gemma2-2b", "float32"),
                                        ("qwen2-0.5b", "bfloat16"),
                                        ("arctic-480b", "bfloat16")])
def test_init_params_counts_match_reference(arch, dtype):
    cfg = get_reduced_config(arch, dtype=dtype)
    ref = JT.init_params(jax_config(arch, dtype=dtype), jax.random.key(0))
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert TT.param_count(params) == JT.param_count(ref)
    assert TT.param_bytes(params) == JT.param_bytes(ref)
    emb = params["embed"]["table"].float()
    # the reference's fan-in scale d^-0.5, within sampling error
    assert abs(emb.std().item() * cfg.d_model ** 0.5 - 1) < 0.05


def test_token_serve_main_on_cpu():
    argv = ["--arch", "gemma2-2b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "6", "--gen", "5"]
    out = token_serve.main(argv)
    assert set(out) >= {"tokens", "decode_tok_per_s", "prefill_s"}
    assert out["tokens"].shape == (2, 5) and out["prompts"].shape == (2, 6)
    assert np.array_equal(out["tokens"], token_serve.main(argv)["tokens"])
    # the same loop on the same weights and prompts
    cfg = get_reduced_config("gemma2-2b")
    gen = torch.Generator().manual_seed(0)
    params = TT.init_params(cfg, gen, "cpu")
    prompts = torch.randint(0, cfg.vocab_size, (2, 6), generator=gen)
    assert np.array_equal(prompts.numpy(), out["prompts"])
    with torch.no_grad():
        again = token_serve.generate(cfg, params, prompts, 5)
    assert np.array_equal(again["tokens"].numpy(), out["tokens"])
    sampled = token_serve.main(argv + ["--temperature", "0.8"])
    assert sampled["tokens"].shape == (2, 5)
    assert (sampled["tokens"] < cfg.vocab_size).all()


#: Decode steps past gemma2's sliding window: the reduced config's window
#: is 64, so after the 8-token prompt the last 48 of these steps attend
#: through it.
PAST_WINDOW_STEPS = 104


def test_decode_past_the_window_matches_reference():
    """Teacher-forced decode of the reduced gemma2-2b (window 64) for
    :data:`PAST_WINDOW_STEPS` steps against the reference's jitted
    ``decode_step``, every step's logits at the float32 tolerances, and
    the greedy tokens of the same length."""
    case = Case("gemma2-2b")
    assert case.cfg.sliding_window == 64
    toks, want = jax_greedy(case, PAST_WINDOW_STEPS)
    plen = case.prompt.shape[1]
    assert plen + PAST_WINDOW_STEPS > 1.5 * case.cfg.sliding_window
    seq = np.concatenate([case.prompt, toks[:, :-1]], axis=1)
    cache = TT.init_cache(case.cfg, seq.shape[0], seq.shape[1] + 1,
                          device="cpu")
    worst = 0.0
    with torch.no_grad():
        for t in range(seq.shape[1]):
            lg, cache = TT.decode_step(
                case.cfg, case.params, cache,
                TT.Batch(tokens=torch.as_tensor(seq[:, t:t + 1])), t)
            if t >= plen - 1:
                ref = want[t - plen + 1]
                np.testing.assert_allclose(lg.numpy(), ref, **F32,
                                           err_msg=f"step {t}")
                worst = max(worst, float(np.abs(lg.numpy() - ref).max()))
        got = token_serve.generate(case.cfg, case.params,
                                   torch.as_tensor(case.prompt),
                                   PAST_WINDOW_STEPS)
    np.testing.assert_array_equal(got["tokens"].numpy(), toks)
    print(f"worst |logit error| over {PAST_WINDOW_STEPS} steps: {worst:.3g}")


# ---------------------------------------------------------------------------
# MoE stacks: the prologue, MoE flags by pattern position, loss and grads
# ---------------------------------------------------------------------------

#: (overrides, the reference's MoE flag of each layer): a dense prologue
#: layer before two MoE layers; MoE on every second layer of a
#: two-position pattern; and the one-position pattern at every_k_layers
#: 2, where ``_pattern_moe_flags`` gives position 0 the flag of layer 0
#: in every repeat, so the reference builds no MoE layer at all.
STACKS = {
    "prologue": (dict(first_k_dense=1, num_layers=3), [False, True, True]),
    "every2_pattern2": (dict(block_pattern=("attn", "attn"), num_layers=4,
                             every_k_layers=2), [False, True, False, True]),
    "every2_pattern1": (dict(every_k_layers=2), [False, False]),
}


@pytest.fixture(scope="module", params=sorted(STACKS))
def stack(request):
    overrides, flags = STACKS[request.param]
    return Case("arctic-480b", **overrides), flags


def test_stack_layers_and_flags_are_the_references(stack):
    case, flags = stack
    assert TT.layer_moe_flags(case.cfg) == flags
    assert [("router" in p.get("ffn", {})) for p in case.params["layers"]] \
        == flags
    want = jax.eval_shape(lambda k: JT.init_params(case.jcfg, k),
                          jax.random.key(0))
    assert jax.tree.structure(case.jparams) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(case.jparams), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    params = TT.init_params(case.cfg, torch.Generator().manual_seed(0),
                            "cpu")
    assert TT.param_count(params) == sum(x.size for x in
                                         jax.tree.leaves(want))
    if case.cfg.first_k_dense:
        pre = case.jparams["pre_0"]
        np.testing.assert_array_equal(
            case.params["layers"][0]["ffn"]["w_up"].numpy(),
            np.asarray(pre["ffn"]["w_up"]))
        np.testing.assert_array_equal(
            case.params["layers"][2]["ffn"]["router"].numpy(),
            np.asarray(case.jparams["blocks"][0]["ffn"]["router"][1]))


def test_stack_forward_and_routes_match_reference(stack):
    case, flags = stack
    (got, rec), (want, jr) = case.forward_routes()
    np.testing.assert_allclose(got, want, **F32)
    assert len(rec) == sum(flags)
    _check_routes(rec, jr)


def test_stack_decode_matches_reference(stack):
    """Teacher-forced decode (each step's batch of 2 one group, so one
    slot an expert) against the reference's jitted decode_step."""
    case, flags = stack
    steps = 4
    toks, want = jax_greedy(case, steps)
    seq = np.concatenate([case.prompt, toks[:, :-1]], axis=1)
    plen = case.prompt.shape[1]
    cache = TT.init_cache(case.cfg, 2, seq.shape[1] + 1, device="cpu")
    assert len(cache["layers"]) == len(flags)
    with torch.no_grad():
        for t in range(seq.shape[1]):
            lg, cache = TT.decode_step(
                case.cfg, case.params, cache,
                TT.Batch(tokens=torch.as_tensor(seq[:, t:t + 1])), t)
            if t >= plen - 1:
                np.testing.assert_allclose(lg.numpy(), want[t - plen + 1],
                                           **F32, err_msg=f"step {t}")
        got = token_serve.generate(case.cfg, case.params,
                                   torch.as_tensor(case.prompt), steps)
    np.testing.assert_array_equal(got["tokens"].numpy(), toks)


def test_decode_drops_picks_at_capacity():
    """Decode groups the batch: at batch 2 with 8 experts a slot an
    expert, so two tokens sharing an expert drop a pick; the routes of
    every step of the greedy run equal the reference's, drops
    included."""
    case = Case("arctic-480b")
    with recorded_top_k() as jrec:
        toks, _ = jax_greedy(case, A.GREEDY_STEPS)
    with A.record_routes() as rec, torch.no_grad():
        got = token_serve.generate(case.cfg, case.params,
                                   torch.as_tensor(case.prompt),
                                   A.GREEDY_STEPS)
    np.testing.assert_array_equal(got["tokens"].numpy(), toks)
    jr = jax_routes(case.jcfg, jrec)
    _check_routes(rec, jr)
    assert all(r.top_e.shape == (1, 2, 2) for r in rec)
    assert not all(bool(r.keep.all()) for r in rec)


@pytest.fixture(scope="module")
def arctic_grads():
    """The reduced float32 arctic's loss, aux and gradients from the
    reference (``jax.value_and_grad`` of its ``loss_fn``) at one
    ``SyntheticLM`` batch of 2 x 64 tokens."""
    case = Case("arctic-480b")
    b = SyntheticLM(case.cfg, DataConfig(seq_len=64, global_batch=2,
                                         seed=3)).batch_at(0)
    jb = JT.Batch(tokens=jnp.asarray(b.tokens), labels=jnp.asarray(b.labels))
    loss, g = jax.value_and_grad(lambda p: JT.loss_fn(case.jcfg, p, jb))(
        case.jparams)
    _, aux = JT.hidden_states(case.jcfg, case.jparams, jb)
    grads = dict(_flatten(TT.params_from_jax(case.cfg,
                                             jax.tree.map(np.asarray, g))))
    tb = TT.Batch(tokens=torch.as_tensor(b.tokens).long(),
                  labels=torch.as_tensor(b.labels).long())
    return case, tb, float(loss), float(aux), grads


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_moe_loss_aux_and_gradients_match_jax(arctic_grads, remat):
    case, batch, want_loss, want_aux, want = arctic_grads
    params = S.trainable(TT.params_from_jax(
        case.cfg, jax.tree.map(np.asarray, case.jparams)))
    with torch.no_grad():
        _, aux = TT.hidden_states(case.cfg, params, batch, remat=remat)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), want_aux, **F32)
    loss, g = S.value_and_grad(case.cfg, params, batch, remat=remat)
    np.testing.assert_allclose(float(loss), want_loss, **F32)
    got = dict(_flatten(g))
    assert sorted(got) == sorted(want)
    assert "layers/1/ffn/router" in got and "layers/0/ffn/residual/w_up" \
        in got
    for path, t in got.items():
        w = want[path]
        assert t.shape == w.shape and t.dtype == torch.float32, path
        err = float((t - w).abs().max())
        assert err <= GRAD_REL * float(w.abs().max()), (path, err)
