"""The port's LM serving path (``repro_torch.models.transformer`` and
``repro_torch.launch.token_serve``) against the reference's
``repro.models.transformer`` on the same weights.

The weights are made with numpy (``repro_torch.models.anchors.
jax_layout_params``) in the reference's stacked pytree layout; the JAX
reference takes them as they are, the port through ``params_from_jax``.
The reduced gemma2-2b (4 layers, d 128, 4/2 heads of 32, window 64,
softcaps 50 and 30, post-norms, scaled tied embeddings) and the reduced
qwen2-0.5b (2 layers, QKV bias, theta 1e6) run a forward at B 2, S 256
(so the window bites), 8 decode steps and 8 greedy tokens.

Tolerances: float32 logits within atol 2e-5 / rtol 1e-5 (measured
~5e-6 on logits of |x| <= 7: float32 matmuls and reductions in another
order); bf16 logits within 0.125 absolute (one bf16 ulp at 16 <= |x| <
32; measured 0.055-0.063) with at least 95 % of the argmaxes equal
(measured 98-99 %), since bf16 rounds at other places in the two
frameworks.  Greedy tokens exactly: the anchors' smallest top-1/top-2
gap is 0.05, four orders above the float32 error.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models import transformer as JT
from repro_torch.configs import get_reduced_config
from repro_torch.launch import token_serve
from repro_torch.models import anchors as A
from repro_torch.models import transformer as TT

ARCHS = ("gemma2-2b", "qwen2-0.5b")
F32 = dict(atol=2e-5, rtol=1e-5)
BF16_ATOL, BF16_ARGMAX = 0.125, 0.95


def _cast(tree, dtype):
    """The numpy weights in the compute dtype, norm scales float32."""
    def go(t, path):
        if isinstance(t, dict):
            return {k: go(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(go(v, path) for v in t)
        a = jnp.asarray(t)
        return a if "scale" in path else a.astype(dtype)
    return go(tree, ())


class Case:
    def __init__(self, arch, dtype="float32"):
        self.cfg = get_reduced_config(arch, dtype=dtype)
        self.jcfg = jax_config(arch, dtype=dtype)
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
    got, want = c.port_forward(), c.jax_forward()
    np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=0)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= BF16_ARGMAX, agree


@pytest.mark.parametrize("arch", ARCHS)
def test_frozen_anchors_are_what_jax_computes(arch):
    """``LM_ANCHORS`` (which ``chip_smoke.py`` holds the card against)
    re-derived from the JAX reference."""
    c, a = Case(arch), A.LM_ANCHORS[arch]
    logits = c.jax_forward()
    for (b, s), row, total in zip(A.ANCHOR_ROWS, a["logits"], a["row_sums"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row,
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(logits[b, s].astype(np.float64).sum(),
                                   total, atol=1e-4, rtol=1e-6)
    toks, _ = jax_greedy(c, A.GREEDY_STEPS)
    np.testing.assert_array_equal(toks, np.asarray(a["greedy"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_matches_frozen_anchors(arch):
    c, a = Case(arch), A.LM_ANCHORS[arch]
    logits = c.port_forward()
    for (b, s), row in zip(A.ANCHOR_ROWS, a["logits"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row, **F32)


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
                                        ("qwen2-0.5b", "bfloat16")])
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
