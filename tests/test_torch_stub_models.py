"""The port's modality-stub models — qwen2-vl-2b (GQA with qkv biases,
tied embeddings, M-RoPE over (3, B, S) t/h/w positions) and
musicgen-large (MHA, GELU, sinusoidal positions, untied head) — against
the reference's ``repro.models.transformer`` on the same weights.

The weights are made with numpy (``repro_torch.models.anchors.
jax_layout_params``: the embedding table is drawn for both, as the
reference's ``init_params`` makes it) in the reference's stacked pytree
layout, each leaf cast to the dtype the reference's ``init_params``
gives it.  The frontends are stubs in both packages: the model takes
precomputed (B, S, d) embeddings (``Batch.embeds``), or token ids
through its table.  The reduced configs (2 layers, d 128, 4/2 heads of
32, vocab 512; qwen2-vl's sections (4, 6, 6)) run a forward on
``anchors.anchor_embeds`` at B 2, S 256 (qwen2-vl at the image
positions of ``anchors.ANCHOR_IMAGE``), teacher-forced decode steps on
embeds and on tokens, 8 greedy tokens, the loss and its gradients on
embeds, a bf16 forward, the reference's ``test_decode_matches_forward``
and the port's ``train.main`` on qwen2-vl's tokens.

Tolerances, the other archs': float32 logits within atol 2e-5 / rtol
1e-5; greedy tokens exactly (the smallest top-1/top-2 gap is 0.047);
gradients within 1e-5 of each leaf's largest magnitude.  bf16: held to
the reference's own float32-vs-bf16 witness, as the SSM and MLA models
are: the largest logit difference at most 1.25 times the witness's
plus one bf16 ulp of the largest logit (both packages round the logits
to bf16, where the witness's float32 logits are unrounded: musicgen's
read 0.03125, two ulps at |x| in [2, 4), against the witness's 0.0249),
the share of equal argmaxes at most 5 points below the witness's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.models import transformer as JT
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_reduced_config
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import steps as S
from repro_torch.launch import token_serve, train
from repro_torch.models import anchors as A
from repro_torch.models import transformer as TT

ARCHS = ["qwen2-vl-2b", "musicgen-large"]
F32 = dict(atol=2e-5, rtol=1e-5)
GRAD_REL = 1e-5
BF16_WITNESS_RATIO, BF16_WITNESS_SHARE = 1.25, 0.05
LOSS_SHAPE = (2, 32)
#: Decode steps on embeds, teacher-forced from position 0.
EMBED_STEPS = 12


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
    reference's ``init_params`` for ``jcfg`` (norm scales stay float32
    in a bf16 model)."""
    want = jax.eval_shape(lambda k: JT.init_params(jcfg, k),
                          jax.random.key(0))
    leaves, treedef = jax.tree.flatten(tree)
    assert treedef == jax.tree.structure(want)
    return jax.tree.unflatten(treedef, [
        jnp.asarray(a).astype(w.dtype)
        for a, w in zip(leaves, jax.tree.leaves(want))])


def _opt(a, wrap):
    return None if a is None else wrap(a)


class Case:
    def __init__(self, arch, dtype="float32"):
        self.cfg = get_reduced_config(arch, dtype=dtype)
        self.jcfg = jax_config(arch, dtype=dtype)
        self.jparams = reference_dtypes(self.jcfg,
                                        A.jax_layout_params(self.cfg))
        self.params = TT.params_from_jax(
            self.cfg, jax.tree.map(np.asarray, self.jparams))
        self.embeds, self.positions = A.anchor_embeds(self.cfg)
        _, self.prompt = A.anchor_tokens(self.cfg)
        self._jax = {}

    def jax_forward(self):
        """The reference's forward on the anchor embeds (float32 numpy);
        computed once."""
        if "fwd" not in self._jax:
            out = JT.forward(self.jcfg, self.jparams, JT.Batch(
                embeds=jnp.asarray(self.embeds),
                positions=_opt(self.positions, jnp.asarray)))
            self._jax["fwd"] = np.asarray(out.astype(jnp.float32))
        return self._jax["fwd"]

    def port_forward(self):
        with torch.no_grad():
            out = TT.forward(self.cfg, self.params, TT.Batch(
                embeds=torch.as_tensor(self.embeds),
                positions=_opt(self.positions, torch.as_tensor)))
        return out.float().numpy()

    def jax_greedy(self, steps=A.GREEDY_STEPS):
        """The reference's token-serve loop on the token prompt (prefill
        through a jitted decode_step, then argmax steps): tokens and each
        step's logits; computed once."""
        if "greedy" in self._jax:
            return self._jax["greedy"]
        step = jax.jit(lambda p, c, tok, pos: JT.decode_step(
            self.jcfg, p, c, JT.Batch(tokens=tok), pos))
        b, plen = self.prompt.shape
        cache = JT.init_cache(self.jcfg, b, plen + steps)
        for t in range(plen):
            lg, cache = step(self.jparams, cache,
                             jnp.asarray(self.prompt[:, t:t + 1]),
                             jnp.int32(t))
        toks, logits = [], [np.asarray(lg)]
        tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
        toks.append(tok)
        for i in range(steps - 1):
            lg, cache = step(self.jparams, cache, tok, jnp.int32(plen + i))
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg[:, -1], axis=-1)[:, None]
            toks.append(tok)
        self._jax["greedy"] = (np.asarray(jnp.concatenate(toks, axis=1)),
                               logits)
        return self._jax["greedy"]

    def jax_embed_decode(self, steps=EMBED_STEPS):
        """The reference's decode steps fed the anchor embeds one
        position at a time from 0: each step's logits; computed once."""
        if "embed_decode" not in self._jax:
            step = jax.jit(lambda p, c, e, pos: JT.decode_step(
                self.jcfg, p, c, JT.Batch(embeds=e), pos))
            cache = JT.init_cache(self.jcfg, self.embeds.shape[0], steps)
            out = []
            for t in range(steps):
                lg, cache = step(self.jparams, cache,
                                 jnp.asarray(self.embeds[:, t:t + 1]),
                                 jnp.int32(t))
                out.append(np.asarray(lg))
            self._jax["embed_decode"] = out
        return self._jax["embed_decode"]


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return Case(request.param)


def test_forward_on_embeds_matches_reference(case):
    got, want = case.port_forward(), case.jax_forward()
    assert got.shape == (*A.FORWARD_SHAPE, case.cfg.vocab_size)
    np.testing.assert_allclose(got, want, **F32)
    assert (case.positions is None) == (not case.cfg.mrope_sections)


def test_image_positions_reach_the_logits(case):
    """qwen2-vl: the image's t/h/w positions move the logits from
    position 16 on, where t = h = w (the default (B, S) positions) does
    not; the first 16 text tokens see the same positions either way.
    musicgen has no M-RoPE: (3, B, S) positions reach only the
    sinusoidal embedding, through their first stream as in the
    reference."""
    if not case.cfg.mrope_sections:
        pos = np.broadcast_to(np.arange(256, dtype=np.int32),
                              (3,) + A.FORWARD_SHAPE)
        with torch.no_grad():
            got = TT.forward(case.cfg, case.params, TT.Batch(
                embeds=torch.as_tensor(case.embeds),
                positions=torch.as_tensor(pos.copy())))
        np.testing.assert_array_equal(got.numpy(), case.port_forward())
        return
    with torch.no_grad():
        text = TT.forward(case.cfg, case.params, TT.Batch(
            embeds=torch.as_tensor(case.embeds))).numpy()
    image = case.port_forward()
    np.testing.assert_array_equal(text[:, :16], image[:, :16])
    assert np.abs(text[:, 16:] - image[:, 16:]).max() > 0.1


@pytest.mark.parametrize("feed", ["tokens", "embeds"])
def test_decode_steps_match_reference(case, feed):
    """Teacher-forced decode: on tokens, the prompt then the reference's
    greedy tokens (every step's logits); on embeds, the anchor embeds
    from position 0 (EMBED_STEPS steps; the batch size comes from the
    embeds).  Each against the reference's steps."""
    if feed == "tokens":
        toks, want = case.jax_greedy()
        seq = np.concatenate([case.prompt, toks[:, :-1]], axis=1)
        first = case.prompt.shape[1] - 1
        inputs = [TT.Batch(tokens=torch.as_tensor(seq[:, t:t + 1]))
                  for t in range(seq.shape[1])]
    else:
        want, first = case.jax_embed_decode(), 0
        inputs = [TT.Batch(embeds=torch.as_tensor(
            case.embeds[:, t:t + 1])) for t in range(EMBED_STEPS)]
    cache = TT.init_cache(case.cfg, 2, len(inputs) + 1, device="cpu")
    with torch.no_grad():
        for t, batch in enumerate(inputs):
            lg, cache = TT.decode_step(case.cfg, case.params, cache, batch, t)
            if t >= first:
                np.testing.assert_allclose(lg.numpy(), want[t - first],
                                           **F32, err_msg=f"step {t}")


def test_greedy_tokens_match_reference(case):
    want, _ = case.jax_greedy()
    with torch.no_grad():
        got = token_serve.generate(case.cfg, case.params,
                                   torch.as_tensor(case.prompt),
                                   A.GREEDY_STEPS)
    np.testing.assert_array_equal(got["tokens"].numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's ``test_decode_matches_forward`` for the stub
    archs, on the port: the reduced float32 model from a seeded init,
    embeds of 0.1-scaled normals, each decode step's logits within 1e-3
    of the forward's at that position."""
    cfg = get_reduced_config(arch, dtype="float32")
    params = TT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s, b = 12, 2
    emb = torch.randn(b, s, cfg.d_model,
                      generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        full = TT.forward(cfg, params, TT.Batch(embeds=emb))
        cache = TT.init_cache(cfg, b, s, device="cpu")
        for t in range(s):
            lg, cache = TT.decode_step(cfg, params, cache,
                                       TT.Batch(embeds=emb[:, t:t + 1]), t)
            assert float((lg[:, 0] - full[:, t]).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_bfloat16_forward_matches_reference(arch):
    """The bf16 forward on embeds against the reference's, no farther
    than the reference's float32 forward on the same weights is from
    it."""
    c = Case(arch, "bfloat16")
    assert c.params["layers"][0]["mixer"]["w_q"].dtype == torch.bfloat16
    assert c.params["layers"][0]["norm1"]["scale"].dtype == torch.float32
    got, want = c.port_forward(), c.jax_forward()
    wide = np.asarray(JT.forward(
        dataclasses.replace(c.jcfg, dtype="float32"),
        jax.tree.map(lambda a: a.astype(jnp.float32), c.jparams),
        JT.Batch(embeds=jnp.asarray(c.embeds),
                 positions=_opt(c.positions, jnp.asarray))))
    diff, w_diff = np.abs(got - want).max(), np.abs(wide - want).max()
    assert diff <= BF16_WITNESS_RATIO * w_diff \
        + bf16_ulp(np.abs(want).max()), (diff, w_diff)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    w_agree = (wide.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= w_agree - BF16_WITNESS_SHARE, (agree, w_agree)


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 values at magnitude ``x`` (8 significant
    bits)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


def test_frozen_anchors_are_what_jax_computes(case):
    """``LM_ANCHORS`` (which ``chip_smoke.py`` holds the card against)
    re-derived from the JAX reference: the forward's logits rows and
    sums on the anchor embeds, the greedy tokens, the smallest
    top-1/top-2 gap."""
    a = A.LM_ANCHORS[case.cfg.name]
    logits = case.jax_forward()
    for (b, s), row, total in zip(A.ANCHOR_ROWS, a["logits"], a["row_sums"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row,
                                   atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(logits[b, s].astype(np.float64).sum(),
                                   total, atol=1e-4, rtol=1e-6)
    toks, steps = case.jax_greedy()
    np.testing.assert_array_equal(toks, np.asarray(a["greedy"]))
    top2 = min(float(np.diff(np.sort(lg[:, -1].astype(np.float64),
                                     axis=-1)[:, -2:], axis=-1).min())
               for lg in steps)
    np.testing.assert_allclose(top2, a["min_top2_gap"], rtol=1e-6)
    assert "routes" not in a


def test_port_matches_frozen_anchors(case):
    a = A.LM_ANCHORS[case.cfg.name]
    logits = case.port_forward()
    for (b, s), row in zip(A.ANCHOR_ROWS, a["logits"]):
        np.testing.assert_allclose(logits[b, s, :A.ANCHOR_VOCAB], row, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_match_the_reference(arch, dtype):
    """The port's ``init_params`` makes the reference's leaves, counts
    and bytes (the embedding table included, which the embeds never
    read); the numpy weights have the reference's layout."""
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
    assert got["embed"]["table"].shape == (cfg.vocab_size, cfg.d_model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == np.float32
    assert ("unembed" in params) == (not cfg.tie_embeddings)


def test_token_serve_refuses_stub_archs():
    """``token_serve.main`` keeps the reference's refusal: the stub
    archs are backbones fed by a frontend."""
    with pytest.raises(SystemExit, match="modality-stub backbone"):
        token_serve.main(["--arch", "qwen2-vl-2b", "--reduced",
                          "--device", "cpu"])


def test_train_main_trains_qwen2_vl_on_tokens():
    """The reference's ``train`` CLI trains qwen2-vl text-only through
    its embedding table; so does the port's."""
    res = train.main(["--arch", "qwen2-vl-2b", "--reduced", "--device",
                      "cpu", "--steps", "6", "--seq-len", "32",
                      "--global-batch", "4", "--lr", "1e-2", "--warmup",
                      "2"])
    assert res["steps"] == 6 == len(res["losses"])
    assert all(np.isfinite(res["losses"]))
    assert res["loss_decreased"], (res["first_loss"], res["last_loss"])


@pytest.fixture(scope="module", params=ARCHS)
def stub_grads(request):
    """The reduced float32 model's loss and gradients from the reference
    (``jax.value_and_grad`` of its ``loss_fn``) on LOSS_SHAPE embeds
    (qwen2-vl at image positions) with SyntheticLM labels."""
    c = Case(request.param)
    b, s = LOSS_SHAPE
    labels = SyntheticLM(c.cfg, DataConfig(seq_len=s, global_batch=b,
                                           seed=3)).batch_at(0).labels
    emb = c.embeds[:, :s]
    pos = None
    if c.positions is not None:
        pos = np.ascontiguousarray(np.broadcast_to(
            A.image_positions(4, 3, 3, s - 13)[:, None], (3, b, s)))
    jb = JT.Batch(embeds=jnp.asarray(emb), positions=_opt(pos, jnp.asarray),
                  labels=jnp.asarray(labels))
    loss, g = jax.value_and_grad(lambda p: JT.loss_fn(c.jcfg, p, jb))(
        c.jparams)
    grads = dict(_flatten(TT.params_from_jax(c.cfg,
                                             jax.tree.map(np.asarray, g))))
    tb = TT.Batch(embeds=torch.as_tensor(emb),
                  positions=_opt(pos, torch.as_tensor),
                  labels=torch.as_tensor(labels).long())
    return c, tb, float(loss), grads


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradients_match_jax(stub_grads, remat):
    c, batch, want_loss, want = stub_grads
    params = S.trainable(TT.params_from_jax(
        c.cfg, jax.tree.map(np.asarray, c.jparams)))
    loss, g = S.value_and_grad(c.cfg, params, batch, remat=remat)
    np.testing.assert_allclose(float(loss), want_loss, **F32)
    got = dict(_flatten(g))
    assert sorted(got) == sorted(want)
    for path, t in got.items():
        w = want[path]
        assert t.shape == w.shape and t.dtype == torch.float32, path
        err = float((t - w).abs().max())
        assert err <= GRAD_REL * max(float(w.abs().max()), 1e-30), \
            (path, err)
