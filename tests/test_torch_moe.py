"""The port's MoE block (``repro_torch.models.moe``) against the
reference's ``repro.models.moe`` in process, on the same numpy weights
and inputs (the reference's ``TestMoE``, case for case, plus its routes).

The reference's routes are read as it computes them (``_jax_routes.
recorded_top_k`` wraps ``jax.lax.top_k``), its keep masks by a plain
loop over the picks (``capacity_keep``); the port's through
``anchors.record_routes``, from inside ``moe_apply``.

Tolerances: outputs and aux losses within atol 1e-5 / rtol 1e-4 (the
reference ``TestMoE``'s; float32 sums in another order), gradients
within 1e-5 of each leaf's largest magnitude (the LM training tests');
routes and keep masks exactly, including where picks are dropped at
capacity and where router probabilities tie.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_routes import capacity_keep, recorded_top_k
from repro.models import moe as JM
from repro.models.common import ModelConfig as JModelConfig
from repro.models.common import MoEConfig as JMoEConfig
from repro_torch.models import anchors as A
from repro_torch.models import layers
from repro_torch.models import moe as M
from repro_torch.models.common import ModelConfig, MoEConfig

TOL = dict(atol=1e-5, rtol=1e-4)
GRAD_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs its files in parallel worker
    processes on a shared machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(e=8, k=2, cf=64.0, shared=0, residual=False, ffn="swiglu"):
    """The reference test's ``_moe_cfg`` in both packages."""
    kw = dict(name="moe-test", family="moe", num_layers=2, d_model=32,
              num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
              dtype="float32", ffn_kind=ffn)
    mk = dict(num_experts=e, top_k=k, d_ff_expert=48, capacity_factor=cf,
              num_shared_experts=shared, dense_residual=residual)
    return (ModelConfig(moe=MoEConfig(**mk), **kw),
            JModelConfig(moe=JMoEConfig(**mk), **kw))


def _params(cfg, seed=0) -> dict:
    """numpy float32 weights of one MoE block at the reference's fan-in
    scales, in its layout."""
    rng = np.random.default_rng(seed)
    m, d = cfg.moe, cfg.d_model
    e, f = m.num_experts, m.d_ff_expert

    def normal(shape, std):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    def dense(ff):
        return {"w_gate": normal((d, ff), d ** -0.5),
                "w_up": normal((d, ff), d ** -0.5),
                "w_down": normal((ff, d), ff ** -0.5)}

    p = {"router": normal((d, e), d ** -0.5),
         "w_gate": normal((e, d, f), d ** -0.5),
         "w_up": normal((e, d, f), d ** -0.5),
         "w_down": normal((e, f, d), f ** -0.5)}
    if m.num_shared_experts:
        p["shared"] = dense(f * m.num_shared_experts)
    if m.dense_residual:
        p["residual"] = dense(cfg.d_ff)
    return p


def _x(shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _torch(tree):
    return jax.tree.map(torch.as_tensor, tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def run_both(cfg, jcfg, params, x):
    """(port y, aux, routes) and (reference y, aux, top_e, keep) of
    ``moe_apply`` on the same weights and input."""
    with A.record_routes() as rec:
        y, aux = M.moe_apply(cfg, _torch(params), torch.as_tensor(x))
    with recorded_top_k() as jrec:
        jy, jaux = JM.moe_apply(jcfg, _jax(params), jnp.asarray(x))
    (r,), ((_, top_e),) = rec, jrec
    gs = top_e.shape[1]
    keep = capacity_keep(top_e, cfg.moe.num_experts,
                         JM._capacity(gs, jcfg.moe))
    return ((y.numpy(), float(aux), r),
            (np.asarray(jy), float(jaux), top_e, keep))


def _check(cfg, jcfg, params, x):
    (y, aux, r), (jy, jaux, top_e, keep) = run_both(cfg, jcfg, params, x)
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(aux, jaux, **TOL)
    return r


@pytest.mark.parametrize("kw", [dict(cf=64.0), dict(cf=1.25),
                                dict(shared=2, residual=True),
                                dict(cf=1.25, ffn="gelu")],
                         ids=["dropless", "cf1.25", "shared_residual",
                              "gelu"])
def test_moe_apply_matches_reference(kw):
    cfg, jcfg = _cfgs(**kw)
    r = _check(cfg, jcfg, _params(cfg), _x((2, 16, 32)))
    assert r.top_e.shape == (1, 32, 2)          # one group of 32 tokens
    if kw.get("cf") == 1.25:
        assert not bool(r.keep.all()), "expected picks dropped at cf 1.25"
    if kw.get("cf") == 64.0:
        assert bool(r.keep.all())


@pytest.mark.parametrize("batch, dup", [(2, True), (8, False)],
                         ids=["b2_same_token", "b8"])
def test_decode_groups_the_batch(batch, dup):
    """S = 1: the whole batch is one group (``_group_tokens``), so at
    batch 2 with 8 experts the capacity is one slot an expert; two equal
    tokens pick the same experts and the second's picks are dropped."""
    cfg, jcfg = _cfgs(cf=1.25)
    x = _x((batch, 1, 32), seed=3)
    if dup:
        x[1] = x[0]
    r = _check(cfg, jcfg, _params(cfg), x)
    assert r.top_e.shape == (1, batch, 2)
    if dup:
        assert M._capacity(batch, cfg.moe) == 1
        np.testing.assert_array_equal(r.keep.numpy(),
                                      [[[True, True], [False, False]]])
    else:
        assert not bool(r.keep.all())


def test_collapsed_router_ties_go_to_the_lower_expert():
    """Router column 0 at 10, the rest 0, on positive inputs: every
    token's probabilities for experts 1..7 tie exactly, and top-2 takes
    expert 0 then expert 1 (``jax.lax.top_k``'s order), at cf 1.25
    (picks past each expert's capacity dropped)."""
    cfg, jcfg = _cfgs(cf=1.25)
    p = _params(cfg)
    p["router"] = np.zeros_like(p["router"])
    p["router"][:, 0] = 10.0
    x = np.abs(_x((2, 16, 32), seed=4))
    r = _check(cfg, jcfg, p, x)
    assert (r.top_e[..., 0] == 0).all() and (r.top_e[..., 1] == 1).all()
    probs = r.probs.numpy()
    assert np.all(probs[..., 1:] == probs[..., 1:2])
    assert int((~r.keep).sum()) == 2 * (32 - M._capacity(32, cfg.moe))


@pytest.mark.parametrize("kw", [dict(), dict(shared=2, residual=True)],
                         ids=["plain", "shared_residual"])
def test_moe_ref_matches_reference(kw):
    cfg, jcfg = _cfgs(**kw)
    params, x = _params(cfg), _x((2, 16, 32))
    got = M.moe_ref(cfg, _torch(params), torch.as_tensor(x)).numpy()
    want = np.asarray(JM.moe_ref(jcfg, _jax(params), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)
    # dropless, moe_apply is the oracle
    y, _ = M.moe_apply(cfg, _torch(params), torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), got, **TOL)


def test_capacity_drops_reduce_output():
    """With capacity factor ~0 a slot an expert is left: the output must
    differ from the dropless one."""
    cfg, _ = _cfgs(cf=64.0)
    params, x = _torch(_params(cfg)), torch.as_tensor(_x((1, 8, 32)))
    full, _ = M.moe_apply(cfg, params, x)
    tiny = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1e-9))
    dropped, _ = M.moe_apply(tiny, params, x)
    assert float((full - dropped).abs().max()) > 1e-4


@pytest.mark.parametrize("cf", [64.0, 1.25])
def test_gradients_match_reference(cf):
    """Gradients of sum(y²) + aux reach the router and the experts, and
    equal ``jax.grad``'s, drops included."""
    cfg, jcfg = _cfgs(cf=cf, residual=True)
    params, x = _params(cfg), _x((2, 16, 32))
    tp = {k: v.requires_grad_() if isinstance(v, torch.Tensor) else v
          for k, v in _torch(params).items()}
    tx = torch.as_tensor(x).requires_grad_()
    y, aux = M.moe_apply(cfg, tp, tx)
    ((y ** 2).sum() + aux).backward()

    def loss(p, xx):
        yy, a = JM.moe_apply(jcfg, p, xx)
        return jnp.sum(yy ** 2) + a

    jg, jgx = jax.grad(loss, argnums=(0, 1))(_jax(params), jnp.asarray(x))
    for name in ("router", "w_gate", "w_up", "w_down"):
        g, w = tp[name].grad.numpy(), np.asarray(jg[name])
        assert np.abs(g).sum() > 0, name
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max(), name
    g, w = tx.grad.numpy(), np.asarray(jgx)
    assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max()


@pytest.mark.parametrize("k", [1, 2])
def test_aux_loss_prefers_balance(k):
    """Routing spread by random weights gives a lower aux loss than a
    router collapsed onto one expert, in both packages alike."""
    cfg, jcfg = _cfgs(e=4, k=k)
    params, x = _params(cfg), _x((4, 64, 32), seed=5)
    collapsed = dict(params, router=np.zeros_like(params["router"]))
    collapsed["router"][:, 0] = 10.0
    auxes = []
    for p in (params, collapsed):
        _, aux = M.moe_apply(cfg, _torch(p), torch.as_tensor(x))
        _, jaux = JM.moe_apply(jcfg, _jax(p), jnp.asarray(x))
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)
        auxes.append(float(aux))
    assert auxes[1] > auxes[0]


@pytest.mark.parametrize("t", [1, 2, 3, 24, 512, 4096, 1000])
def test_grouping_and_capacity_are_the_references(t):
    cfg, jcfg = _cfgs(e=128, cf=1.25)
    xg, gs = M._group_tokens(torch.zeros(t, 4), cfg.moe)
    jxg, jgs = JM._group_tokens(jnp.zeros((t, 4)), jcfg.moe)
    assert gs == jgs and tuple(xg.shape) == jxg.shape
    assert M._capacity(gs, cfg.moe) == JM._capacity(jgs, jcfg.moe)
    assert M.GROUP_SIZE == JM.GROUP_SIZE == 512


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_has_the_references_leaves(dtype):
    """``moe_init`` makes the reference's leaves, shapes and dtypes (the
    router float32 in a bf16 block), at its fan-in scales."""
    cfg, jcfg = _cfgs(e=4, shared=1, residual=True)
    jdt = jnp.dtype(dtype)
    want = jax.eval_shape(lambda key: JM.moe_init(key, jcfg, jdt),
                          jax.random.key(0))
    got = M.moe_init(cfg, layers.DTYPES[dtype],
                     torch.Generator().manual_seed(0), "cpu")
    flat = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat) == len(jax.tree.leaves(got))
    for path, w in flat.items():
        t = got
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == w.shape, path
        assert str(t.dtype).split(".")[-1] == str(w.dtype), path
    for name, fan_in in (("w_up", 32), ("w_down", 48)):
        std = got[name].float().std().item()
        assert abs(std * fan_in ** 0.5 - 1) < 0.05, name


def test_normal_multiplies_in_place_to_the_same_values():
    g1, g2 = (torch.Generator().manual_seed(7) for _ in range(2))
    got = layers.normal((64, 48), 0.125, torch.bfloat16, g1, "cpu")
    x = torch.randn((64, 48), generator=g2, dtype=torch.float32)
    assert torch.equal(got, (x * 0.125).to(torch.bfloat16))
