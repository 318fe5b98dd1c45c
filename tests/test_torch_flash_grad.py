"""Gradients of the LM's kernel paths in the port against the JAX package.

* ``repro_torch.models.flash.flash_attention`` where autograd records
  runs ``FlashAttentionFunction`` (forward ``_fwd_pass`` on CPU tensors,
  kernel E with its softmax statistics on the card; backward the
  reference's ``_bwd_pass`` as torch ops): its (dq, dk, dv) against
  ``jax.vjp`` of ``repro.models.flash.flash_attention`` (the reference's
  custom VJP) on the same numpy inputs and cotangent, with several block
  pairs (q_block = kv_block = 32), causal and not, windows, the softcap,
  GQA and queries at the end of longer keys.
* ``blockwise_attention`` (plain, differentiated by autograd) against
  the reference's ``blockwise_attention`` under ``jax.vjp``: forward
  and gradient.
* Kernel D's ``RMSNormFunction`` (what ``layers.rmsnorm`` runs under
  autograd) against ``jax.grad`` of the reference's ``layers.rmsnorm``.
* Kernel E's plain statistics (``flash_attention_fwd(...,
  return_stats=True)`` on CPU tensors, the full softmax) against the
  reference's ``_fwd_pass`` statistics.

Tolerances, float32: outputs and gradients within 2e-5 absolute + 2e-5
relative (measured at most ~2e-6: float32 sums in another order; the
reference's own blockwise tests allow 2e-5); bf16 RMSNorm gradients
within 2e-2 (one bf16 ulp at |x| < 4 is at most 2^-6).  The CUDA
kernels themselves run only on the card (``chip_smoke.py`` holds the
Function's gradient there against autograd through the plain
versions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import flash as JF
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as E
from repro_torch.kernels import rmsnorm as D
from repro_torch.models import attention as TA
from repro_torch.models import flash as TF
from repro_torch.models import layers as TL

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module on one intra-op thread, its module-scoped fixtures
    included (this fixture is set up before them): the suite runs its
    files in parallel worker processes (``-n 6``) on a shared machine,
    where torch's default of a thread a core makes every parallel op
    wait on the others' (measured: 3 s alone, 157 s beside five busy
    processes, 19 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# (b, sq, skv, h, kv, d, causal, window, softcap)
CASES = {
    "causal-gqa": (2, 128, 128, 4, 2, 32, True, 0, 0.0),
    "window": (1, 128, 128, 4, 2, 32, True, 48, 0.0),
    "softcap-window": (1, 128, 128, 6, 2, 64, True, 40, 50.0),
    "mha-softcap": (2, 96, 96, 2, 2, 32, True, 0, 30.0),
    "non-causal": (1, 64, 64, 4, 1, 32, False, 0, 0.0),
    "sq<skv": (1, 64, 160, 4, 2, 32, True, 70, 0.0),
}


def _inputs(b, sq, skv, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_vjp(fn, q, k, v, do, **kw):
    out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, **kw),
                       *(jnp.asarray(x) for x in (q, k, v)))
    return (np.asarray(out),) + tuple(np.asarray(g) for g in
                                      vjp(jnp.asarray(do)))


def _torch_vjp(fn, q, k, v, do, **kw):
    tq, tk, tv = (torch.as_tensor(x).requires_grad_() for x in (q, k, v))
    out = fn(tq, tk, tv, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(do))
    return (out,) + grads


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    """One case's inputs and the reference's flash and blockwise VJPs
    (q_block = kv_block = 32)."""
    b, sq, skv, h, kv, d, causal, window, cap = CASES[request.param]
    arrays = _inputs(b, sq, skv, h, kv, d, seed=len(request.param))
    kw = dict(causal=causal, window=window, logit_softcap=cap, q_block=32,
              kv_block=32)
    return {"name": request.param, "arrays": arrays, "kw": kw,
            "flash": _jax_vjp(JF.flash_attention, *arrays, **kw),
            "blockwise": _jax_vjp(JA.blockwise_attention, *arrays, **kw)}


def _assert_all_close(got, want, what):
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert tuple(g.shape) == w.shape, (what, name)
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL,
                                   err_msg=f"{what} {name}")


def test_flash_function_matches_reference_vjp(case):
    got = _torch_vjp(TF.flash_attention, *case["arrays"], **case["kw"])
    assert type(got[0].grad_fn).__name__ == "FlashAttentionFunctionBackward"
    _assert_all_close(got, case["flash"], f"flash {case['name']}")


def test_blockwise_attention_matches_reference_forward_and_vjp(case):
    got = _torch_vjp(TA.blockwise_attention, *case["arrays"], **case["kw"])
    _assert_all_close(got, case["blockwise"], f"blockwise {case['name']}")


def test_flash_function_forward_equals_the_no_grad_forward(case):
    """The Function's forward on the CPU is ``_fwd_pass``: bitwise the
    output of the same call without autograd."""
    q, k, v, _ = (torch.as_tensor(a) for a in case["arrays"])
    with torch.no_grad():
        want = TF.flash_attention(q, k, v, **case["kw"])
    got = TF.flash_attention(q.requires_grad_(), k, v, **case["kw"])
    assert got.grad_fn is not None and torch.equal(got.detach(), want)


def test_plain_stats_match_the_reference_fwd_pass(case):
    """Kernel E's plain version with ``return_stats`` (the full softmax)
    gives the reference ``_fwd_pass``'s m and l, (B, Sq, KV, g)."""
    q, k, v, _ = case["arrays"]
    kw = case["kw"]
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    pairs = jnp.asarray(JA._block_pairs(sq // 32, skv // 32, 32, 32,
                                        skv - sq, kw["causal"],
                                        kw["window"]), jnp.int32)
    _, jm, jl = JF._fwd_pass(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             pairs, causal=kw["causal"], window=kw["window"],
                             logit_softcap=kw["logit_softcap"], q_block=32,
                             kv_block=32, scale=d ** -0.5)
    out, m, l = E.flash_attention_fwd(
        *(torch.as_tensor(a) for a in (q, k, v)), causal=kw["causal"],
        window=kw["window"], logit_softcap=kw["logit_softcap"],
        return_stats=True)
    assert m.shape == l.shape == (b, sq, kvh, h // kvh)
    assert m.dtype == l.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)


def test_stats_with_one_visible_key():
    """A window of 1 leaves each query its own key alone: l is exactly 1
    and m that one score, on the plain statistics and ``_fwd_pass``."""
    q, k, v, _ = _inputs(1, 8, 8, 2, 1, 32, 9)
    tq, tk, tv = (torch.as_tensor(a) for a in (q, k, v))
    _, m, l = E.flash_attention_fwd(tq, tk, tv, window=1, return_stats=True)
    assert torch.equal(l, torch.ones_like(l))
    diag = torch.einsum("sgd,sd->sg", tq[0], tk[0, :, 0]) * 32 ** -0.5
    torch.testing.assert_close(m[0, :, 0], diag, **TOL)
    _, m2, l2 = TF._fwd_pass(tq, tk, tv, [(0, 0)], causal=True, window=1,
                             logit_softcap=0.0, q_block=8, kv_block=8,
                             scale=32 ** -0.5)
    torch.testing.assert_close(m, m2, **TOL)
    torch.testing.assert_close(l, l2, **TOL)


def _backward_names(t) -> set:
    """The class names of every node of ``t``'s autograd graph."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or type(fn).__name__ in seen:
            continue
        seen.add(type(fn).__name__)
        todo += [nxt for nxt, _ in fn.next_functions]
    return seen


@pytest.mark.parametrize("shape", [(3, 7, 128), (16, 896), (997, 130)])
def test_rmsnorm_function_gradient_matches_jax_grad(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) * 0.1).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, s: JL.rmsnorm({"scale": s}, a),
                       jnp.asarray(x), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g))
    tx = torch.as_tensor(x).requires_grad_()
    ts = torch.as_tensor(scale).requires_grad_()
    y = TL.rmsnorm({"scale": ts}, tx)
    assert "RMSNormFunctionBackward" in _backward_names(y)
    dx, ds = torch.autograd.grad(y, (tx, ts), torch.as_tensor(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=1e-4,
                               rtol=2e-5)


def test_rmsnorm_function_gradient_bf16():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    scale = (rng.standard_normal(256) * 0.1).astype(np.float32)
    g = rng.standard_normal((64, 256)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s: JL.rmsnorm({"scale": s}, a),
                     jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = torch.as_tensor(x).bfloat16().requires_grad_()
    ts = torch.as_tensor(scale).requires_grad_()
    y = D.rmsnorm(tx, ts)
    dx, ds = torch.autograd.grad(y, (tx, ts),
                                 torch.as_tensor(g).bfloat16())
    assert dx.dtype == torch.bfloat16 and ds.dtype == torch.float32
    np.testing.assert_allclose(dx.float().numpy(),
                               np.asarray(jdx.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), atol=2e-2,
                               rtol=2e-2)


def test_rmsnorm_function_backward_is_the_plain_autograd():
    """The Function's backward (torch ops from the saved x and scale)
    against autograd through the plain ``rmsnorm_ref``."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(40, 96, generator=g, requires_grad=True)
    s = (0.1 * torch.randn(96, generator=g)).requires_grad_()
    gy = torch.randn(40, 96, generator=g)
    want = torch.autograd.grad(D.rmsnorm_ref(x, s), (x, s), gy)
    got = torch.autograd.grad(D.RMSNormFunction.apply(x, s, 1e-6), (x, s),
                              gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_no_grad_calls_skip_the_functions():
    """Without autograd the norm and the attention take the kernel
    wrappers directly (no Function, no saved tensors)."""
    g = torch.Generator().manual_seed(1)
    x, s = torch.randn(4, 32, generator=g), torch.zeros(32)
    assert D.rmsnorm(x, s).grad_fn is None
    q = torch.randn(1, 32, 2, 32, generator=g)
    k = torch.randn(1, 32, 1, 32, generator=g)
    assert TF.flash_attention(q, k, k).grad_fn is None
    with torch.no_grad():
        assert D.rmsnorm(x.requires_grad_(), s).grad_fn is None


def test_public_wrapper_matches_the_reference_ops():
    """``kernels.flash_attention.flash_attention`` (the reference's
    ``ops.flash_attention`` but ``interpret``) against the reference's,
    the Pallas kernel in interpret mode, on the same inputs."""
    from repro.kernels.flash_attention import ops as jax_ops
    q, k, v, _ = _inputs(1, 128, 128, 4, 2, 32, 11)
    kw = dict(causal=True, window=48, logit_softcap=50.0, block_q=64,
              block_kv=64)
    want = np.asarray(jax_ops.flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), interpret=True, **kw))
    got = E.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="do not tile"):
        E.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                          block_q=48)
