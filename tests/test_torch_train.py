"""LM training in the port (``repro_torch.data``, ``models.transformer.
loss_fn``, ``launch.steps``, ``launch.train``) against the JAX package, on
the CPU.

* ``SyntheticLM`` batches are bitwise the reference's, and the pipeline
  behaves as the reference's ``TestDataPipeline`` asks.
* ``loss_fn``'s value and gradients for the reduced float32 qwen2-0.5b
  and gemma2-2b (weights from ``anchors.jax_layout_params``, batches
  from ``SyntheticLM``) against ``jax.value_and_grad`` of the reference's
  ``loss_fn``, with and without remat, at 64 tokens and at 512 (longer
  than ``LOSS_CHUNK``: two loss chunks, and gemma2's window of 64 bites).
* Five ``make_train_step`` steps against the reference's jitted train
  step, and ``TRAIN_ANCHORS`` (what ``chip_smoke.py`` holds the card
  to) re-derived from JAX.
* The training CLI: the loss decreases, and a resume from a checkpoint is
  bitwise the uninterrupted run.

Tolerances.  Loss at one point: 2e-5 absolute + 1e-5 relative (the LM
tests' float32 bound; measured <= 1.5e-6).  Gradients: every leaf within
1e-5 of its largest magnitude (measured <= 2.1e-6: float32 sums in
another order).  Over five AdamW steps at lr 1e-2 the two runs drift
apart (an update divides by sqrt(v), which magnifies the ulps of small
gradients): losses within 1e-4 relative (measured 1.3e-5) and global
gradient norms within 1e-3 relative (measured 1.3e-4).
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jax_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_pipeline as jax_make_pipeline
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten
from repro_torch.configs import get_reduced_config
from repro_torch.data import DataConfig, SyntheticLM, make_pipeline
from repro_torch.launch import steps as S
from repro_torch.launch import train
from repro_torch.models import anchors as A
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as TA

ARCHS = ("qwen2-0.5b", "gemma2-2b")
F32 = dict(atol=2e-5, rtol=1e-5)
GRAD_REL = 1e-5
TRAJ_LOSS_RTOL, TRAJ_GNORM_RTOL = 1e-4, 1e-3


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


def _tbatch(b) -> TT.Batch:
    return TT.Batch(tokens=torch.as_tensor(b.tokens).long(),
                    labels=torch.as_tensor(b.labels).long())


def _jbatch(b) -> JT.Batch:
    return JT.Batch(tokens=jnp.asarray(b.tokens),
                    labels=jnp.asarray(b.labels))


# ---------------------------------------------------------------------------
# Data pipeline (the reference's TestDataPipeline, case for case)
# ---------------------------------------------------------------------------


def _qwen():
    return get_reduced_config("qwen2-0.5b")


@pytest.mark.parametrize("seq, batch, seed, rank, ranks, step", [
    (32, 4, 7, 0, 1, 5), (16, 8, 1, 3, 4, 0), (128, 8, 0, 0, 1, 99)])
def test_batches_are_bitwise_the_reference(seq, batch, seed, rank, ranks,
                                           step):
    kw = dict(seq_len=seq, global_batch=batch, seed=seed, rank=rank,
              num_ranks=ranks)
    got = SyntheticLM(_qwen(), DataConfig(**kw)).batch_at(step)
    want = JSyntheticLM(jax_config("qwen2-0.5b"),
                        JDataConfig(**kw)).batch_at(step)
    for a, b in ((got.tokens, want.tokens), (got.labels, want.labels)):
        assert a.dtype == b.dtype == np.int32 and np.array_equal(a, b)


def test_deterministic_per_step():
    ds = SyntheticLM(_qwen(), DataConfig(seq_len=32, global_batch=4, seed=7))
    a, b = ds.batch_at(5), ds.batch_at(5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert not np.array_equal(a.tokens, ds.batch_at(6).tokens)


def test_rank_sharding_disjoint_and_sized():
    batches = [SyntheticLM(_qwen(), DataConfig(
        seq_len=16, global_batch=8, seed=1, num_ranks=4,
        rank=rank)).batch_at(0) for rank in range(4)]
    assert all(b.tokens.shape == (2, 16) for b in batches)
    assert not np.array_equal(batches[0].tokens, batches[1].tokens)


def test_labels_are_shifted_tokens():
    b = SyntheticLM(_qwen(), DataConfig(seq_len=16,
                                        global_batch=2)).batch_at(0)
    np.testing.assert_array_equal(b.tokens[:, 1:], b.labels[:, :-1])


def test_resume_replays_stream():
    dc = DataConfig(seq_len=16, global_batch=2, prefetch_depth=2)
    it1 = make_pipeline(_qwen(), dc, start_step=0)
    seq1 = [next(it1).tokens for _ in range(5)]
    it1.close()
    it2 = make_pipeline(_qwen(), dc, start_step=3)
    seq2 = [next(it2).tokens for _ in range(2)]
    it2.close()
    np.testing.assert_array_equal(seq1[3], seq2[0])
    np.testing.assert_array_equal(seq1[4], seq2[1])
    assert not it1._thread.is_alive() and not it2._thread.is_alive()


def test_prefetched_stream_is_the_reference_stream():
    dc = dict(seq_len=16, global_batch=2, seed=4)
    ours = make_pipeline(_qwen(), DataConfig(**dc), start_step=2)
    theirs = jax_make_pipeline(jax_config("qwen2-0.5b"), JDataConfig(**dc),
                               start_step=2)
    for _ in range(3):
        assert np.array_equal(next(ours).tokens, next(theirs).tokens)
    ours.close()
    theirs.close()


def test_tokens_in_vocab():
    cfg = _qwen()
    b = SyntheticLM(cfg, DataConfig(seq_len=64, global_batch=2)).batch_at(0)
    assert b.tokens.min() >= 0 and b.tokens.max() < cfg.vocab_size


def test_uneven_rank_split_is_refused():
    with pytest.raises(ValueError, match="does not split"):
        DataConfig(seq_len=4, global_batch=6, num_ranks=4).per_rank_batch


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


class Model:
    """The reduced float32 ``arch`` in both packages, on the numpy
    weights of ``anchors.jax_layout_params``."""

    def __init__(self, arch):
        self.cfg = get_reduced_config(arch, dtype="float32")
        self.jcfg = jax_config(arch, dtype="float32")
        self.np_params = A.jax_layout_params(self.cfg)
        self.jparams = jax.tree.map(jnp.asarray, self.np_params)

    def port_params(self):
        return S.trainable(TT.params_from_jax(self.cfg, self.np_params))

    def port_tree(self, jax_tree) -> dict:
        """A tree of the reference's layout as {port path: tensor}."""
        return dict(_flatten(TT.params_from_jax(
            self.cfg, jax.tree.map(np.asarray, jax_tree))))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    return Model(request.param)


@pytest.fixture(scope="module", params=[64, 512], ids=["s64", "s512"])
def grads(request, model):
    """The reference's loss and gradients at one batch of ``seq``
    tokens (one JAX computation a case)."""
    seq = request.param
    b = SyntheticLM(model.cfg, DataConfig(seq_len=seq, global_batch=2,
                                          seed=3)).batch_at(0)
    loss, g = jax.value_and_grad(lambda p: JT.loss_fn(
        model.jcfg, p, _jbatch(b)))(model.jparams)
    return {"batch": b, "loss": float(loss), "grads": model.port_tree(g),
            "seq": seq}


def _port_grads(model, grads, remat):
    loss, g = S.value_and_grad(model.cfg, model.port_params(),
                               _tbatch(grads["batch"]), remat=remat)
    return float(loss), dict(_flatten(g))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_gradients_match_jax(model, grads, remat):
    loss, got = _port_grads(model, grads, remat)
    np.testing.assert_allclose(loss, grads["loss"], **F32)
    want = grads["grads"]
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        assert g.shape == w.shape and g.dtype == torch.float32, path
        err = float((g - w).abs().max())
        assert err <= GRAD_REL * float(w.abs().max()), (path, err)


def test_remat_gives_the_same_numbers(model, grads):
    """Recomputation repeats the same operations: remat on and off give
    bitwise the same loss and gradients, but for the tied embedding
    table, whose gradient sums its parts (the gather and each loss
    chunk's logits) in another order when the chunks are recomputed
    (measured 7e-8 and 2e-7 of its largest magnitude at 512 tokens)."""
    a, ga = _port_grads(model, grads, False)
    b, gb = _port_grads(model, grads, True)
    assert a == b
    for k in ga:
        if k == "embed/table":
            err = float((ga[k] - gb[k]).abs().max())
            assert err <= 1e-6 * float(ga[k].abs().max())
        else:
            assert torch.equal(ga[k], gb[k]), k


def test_loss_chunks_tile_the_sequence(model):
    """At 512 tokens the loss takes two chunks of LOSS_CHUNK, at 96 one
    of 96; the sum over chunks over B·S is the unchunked mean."""
    assert TT.LOSS_CHUNK == 256
    for seq in (96, 512):
        b = SyntheticLM(model.cfg, DataConfig(seq_len=seq, global_batch=2,
                                              seed=1)).batch_at(0)
        batch = _tbatch(b)
        with torch.no_grad():
            loss = TT.loss_fn(model.cfg, model.port_params(), batch)
            logits = TT.forward(model.cfg, model.port_params(), batch)
            full = torch.nn.functional.cross_entropy(
                logits.reshape(-1, logits.shape[-1]).float(),
                batch.labels.reshape(-1))
        torch.testing.assert_close(loss, full, atol=2e-6, rtol=1e-6)


def test_loss_graph_reaches_every_leaf_through_the_kernel_functions():
    """Every parameter gets a gradient, and the graph runs through kernel
    D's and E's autograd Functions (as it does on the card)."""
    m = Model("gemma2-2b")
    p = m.port_params()
    b = SyntheticLM(m.cfg, DataConfig(seq_len=64, global_batch=1)).batch_at(0)
    loss = TT.loss_fn(m.cfg, p, _tbatch(b))
    seen, todo = set(), [loss.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo += [nxt for nxt, _ in fn.next_functions]
    names = {type(fn).__name__ for fn in seen}
    assert {"RMSNormFunctionBackward",
            "FlashAttentionFunctionBackward"} <= names
    leaves = []
    TA._map(leaves.append, p)
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(g.abs().sum() > 0) for g in grads)


# ---------------------------------------------------------------------------
# Five train steps and TRAIN_ANCHORS
# ---------------------------------------------------------------------------


def _jax_opt():
    return JA.AdamWConfig(lr=A.TRAIN_LR, warmup_steps=A.TRAIN_WARMUP,
                          total_steps=A.TRAIN_STEPS)


def _data(cfg, lib):
    b, s = A.TRAIN_SHAPE
    dc = lib[0](seq_len=s, global_batch=b, seed=A.TRAIN_DATA_SEED)
    return lib[1](cfg, dc)


def jax_train_anchor(m: Model) -> dict:
    """The reference's run behind ``TRAIN_ANCHORS[arch]``: its jitted
    ``make_train_step`` (no remat) for TRAIN_STEPS steps from the anchor
    weights, each step's loss and global gradient norm, and the first
    step's gradient norm of every leaf (by the port's leaf path)."""
    ds = _data(m.jcfg, (JDataConfig, JSyntheticLM))
    params, opt_cfg = m.jparams, _jax_opt()
    g0 = jax.grad(lambda p: JT.loss_fn(m.jcfg, p, _jbatch(
        ds.batch_at(0))))(params)
    leaf = {k: float(np.linalg.norm(np.asarray(v, np.float64)))
            for k, v in m.port_tree(g0).items()}
    step = jax.jit(JS.make_train_step(m.jcfg, opt_cfg, remat=False))
    opt, losses, norms = JA.init(opt_cfg, params), [], []
    for i in range(A.TRAIN_STEPS):
        params, opt, met = step(params, opt, _jbatch(ds.batch_at(i)))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return {"losses": tuple(losses), "grad_norms": tuple(norms),
            "leaf_grad_norms": dict(sorted(leaf.items()))}


@pytest.fixture(scope="module")
def runs(model):
    """The reference's run and the port's (``anchors.train_run``, on the
    CPU) of ``TRAIN_ANCHORS``' training."""
    return jax_train_anchor(model), A.train_run(model.cfg.name, "cpu")


def _hold(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], **F32)
    np.testing.assert_allclose(got["losses"], want["losses"], atol=0,
                               rtol=TRAJ_LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               atol=0, rtol=TRAJ_GNORM_RTOL)
    assert sorted(got["leaf_grad_norms"]) == sorted(want["leaf_grad_norms"])
    for k, v in want["leaf_grad_norms"].items():
        np.testing.assert_allclose(got["leaf_grad_norms"][k], v, atol=1e-7,
                                   rtol=GRAD_REL, err_msg=k)


def test_train_steps_hold_to_the_jax_run(runs):
    jax_run, port_run = runs
    _hold(port_run, jax_run)
    assert port_run["losses"][-1] < port_run["losses"][0]


def test_train_anchors_are_what_jax_computes(model, runs):
    a = A.TRAIN_ANCHORS[model.cfg.name]
    jax_run = runs[0]
    np.testing.assert_allclose(jax_run["losses"], a["losses"], atol=0,
                               rtol=1e-6)
    np.testing.assert_allclose(jax_run["grad_norms"], a["grad_norms"],
                               atol=0, rtol=1e-5)
    assert sorted(jax_run["leaf_grad_norms"]) == sorted(a["leaf_grad_norms"])
    for k, v in a["leaf_grad_norms"].items():
        np.testing.assert_allclose(jax_run["leaf_grad_norms"][k], v,
                                   atol=1e-8, rtol=1e-6, err_msg=k)


def test_port_meets_the_train_anchors(model, runs):
    _hold(runs[1], A.TRAIN_ANCHORS[model.cfg.name])


def test_new_params_are_leaves_that_require_grad(runs):
    leaves = []
    TA._map(leaves.append, runs[1]["params"])
    assert all(t.is_leaf and t.requires_grad and t.grad is None
               for t in leaves)


# ---------------------------------------------------------------------------
# The training CLI (the reference's TestTrainDriverEndToEnd)
# ---------------------------------------------------------------------------

DRIVER = ["--arch", "qwen2-0.5b", "--reduced", "--seq-len", "32",
          "--global-batch", "4", "--device", "cpu"]


def test_tiny_train_run_loss_decreases(tmp_path):
    res = train.main(DRIVER + ["--steps", "12", "--lr", "1e-2",
                               "--warmup", "2", "--ckpt-dir", str(tmp_path),
                               "--ckpt-every", "6"])
    assert res["steps"] == 12 == len(res["losses"])
    assert res["loss_decreased"], (res["first_loss"], res["last_loss"])
    assert CheckpointManager(str(tmp_path)).all_steps() == [6, 12]


def test_resume_from_checkpoint(tmp_path):
    train.main(DRIVER + ["--steps", "6", "--ckpt-dir", str(tmp_path),
                         "--ckpt-every", "3"])
    res = train.main(DRIVER + ["--steps", "9", "--ckpt-dir", str(tmp_path),
                               "--ckpt-every", "3", "--resume"])
    assert res["steps"] == 3   # resumed at 6, ran to 9


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):        # bf16 comes back as a tensor
        return a.contiguous().view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def test_resume_is_bitwise_the_uninterrupted_run(tmp_path):
    """Six steps straight (checkpoints at 3 and 6), against a resume from
    that run's step-3 checkpoint: the last three losses and the step-6
    checkpoint (parameters and AdamW state) bitwise equal."""
    whole, part = tmp_path / "whole", tmp_path / "part"
    args = DRIVER + ["--steps", "6", "--ckpt-every", "3", "--lr", "1e-2",
                     "--warmup", "2"]
    a = train.main(args + ["--ckpt-dir", str(whole)])
    part.mkdir()
    shutil.copytree(whole / "step_000000003", part / "step_000000003")
    b = train.main(args + ["--ckpt-dir", str(part), "--resume"])
    assert b["steps"] == 3 and b["losses"] == a["losses"][3:]
    got = CheckpointManager(str(part)).restore_items(6)
    want = CheckpointManager(str(whole)).restore_items(6)
    assert list(got) == list(want) and "opt/step" in got
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert _bits(got[k]) == _bits(want[k]), k


def test_prefill_and_serve_steps():
    """``make_prefill_step`` gives the forward's last-position logits and
    ``make_serve_step`` is ``decode_step``, both without autograd."""
    m = Model("qwen2-0.5b")
    params = TT.params_from_jax(m.cfg, m.np_params)
    toks = torch.as_tensor(SyntheticLM(m.cfg, DataConfig(
        seq_len=16, global_batch=2)).batch_at(0).tokens).long()
    got = S.make_prefill_step(m.cfg)(params, TT.Batch(tokens=toks))
    with torch.no_grad():
        full = TT.forward(m.cfg, params, TT.Batch(tokens=toks))
    assert got.shape == (2, 1, m.cfg.vocab_size) and got.grad_fn is None
    torch.testing.assert_close(got, full[:, -1:], atol=2e-5, rtol=1e-5)
    serve = S.make_serve_step(m.cfg)
    cache = TT.init_cache(m.cfg, 2, 4, device="cpu")
    logits, cache = serve(params, cache, TT.Batch(tokens=toks[:, :1]), 0)
    assert logits.shape == (2, 1, m.cfg.vocab_size)
    torch.testing.assert_close(logits, full[:, :1], atol=2e-5, rtol=1e-5)
    assert S.TrainState(params, TA.init(TA.AdamWConfig(), params)).opt.step \
        == 0
