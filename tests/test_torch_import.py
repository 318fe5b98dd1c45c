"""The PyTorch port stands alone: no JAX, no reference package, and its
entry points never fall back to the CPU silently."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import dataclasses

from repro_torch import handtracking_pipeline
from repro_torch.configs import get_reduced_config
from repro_torch.core import backend as B
from repro_torch.core import partition, stream, sweep
from repro_torch.kernels import flash_attention, rmsnorm, sweep_grid
from repro_torch.launch import token_serve, train
from repro_torch.models import attention, flash, layers
from repro_torch.models import transformer as T
from repro_torch.models.cnn import HandCNN
from repro_torch.models.common import MoEConfig
from repro_torch.core.service import SweepService
from repro_torch.runtime import workers as WK

PKG = pathlib.Path(__file__).resolve().parent.parent / "src" / "repro_torch"


def test_import_all_modules_without_jax_or_reference():
    code = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len(mods))
"""
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert int(out.stdout.split()[-1]) >= 53


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_source_never_imports_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [PKG.parents[1] / "chip_smoke.py"]
    assert len(files) >= 50
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


@pytest.mark.parametrize("call", [
    lambda: sweep.evaluate_grid(cuts=(0, 1)),
    lambda: stream.stream_grid(cuts=(0, 1)),
    lambda: stream.plan_stream(cuts=(0, 1)),
    lambda: sweep.evaluate_one(3),
    lambda: partition.optimal_partition(),
    lambda: HandCNN.keynet(),
    lambda: handtracking_pipeline.run_pipeline(
        np.zeros((1, 240, 320, 1), np.float32), [], []),
    lambda: token_serve.main(["--arch", "gemma2-2b", "--reduced"]),
    lambda: train.main(["--arch", "qwen2-0.5b", "--reduced", "--steps",
                        "1"]),
    lambda: T.init_params(get_reduced_config("gemma2-2b")),
    lambda: T.init_cache(get_reduced_config("gemma2-2b"), 1, 4),
    lambda: SweepService(),
    lambda: WK.WorkerPool("unused-spool", 1),
], ids=["evaluate_grid", "stream_grid", "plan_stream", "evaluate_one",
        "optimal_partition", "HandCNN", "run_pipeline", "token_serve",
        "train", "init_params", "init_cache", "SweepService",
        "WorkerPool"])
def test_default_device_is_cuda_and_raises_without_it(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_backend_defaults_follow_the_device():
    assert B.default_backend("cpu") == "torch"
    assert B.default_backend("cuda") == "cuda"
    assert B.get_backend(None, "cpu").name == "torch"
    assert B.get_backend("cuda").name == "cuda"
    assert set(B.available_backends()) >= {"torch", "cuda"}
    with pytest.raises(ValueError, match="unknown"):
        B.get_backend("xla")


def test_get_backend_defaults_to_the_card():
    """Like every entry point, get_backend() defaults to device="cuda"
    and so to the kernels' backend (resolving it needs no card)."""
    assert B.get_backend().name == "cuda"
    assert B.get_backend(None).name == "cuda"
    assert B.get_backend(None, "cpu").name == "torch"
    with pytest.raises(ValueError, match="unknown"):
        B.get_backend("xla")


def test_kernel_wrappers_take_the_plain_version_on_cpu():
    S, axis_arrays, _ = sweep.build_axes(cuts=(0, 5, 33),
                                         sensor_nodes=("7nm", "16nm"))
    shape = tuple(a.size for a in axis_arrays)
    T = B.device_tables(S, "cpu")
    axvals = sweep.axes_to_device(axis_arrays, "cpu")
    flat = torch.arange(int(np.prod(shape)), dtype=torch.int64)
    before = (sweep_grid.sweep_grid_eval.launches,
              sweep_grid.sweep_grid_chunk.launches)
    got = sweep_grid.sweep_grid_eval(T, shape, sweep.FIELDS, axvals, flat)
    want = sweep_grid.sweep_grid_eval_ref(T, shape, sweep.FIELDS, axvals,
                                          flat)
    for f in sweep.FIELDS:
        assert torch.equal(got[f].isnan(), want[f].isnan())
        assert torch.equal(got[f].nan_to_num(), want[f].nan_to_num())
    assert (sweep_grid.sweep_grid_eval.launches,
            sweep_grid.sweep_grid_chunk.launches) == before


@pytest.mark.parametrize("kw, exc, match", [
    pytest.param(dict(devices=("cuda:0",)), RuntimeError,
                 "CUDA is not available", id="kw0"),
    pytest.param(dict(devices=("cuda:0", "cuda:1")), RuntimeError,
                 "CUDA is not available", id="kw1"),
    pytest.param(dict(devices=("cpu", "cpu"), backend="cuda"), ValueError,
                 "does not support the multi-device path", id="kw2"),
    pytest.param(dict(scenarios="default"), ValueError,
                 "unknown scenario profile 'default'", id="kw3"),
    pytest.param(dict(scenarios=("default",)), ValueError,
                 "unknown scenario profile 'default'", id="kw4"),
])
def test_unported_stream_features_raise(kw, exc, match):
    """Every reference stream_grid parameter is ported; what the port
    refuses, it refuses as the reference does: a device that is not
    there, several shards on the ``"cuda"`` kernels (the reference's
    Pallas backend refuses its pmap path), an unknown scenario
    profile."""
    with pytest.raises(exc, match=match):
        stream.stream_grid(cuts=(0, 1), device="cpu", **kw)
    assert not hasattr(stream, "_NOT_PORTED")


def test_lm_kernel_wrappers_take_the_plain_version_on_cpu():
    g = torch.Generator().manual_seed(0)
    x, scale = torch.randn(6, 40, generator=g), torch.randn(40, generator=g)
    q = torch.randn(1, 16, 4, 32, generator=g)
    k, v = torch.randn(2, 1, 16, 2, 32, generator=g)
    before = (rmsnorm.rmsnorm_fused.launches,
              flash_attention.flash_attention_fwd.launches)
    assert torch.equal(rmsnorm.rmsnorm(x, scale),
                       rmsnorm.rmsnorm_ref(x, scale))
    assert torch.equal(flash_attention.flash_attention_fwd(q, k, v),
                       flash_attention.flash_attention_ref(q, k, v))
    assert torch.allclose(flash.flash_attention(q, k, v),
                          flash_attention.flash_attention_ref(q, k, v),
                          atol=1e-6)
    assert (rmsnorm.rmsnorm_fused.launches,
            flash_attention.flash_attention_fwd.launches) == before


def _gemma(**kw):
    return dataclasses.replace(get_reduced_config("gemma2-2b"), **kw)


def _reference_pair(cfg):
    """``cfg`` (float32) in both packages on the same numpy weights:
    (the reference's config and params, the port's params)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced_config as jax_config
    from repro_torch.models import anchors

    jcfg = dataclasses.replace(jax_config(cfg.name), **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if f.name != "moe"})
    w = anchors.jax_layout_params(cfg)
    return jcfg, jax.tree.map(jnp.asarray, w), T.params_from_jax(cfg, w)


@pytest.mark.parametrize("cfg, slice_", [
    (_gemma(seq_parallel=True), "sharding"),
    (_gemma(frontend_stub=True, dtype="float32"), None),
], ids=["seq_parallel", "frontend_stub"])
def test_later_slices_raise_not_implemented(cfg, slice_):
    """Sequence parallelism still raises, naming its slice; the
    modality-stub configs came with the modality-stub slice and now
    build, and gemma2's pattern as a stub backbone takes embeds (which
    skip the embedding scale) as the reference's does."""
    if slice_ is not None:
        with pytest.raises(NotImplementedError, match=f"{slice_} slice"):
            T.init_params(cfg, device="cpu")
        return
    import jax.numpy as jnp

    from repro.models import transformer as JT

    T.check_supported(cfg)
    assert len(T.init_params(cfg, device="cpu")["layers"]) == cfg.num_layers
    jcfg, jparams, params = _reference_pair(cfg)
    emb = np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    want = np.asarray(JT.forward(jcfg, jparams,
                                 JT.Batch(embeds=jnp.asarray(emb))))
    with torch.no_grad():
        got = T.forward(cfg, params, T.Batch(embeds=torch.as_tensor(emb)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


_MLA_DIMS = dict(attention_kind="mla", q_lora_rank=32, kv_lora_rank=16,
                 qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


@pytest.mark.parametrize("cfg", [
    get_reduced_config("deepseek-v2-236b"),
    get_reduced_config("deepseek-v2-236b", q_lora_rank=0),
    _gemma(**_MLA_DIMS),
], ids=["deepseek", "no_q_lora", "gemma_pattern"])
def test_mla_configs_build_and_run(cfg):
    """MLA came with the MLA slice: ``check_supported`` accepts it, and
    the config builds and runs a forward, a loss and a decode step each
    way (naive and absorbed) on the CPU; on gemma2's pattern the window
    and softcap, which MLA does not read, change nothing."""
    T.check_supported(cfg)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert all(("w_uq" in p["mixer"]) == bool(cfg.q_lora_rank)
               for p in params["layers"])
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = T.forward(cfg, params, T.Batch(tokens=tokens))
        loss = T.loss_fn(cfg, params, T.Batch(tokens=tokens, labels=tokens))
        steps = []
        for absorb in (False, True):
            cache = T.init_cache(cfg, 2, 4, device="cpu")
            step, cache = T.decode_step(cfg, params, cache,
                                        T.Batch(tokens=tokens[:, :1]), 0,
                                        mla_absorb=absorb)
            assert isinstance(cache["layers"][0], attention.MLACache)
            steps.append(step)
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert bool(logits.isfinite().all()) and bool(loss.isfinite())
    # bf16: the absorbed step rounds its latent context to bf16 before
    # w_uv, the naive one keeps p@v in float32
    for step in steps:
        assert step.shape == (2, 1, cfg.vocab_size)
        assert bool(step.isfinite().all())
    assert (steps[0] - steps[1]).abs().max().item() < 0.25


@pytest.mark.parametrize("cfg, n_moe", [
    (_gemma(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64)), 4),
    (_gemma(first_k_dense=2, num_layers=6), 0),
    (_gemma(block_pattern=("mamba", "attn")), 0),
    (_gemma(use_rope=False), 0),
], ids=["moe", "first_k_dense", "ssm", "sinusoidal"])
def test_moe_and_prologue_configs_build_and_run(cfg, n_moe):
    """MoE blocks and the dense prologue came with the MoE slice, SSM
    blocks and sinusoidal positions with the SSM slice: the configs
    that raised before them now build, run a forward, a decode step and
    a loss on the CPU."""
    T.check_supported(cfg)
    params = T.init_params(cfg, device="cpu")
    assert len(params["layers"]) == cfg.num_layers
    assert sum("router" in p["ffn"] for p in params["layers"]) == n_moe
    tokens = torch.randint(0, cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = T.forward(cfg, params, T.Batch(tokens=tokens))
        loss = T.loss_fn(cfg, params, T.Batch(tokens=tokens, labels=tokens))
        cache = T.init_cache(cfg, 2, 4, device="cpu")
        step, _ = T.decode_step(cfg, params, cache,
                                T.Batch(tokens=tokens[:, :1]), 0)
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert step.shape == (2, 1, cfg.vocab_size)
    assert bool(logits.isfinite().all()) and bool(loss.isfinite())


def _embeds_call(what):
    """(the port's call, the reference's call) of one entry point that
    raised before the modality-stub slice, on (1, 8, d) embeds."""
    import jax.numpy as jnp

    from repro.models import layers as JL
    from repro.models import transformer as JT

    rng = np.random.default_rng(1)
    emb = rng.standard_normal((1, 8, 128)).astype(np.float32)
    labels = rng.integers(0, 512, (1, 8)).astype(np.int32)
    tb = T.Batch(embeds=torch.as_tensor(emb),
                 labels=torch.as_tensor(labels).long())
    jb = JT.Batch(embeds=jnp.asarray(emb), labels=jnp.asarray(labels))
    if what == "embeds":
        return (lambda p, c: T.forward(c, p, tb),
                lambda p, c: JT.forward(c, p, jb))
    if what == "remat":
        return (lambda p, c: T.hidden_states(c, p, tb, remat=True)[0],
                lambda p, c: JT.hidden_states(c, p, jb, remat=True)[0])
    if what == "loss_fn":
        return (lambda p, c: T.loss_fn(c, p, tb),
                lambda p, c: JT.loss_fn(c, p, jb))
    x = rng.standard_normal((1, 2, 2, 8)).astype(np.float32)
    pos3 = rng.integers(0, 64, (3, 1, 2)).astype(np.int32)
    return (lambda p, c: layers.apply_mrope(
                torch.as_tensor(x), torch.as_tensor(pos3), 1e4, (2, 1, 1)),
            lambda p, c: JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                        1e4, (2, 1, 1)))


@pytest.mark.parametrize("what", ["embeds", "remat", "loss_fn", "mrope"])
def test_later_entry_points_raise_not_implemented(what):
    """The entry points that raised before the modality-stub slice
    (frontend embeds through ``forward``, ``hidden_states`` with remat
    and ``loss_fn``, and ``apply_mrope``) now run and agree with the
    reference on the same weights and inputs."""
    cfg = get_reduced_config("gemma2-2b", dtype="float32")
    jcfg, jparams, params = _reference_pair(cfg)
    port, ref = _embeds_call(what)
    with torch.no_grad():
        got = port(params, cfg)
    want = np.asarray(ref(jparams, jcfg))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=1e-5)


def test_every_cuda_source_belongs_to_a_registered_library():
    """``chip_smoke.py`` builds ``all_libraries()``: a kernel source left
    out of the registry would never be built or checked on the card."""
    from repro_torch.kernels._build import BUILD_DIR, all_libraries

    libs = all_libraries()
    assert len({lib.name for lib in libs}) == len(libs) == 4
    covered = set()
    for lib in libs:
        assert lib.main in lib.sources
        for name in lib.sources:
            assert (lib.csrc / name).is_file(), (lib.name, name)
            covered.add((lib.csrc / name).resolve())
        assert lib.path().parent == BUILD_DIR
        assert "sm_90a" in " ".join(lib.flags)
    on_disk = {p.resolve() for p in PKG.rglob("csrc/*.cu*")}
    assert on_disk == covered


#: The serving modules (their source names neither JAX nor the
#: reference package; the port keeps its own copy of each).
SERVING = ("runtime/admission.py", "runtime/transport.py",
           "runtime/workers.py", "core/service.py", "core/client.py",
           "service.py")


def test_serving_modules_import_with_jax_and_reference_unimportable():
    code = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
for m in ("runtime.admission", "runtime.transport", "runtime.workers",
          "core.service", "core.client", "service", "runtime", "core"):
    importlib.import_module("repro_torch." + m)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", \
        out.stderr[-2000:]


@pytest.mark.parametrize("module", SERVING)
def test_serving_source_names_neither_jax_nor_the_reference(module):
    import re
    text = (PKG / module).read_text()
    assert not re.search(r"jax|xla", text, re.IGNORECASE), module
    assert not re.search(r"\brepro(?!_torch)\b", text), module


def test_service_cli_defaults_to_the_card_and_raises_without_it(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(PKG.parent),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.service", "--spool",
         str(tmp_path / "spool")], env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
    assert not (tmp_path / "spool").exists()


class _Spawned:
    """Stands in for ``subprocess.Popen``: records each child's command
    line and environment."""
    calls: list = []

    def __init__(self, argv, env, **kw):
        self.args, self.env, self.pid = argv, env, 0
        _Spawned.calls.append(self)

    def poll(self):
        return 0

    def wait(self, timeout=None):
        return 0


@pytest.mark.parametrize("visible, count, want", [
    ("3,5", 2, ["3", "5", "3"]),
    (None, 2, ["0", "1", "0"]),
    (None, 1, ["0", "0", "0"]),
], ids=["visible_list", "two_cards", "one_card"])
def test_worker_children_take_one_card_each(monkeypatch, tmp_path,
                                            visible, count, want):
    """On the card each child is ``python -m repro_torch.runtime.workers
    --device cuda`` seeing one card, ``i % count`` of the pool's."""
    monkeypatch.setattr(WK, "_one_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    monkeypatch.setattr(WK.subprocess, "Popen", _Spawned)
    _Spawned.calls = []
    WK.WorkerPool(str(tmp_path), 3, respawn=False)
    assert [c.env["CUDA_VISIBLE_DEVICES"] for c in _Spawned.calls] == want
    for c in _Spawned.calls:
        assert c.args[1:3] == ["-m", "repro_torch.runtime.workers"]
        assert c.args[c.args.index("--device") + 1] == "cuda"


def test_worker_children_on_the_cpu_get_device_cpu(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "7")
    monkeypatch.setattr(WK.subprocess, "Popen", _Spawned)
    _Spawned.calls = []
    WK.WorkerPool(str(tmp_path), 2, respawn=False, device="cpu")
    for i, c in enumerate(_Spawned.calls):
        assert c.args[1:3] == ["-m", "repro_torch.runtime.workers"]
        assert c.args[c.args.index("--device") + 1] == "cpu"
        assert c.args[c.args.index("--wid") + 1].startswith(f"w{i}.")
        assert c.env["CUDA_VISIBLE_DEVICES"] == "7"


#: The analysis modules: the port of the reference's
#: ``core/{hlo_analysis,hlo_cost,roofline,tpu_energy,dosc}.py``.
ANALYSIS = ("hlo_analysis", "hlo_cost", "roofline", "tpu_energy", "dosc")


def test_analysis_modules_stand_alone_and_are_exported():
    """They import with JAX and the reference package unimportable, and
    ``repro_torch.core`` exports each, as the reference's does; so does
    the shared tree helper."""
    code = """
import importlib, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
import repro_torch.core as core
import repro_torch.tree
for m in %r:
    assert getattr(core, m) is sys.modules["repro_torch.core." + m], m
print("ok")
""" % (ANALYSIS,)
    env = dict(os.environ, PYTHONPATH=str(PKG.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.split()[-1] == "ok", \
        out.stderr[-2000:]
    for m in ANALYSIS:
        for name in _imports(PKG / "core" / f"{m}.py"):
            assert name.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                (m, name)
