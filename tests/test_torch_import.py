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
from repro_torch.launch import token_serve
from repro_torch.models import attention, flash, layers
from repro_torch.models import transformer as T
from repro_torch.models.cnn import HandCNN
from repro_torch.models.common import MoEConfig

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
    lambda: T.init_params(get_reduced_config("gemma2-2b")),
    lambda: T.init_cache(get_reduced_config("gemma2-2b"), 1, 4),
], ids=["evaluate_grid", "stream_grid", "plan_stream", "evaluate_one",
        "optimal_partition", "HandCNN", "run_pipeline", "token_serve",
        "init_params", "init_cache"])
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


@pytest.mark.parametrize("cfg, slice_", [
    (_gemma(moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64)), "MoE"),
    (_gemma(block_pattern=("mamba", "attn")), "SSM"),
    (_gemma(attention_kind="mla"), "MLA"),
    (_gemma(first_k_dense=2, num_layers=6), "MoE"),
    (_gemma(seq_parallel=True), "sharding"),
    (_gemma(frontend_stub=True), "modality-stub"),
    (_gemma(use_rope=False), "modality-stub"),
], ids=["moe", "ssm", "mla", "first_k_dense", "seq_parallel",
        "frontend_stub", "sinusoidal"])
def test_later_slices_raise_not_implemented(cfg, slice_):
    with pytest.raises(NotImplementedError, match=f"{slice_} slice"):
        T.init_params(cfg, device="cpu")


@pytest.mark.parametrize("call, slice_", [
    (lambda p, c: T.forward(c, p, T.Batch(embeds=torch.zeros(1, 2, 128))),
     "modality-stub"),
    (lambda p, c: T.hidden_states(
        c, p, T.Batch(tokens=torch.zeros(1, 2, dtype=torch.int64)),
        remat=True), "training"),
    (lambda p, c: T.loss_fn(c, p, T.Batch()), "training"),
    (lambda p, c: layers.apply_mrope(torch.zeros(1, 2, 2, 8),
                                     torch.zeros(3, 1, 2), 1e4, (2, 1, 1)),
     "modality-stub"),
    (lambda p, c: attention.mla_forward(c, p, None, None), "MLA"),
    (lambda p, c: attention.mla_decode(c, p, None, None, 0), "MLA"),
], ids=["embeds", "remat", "loss_fn", "mrope", "mla_forward", "mla_decode"])
def test_later_entry_points_raise_not_implemented(call, slice_):
    cfg = get_reduced_config("gemma2-2b")
    params = T.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=f"{slice_} slice"):
        call(params, cfg)


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
