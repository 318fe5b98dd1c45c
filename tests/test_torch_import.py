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

from repro_torch import handtracking_pipeline
from repro_torch.core import backend as B
from repro_torch.core import partition, stream, sweep
from repro_torch.kernels import sweep_grid
from repro_torch.models.cnn import HandCNN

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
    assert int(out.stdout.split()[-1]) >= 28


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
    assert len(files) >= 30
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
], ids=["evaluate_grid", "stream_grid", "plan_stream", "evaluate_one",
        "optimal_partition", "HandCNN", "run_pipeline"])
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


@pytest.mark.parametrize("kw", [dict(prefetch=2), dict(scan_chunks=4),
                                dict(checkpoint_dir="ckpt"),
                                dict(flat_range=(0, 8)),
                                dict(scenarios="default")])
def test_unported_stream_features_raise(kw):
    with pytest.raises(NotImplementedError):
        stream.stream_grid(cuts=(0, 1), device="cpu", **kw)
