"""Kernel F, the chunk fold of the ``"cuda"`` backend, on the CPU: its
launch plan, the bound it serves (``FOLD_MAX_K``, ``FOLD_MAX_BINS``)
and how a chunk step chooses its fold on either side of it, the
``"torch"`` backend's fold looked up at call time, and the sweep's
``fold_kernel_chunks`` counter.  The kernel itself runs only on the
card (``chip_smoke.py``'s kernels phase holds it to ``fold_chunk`` bit
for bit); its wrapper on CPU tensors is ``fold_chunk``
(``test_torch_sweep_grid_kernel.py``)."""

import functools
import pathlib
import re
from collections import OrderedDict

import pytest

from repro_torch.core import backend as B
from repro_torch.core import spans, stream
from repro_torch.core.grids import REFERENCE_GRID
from repro_torch.kernels import sweep_grid as K
from repro_torch.kernels.sweep_grid import kernel as AK

FOLD_CUH = (pathlib.Path(AK.__file__).resolve().parent / "csrc"
            / "fold.cuh")


@pytest.fixture(autouse=True)
def _empty_step_cache(monkeypatch):
    monkeypatch.setattr(B, "_STEP_CACHE", OrderedDict())


def _spec(top_k=4, hist_bins=0, **kw):
    kw = dict(dict(REFERENCE_GRID, chunk_size=997), **kw)
    if hist_bins:
        kw.update(hist_bins=hist_bins,
                  hist_ranges={o: (0.0, 1.0) for o in kw.get(
                      "objectives", ("avg_power",))})
    return stream.plan_stream(top_k=top_k, device="cpu", **kw).spec


def test_bounds_are_the_headers():
    src = FOLD_CUH.read_text()
    for name in ("FOLD_MAX_K", "FOLD_MAX_BINS"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(AK, name), name
    assert "chunk_kernel" not in src and "eval_kernel" not in src


@pytest.mark.parametrize("bins", [0, 16, 256, AK.FOLD_MAX_BINS])
@pytest.mark.parametrize("k", [1, 2, 4, 5, 16, 33, AK.FOLD_MAX_K])
@pytest.mark.parametrize("d,nf", [(1, 1), (1, 3), (2, 2), (3, 3), (3, 11)])
def test_fold_plan_fits_a_block(d, nf, k, bins):
    spec = B.ChunkSpec(S=None, shape=(100_096_000,), n_total=100_096_000,
                       chunk=131072, fields=K.kernel.SW.FIELDS[:nf], d=d,
                       k=k, sign=(1.0,) * d, cons_static=(), hist_bins=bins,
                       survivor_cap=16384, small_index=True)
    assert AK.fold_runs(spec)
    p = AK.fold_plan(spec)
    assert p.threads == AK.FOLD_THREADS and p.threads % 32 == 0
    warps = p.threads // 32
    assert p.threads <= 1024 and warps & (warps - 1) == 0
    # a block a part: each objective's top-k, the argmin, the survivors,
    # each objective's histogram
    assert p.blocks == d + 2 + (d if bins else 0)
    # a warp's list of 32 pairs a lane holds the k smallest
    assert p.lists == (1 if k <= 32 else 2) and k <= 32 * p.lists
    assert p.smem_bytes == max(warps * 32 * p.lists * 16, 4 * bins)
    assert p.smem_bytes + AK.FOLD_STATIC_SMEM <= AK.SMEM_PER_BLOCK
    # one block of the launch bounds: 65,536 registers over its threads
    assert AK.SM_REGISTERS // p.threads >= 64


@pytest.mark.parametrize("k,bins", [(AK.FOLD_MAX_K + 1, 0),
                                    (4, AK.FOLD_MAX_BINS + 1)])
def test_fold_plan_refuses_past_its_bounds(k, bins):
    spec = _spec(top_k=k, hist_bins=bins)
    assert not AK.fold_runs(spec)
    with pytest.raises(ValueError):
        AK.fold_plan(spec)


@pytest.mark.parametrize("k,bins,by_kernel", [
    (4, 0, True), (AK.FOLD_MAX_K, 16, True),
    (AK.FOLD_MAX_K + 1, 0, False), (4, AK.FOLD_MAX_BINS + 1, False)])
def test_cuda_step_chooses_its_fold_from_the_spec(k, bins, by_kernel):
    """At or below the bounds the ``"cuda"`` backend folds with kernel F
    and its graph replays count F's launches and the sweep's
    ``fold_kernel_chunks``; above them it keeps ``fold_chunk``'s torch
    ops and counts neither."""
    spec = _spec(top_k=k, hist_bins=bins)
    be = B.get_backend("cuda")
    fold = be.build_chunk_fold(spec, "cpu")
    torch_fold = (isinstance(fold, functools.partial)
                  and fold.func is B.fold_chunks)
    assert torch_fold != by_kernel
    stats = {"total_s": 0.0, "fold_kernel_chunks": 0.0}
    a, f = K.sweep_grid_chunk.launches, K.sweep_grid_fold.launches
    try:
        with spans.sweep("stream.test", "total_s", stats):
            be.graph_replayed(spec, 3)
        assert K.sweep_grid_chunk.launches == a + 3
        assert K.sweep_grid_fold.launches == f + 3 * by_kernel
        assert stats["fold_kernel_chunks"] == 3 * by_kernel
    finally:
        K.sweep_grid_chunk.launches, K.sweep_grid_fold.launches = a, f


@pytest.mark.parametrize("backend,top_k", [("torch", 4), ("cuda", 4),
                                           ("cuda", AK.FOLD_MAX_K + 1)])
def test_a_step_calls_fold_chunk_when_it_runs(backend, top_k, monkeypatch):
    """A chunk step on the CPU reaches ``backend.fold_chunk`` as it is
    when the step runs, not when it was built: on ``"torch"``, and on
    ``"cuda"`` (whose fold wrapper on the CPU is ``fold_chunk``) on
    either side of the bound."""
    spec = _spec(top_k=top_k)
    step = B.build_step(spec, backend, "cpu", scan_chunks=3)
    calls = []
    fold = B.fold_chunk

    def counted(*args):
        calls.append(args[-1])
        return fold(*args)
    monkeypatch.setattr(B, "fold_chunk", counted)
    flat, vals, count = step(0)
    assert len(calls) == 3
    assert flat.shape == (3, spec.survivor_cap)
    assert vals.shape == (3, spec.survivor_cap, spec.d)
    assert count.shape == (3,)


@pytest.mark.parametrize("backend", [None, "cuda"])
def test_no_fold_kernel_chunks_on_a_cpu_stream(backend):
    res = stream.stream_grid(**dict(REFERENCE_GRID, chunk_size=997),
                             backend=backend, device="cpu")
    assert res.stats["fold_kernel_chunks"] == 0.0
    assert res.stats["graph_replays"] == 0.0
