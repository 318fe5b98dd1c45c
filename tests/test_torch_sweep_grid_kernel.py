"""The plain versions of the two sweep-grid kernels against the JAX
reference: the Pallas kernels in interpret mode and the XLA backend.

Kernel A's plain version (``chunk_partials_ref``) must reproduce every
block partial of the reference chunk step, and the port's ``fold_chunk``
every carry entry and the survivors, for chunks that do and do not
divide the grid, reach past its end, d = 1, 2, 3 (the last two with the
prefix-min bin table), constraints, maximize, histograms and a filter
built from a real front.  Floats agree to 1e-12 relative with the NaN
pattern identical; integers, booleans and index sets exactly.

Two differences between the reference's own lowerings are by design,
and the port follows the XLA one: in the lanes that pad a chunk to
whole blocks, the Pallas kernel leaves ``Fd`` at whatever those lanes
decode to where XLA writes NaN, and in a block with no valid lane its
``bidx`` is the block's first flat index where XLA's is the padding
fill ``n_total``.  ``fold_chunk`` reads neither (it takes ``bidx`` only
where the block min is finite), so against Pallas ``Fd`` is compared
over the chunk's own lanes and ``bidx`` where ``bmin`` is finite.
"""

import numpy as np
import pytest
import torch

from _jax_reference import assert_close, run
from repro_torch.core import backend as B
from repro_torch.core import sweep
from repro_torch.core.grids import REFERENCE_GRID
from repro_torch.kernels import sweep_grid

N_TOTAL = 10_880
CASES = {
    # d = 1, non-dividing chunk that runs past the end of the grid.
    "c997_d1_tail": dict(chunk=997, objectives=["avg_power"],
                         track=["latency", "sensor_memory"],
                         start=N_TOTAL - 500),
    # d = 2 (bin table), constraints, histograms, dividing chunk.
    "c4096_d2_cons_hist": dict(
        chunk=4096, objectives=["avg_power", "latency"],
        constraints={"mipi_bytes_per_s": 3.0e5, "latency": [">", 0.02]},
        hist_bins=16, hist_lo=[0.0, 0.0], hist_hi=[0.05, 0.06],
        start=4096),
    # d = 3 (bin table) with a maximized objective and a survivor cap
    # the chunk overflows.
    "c997_d3_max_hist": dict(
        chunk=997, objectives=["avg_power", "latency", "sensor_macs_per_s"],
        maximize=["sensor_macs_per_s"], track=["mipi"], hist_bins=8,
        hist_lo=[0.0, 0.0, -1e9], hist_hi=[0.05, 0.06, 0.0], start=1994,
        cap=16),
}
EVAL_FLAT = np.unique(np.concatenate([
    np.random.default_rng(11).integers(0, N_TOTAL, 1200),
    [0, N_TOTAL - 1]])).astype(np.int64)


@pytest.fixture(scope="module")
def ref():
    cases = {name: dict(case, grid=REFERENCE_GRID)
             for name, case in CASES.items()}
    return run("chunk", cases=cases, eval_grid=REFERENCE_GRID,
               eval_flat=EVAL_FLAT.tolist())


@pytest.fixture(scope="module")
def grid():
    S, axis_arrays, _ = sweep.build_axes(**REFERENCE_GRID)
    return (S, tuple(a.size for a in axis_arrays),
            sweep.axes_to_device(axis_arrays, "cpu"))


def _port_inputs(grid, r):
    S, shape, axvals = grid
    s = r["spec"]
    assert tuple(s["shape"]) == shape and s["n_total"] == N_TOTAL
    spec = B.ChunkSpec(
        S=S, shape=shape, n_total=s["n_total"], chunk=s["chunk"],
        fields=tuple(s["fields"]), d=s["d"], k=s["k"], sign=tuple(s["sign"]),
        cons_static=tuple(tuple(c) for c in s["cons_static"]),
        hist_bins=s["hist_bins"], survivor_cap=s["survivor_cap"],
        small_index=s["small_index"])
    aux = {k: ({kk: torch.as_tensor(vv) for kk, vv in v.items()}
               if isinstance(v, dict) else torch.as_tensor(v))
           for k, v in r["aux"].items()}
    return spec, B.device_tables(S, "cpu"), axvals, aux


def _compare(got: dict, want: dict, lanes=None):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        w = np.asarray(w)
        if lanes is not None and k == "Fd":
            g, w = g[..., :lanes], w[..., :lanes]
        if lanes is not None and k == "bidx":
            live = np.isfinite(np.asarray(want["bmin"]))
            g, w = g[live], w[live]
        assert g.shape == w.shape, k
        if w.dtype.kind == "f":
            assert_close(g, w, what=k)
        else:
            # The XLA reference sums the valid counts in its default
            # int64; the Pallas kernel (and the port) keep int32.
            assert g.dtype == w.dtype or k == "cnt", k
            assert np.array_equal(g, w), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_chunk_partials_match_xla(grid, ref, case):
    spec, T, axvals, aux = _port_inputs(grid, ref[case])
    got = sweep_grid.chunk_partials_ref(spec, T, axvals, aux,
                                        CASES[case]["start"])
    _compare(got, ref[case]["xla"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_chunk_partials_match_pallas_interpret(grid, ref, case):
    spec, T, axvals, aux = _port_inputs(grid, ref[case])
    got = sweep_grid.chunk_partials_ref(spec, T, axvals, aux,
                                        CASES[case]["start"])
    _compare(got, ref[case]["pallas"], lanes=spec.chunk)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_chunk_matches_reference(grid, ref, case):
    spec, T, axvals, aux = _port_inputs(grid, ref[case])
    start = CASES[case]["start"]
    partials = sweep_grid.chunk_partials_ref(spec, T, axvals, aux, start)
    carry0 = B.carry_to_device(B.init_carry(spec), "cpu")
    carry, surv = B.fold_chunk(spec, carry0, partials, aux, start)
    _compare(carry, ref[case]["carry"])
    flat, vals, count = (x.numpy() for x in surv)
    rflat, rvals, rcount = ref[case]["surv"]
    assert int(count) == int(rcount)
    n = min(int(count), spec.survivor_cap)
    assert np.array_equal(flat[:n], rflat[:n])
    assert_close(vals[:n], rvals[:n], what="survivor values")


def test_init_carry_matches_reference_layout(grid, ref):
    spec, *_ = _port_inputs(grid, ref["c4096_d2_cons_hist"])
    carry = B.init_carry(spec)
    want = ref["c4096_d2_cons_hist"]["carry"]
    assert carry.keys() == want.keys()
    for k in carry:
        assert carry[k].dtype == want[k].dtype
        assert carry[k].shape == want[k].shape


def test_cpu_wrapper_is_the_plain_version(grid, ref):
    case = "c997_d3_max_hist"
    spec, T, axvals, aux = _port_inputs(grid, ref[case])
    n = sweep_grid.sweep_grid_chunk.launches
    got = sweep_grid.sweep_grid_chunk(spec, T, axvals, aux,
                                      CASES[case]["start"])
    assert sweep_grid.sweep_grid_chunk.launches == n
    _compare(got, ref[case]["xla"])


@pytest.mark.parametrize("oracle", ["pallas", "xla"])
def test_sweep_grid_eval_ref_matches(grid, ref, oracle):
    S, shape, axvals = grid
    got = sweep_grid.sweep_grid_eval_ref(
        B.device_tables(S, "cpu"), shape, sweep.FIELDS, axvals,
        torch.as_tensor(EVAL_FLAT))
    for f in sweep.FIELDS:
        assert_close(got[f].numpy(), ref["eval"][oracle][f], what=f)


def test_merged_carries_equal_one_fold(grid, ref):
    """Two chunks folded into two carries and merged on the host
    (``merge_device_carries``) give the carry of folding both into one."""
    case = "c4096_d2_cons_hist"
    spec, T, axvals, aux = _port_inputs(grid, ref[case])
    starts = (0, 2 * spec.chunk)
    fresh = lambda: B.carry_to_device(B.init_carry(spec), "cpu")  # noqa
    parts, seq = [], fresh()
    for s in starts:
        partials = sweep_grid.chunk_partials_ref(spec, T, axvals, aux, s)
        parts.append(B.carry_to_host(
            B.fold_chunk(spec, fresh(), partials, aux, s)[0]))
        seq = B.fold_chunk(spec, seq, partials, aux, s)[0]
    stacked = {k: np.stack([p[k] for p in parts]) for k in parts[0]}
    merged = B.merge_device_carries(stacked, spec.k)
    for k, v in B.carry_to_host(seq).items():
        assert merged[k].dtype == v.dtype, k
        assert np.array_equal(merged[k], v), k
