"""The parts of ``chip_smoke.py`` that decide a result without the card:
the checks of a trace-timed reading, kernel E's bound, the
``flex_attention`` yardstick's function, the guard of the LM's
kernels-vs-plain comparison, the ptxas report's registers, stack frames
and spills (kernels B, C and E), the float64 count a configuration read
from kernel B's SASS instances, kernel B's dense bound, the bitwise
comparison, and the filter work that kernel A's bound counts; the
provenance of ``ANCHOR_SCENARIO_1M`` (the JAX package's 1,018,368-pair
run gives it), the port's CPU run against the JAX package on a cut of
that grid, and the scenario phase's checks and JSON line, run on the CPU.
Everything here runs on the CPU; the script's timings and kernel
launches run only on the card."""

import json
import pathlib
import sys

import pytest
import torch

from _jax_reference import run

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402

from repro_torch.core import grids as G  # noqa: E402
from repro_torch.core import stream as ST  # noqa: E402
from repro_torch.kernels import flash_attention as E  # noqa: E402
from repro_torch.kernels import rmsnorm as D  # noqa: E402
from repro_torch.models import flash, layers  # noqa: E402

FWD = {"void (anonymous namespace)::mma::flash_fwd_kernel<256>(...)": 26,
       "void (anonymous namespace)::vec::rmsnorm_kernel<__nv_bfloat16, 9, "
       "1>(...)": 105,
       "nvjet_gemm": 183}
MINE = {"::flash_fwd_kernel<": 26, "::rmsnorm_kernel<": 105}


@pytest.fixture
def one_thread():
    """One intra-op thread for the phases rehearsed on the CPU: the
    suite runs its files in parallel worker processes (``-n 6``) on a
    shared machine, where torch's default of a thread a core makes
    every parallel op wait on the others' (the train phase: 3 s alone,
    157 s beside five busy processes, 19 s on one thread; the scenario
    phase 2 s alone, 274-565 s in parallel runs of the suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_traces(monkeypatch, traces):
    """``trace_events`` returns the given {name: records} traces in turn
    (1 µs a record)."""
    it = iter(traces)
    monkeypatch.setattr(CS, "trace_events", lambda run: (run(), {
        k: (n * 1e-6, n) for k, n in next(it).items()})[1])


def test_a_complete_trace_is_read(monkeypatch):
    _fake_traces(monkeypatch, [{k: 2 * n for k, n in FWD.items()}])
    ms, method = CS.trace_ms(lambda: None, 2, "fwd", MINE)
    assert method == "trace"
    assert ms == pytest.approx(sum(FWD.values()) * 1e-3)


@pytest.mark.parametrize("drop", [
    "void (anonymous namespace)::mma::flash_fwd_kernel<256>(...)",
    "nvjet_gemm"])
def test_a_trace_missing_one_record_is_taken_again(monkeypatch, drop):
    short = {k: 2 * n - (k == drop) for k, n in FWD.items()}
    _fake_traces(monkeypatch, [short, {k: 2 * n for k, n in FWD.items()}])
    ms, method = CS.trace_ms(lambda: None, 2, "fwd", MINE)
    assert method == "trace"
    assert ms == pytest.approx(sum(FWD.values()) * 1e-3)


def test_three_traces_missing_records_are_not_read(monkeypatch):
    """Their calls are timed by events as they run instead (an upper
    bound on device time), and the method says so."""
    short = {k: 2 * n for k, n in FWD.items()}
    short["nvjet_gemm"] -= 2       # multiples of reps still, but E is
    short[next(iter(FWD))] -= 2    # counted short of what is expected
    _fake_traces(monkeypatch, [short] * 3)
    monkeypatch.setattr(CS, "unheld_ms", lambda fn, reps: 650.0)
    assert CS.trace_ms(lambda: None, 2, "fwd", MINE) == (650.0,
                                                         "events_unheld")


def test_a_trace_of_one_call_is_refused():
    with pytest.raises(CS.SmokeFailure, match="one call"):
        CS.trace_ms(lambda: None, 1, "fwd")


def test_flash_bound_costs_qk_at_the_bf16_rate_on_bf16_inputs():
    """On bf16 inputs q.k is one bf16 tensor-core pass and p@v three (f32
    p as three bf16 pieces, computed exactly); on f32 inputs both run at
    the f32 rate.  The gemma2-2b local + global pair: 0.973 ms."""
    nbytes, qk, pv = CS.flash_work(1, 8192, 8192, 8, 4, 256, True, 0, 2)
    assert qk == pv == 2 * 256 * 8 * 8192 * 8193 // 2
    bf16, by = CS.flash_bound(nbytes, qk, pv, True)
    f32, _ = CS.flash_bound(nbytes, qk, pv, False)
    assert by == "operations"
    assert bf16 == pytest.approx((qk + 3 * pv) / 989e12 * 1e3)
    assert f32 == pytest.approx((qk + pv) / 67e12 * 1e3)
    local = CS.flash_work(1, 8192, 8192, 8, 4, 256, True, 4096, 2)
    pair = [a + b for a, b in zip(local, (nbytes, qk, pv))]
    assert CS.flash_bound(*pair, True)[0] == pytest.approx(0.973, abs=5e-4)


@pytest.mark.parametrize("sq,skv,causal,window,cap", [
    (128, 128, True, 32, 50.0), (128, 128, True, 0, 50.0),
    (64, 192, True, 40, 0.0), (128, 128, False, 0, 0.0)])
def test_flex_yardstick_computes_kernel_e_function(monkeypatch, sq, skv,
                                                   causal, window, cap):
    """Uncompiled on the CPU, the yardstick's masks, offset, softcap and
    GQA give kernel E's plain version to float32 rounding."""
    monkeypatch.setattr(torch, "compile", lambda fn, **kw: fn)
    monkeypatch.setattr(CS, "timed", lambda row, key, *a, **k: None)
    q, k, v = CS.flash_inputs(1, sq, skv, 8, 4, 32, "float32", 0,
                              torch.device("cpu"))
    q = q * 3.0
    want = E.flash_attention_ref(q, k, v, causal=causal, window=window,
                                 logit_softcap=cap)
    row = {}
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    CS.flex_library(row, qt, kt, vt, causal, window, cap, want, 3)
    assert row["library"] == "flex_attention"
    assert row["library_max_abs_diff"] <= 1e-5


def test_plain_kernels_swaps_in_the_plain_versions_and_restores():
    g = torch.Generator().manual_seed(0)
    x, scale = torch.randn(3, 16, generator=g), torch.randn(16, generator=g)
    saved = layers.rmsnorm_op, flash.flash_attention_fwd
    with CS.plain_kernels():
        assert flash.flash_attention_fwd is CS.flash_ref_by_kv_head
        assert torch.equal(layers.rmsnorm_op(x, scale),
                           D.rmsnorm_ref(x, scale))
    assert (layers.rmsnorm_op, flash.flash_attention_fwd) == saved


@pytest.mark.parametrize("kernel", ["rmsnorm_fused", "flash_attention_fwd"])
def test_plain_kernels_fails_if_a_kernel_launches_inside(kernel):
    fn = getattr(D if kernel == "rmsnorm_fused" else E, kernel)
    saved = layers.rmsnorm_op, flash.flash_attention_fwd
    with pytest.raises(CS.SmokeFailure, match="plain path launched"):
        with CS.plain_kernels():
            fn.launches += 1
    assert (layers.rmsnorm_op, flash.flash_attention_fwd) == saved



# kernel E's instances as ptxas names them: templates on the (q·k, v)
# head-dim pair
MMA256 = ("_ZN12_GLOBAL__N_13mma16flash_fwd_kernelILi256ELi256EEEvPK13__nv_"
          "bfloat16S4_S4_PS2_iiiiiiff")
SIMT256 = ("_ZN12_GLOBAL__N_116flash_fwd_kernelIfLi256ELi256EEEvPKT_S3_S3_"
           "PS1_iiiiiiff")
MMA192 = MMA256.replace("ILi256ELi256EE", "ILi192ELi128EE")
PTXAS = f"""\
ptxas info    : Compiling entry function '{MMA256}' for 'sm_90a'
ptxas info    : Function properties for {MMA256}
    120 bytes stack frame, 168 bytes spill stores, 288 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 120 bytes cumulative
ptxas info    : Function properties for __internal_helper
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '{SIMT256}' for 'sm_90a'
ptxas info    : Function properties for {SIMT256}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 178 registers, used 1 barriers
ptxas info    : Compiling entry function '{MMA192}' for 'sm_90a'
ptxas info    : Function properties for {MMA192}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 249 registers, used 1 barriers
"""


def test_ptxas_report_gives_each_route_its_registers_and_spills():
    usage = CS.ptxas_usage(PTXAS)
    assert CS.flash_kernel_usage(usage, "mma", 256) == {
        "registers": 255, "stack_frame": 120, "spill_stores": 168,
        "spill_loads": 288}
    assert CS.flash_kernel_usage(usage, "simt", 256) == {
        "registers": 178, "stack_frame": 0, "spill_stores": 0,
        "spill_loads": 0}
    with pytest.raises(CS.SmokeFailure, match="0 kernels"):
        CS.flash_kernel_usage(usage, "mma", 128)
    # the pair: (192, 128) is its own instance, not (256, 256)'s
    assert CS.flash_kernel_usage(usage, "mma", 192, 128)["registers"] == 249
    with pytest.raises(CS.SmokeFailure, match="0 kernels"):
        CS.flash_kernel_usage(usage, "mma", 192)


def test_misaligned_rmsnorm_case_takes_the_strided_route():
    for i, (rows, d, dtype, what) in enumerate(CS.RMSNORM_CASES):
        x, scale = CS.rmsnorm_inputs(min(rows, 8), d, dtype, 40 + i,
                                     torch.device("cpu"), what)
        assert x.is_contiguous() and tuple(x.shape) == (min(rows, 8), d)
        route = D.plan(*x.shape, x.element_size(), x.data_ptr(),
                       scale.data_ptr()).route
        assert (route == "strided") == (what in ("misaligned", "ragged"))


# kernel C's two tiles as ptxas names them (CUDA 12, sm_90a)
RBE_SMALL = ("_ZN46_GLOBAL__N__c35e109e_13_rbe_matmul_cu_77f2eb7e17rbe_matmul_"
             "kernelILi1ELi2ELi1EEEvPKaS2_PKfS4_Pfiiii")
RBE_LARGE = RBE_SMALL.replace("ILi1ELi2ELi1E", "ILi2ELi2ELi2E")
RBE_PTXAS = f"""\
ptxas info    : Compiling entry function '{RBE_LARGE}' for 'sm_90a'
ptxas info    : Function properties for {RBE_LARGE}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '{RBE_SMALL}' for 'sm_90a'
ptxas info    : Function properties for {RBE_SMALL}
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
"""


def test_ptxas_report_gives_each_rbe_tile_its_registers_and_spills():
    usage = CS.ptxas_usage(RBE_PTXAS)
    large = CS.rbe_kernel_usage(usage, "large")
    small = CS.rbe_kernel_usage(usage, "small")
    assert large == {"registers": 64, "stack_frame": 0, "spill_stores": 0,
                     "spill_loads": 0}
    assert small == {"registers": 48, "stack_frame": 8, "spill_stores": 4,
                     "spill_loads": 8}
    CS.no_spills("large", large)
    with pytest.raises(CS.SmokeFailure, match="4 bytes of spill stores"):
        CS.no_spills("small", small)
    # no report (a build this process did not make): nothing to check
    assert CS.rbe_kernel_usage({}, "small")["registers"] is None


def test_filter_work_counts_rows_until_the_first_dominating_one():
    rng = torch.Generator().manual_seed(0)
    d, n, r = 3, 500, 6
    Fsg = torch.rand((d, n), generator=rng, dtype=torch.float64)
    Fsg[1, :40] = float("inf")                      # lanes the filter skips
    rows = torch.rand((r, d), generator=rng, dtype=torch.float64) * 0.6
    rows[2] = Fsg[:, 100]                           # equal: not dominating
    scanned = to_table = 0
    for i in range(n):
        q = Fsg[:, i]
        if not torch.isfinite(q).all():
            continue
        for k in range(r):
            scanned += 1
            if bool((rows[k] <= q).all() and (rows[k] < q).any()):
                break
        else:
            to_table += 1
    assert to_table > 0 and scanned > n - 40
    assert CS.filter_work({"rows": rows, "table": None}, Fsg) == \
        (scanned, to_table)
    assert CS.filter_work({"rows": rows}, Fsg) == (scanned, 0)


# kernels of the sweep-grid library as ptxas names them: an untemplated
# kernel B with a local array (an 88-byte stack frame), two template
# instances of kernel B (one and two indices a thread) and kernel A
NS = "_ZN46_GLOBAL__N__cccfe8ff_13_sweep_grid_cu_59f9aeff"
EVAL_OLD = NS + "11eval_kernelENS_8EvalArgsE"
EVAL_1 = NS + "11eval_kernelIjLi1ELb0EEEvNS_8EvalArgsE"
EVAL_2 = NS + "11eval_kernelIjLi2ELb0EEEvNS_8EvalArgsE"
CHUNK = NS + "12chunk_kernelENS_9ChunkArgsE"
SWEEP_PTXAS = f"""\
ptxas info    : Compiling entry function '{EVAL_OLD}' for 'sm_90a'
ptxas info    : Function properties for {EVAL_OLD}
    88 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 96 registers, used 0 barriers, 88 bytes cumulative \
stack size
ptxas info    : Compiling entry function '{EVAL_2}' for 'sm_90a'
ptxas info    : Function properties for {EVAL_2}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 126 registers, used 0 barriers
ptxas info    : Compiling entry function '{CHUNK}' for 'sm_90a'
ptxas info    : Function properties for {CHUNK}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


def test_ptxas_report_gives_kernel_b_instances_their_stack_frames():
    usage = CS.eval_kernel_usage(CS.ptxas_usage(SWEEP_PTXAS))
    assert usage == {
        EVAL_OLD: {"registers": 96, "stack_frame": 88, "spill_stores": 0,
                   "spill_loads": 0},
        EVAL_2: {"registers": 126, "stack_frame": 0, "spill_stores": 0,
                 "spill_loads": 0}}
    assert CS.eval_kernel_usage({}) == {}


def test_eval_float64_count_is_the_one_config_instance():
    """Kernel B's instances that evaluate two configurations a thread
    issue twice Eq. 1-11's float64 work; the count a configuration is the
    smallest instance's."""
    sass = CS.eval_per_config({
        "chunk_kernel": {"fp64": 434, "divides": 10},
        EVAL_1: {"fp64": 268, "divides": 10},
        EVAL_2: {"fp64": 536, "divides": 20}}, "test")
    assert sass["eval_kernel"] == {"fp64": 268, "divides": 10}
    assert sass["eval_instances"] == {EVAL_1: 268, EVAL_2: 536}
    assert sass["chunk_kernel"]["fp64"] == 434
    with pytest.raises(CS.SmokeFailure, match="missing"):
        CS.eval_per_config({"chunk_kernel": {"fp64": 1, "divides": 0}}, "x")


def test_dense_bound_is_bytes_at_the_1m_grid():
    """1,000,960 configurations x (8-byte index + 11 x 8 output bytes) plus
    the tables and axes, over 3.35 TB/s: 28.7 us, above the float64 work
    (268 instructions a configuration at ~16.7e12/s: ~16 us)."""
    dev = torch.device("cpu")
    from repro_torch.core.grids import stream_grid_axes
    T, shape, axvals, flat = CS.dense_inputs(stream_grid_axes(CS.DENSE_N),
                                             dev)
    n = flat.numel()
    assert n == 1_000_960 and tuple(T.buf.shape) == (447,)
    nbytes = CS.eval_bytes(T, axvals, n, 11)
    assert nbytes == 447 * 8 + 144 * 8 + n * 96 == 96_096_888
    assert nbytes / CS.PEAK_BYTES_PER_S * 1e6 == pytest.approx(28.7, abs=0.05)
    assert n * 268 / 16.7e12 * 1e6 == pytest.approx(16.1, abs=0.1)


def test_bitwise_equal_holds_nan_positions_and_bits():
    import numpy as np
    a = np.array([1.0, np.nan, 0.0, 2.0])
    assert CS.bitwise_equal(a, a.copy())
    assert not CS.bitwise_equal(a, np.array([1.0, np.nan, -0.0, 2.0]))
    assert not CS.bitwise_equal(a, np.array([1.0, 3.0, 0.0, 2.0]))
    assert not CS.bitwise_equal(a, np.nextafter(a, 3.0))


def test_stream_split_and_deliverables_read_a_stream_result():
    from repro_torch.core import stream
    from repro_torch.core.grids import REFERENCE_GRID
    res = stream.stream_grid(**REFERENCE_GRID, chunk_size=4096,
                             device="cpu")
    split = CS.stream_split(res)
    assert split["n_configs"] == 10880.0 and split["graph_replays"] == 0.0
    assert CS.deliverables(res) == CS.deliverables(stream.merge_results(
        [res]))


# ---------------------------------------------------------------------------
# The scenario phase and its anchor
# ---------------------------------------------------------------------------

SCEN_KW = dict(objectives=list(G.SCENARIO_OBJECTIVES),
               maximize=["time_to_empty_s"])
#: The anchor's grid cut to its first six camera rates: 84,864 pairs.
SCEN_CUT = dict(G.SCENARIO_BIG_GRID,
                camera_fps=G.SCENARIO_BIG_GRID["camera_fps"][:6])


@pytest.fixture(scope="module")
def scen_ref():
    return run("scenario", streams={
        "big": (G.SCENARIO_BIG_GRID, "all", SCEN_KW),
        "cut": (SCEN_CUT, "all", SCEN_KW)})


def _from_reference(summary) -> dict:
    return G.scenario_summary(ST.result_from_json(summary["json"]))


def test_scenario_anchor_is_the_reference_run(scen_ref):
    """ANCHOR_SCENARIO_1M is what the JAX package's stream of the
    1,018,368 pairs returns, value for value."""
    assert _from_reference(scen_ref["streams"]["big"]) == \
        G.ANCHOR_SCENARIO_1M


def test_port_reproduces_the_reference_on_a_cut_of_the_anchor_grid(
        scen_ref, one_thread):
    got = G.scenario_summary(ST.stream_grid(
        scenarios="all", **SCEN_CUT, **SCEN_KW, device="cpu"))
    want = _from_reference(scen_ref["streams"]["cut"])
    assert got["n_pairs"] == want["n_pairs"] == 84_864
    for key in ("best_tte", "min_peak"):
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0)
    assert {k: v for k, v in got.items() if k not in ("best_tte",
                                                      "min_peak")} == \
        {k: v for k, v in want.items() if k not in ("best_tte",
                                                    "min_peak")}


def test_scenario_phase_checks_and_prints_its_line(scen_ref, monkeypatch,
                                                   capsys, one_thread):
    """The phase on the CPU, the cut grid held to the reference's cut
    anchor: every check passes and the scenario line has its keys."""
    monkeypatch.setattr(CS, "device_busy", lambda fn: (fn(), {"k": 0.5})[1])
    out = CS.phase_scenario(torch.device("cpu"), "cpu, not a card",
                            big_grid=SCEN_CUT,
                            anchor=_from_reference(scen_ref["streams"]["cut"]))
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"scenario"')]
    assert len(line) == 1 and json.loads(line[0])["scenario"] == out
    assert set(out) >= {"wall_s", "pairs_per_s", "evals_per_s", "n_steps",
                        "scan_chunks", "graph_replays", "host_merge_s",
                        "fallback_s", "device_busy_share", "backend",
                        "max_rel_err", "card"}
    assert out["backend"] == "torch" and out["n_steps"] == 20
    # the busy share divides the profiled run's device time by that
    # run's own wall time
    assert out["device_busy_share"] == 0.5 / out["profiled_total_s"]
    assert out["launches"] == dict.fromkeys("ABCDE", 0)
    assert out["max_rel_err"] <= CS.RTOL


def test_scenario_phase_fails_on_a_wrong_anchor(scen_ref, monkeypatch,
                                                one_thread):
    monkeypatch.setattr(CS, "device_busy", lambda fn: (fn(), {"k": 0.5})[1])
    anchor = dict(_from_reference(scen_ref["streams"]["cut"]))
    anchor["front_idx"] = anchor["front_idx"] + (0,)
    with pytest.raises(CS.SmokeFailure, match="front_idx"):
        CS.phase_scenario(torch.device("cpu"), "cpu", big_grid=SCEN_CUT,
                          anchor=anchor)


# ---------------------------------------------------------------------------
# The optimize and stream_devices phases, run on the CPU
# ---------------------------------------------------------------------------


def test_optimize_phase_checks_and_prints_its_line(monkeypatch, capsys):
    """On the CPU the kernel wrappers count nothing, so the launch read
    around ``grid_argmin`` is stubbed to the card's one launch of B; every
    other check (gradient, search and grid against ``ANCHOR_OPTIMIZE``)
    runs as on the card."""
    monkeypatch.setattr(CS, "read_counts",
                        lambda: dict(A=0, B=1, C=0, D=0, E=0))
    out = CS.phase_optimize(torch.device("cpu"), "cpu, not a card")
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"optimize"')]
    assert len(line) == 1 and json.loads(line[0])["optimize"] == out
    assert out["knobs"] == G.ANCHOR_OPTIMIZE["knobs"]
    assert out["grid_n"] == 41 * 41 and out["steps"] == 200
    assert out["steps_per_s"] == 200 / out["wall_s"]
    assert out["max_rel_err"] <= CS.RTOL
    assert out["trajectory_max_rel_err"] <= 1e-6


@pytest.mark.parametrize("launches", [dict(A=1, B=1, C=0, D=0, E=0),
                                      dict(A=0, B=2, C=0, D=0, E=0),
                                      dict(A=0, B=0, C=0, D=0, E=0)],
                         ids=["A", "two_B", "none"])
def test_optimize_phase_fails_on_other_launches(monkeypatch, launches):
    monkeypatch.setattr(CS, "read_counts", lambda: launches)
    with pytest.raises(CS.SmokeFailure, match="grid_argmin: launches"):
        CS.phase_optimize(torch.device("cpu"), "cpu")


def test_optimize_phase_fails_on_a_wrong_anchor(monkeypatch):
    monkeypatch.setattr(CS, "read_counts",
                        lambda: dict(A=0, B=1, C=0, D=0, E=0))
    bad = dict(G.ANCHOR_OPTIMIZE, gradient=dict(
        G.ANCHOR_OPTIMIZE["gradient"], camera_fps=-0.0026841421785))
    monkeypatch.setattr(G, "ANCHOR_OPTIMIZE", bad)
    with pytest.raises(CS.SmokeFailure, match="gradient camera_fps"):
        CS.phase_optimize(torch.device("cpu"), "cpu")


def _anchor_of(res) -> dict:
    """``check_anchor_10m``'s keys read off one stream result."""
    return dict(n_configs=res.n_configs,
                argmin_idx=res.min_idx["avg_power"],
                best_avg_power=res.min_val["avg_power"],
                topk_idx=tuple(tuple(int(i) for i in row)
                               for row in res.topk_idx),
                finite=res.finite_counts["avg_power"],
                front_size=res.front_indices.size,
                front_hash=G.index_hash(res.front_indices))


def test_stream_devices_phase_on_the_cpu(capsys):
    """The phase on CPU shards over the reference grid in chunks of 512
    (eleven dispatches of two shards), held to the one-shard run's
    reductions: two shards, a lost shard replanned, the refusal and the
    automatic list."""
    one = ST.stream_grid(**G.REFERENCE_GRID, chunk_size=512, device="cpu")
    out = CS.phase_stream_devices(torch.device("cpu"), "cpu, not a card",
                                  grid=G.REFERENCE_GRID,
                                  anchor=_anchor_of(one), chunk_size=512)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"stream_devices"')]
    assert len(line) == 1 and json.loads(line[0])["stream_devices"] == out
    assert out["lost_shard"]["elastic_replans"] == 1.0
    assert out["lost_shard"]["lost_at_chunk"] > 0
    assert out["cards"] == 1 and "every_card" not in out


# ---------------------------------------------------------------------------
# The service phase
# ---------------------------------------------------------------------------


def test_service_phase_runs_the_service_benchmarks_workload():
    """The phase's grids are the reference service benchmark's: the
    10,009,600-config request, the 10,880-config warm-up, and the 8
    tenants' requests over ``_grid_for(10**5)`` (read from what its
    ``_tenant_latencies`` submits), each at the default track."""
    want = run("service_bench")
    w = CS.service_workload()
    assert w["grid"] == want["big"] and w["warm_grid"] == want["warm"]
    assert w["anchor"] is G.ANCHOR_10M
    assert set(CS.SERVICE_WORKERS) <= set(want["workers"])
    assert CS.SERVICE_TENANTS == want["n_tenants"]
    tenants = CS.tenant_grids(w["tenant_base"])
    assert [(f"tenant-{i}", g, None) for i, g in enumerate(tenants)] == \
        want["tenants"]
    assert ST.plan_stream(**tenants[0], device="cpu").n_total == 97_920


def test_same_result_catches_one_bit_and_a_swapped_index():
    import dataclasses

    import numpy as np
    res = ST.stream_grid(**G.REFERENCE_GRID, track="all", device="cpu")
    CS.same_result(res, dataclasses.replace(res), "copy")
    f = "avg_power"
    one_bit = dataclasses.replace(res, min_val=dict(
        res.min_val, **{f: float(np.nextafter(res.min_val[f], 1.0))}))
    swapped = res.topk_idx.copy()
    swapped[0, [0, 1]] = swapped[0, [1, 0]]
    for other in (one_bit, dataclasses.replace(res, topk_idx=swapped)):
        with pytest.raises(CS.SmokeFailure, match="differs"):
            CS.same_result(other, res, "mutated")


def test_service_phase_on_the_cpu(capsys):
    """The whole phase on the CPU at small grids: in process (cold,
    resubmitted, two services, a fused batch), tenants, pools of 1 and 2
    workers (one SIGKILLed mid-lease), the networked service killed and
    restarted; every result bitwise its solo run."""
    one = ST.stream_grid(**G.REFERENCE_GRID, track="all", device="cpu")
    out = CS.phase_service(
        torch.device("cpu"), "cpu, not a card", grid=G.REFERENCE_GRID,
        anchor=_anchor_of(one),
        tenant_base=dict(G.REFERENCE_GRID, camera_fps=(30.0,)),
        warm_grid=dict(G.REFERENCE_GRID, camera_fps=(30.0, 60.0)),
        kill_grid=G.stream_grid_axes(10**6),
        kill_kw=dict(chunk_size=16384))
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"service"')]
    assert len(line) == 1 and json.loads(line[0])["service"] == out
    ip = out["in_process"]
    assert ip["plan_cache"]["hits"] == 1 and ip["step_cache_hits"] == 1
    assert not any(ip["launches"].values())
    assert len(out["tenants"]["tickets_s"]) == CS.SERVICE_TENANTS
    assert set(out["pooled"]) == {str(n) for n in CS.SERVICE_WORKERS}
    assert out["pooled"]["2"]["kill"]["leases_reissued"] >= 1
    net = out["networked"]
    assert net["auth_failures"] >= 1 and net["resumed_from_step"] > 0
    assert not (CS.ROOT / "build" / "service").exists()


# ---------------------------------------------------------------------------
# The training path (phase 11) and phases 7-8's gradient and stats checks
# ---------------------------------------------------------------------------


def test_train_launches_follow_the_config():
    """qwen2-0.5b at full width: 49 launches of D (two norms a layer and
    the final one) and 24 of E a step; gemma2-2b's post-block norms make
    it four a layer (the forward's 105 and 26)."""
    from repro_torch.configs import get_config
    assert CS.train_launches(get_config("qwen2-0.5b")) == {"D": 49, "E": 24}
    assert CS.train_launches(get_config("gemma2-2b")) == {"D": 105, "E": 26}


def test_train_step_matmul_bound():
    """qwen2-0.5b, 8 x 128 tokens: 6 x 493.9 M matmul weights x 1,024
    tokens plus the causal attention products, 3.05 TFLOP, 3.09 ms at
    989 TFLOP/s."""
    from repro_torch.configs import get_config
    f = CS.train_step_flops(get_config("qwen2-0.5b"), 8, 128)
    assert f["tokens"] == 1024
    assert f["weights"] == 24 * (2 * 896 * 14 * 64 + 2 * 896 * 2 * 64
                                 + 3 * 896 * 4864) + 151936 * 896
    attn = 24 * 3 * 2 * 2 * 64 * 14 * 8 * (128 * 129 // 2)
    assert f["ops"] == 6 * f["weights"] * 1024 + attn
    assert f["bound_ms"] == pytest.approx(3.086, abs=1e-3)


def test_train_matmul_weights_are_the_params_but_norms_and_biases():
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T
    for arch in ("qwen2-0.5b", "gemma2-2b"):
        cfg = get_reduced_config(arch)
        params = T.init_params(cfg, device="cpu")
        small = sum(t.numel() for path, t in CS.leaf_paths(params).items()
                    if path.endswith("scale") or "/b_" in path)
        assert CS.train_step_flops(cfg, 1, 8)["weights"] == \
            T.param_count(params) - small


def test_stats_blocks_tile_each_sequence():
    assert [CS.stats_blocks(n) for n in (8192, 1000, 2048, 128, 96)] == \
        [512, 8, 512, 128, 32]


def test_grad_close_holds_each_dtype_to_its_bound():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 32, generator=g)
    assert CS.grad_close(w + 1e-7, w, "f32") < 1e-6
    with pytest.raises(CS.SmokeFailure, match="differs"):
        CS.grad_close(w + 1e-3, w, "f32")
    wb = w.bfloat16()
    assert CS.grad_close(wb, wb, "bf16") == 0.0
    off = wb.float().clone()
    off[0, 0] += 0.05 * float(w.abs().max())
    with pytest.raises(CS.SmokeFailure, match="differs"):
        CS.grad_close(off.bfloat16(), wb, "bf16")
    assert CS.grad_close(off.bfloat16(), wb, "bf16 share",
                         bf16_share=0.1) < 0.1
    with pytest.raises(CS.SmokeFailure, match="differs"):
        CS.grad_close(off.bfloat16(), wb, "bf16 share", bf16_share=0.01)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_stats_and_grad_checks_pass_on_the_plain_versions(dtype,
                                                             one_thread):
    dev = torch.device("cpu")
    q, k, v = CS.flash_inputs(2, 96, 96, 6, 2, 32, dtype, 3, dev)
    kw = dict(causal=True, window=40, logit_softcap=50.0)
    out = E.flash_attention_fwd(q, k, v, **kw)
    stats = CS.flash_stats_check(q, k, v, out, kw, "cpu")
    assert stats["m"] <= 1e-5 and stats["l"] <= 1e-4
    grad = CS.flash_grad_check(q, k, v, kw, 7, "cpu")
    assert set(grad) == {"dq", "dk", "dv"}
    assert max(grad.values()) < (1e-2 if dtype == "bfloat16" else 1e-5)


def test_flash_stats_check_catches_wrong_stats(monkeypatch, one_thread):
    dev = torch.device("cpu")
    q, k, v = CS.flash_inputs(1, 64, 64, 4, 2, 32, "float32", 4, dev)
    kw = dict(causal=True, window=0, logit_softcap=0.0)
    out = E.flash_attention_fwd(q, k, v, **kw)
    real = E.flash_attention_fwd

    def shifted(*a, return_stats=False, **k):
        res = real(*a, return_stats=return_stats, **k)
        return (res[0], res[1], res[2] * 1.001) if return_stats else res

    monkeypatch.setattr(E, "flash_attention_fwd", shifted)
    with pytest.raises(CS.SmokeFailure, match="stats l"):
        CS.flash_stats_check(q, k, v, out, kw, "cpu")


def test_rmsnorm_grad_check_passes_on_the_plain_version(one_thread):
    dev = torch.device("cpu")
    for dtype in ("float32", "bfloat16"):
        x, scale = CS.rmsnorm_inputs(96, 896, dtype, 1, dev)
        out = CS.rmsnorm_grad_check(x, scale, 2, dtype)
        assert out["dx"] < 1e-2 and out["dscale"] < 1e-5


def test_plain_kernels_swaps_the_flash_vjp_and_restores():
    """Under ``plain_kernels`` a gradient runs autograd through the plain
    versions (no Function in the graph), and the names come back."""
    saved = flash.flash_attention_vjp
    q, k, v = (t.requires_grad_() for t in CS.flash_inputs(
        1, 32, 32, 2, 1, 32, "float32", 5, torch.device("cpu")))
    with CS.plain_kernels():
        out = flash.flash_attention(q, k, v)
        assert "FlashAttention" not in type(out.grad_fn).__name__
        y = layers.rmsnorm({"scale": torch.zeros(32, requires_grad=True)},
                           q)
        assert "RMSNorm" not in type(y.grad_fn).__name__
    assert flash.flash_attention_vjp is saved
    out = flash.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"


def test_compare_grads_reads_cosines_and_norms():
    a = {"x": torch.tensor([1.0, 0.0]), "y": [torch.tensor([0.0, 2.0])]}
    b = {"x": torch.tensor([1.0, 1.0]), "y": [torch.tensor([0.0, 2.0])]}
    out = CS.compare_grads(1.0, a, 1.25, b)
    assert out["loss_diff"] == 0.25 and out["min_cos_leaf"] == "x"
    assert out["min_leaf_cos"] == pytest.approx(2 ** -0.5)
    assert out["grad_norm"] == pytest.approx(5 ** 0.5)
    assert out["grad_norm_rel_diff"] == pytest.approx(1 - (5 / 6) ** 0.5)


TRAIN_ARGV = ["--arch", "qwen2-0.5b", "--reduced", "--steps", "12",
              "--seq-len", "32", "--global-batch", "4", "--lr", "1e-2",
              "--warmup", "2"]


def _train_counts(monkeypatch, main_counts, step_counts):
    """``read_counts`` as the card gives them around train.main, the
    plain path, the plain p_bf16 path, the p_bf16 steps (each launch of
    E on the route) and one step (on the CPU the wrappers count
    nothing)."""
    zeros = dict(A=0, B=0, C=0, D=0, E=0)
    n = CS.TRAIN_P_BF16_STEPS
    p16 = dict(step_counts, D=n * step_counts["D"], E=n * step_counts["E"])
    seq = iter([main_counts, zeros, zeros, p16, step_counts])
    monkeypatch.setattr(CS, "read_counts", lambda: next(seq))
    monkeypatch.setattr(CS, "p_bf16_launches", lambda: p16["E"])


def test_train_phase_on_the_cpu(monkeypatch, tmp_path, capsys, one_thread):
    """The whole phase at the reduced qwen2-0.5b: the training CLI's loss
    decreases, one step against the plain path, the reduced float32
    models on the training anchors, the resume bitwise."""
    _train_counts(monkeypatch, dict(A=0, B=0, C=0, D=60, E=24),
                  dict(A=0, B=0, C=0, D=5, E=2))
    main, one, out = CS.phase_train(torch.device("cpu"), "cpu, not a card",
                                    TRAIN_ARGV, tmp_path / "resume")
    assert main["D"] == 60 and one == dict(A=0, B=0, C=0, D=5, E=2)
    assert out["main"]["loss_decreased"] and out["main"]["steps"] == 12
    assert out["vs_plain"]["min_leaf_cos"] >= CS.TRAIN_LEAF_COS
    assert out["p_bf16"]["vs_plain"]["min_leaf_cos"] >= CS.TRAIN_LEAF_COS
    assert out["p_bf16"]["launches_p_bf16"] == 2 * CS.TRAIN_P_BF16_STEPS
    assert set(out["anchors"]) == {"qwen2-0.5b", "gemma2-2b"}
    assert out["resume"]["loss_gap"] == 0
    assert out["resume"]["leaves_differing"] == []
    assert out["step"]["timed_steps"] == CS.TRAIN_TIMED_STEPS
    assert not (tmp_path / "resume").exists()
    assert "train qwen2-0.5b: step" in capsys.readouterr().out


@pytest.mark.parametrize("main_counts", [dict(A=0, B=0, C=0, D=59, E=24),
                                         dict(A=1, B=0, C=0, D=60, E=24)],
                         ids=["short_D", "A"])
def test_train_phase_fails_on_other_launches(monkeypatch, tmp_path,
                                             main_counts, one_thread):
    _train_counts(monkeypatch, main_counts, dict(A=0, B=0, C=0, D=5, E=2))
    with pytest.raises(CS.SmokeFailure, match="expected launches"):
        CS.phase_train(torch.device("cpu"), "cpu", TRAIN_ARGV,
                       tmp_path / "resume")


def test_train_phase_fails_on_a_wrong_anchor(monkeypatch, one_thread):
    from repro_torch.models import anchors as A
    bad = dict(A.TRAIN_ANCHORS["gemma2-2b"])
    bad["losses"] = (bad["losses"][0],) + tuple(
        x * 1.001 for x in bad["losses"][1:])
    monkeypatch.setitem(A.TRAIN_ANCHORS, "gemma2-2b", bad)
    with pytest.raises(CS.SmokeFailure, match="losses"):
        CS.phase_train_anchor("gemma2-2b", torch.device("cpu"))


# ---------------------------------------------------------------------------
# Phase 9d: MoE serving (arctic-480b)
# ---------------------------------------------------------------------------

#: The rehearsal's serve run: batch, prompt, generated tokens.
MOE_SERVE = (2, 8, 4)


def _moe_counts(monkeypatch, fwd, serve):
    """``read_counts`` as the card gives them around each prompt's
    forward, its plain and float32 plain forwards, and the serve run (on
    the CPU the wrappers count nothing)."""
    zero = dict(A=0, B=0, C=0, D=0, E=0)
    seq = iter([fwd, zero, zero] * 2 + [serve, zero])
    monkeypatch.setattr(CS, "read_counts", lambda: next(seq))


def _moe_phase(monkeypatch, fwd=None, serve=None):
    from repro_torch.configs import get_reduced_config
    b, p, g = MOE_SERVE
    _moe_counts(monkeypatch, fwd or dict(A=0, B=0, C=0, D=5, E=2),
                serve or dict(A=0, B=0, C=0, D=5 * (p + g - 1), E=0))
    return CS.phase_moe(torch.device("cpu"), "cpu, not a card",
                        get_reduced_config("arctic-480b"), 64, MOE_SERVE)


def test_moe_phase_on_the_cpu(monkeypatch, capsys, one_thread):
    """The whole phase at the reduced bf16 arctic-480b (2 MoE layers of
    8 experts): the forward and the serve run against themselves on the
    plain path, routes equal, drops counted, the bounds from this run's
    routes, and the reduced float32 model on its JAX anchors (routes
    included)."""
    fwd, step, out = _moe_phase(monkeypatch)
    assert fwd == dict(A=0, B=0, C=0, D=5, E=2)
    assert step == dict(A=0, B=0, C=0, D=5, E=0)
    f, s = out["forward"], out["serve"]
    assert f["routes_agree"] == [1.0, 1.0] and s["routes_agree"] == [1, 1]
    assert f["vs_plain"]["rows"] == f["vs_plain"]["of_rows"] == 64
    second = f["second_prompt"]
    assert second["seed"] == CS.MOE_SECOND_PROMPT_SEED
    assert second["routes_agree"] == [1.0, 1.0]
    for rep in (f, second):
        wit = rep["float32_witness"]
        assert len(wit["routes_agree"]) == 2
        assert 0 < min(wit["routes_agree"]) <= 1
        assert wit["vs_plain_all_tokens"]["max_abs_diff"] > 0
    assert len(f["dropped_share"]) == 2 and 0 < f["kept_picks"] <= 256
    assert f["bound"]["bound_by"] == "bytes" and s["bound_ms"] > 0
    assert s["routed_bound_ms"] <= s["bound_ms"]
    assert out["anchors"]["routes_equal"]
    assert "bound_share" not in f and "busy_share" not in f  # no card
    assert "arctic-480b forward (2 layers)" in capsys.readouterr().out


def test_moe_phase_fails_on_other_launches(monkeypatch, one_thread):
    with pytest.raises(CS.SmokeFailure,
                       match="arctic-480b forward: expected"):
        _moe_phase(monkeypatch, fwd=dict(A=0, B=0, C=0, D=4, E=2))


def test_moe_phase_fails_on_a_wrong_route_anchor(monkeypatch, one_thread):
    from repro_torch.models import anchors as A
    bad = dict(A.LM_ANCHORS["arctic-480b"])
    bad["routes"] = dict(bad["routes"], dropped=(89, 61))
    monkeypatch.setitem(A.LM_ANCHORS, "arctic-480b", bad)
    with pytest.raises(CS.SmokeFailure, match="routes"):
        CS.phase_anchor("arctic-480b", torch.device("cpu"))


def test_float32_experts_is_the_float32_product():
    """Under ``float32_experts`` a float32 batch by a bf16 one is the
    float32 product, a slice of experts at a time (20 experts: two
    slices); same dtypes pass through, and ``torch.bmm`` comes back."""
    g = torch.Generator().manual_seed(5)
    a = torch.randn(20, 3, 8, generator=g)
    b = torch.randn(20, 8, 4, generator=g).to(torch.bfloat16)
    saved = torch.bmm
    with CS.float32_experts():
        got = torch.bmm(a, b)
        same = torch.bmm(a, a.transpose(1, 2))
    assert torch.bmm is saved
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a, b.float()))
    assert torch.equal(same, torch.bmm(a, a.transpose(1, 2)))


def test_float32_copy_keeps_only_the_expert_weights():
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T

    cfg = get_reduced_config("arctic-480b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    wide = CS.float32_copy(params)
    moe = wide["layers"][0]["ffn"]
    for k in ("w_gate", "w_up", "w_down"):
        assert moe[k] is params["layers"][0]["ffn"][k]
        assert moe[k].dtype == torch.bfloat16
    assert moe["router"].dtype == torch.float32
    assert moe["residual"]["w_up"].dtype == torch.float32
    assert wide["embed"]["table"].dtype == torch.float32
    assert torch.equal(wide["unembed"]["w"], params["unembed"]["w"].float())


def test_plain_attention_by_kv_head_is_the_plain_function():
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 40, 14, 32, generator=g)
    k, v = torch.randn(2, 1, 40, 2, 32, generator=g)
    want = E.flash_attention_ref(q, k, v, causal=True)
    got = CS.flash_ref_by_kv_head(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    with CS.plain_kernels():
        assert flash.flash_attention_fwd is CS.flash_ref_by_kv_head
    assert flash.flash_attention_fwd is E.flash_attention_fwd


def _meta_params(cfg) -> dict:
    """arctic's parameter tree on the meta device (shapes and dtypes,
    no storage), for counting its bytes at full width."""
    from repro_torch.models import transformer as T

    d, m, bf = cfg.d_model, cfg.moe, torch.bfloat16
    hd, h, kv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads

    def t(*shape, dtype=bf):
        return torch.empty(shape, dtype=dtype, device="meta")

    def dense(f):
        return {"w_gate": t(d, f), "w_up": t(d, f), "w_down": t(f, d)}

    layers = []
    for use_moe in T.layer_moe_flags(cfg):
        ffn = dict(router=t(d, m.num_experts, dtype=torch.float32),
                   w_gate=t(m.num_experts, d, m.d_ff_expert),
                   w_up=t(m.num_experts, d, m.d_ff_expert),
                   w_down=t(m.num_experts, m.d_ff_expert, d),
                   residual=dense(cfg.d_ff)) if use_moe else dense(cfg.d_ff)
        layers.append({
            "norm1": {"scale": t(d, dtype=torch.float32)},
            "norm2": {"scale": t(d, dtype=torch.float32)},
            "mixer": {"w_q": t(d, h, hd), "w_k": t(d, kv, hd),
                      "w_v": t(d, kv, hd), "w_o": t(h, hd, d)},
            "ffn": ffn})
    return {"embed": {"table": t(cfg.vocab_size, d)},
            "unembed": {"w": t(d, cfg.vocab_size)},
            "final_norm": {"scale": t(d, dtype=torch.float32)},
            "layers": layers}


def test_moe_bounds_at_arctic_full_width():
    """Two full-width layers hold 55.4 GB; a decode step of the static
    buffer reads every expert's weights (54.9 GB: 16.4 ms at 3.35 TB/s),
    the 4096-token prompt as much plus its logits, and its operations
    (9.4 TFLOP with no pick dropped, at 989 TFLOP/s) take less: both
    bound by bytes."""
    from repro_torch.models import transformer as T

    cfg = CS.moe_config()
    assert (cfg.num_layers, cfg.d_model, cfg.moe.num_experts) == \
        (2, 7168, 128)
    params = _meta_params(cfg)
    assert abs(T.param_bytes(params) / 1e9 - 55.37) < 0.01
    e = 2 * cfg.moe.num_experts
    step = CS.lm_bounds(cfg, params, 4, kept=16, used=e, ctx=48)
    assert step["bound_by"] == "bytes"
    assert abs(step["bound_ms"] - 16.39) < 0.01
    routed = CS.lm_bounds(cfg, params, 4, kept=16, used=16, ctx=48)
    assert routed["bound_ms"] < 0.1 * step["bound_ms"]
    fwd = CS.lm_bounds(cfg, params, 4096, kept=2 * 8192, used=e)
    assert fwd["bound_by"] == "bytes"
    assert abs(fwd["bytes_ms"] - 16.49) < 0.01
    assert abs(fwd["ops_ms"] - 9.55) < 0.01


# ---------------------------------------------------------------------------
# Phase 9e: SSM serving (xlstm-350m, jamba-v0.1-52b)
# ---------------------------------------------------------------------------

#: The rehearsal's serve run (batch, prompt, generated) and the xlstm
#: CLI line that serves it.
SSM_SERVE = (2, 8, 4)
SSM_ARGV = ["--arch", "xlstm-350m", "--reduced", "--batch", "2",
            "--prompt-len", "8", "--gen", "4"]
ZERO = dict(A=0, B=0, C=0, D=0, E=0)


def _ssm_phase(monkeypatch, xl_fwd=None, jb_fwd=None):
    """Phase 9e at the reduced bf16 xlstm-350m (4 layers) and jamba (one
    super-block of 8 layers, 8 experts), a 64-token prompt;
    ``read_counts`` as the card gives them around each model's forward,
    its plain and float32 plain forwards, the serve run and its plain
    teacher-forced run."""
    from repro_torch.configs import get_reduced_config

    steps = SSM_SERVE[1] + SSM_SERVE[2] - 1
    seq = iter([xl_fwd or dict(ZERO, D=5), ZERO, ZERO,
                dict(ZERO, D=5 * steps), ZERO,
                jb_fwd or dict(ZERO, D=17, E=1), ZERO, ZERO,
                dict(ZERO, D=17 * steps), ZERO])
    monkeypatch.setattr(CS, "read_counts", lambda: next(seq))
    return CS.phase_ssm(torch.device("cpu"), "cpu, not a card",
                        get_reduced_config("xlstm-350m"),
                        get_reduced_config("jamba-v0.1-52b", num_layers=8),
                        (64, 64), SSM_SERVE, SSM_ARGV)


def test_ssm_phase_on_the_cpu(monkeypatch, capsys, one_thread):
    """The whole phase at the reduced bf16 models: each forward and
    serve run against itself on the plain path (equal), beside the
    float32 witness (not equal), jamba's routes and drops, the bounds,
    and the reduced float32 models on their JAX anchors."""
    launches, out = _ssm_phase(monkeypatch)
    assert launches == {
        "xlstm-350m": {"forward": dict(ZERO, D=5),
                       "decode_step": dict(ZERO, D=5)},
        "jamba-v0.1-52b": {"forward": dict(ZERO, D=17, E=1),
                           "decode_step": dict(ZERO, D=17)}}
    xl, jb = out["xlstm-350m"], out["jamba-v0.1-52b"]
    for rep in (xl, jb):
        f, s = rep["forward"], rep["serve"]
        assert f["vs_plain_all_tokens"]["max_abs_diff"] == 0.0
        assert s["vs_plain_all_tokens"]["max_abs_diff"] == 0.0
        assert f["float32_witness"]["vs_plain_all_tokens"][
            "max_abs_diff"] > 0
        assert f["float32"]["vs_plain_all_tokens"]["max_abs_diff"] == 0.0
        assert [b["positions"] for b in f["vs_plain_by_position"]] == [
            [0, 1], [1, 16], [16, 64]]
        assert f["bound"]["bound_ms"] > 0 and s["bound_ms"] > 0
        assert "device_ms" not in f and "bound_share" not in s  # no card
    assert xl["forward"]["routes_agree"] == [] and "experts" not in xl
    f = jb["forward"]
    assert f["routes_agree"] == [1.0] * 4 and len(f["dropped_share"]) == 4
    assert f["kept_picks"] <= f["slots"] == 4 * 8 * 20
    assert f["routed_bound"]["ops"] < f["bound"]["ops"]
    assert jb["serve"]["routes_agree"] == [1.0] * 4
    assert out["anchors"]["jamba-v0.1-52b"]["routes_equal"]
    assert out["anchors"]["xlstm-350m"]["greedy_equal"]
    printed = capsys.readouterr().out
    assert "xlstm-350m forward (4 layers)" in printed
    assert "jamba-v0.1-52b serve batch=2" in printed


def test_ssm_phase_fails_on_other_launches(monkeypatch, one_thread):
    with pytest.raises(CS.SmokeFailure,
                       match="xlstm-350m forward: expected 5 launches"):
        _ssm_phase(monkeypatch, xl_fwd=dict(ZERO, D=4))


def test_ssm_anchors_fail_on_a_wrong_route_digest(monkeypatch, one_thread):
    from repro_torch.models import anchors as A
    bad = dict(A.LM_ANCHORS["jamba-v0.1-52b"])
    bad["routes"] = dict(bad["routes"], keep_crc32=1)
    monkeypatch.setitem(A.LM_ANCHORS, "jamba-v0.1-52b", bad)
    with pytest.raises(CS.SmokeFailure, match="routes"):
        CS.phase_anchor("jamba-v0.1-52b", torch.device("cpu"))


@pytest.mark.parametrize("arch, want", [
    ("gemma2-2b", dict(ZERO, D=17, E=4)),
    ("arctic-480b", dict(ZERO, D=5, E=2)),
    ("xlstm-350m", dict(ZERO, D=5)),
    ("jamba-v0.1-52b", dict(ZERO, D=33, E=2)),
    ("deepseek-v2-236b", dict(ZERO, D=13, E=3)),
])
def test_lm_launches_count_the_norms_and_attention_layers(arch, want):
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T

    cfg = get_reduced_config(arch)
    params = T.init_params(cfg, torch.Generator(), "meta")
    assert CS.lm_launches(cfg, params) == want


def test_lm_bounds_at_the_ssm_cells():
    """jamba at 16 of 32 layers holds 52.1 GB; a decode step of the
    static buffer reads every weight but the embedding table, of which
    it gathers four rows (51.6 GB: 15.4 ms at 3.35 TB/s); its
    4096-token prompt's operations with every slot of the buffer
    (16 experts x 80 slots x 8 groups a MoE layer) take ~56 ms at
    989 TFLOP/s, and the float32 ones (the dt projection, the conv and
    the scan: 0.30 TFLOP) 4.4 ms more at 67 TFLOP/s.  xlstm-350m's forward is set by its mLSTM parallel form
    in float32 (~12 ms at 67 TFLOP/s); its decode step by bytes."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    cfg = CS.ssm_jamba_config()
    params = T.init_params(cfg, torch.Generator(), "meta")
    assert abs(T.param_bytes(params) / 1e9 - 52.11) < 0.01
    every = 8 * 16
    step = CS.lm_bounds(cfg, params, 4, kept=8 * 16, used=every, ctx=48)
    assert step["bound_by"] == "bytes"
    assert abs(step["bound_ms"] - 15.42) < 0.01
    fwd = CS.lm_bounds(cfg, params, 4096, kept=8 * 16 * 80 * 8, used=every)
    assert fwd["bound_by"] == "operations"
    bf16_ms = (fwd["ops"] - fwd["f32_ops"]) / CS.BF16_PEAK_OPS * 1e3
    assert 55 < bf16_ms < 57
    assert abs(fwd["ops_ms"] - bf16_ms - 4.4) < 0.1
    xl = get_config("xlstm-350m")
    xp = T.init_params(xl, torch.Generator(), "meta")
    xf = CS.lm_bounds(xl, xp, 4096)
    assert xf["bound_by"] == "operations"
    assert xf["f32_ops"] / CS.PEAK_F32_OPS_PER_S * 1e3 > 10
    assert CS.lm_bounds(xl, xp, 4, ctx=48)["bound_by"] == "bytes"


class _Ev:
    """A raw profiler record as :func:`chip_smoke.split_trace` reads it:
    its device, name, correlation id and times (ns)."""

    def __init__(self, dev, name, corr, start, end):
        self._v = (dev, name, corr, start, end)

    def device_type(self):
        return self._v[0]

    def name(self):
        return self._v[1]

    def correlation_id(self):
        return self._v[2]

    def start_ns(self):
        return self._v[3]

    def duration_ns(self):
        return self._v[4] - self._v[3]


def test_split_trace_attributes_kernels_to_the_scan_ranges():
    """A kernel counts in a scan where the runtime or driver call that
    launched it starts inside the scan's host range; the device's mirror
    of a range or of the profiler step is not a kernel; a kernel without
    a launch record counts in the total only."""
    from torch.autograd import DeviceType as Dt
    cpu, gpu = Dt.CPU, Dt.CUDA
    tag = CS.SCAN_TAG
    events = [
        _Ev(cpu, tag + "_mamba_scan", 0, 100, 200),
        _Ev(cpu, tag + "_slstm_scan", 0, 300, 400),
        _Ev(cpu, "cudaLaunchKernel", 1, 50, 51),
        _Ev(cpu, "cudaLaunchKernel", 2, 150, 151),
        _Ev(cpu, "cuLaunchKernelEx", 3, 350, 351),
        _Ev(cpu, "aten::add", 9, 140, 160),
        _Ev(gpu, "gemm", 1, 1000, 1010),
        _Ev(gpu, "addcmul", 2, 1010, 1013),
        _Ev(gpu, "tanh", 3, 1013, 1017),
        _Ev(gpu, "orphan", 7, 1017, 1018),
        _Ev(gpu, tag + "_mamba_scan", 0, 1010, 1013),
        _Ev(gpu, "ProfilerStep#1", 0, 990, 1020),
    ]
    got = CS.split_trace(events)
    assert got["kernels"] == 4 and got["device_s"] == 18e-9
    assert got["scan_device_s"] == {"_mamba_scan": 3e-9,
                                    "_slstm_scan": 4e-9}
    assert got["launches_matched"] == 0.75
    assert got["scan_calls"] == {"_mamba_scan": 1, "_slstm_scan": 1,
                                 "mlstm_parallel": 0}
    assert list(got["device_s_by_kernel"])[0] == "gemm"
    with pytest.raises(CS.SmokeFailure, match="no device events"):
        CS.split_trace(events[:6])


def test_scan_ranges_wrap_the_scans_and_restore():
    from repro_torch.models import ssm

    saved = {n: getattr(ssm, n) for n in CS.SCANS}
    with CS.scan_ranges():
        assert all(getattr(ssm, n) is not saved[n] for n in CS.SCANS)
        x = torch.zeros(1, 4, 2)
        out = ssm._mamba_scan(torch.zeros(2, 3), torch.zeros(1, 4, 3),
                              torch.zeros(1, 4, 3), x, x)
        assert out.shape == (1, 4, 2)
    assert all(getattr(ssm, n) is saved[n] for n in CS.SCANS)


# ---------------------------------------------------------------------------
# Phase 9f: MLA serving (deepseek-v2-236b)
# ---------------------------------------------------------------------------

#: The rehearsal's serve run (batch, prompt, generated) and the absorbed
#: step's cache length.
MLA_SERVE, MLA_CTX = (2, 8, 4), 64
#: The reduced deepseek-v2's launches: norm1, norm2, q_norm and kv_norm in
#: each of 3 layers and the final norm; E once a layer.
MLA_FWD = dict(ZERO, D=13, E=3)


def _mla_phase(monkeypatch, fwd=MLA_FWD, step=dict(ZERO, D=13)):
    """Phase 9f at the reduced bf16 deepseek-v2 (the dense prologue and 2
    MoE layers of 8 experts), a 64-token prompt; ``read_counts`` as the
    card gives them around each prompt's forward and its plain and
    float32 plain forwards, the naive and the absorbed step, the serve
    run and its plain teacher-forced run."""
    from repro_torch.configs import get_reduced_config

    steps = MLA_SERVE[1] + MLA_SERVE[2] - 1
    seq = iter([fwd, ZERO, ZERO] * 2 + [step] * 2
               + [dict(ZERO, D=13 * steps), ZERO])
    monkeypatch.setattr(CS, "read_counts", lambda: next(seq))
    return CS.phase_mla(torch.device("cpu"), "cpu, not a card",
                        get_reduced_config("deepseek-v2-236b"), 64,
                        MLA_SERVE, MLA_CTX)


def test_mla_phase_on_the_cpu(monkeypatch, capsys, one_thread):
    """The whole phase at the reduced bf16 deepseek-v2: the forward and
    the serve run against themselves on the plain path (equal), beside
    the float32 witness (not equal), in float32 on the kernels' float32
    routes; the absorbed step against the naive one (float32 within
    1e-4 of the largest logit, bf16 within the witness); the bounds; the
    reduced float32 model on its JAX anchors, routes included."""
    fwd, step, out = _mla_phase(monkeypatch)
    assert fwd == MLA_FWD and step == dict(ZERO, D=13)
    assert (out["layers"], out["of_layers"], out["qk_dims"]) == \
        (3, 60, [32, 16])
    f, s, a = out["forward"], out["serve"], out["absorb"]
    assert f["routes_agree"] == [1.0, 1.0] and s["routes_agree"] == [1, 1]
    assert f["vs_plain_all_tokens"]["max_abs_diff"] == 0.0
    assert f["float32_witness"]["vs_plain_all_tokens"]["max_abs_diff"] > 0
    assert f["float32"]["routes_agree"] == [1.0, 1.0]
    assert f["second_prompt"]["seed"] == CS.MOE_SECOND_PROMPT_SEED
    assert f["kept_picks"] <= f["slots"] and f["bound"]["bound_ms"] > 0
    assert f["routed_bound"]["ops"] < f["bound"]["ops"]
    assert a["launches_naive"] == a["launches_absorbed"] == \
        dict(ZERO, D=13)
    assert a["float32"]["max_abs_diff"] <= 1e-4 * a["float32"]["max_abs"]
    assert 0 < a["absorbed_vs_naive"]["max_abs_diff"] <= \
        1.25 * a["float32_witness"]["max_abs_diff"]
    assert a["absorbed_bound"]["ops"] < a["naive_bound"]["ops"]
    assert s["launches_per_step"] == dict(ZERO, D=13)
    assert out["anchors"]["routes_equal"] and out["anchors"]["greedy_equal"]
    assert "device_ms" not in f and "naive_ms" not in a  # no card
    printed = capsys.readouterr().out
    assert "deepseek-v2-236b forward (3 layers)" in printed
    assert "absorbed vs naive" in printed and "mla phase" in printed


def test_mla_phase_fails_on_other_launches(monkeypatch, one_thread):
    with pytest.raises(CS.SmokeFailure,
                       match="deepseek-v2-236b forward: expected 13"):
        _mla_phase(monkeypatch, fwd=dict(ZERO, D=11, E=3))


def test_mla_absorbed_step_fails_on_other_launches(monkeypatch,
                                                   one_thread):
    with pytest.raises(CS.SmokeFailure, match="naive step: expected 13"):
        _mla_phase(monkeypatch, step=dict(ZERO, D=13, E=3))


def test_mla_anchors_fail_on_a_wrong_route_digest(monkeypatch, one_thread):
    from repro_torch.models import anchors as A
    bad = dict(A.LM_ANCHORS["deepseek-v2-236b"])
    bad["routes"] = dict(bad["routes"], top_e_crc32=1)
    monkeypatch.setitem(A.LM_ANCHORS, "deepseek-v2-236b", bad)
    with pytest.raises(CS.SmokeFailure, match="routes"):
        CS.phase_anchor("deepseek-v2-236b", torch.device("cpu"))


def test_mla_bounds_at_deepseek_full_width():
    """Seven full-width layers hold 50.1 GB.  The 4096-token prompt with
    every slot of the MoE buffer (160 experts x 8 groups x 24 slots a
    layer) is 28.9 TFLOP of bf16: ~29 ms at 989 TFLOP/s, over its 14.9
    ms of bytes.  A decode step at batch 4 reads every weight but the
    embedding table (14.6 ms); at a 4096-token cache the naive step's
    expansion of k_nope and v is 0.55 TFLOP a layer, the absorbed step's
    work a fortieth of it; both bound by bytes."""
    from repro_torch.models import transformer as T

    cfg = CS.mla_config()
    assert (cfg.num_layers, cfg.d_model, cfg.moe.num_experts) == \
        (7, 5120, 160)
    params = T.init_params(cfg, torch.Generator(), "meta")
    assert abs(T.param_bytes(params) / 1e9 - 50.12) < 0.01
    slots = 6 * 160 * 8 * 24
    fwd = CS.lm_bounds(cfg, params, 4096, kept=slots, used=6 * 160)
    assert fwd["bound_by"] == "operations"
    assert abs(fwd["ops"] / 1e12 - 28.9) < 0.05
    assert abs(fwd["bytes_ms"] - 14.91) < 0.01
    step = CS.lm_bounds(cfg, params, 4, kept=6 * 160, used=6 * 160, ctx=48)
    assert step["bound_by"] == "bytes"
    assert abs(step["bound_ms"] - 14.65) < 0.01
    naive = CS.lm_bounds(cfg, params, 4, kept=6 * 160, used=6 * 160,
                         ctx=4096)
    absorbed = CS.lm_bounds(cfg, params, 4, kept=6 * 160, used=6 * 160,
                            ctx=4096, absorb=True)
    expand = 2 * 4 * 4096 * 512 * 128 * 256
    assert abs(naive["ops"] - absorbed["ops"] - 7 * expand) \
        < 0.05 * expand
    assert naive["bound_by"] == absorbed["bound_by"] == "bytes"
    assert naive["bytes"] == absorbed["bytes"]


def test_flash_bound_with_head_dims_apart():
    """deepseek-v2's prompt attention: q·k over 192, p@v over 128, at S
    4096 and 128 heads: 0.41 + 3 x 0.27 TFLOP at 989 TFLOP/s, 1.25 ms."""
    assert CS.head_dims((192, 128)) == (192, 128)
    assert CS.head_dims(64) == (64, 64)
    nbytes, qk, pv = CS.flash_work(1, 4096, 4096, 128, 128, 192, True, 0,
                                   2, 128)
    pairs = 128 * 4096 * 4097 // 2
    assert (qk, pv) == (2 * 192 * pairs, 2 * 128 * pairs)
    assert nbytes == 2 * (192 + 128) * 2 * 4096 * 128
    ms, by = CS.flash_bound(nbytes, qk, pv, True)
    assert by == "operations" and ms == pytest.approx(1.251, abs=1e-3)
    q, k, v = CS.flash_inputs(1, 8, 8, 2, 2, 48, "float32", 0,
                              torch.device("cpu"), 32)
    assert (q.shape[-1], k.shape[-1], v.shape[-1]) == (48, 48, 32)


def test_fill_mla_cache_draws_every_layer_up_to_its_end():
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T

    cfg = get_reduced_config("deepseek-v2-236b")
    cache = T.init_cache(cfg, 2, 8, device="cpu")
    CS.fill_mla_cache(cache, 7, 3)
    for c in cache["layers"]:
        for t in c:
            assert bool((t[:, 7] == 0).all()) and bool((t[:, :7] != 0).all())
            assert t.dtype == torch.bfloat16
    assert not torch.equal(cache["layers"][0].c_kv, cache["layers"][1].c_kv)


# ---------------------------------------------------------------------------
# Phase 9g: modality-stub serving (qwen2-vl-2b, musicgen-large)
# ---------------------------------------------------------------------------

#: The rehearsal's sizes: qwen2-vl's prompt layout (text, image rows and
#: columns, text: 32 tokens), musicgen's frames, serving (batch, tokens)
#: and the compression backward's layout (12 tokens).
STUB_IMAGE, STUB_FRAMES, STUB_SERVE, STUB_GRAD = (4, 3, 3, 19), 24, (2, 4), \
    (2, 2, 2, 6)


def _stub_counts(cfg):
    """A forward's launches from the config's layer count (norm1 and
    norm2 a layer and the final norm; E once a layer) and a decode
    step's (the norms, no E)."""
    n = cfg.num_layers
    return dict(ZERO, D=2 * n + 1, E=n), dict(ZERO, D=2 * n + 1)


def _stub_phase(monkeypatch, vl_fwd=None):
    """Phase 9g at the reduced bf16 qwen2-vl-2b and musicgen-large (2
    layers each); ``read_counts`` as the card gives them around each
    forward (and its plain and float32 plain forwards), the served
    decode steps (qwen2-vl's plain teacher-forced runs, bf16 and float32,
    inside ``plain_kernels``) and the compression gate's backward."""
    from repro_torch.configs import get_reduced_config

    vl = get_reduced_config("qwen2-vl-2b")
    au = get_reduced_config("musicgen-large")
    (vf, vs), (af, as_) = _stub_counts(vl), _stub_counts(au)
    steps_vl, steps_au = STUB_SERVE[1] - 1, STUB_SERVE[1]
    seq = iter([vl_fwd or vf, ZERO, ZERO, dict(ZERO, D=vs["D"] * steps_vl),
                ZERO, ZERO, vf,
                af, ZERO, ZERO, dict(ZERO, D=as_["D"] * steps_au)])
    monkeypatch.setattr(CS, "read_counts", lambda: next(seq))
    return CS.phase_stub(torch.device("cpu"), "cpu, not a card", vl, au,
                         STUB_IMAGE, STUB_FRAMES, STUB_SERVE, STUB_GRAD)


def test_stub_phase_on_the_cpu(monkeypatch, capsys, one_thread):
    """The whole phase at the reduced bf16 models: the forwards and
    qwen2-vl's serve run against themselves on the plain path (equal),
    beside the float32 witness (not equal); the M-RoPE gates (t = h = w
    is RoPE exactly; the image's positions move the logits after the
    first text run only); the prefill from one forward against a decode
    step a position; musicgen's decode against its forward, bf16 and
    float32; the compression gate; the reduced float32 models on their
    JAX anchors; the ``stub`` line's keys."""
    from repro_torch.configs import get_reduced_config

    launches, out = _stub_phase(monkeypatch)
    for arch in ("qwen2-vl-2b", "musicgen-large"):
        fwd, step = _stub_counts(get_reduced_config(arch))
        assert launches[arch] == {"forward": fwd, "decode_step": step}
        rep = out[arch]
        f = rep["forward"]
        assert f["launches"] == fwd and rep["layers"] == 2
        assert f["vs_plain"]["max_abs_diff"] == 0.0
        assert f["float32_witness"]["vs_plain"]["max_abs_diff"] > 0
        assert f["bound"]["bound_ms"] > 0 and "device_ms" not in f
        assert rep["serve"]["launches_per_step"] == step
        assert rep["serve"]["bound_ms"] > 0
        assert "step_device_ms" not in rep["serve"]        # no card
        assert out["anchors"][arch]["greedy_equal"]
    vl, au = out["qwen2-vl-2b"], out["musicgen-large"]
    assert vl["image"] == dict(zip(("before", "rows", "cols", "after"),
                                   STUB_IMAGE))
    m = vl["forward"]["mrope"]
    assert m["rope_vs_mrope_f32"] == 0.0
    assert m["text_run"]["max_abs_diff"] == 0.0
    assert m["after_text_run"]["max_abs_diff"] > CS.LM_BF16_MAX_DIFF
    s = vl["serve"]
    assert s["vs_plain"]["max_abs_diff"] == 0
    assert s["float32"]["tokens_reproduced"]
    assert s["float32"]["max_abs_diff"] == 0
    for rep in (vl, au):
        assert rep["forward"]["float32"]["vs_plain"]["max_abs_diff"] == 0
    assert s["prefill_check"]["positions"] == 32
    assert s["prefill_check"]["max_abs_diff"] <= CS.LM_BF16_MAX_DIFF
    assert au["serve"]["vs_forward"]["argmax_agree"] >= CS.LM_BF16_ARGMAX
    assert au["serve"]["float32_vs_forward"]["max_abs_diff"] \
        <= CS.STUB_DECODE_F32_MAX_DIFF
    c = vl["compression"]
    assert c["launches"] == _stub_counts(get_reduced_config(
        "qwen2-vl-2b"))[0]
    assert [x["kind"] for x in c["steps"]] == ["int8", "int8", "bf16"]
    assert [x["wire_bytes"] for x in c["steps"]] == \
        [c["elements"], c["elements"], 2 * c["elements"]]
    assert all(0 < x["worst_share_of_bound"] <= 1 for x in c["steps"])
    assert c["leaves"] == 26 and c["seq"] == 12
    json.dumps({"stub": out})
    printed = capsys.readouterr().out
    assert "qwen2-vl-2b forward (2 layers)" in printed
    assert "M-RoPE" in printed and "stub phase" in printed


def test_stub_phase_fails_on_a_perturbed_plain_e(monkeypatch, one_thread):
    """A plain E that is not the function (its output off by 0.5) fails
    the first kernels-vs-plain gate, qwen2-vl's forward.  On the CPU both
    paths' attention is the blockwise ``_fwd_pass``: it is perturbed
    where ``plain_kernels`` has swapped the plain E in."""
    real = flash._fwd_pass

    def perturbed(*args, **kw):
        out, m, l_ = real(*args, **kw)
        if flash.flash_attention_fwd is CS.flash_ref_by_kv_head:
            out = out + 0.5
        return out, m, l_

    monkeypatch.setattr(flash, "_fwd_pass", perturbed)
    with pytest.raises(CS.SmokeFailure,
                       match="qwen2-vl-2b forward: kernels vs plain"):
        _stub_phase(monkeypatch)


def test_stub_phase_fails_on_other_launches(monkeypatch, one_thread):
    with pytest.raises(CS.SmokeFailure,
                       match="qwen2-vl-2b forward: expected 5"):
        _stub_phase(monkeypatch, vl_fwd=dict(ZERO, D=5, E=1))


def test_forward_prefill_writes_the_decode_steps_cache(one_thread):
    """The cache one forward writes (:func:`chip_smoke.forward_prefill`)
    is the cache the reference's prefill writes, a decode step a
    position: the reduced float32 qwen2-vl (M-RoPE at t = h = w = the
    index) and musicgen (sinusoidal positions), on embeds, within 1e-5;
    the next step's logits from either cache agree as closely."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import transformer as T

    for arch in ("qwen2-vl-2b", "musicgen-large"):
        cfg = get_reduced_config(arch, dtype="float32")
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        emb = torch.randn(2, 9, cfg.d_model,
                          generator=torch.Generator().manual_seed(1)) * 0.1
        with torch.no_grad():
            fast = T.init_cache(cfg, 2, 9, device="cpu")
            CS.forward_prefill(cfg, params, T.Batch(embeds=emb), fast, 8)
            slow = T.init_cache(cfg, 2, 9, device="cpu")
            for t in range(8):
                T.decode_step(cfg, params, slow,
                              T.Batch(embeds=emb[:, t:t + 1]), t)
            for a, b in zip(fast["layers"], slow["layers"]):
                assert torch.allclose(a.k, b.k, atol=1e-5)
                assert torch.allclose(a.v, b.v, atol=1e-5)
                assert bool((a.k[:, 8:] == 0).all())
            last = T.Batch(embeds=emb[:, 8:9])
            x, _ = T.decode_step(cfg, params, fast, last, 8)
            y, _ = T.decode_step(cfg, params, slow, last, 8)
        assert torch.allclose(x, y, atol=1e-5)


def test_stub_embeds_follow_the_prompt_layout():
    """qwen2-vl's prompt: text rows of the model's own table around the
    image's seeded normals (at the table's scale), positions by
    Qwen2-VL's rule for every sequence; musicgen's frames all normals."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import anchors as A
    from repro_torch.models import transformer as T

    cfg = get_reduced_config("qwen2-vl-2b")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x, pos = CS.stub_embeds(cfg, params, STUB_IMAGE, 0, 2,
                            torch.Generator().manual_seed(1))
    table = params["embed"]["table"]
    assert tuple(x.shape) == (2, 32, 128) and x.dtype == table.dtype
    for row in list(range(4)) + list(range(13, 32)):
        assert any(torch.equal(x[0, row], t) for t in table)
    assert not any(torch.equal(x[0, 4], t) for t in table)
    assert tuple(pos.shape) == (3, 2, 32)
    assert torch.equal(pos[:, 1], torch.as_tensor(A.image_positions(
        *STUB_IMAGE)).to(pos.dtype))
    au = get_reduced_config("musicgen-large")
    frames, none = CS.stub_embeds(au, T.init_params(au, device="cpu"), None,
                                  7, 3, torch.Generator().manual_seed(2))
    assert tuple(frames.shape) == (3, 7, 128) and none is None
    assert abs(frames.float().std().item() - 128 ** -0.5) < 0.01


def test_stub_bounds_at_full_width():
    """qwen2-vl-2b (1.54 B parameters, 3.09 GB of bf16): its 4096-token
    prompt is ~14 TFLOP of bf16 (10.7 for the layers' products, 1.9 for
    the tied unembed, 1.4 for causal attention), ~14 ms at 989 TFLOP/s;
    a decode step at batch 4 reads every weight, the tied table
    included (~0.92 ms at 3.35 TB/s).  musicgen-large (2.42 B, 4.85 GB):
    its 1536-frame prompt ~7.9 TFLOP; a decode step reads every weight
    but the untied embedding table, and its 48 layers' k and v caches."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    vl = get_config("qwen2-vl-2b")
    vp = T.init_params(vl, torch.Generator(), "meta")
    assert abs(T.param_count(vp) / 1e9 - 1.54) < 0.01
    assert abs(T.param_bytes(vp) / 1e9 - 3.09) < 0.01
    fwd = CS.lm_bounds(vl, vp, 4096)
    assert fwd["bound_by"] == "operations"
    assert 13.5e12 < fwd["ops"] < 14.5e12
    unembed = 2 * 4096 * 1536 * 151936
    assert abs(unembed / 1e12 - 1.91) < 0.01
    step = CS.lm_bounds(vl, vp, 4, ctx=4112)
    assert step["bound_by"] == "bytes"
    assert step["bytes"] > T.param_bytes(vp)           # the table read whole
    au = get_config("musicgen-large")
    ap = T.init_params(au, torch.Generator(), "meta")
    assert abs(T.param_bytes(ap) / 1e9 - 4.85) < 0.01
    afwd = CS.lm_bounds(au, ap, 1536)
    assert 7.8e12 < afwd["ops"] < 8.0e12
    astep = CS.lm_bounds(au, ap, 4, ctx=1516)
    table = ap["embed"]["table"]
    cache = 48 * 2 * 4 * 1516 * 32 * 64 * 2          # k and v, every layer
    want = T.param_bytes(ap) - table.numel() * 2 + cache
    assert abs(astep["bytes"] - want) < 1e-3 * want


def test_stub_launches_count_the_norms_and_attention_layers():
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    for arch, want in (("qwen2-vl-2b", dict(ZERO, D=57, E=28)),
                       ("musicgen-large", dict(ZERO, D=97, E=48))):
        cfg = get_config(arch)
        params = T.init_params(cfg, torch.Generator(), "meta")
        assert CS.lm_launches(cfg, params) == want
