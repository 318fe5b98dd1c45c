"""``chip_smoke.py``'s ``sharding`` phase (9i), rehearsed on the CPU at a
reduced size: the reduced codeqwen1.5-7b, 8 sequences of 256 tokens, on
a (2, 4) mesh of a fake 8-rank world, its kv heads (2) fewer than the
"model" axis (4) so kernel E's shards take their q heads' kv heads.
Rank 0's shard runs on the CPU where the phase runs it on the card;
stand-ins for kernels D and E compute their plain versions out of the
count's sight (as a ``ctypes`` launch is), count their launches and
report them to ``repro_torch.kernels._credit`` as the real wrappers do,
so the launch and shape gates and the meta-against-device count gate
run as on the card.  The card's memory readings and kernel timings are
stood in."""

import pathlib
import sys

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
import chip_smoke as CS  # noqa: E402

from repro_torch.configs import InputShape, get_reduced_config  # noqa: E402
from repro_torch.kernels import _credit  # noqa: E402
from repro_torch.kernels import flash_attention as E  # noqa: E402
from repro_torch.kernels import rmsnorm as D  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as norm_ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import flash  # noqa: E402

SHAPE = InputShape("prefill_256", 256, 8, "prefill")
MESH = "2x4"


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stand_ins(monkeypatch):
    """Kernels D and E stood in on the CPU: each computes its plain
    version unseen by a count, adds one to its launch count and reports
    the launch, as the wrappers do on the card."""
    real_blockwise = flash.blockwise_fwd

    def fake_norm(x, scale, *, eps=1e-6):
        with _disable_current_modes():
            out = D.rmsnorm_ref(x, scale, eps)
        D.rmsnorm_fused.launches += 1
        if _credit.active():
            _credit.credit("rmsnorm", D.rmsnorm_ref, (x, scale, eps), {},
                           (x, scale), (out,))
        return out

    def fake_blockwise(q, k, v, **kw):
        with _disable_current_modes():
            res = real_blockwise(q, k, v, **kw)
        E.flash_attention_fwd.launches += 1
        E.flash_attention_fwd.launches_p_bf16 += kw.get("p_bf16", False)
        if _credit.active():
            _credit.credit("flash_attention", real_blockwise, (q, k, v), kw,
                           (q, k, v), (res,))
        return res

    monkeypatch.setattr(norm_ops, "rmsnorm_fused", fake_norm)
    monkeypatch.setattr(flash, "blockwise_fwd", fake_blockwise)
    monkeypatch.setattr(CS, "device_ms", lambda fn, reps, what, expect=None:
                        ((fn() is None) + 1.0, "events"))


def _run_cell(*args, device="meta", **kw):
    """The dry-run's cell, with the card's memory readings stood in for
    rank 0's run on the CPU."""
    row = dryrun.run_cell(*args, device=device, **kw)
    if device == "cpu" and row["status"] == "ok":
        mem = row["memory_analysis"]
        mem["peak_allocated_bytes"] = 2 * mem["local_state_bytes"]
        mem["device_total_bytes"] = 80 * 2**30
    return row


def test_sharding_phase_on_the_cpu(stand_ins):
    cfg = get_reduced_config(CS.SHARD_ARCH)
    launches, rep = CS.phase_sharding(
        torch.device("cpu"), "cpu", cfg=cfg, shape=SHAPE, mesh_shape=MESH,
        run_cell=_run_cell)
    layers = cfg.num_layers
    # two steps a run: the counted one and the timed one
    assert launches == dict.fromkeys(
        ("plain", "seq_parallel", "p_bf16"),
        {"D": 2 * (2 * layers + 1), "E": 2 * layers})
    assert rep["runs"]["p_bf16"]["launches_p_bf16"] == 2 * layers
    assert rep["runs"]["plain"]["launches_p_bf16"] == 0
    plain, sp = rep["runs"]["plain"], rep["runs"]["seq_parallel"]
    # rank 0 holds 8 / 2 sequences and 4 / 4 q heads; with seq_parallel
    # its layer norms see 256 / 4 tokens of each
    assert plain["launch_shapes"] == {
        "D": {f"1024x{cfg.d_model}": 2 * layers + 1},
        "E": {f"4x256x1x{cfg.resolved_head_dim}": layers}}
    assert sp["launch_shapes"]["D"] == {f"256x{cfg.d_model}": 2 * layers,
                                        f"1024x{cfg.d_model}": 1}
    for run in (plain, sp):
        meta = run["meta_row"]["cost_analysis"]
        assert meta["flops_by_op"] == run["card"]["cost_analysis"][
            "flops_by_op"]
        assert run["card"]["collectives"]
    assert rep["kernels"]["D"]["shape"] == [1024, cfg.d_model]
    assert rep["kernels"]["E"]["shape"] == [4, 256, 1,
                                            cfg.resolved_head_dim]
    for k in ("D", "E"):
        assert {"ms", "plain_ms", "library_ms", "bound_ms"} <= set(
            rep["kernels"][k])
    p16 = rep["kernels"]["E"]["p_bf16"]
    assert {"ms", "library_ms", "bound_ms", "ties", "m", "l"} <= set(p16)


def test_shard_launches_at_full_size():
    """Gate (a)'s arithmetic for the card's cell: 65 launches of D (two
    norms in each of 32 layers and the final norm) and 32 of E a step,
    at rank 0's (2, 32768) tokens and 2 heads; 4,096-row norms with
    seq_parallel."""
    from repro_torch.configs import SHAPES, get_config

    cfg = get_config(CS.SHARD_ARCH)
    shape = SHAPES[CS.SHARD_SHAPE]
    assert CS.shard_launches(cfg, shape, (16, 16), False) == {
        "D": {(65536, 4096): 65}, "E": {(2, 32768, 2, 128): 32}}
    assert CS.shard_launches(cfg, shape, (16, 16), True)["D"] == {
        (4096, 4096): 64, (65536, 4096): 1}


def test_sharding_is_a_phase():
    assert "sharding" in CS.PHASES
    assert CS.parse_phases(["--phases", "sharding"]) == ("sharding",)
    assert CS.FIELD_PHASE["launches_sharding"] == "sharding"
    assert all("launches_sharding" in CS.ROW_FIELDS[k] for k in "DE")
