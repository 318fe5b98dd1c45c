"""The port's dry-run (``repro_torch.launch.dryrun``): each cell's step
run once as rank 0 of a fake world of the mesh's size, on ``meta``
DTensors placed by the rules, and counted.

Rows for the reference's six reduced archs (d_model 64, vocab 256)
training, prefilling and decoding on the (2, 4) debug mesh of a fake
8-rank world: each ``ok``, with the reference's row keys (read from its
``analyse_cell``) and the reference's analytic state bytes (its rules
run in a child).  One full-size cell, codeqwen1.5-7b x prefill_32k on
(16, 16): every sharded dim divides its axis, so rank 0's dot flops
are exactly 1/256 of the unsharded step's.  ``--attn-p-bf16`` and
``--vmem-credit`` give ``ok`` rows."""

import ast
import json
import pathlib

import pytest
import torch

import _jax_reference as R
from repro_torch.configs import InputShape, SHAPES, get_config
from repro_torch.configs import get_reduced_config
from repro_torch.core.hlo_cost import analyze_program
from repro_torch.launch import dryrun, specs, steps

ARCHS = ("qwen2-0.5b", "arctic-480b", "jamba-v0.1-52b", "deepseek-v2-236b",
         "gemma2-2b", "xlstm-350m")
REDUCED = dict(d_model=64, vocab_size=256)
SHAPES_SMALL = (InputShape("train_small", 16, 8, "train"),
                InputShape("prefill_small", 64, 8, "prefill"),
                InputShape("decode_small", 1088, 8, "decode"))
MESH = "2x4"
REF_DRYRUN = (pathlib.Path(__file__).resolve().parent.parent / "src"
              / "repro" / "launch" / "dryrun.py")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_state():
    return R.run("sharding_rules", archs=list(ARCHS), reduced=REDUCED,
                 shapes=[[s.name, s.seq_len, s.global_batch, s.mode]
                         for s in SHAPES_SMALL],
                 meshes={MESH: {"data": 2, "model": 4}})


def _ref_row_keys() -> tuple:
    """The keys of the reference's ``analyse_cell`` row and of its
    ``cost_analysis``, read from its source, and those ``run_cell``
    adds."""
    tree = ast.parse(REF_DRYRUN.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "analyse_cell")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    keys = {k.value for k in ret.value.keys}
    cost = next(v for k, v in zip(ret.value.keys, ret.value.values)
                if k.value == "cost_analysis")
    return keys | {"tag", "compile_seconds"}, {k.value for k in cost.keys}


@pytest.mark.parametrize("shape", SHAPES_SMALL, ids=lambda s: s.mode)
@pytest.mark.parametrize("arch", ARCHS)
def test_meta_rows(ref_state, arch, shape):
    cfg = get_reduced_config(arch, **REDUCED)
    row = dryrun.run_cell(arch, shape, False, mesh_shape=MESH, cfg=cfg)
    assert row["status"] == "ok", row.get("traceback")
    keys, cost_keys = _ref_row_keys()
    assert keys <= set(row) and cost_keys <= set(row["cost_analysis"])
    assert row["cost_analysis"]["xla_reported_flops"] is None
    assert row["memory_analysis"] == {"error": "no device: meta"}
    assert row["chips"] == 8 and row["mesh"] == MESH
    assert row["cost_analysis"]["flops_per_device"] > 0
    assert row["collectives"], "a sharded step issues collectives"
    assert row["state_bytes_per_device"] == pytest.approx(
        ref_state[arch]["cells"][shape.name]["state_bytes"][MESH],
        rel=1e-12, abs=0)


def test_full_size_cell_is_a_256th_of_the_step():
    """codeqwen1.5-7b x prefill_32k on (16, 16): rank 0's dot flops
    times 256 equal the unsharded step's exactly (batch 32 over 16,
    heads 32, FFN 13,440 and vocab 92,416 over 16)."""
    cfg = get_config("codeqwen1.5-7b")
    shape = SHAPES["prefill_32k"]
    cost, ctx = dryrun.lower_cell("codeqwen1.5-7b", "prefill_32k", False)
    whole = analyze_program(steps.make_prefill_step(cfg),
                            specs.params_specs(cfg),
                            specs.input_specs(cfg, shape))
    assert cost.flops_by_op["dot"] * 256 == whole.flops_by_op["dot"]
    assert ctx["chips"] == 256
    assert cost.collectives.ops


@pytest.mark.parametrize("flag, message", [
    ("--attn-p-bf16", "dot"),
    ("--vmem-credit", "vmem-block-io"),
])
def test_flags_without_counterpart_give_error_rows(tmp_path, flag, message):
    """Both flags have their counterparts now (they gave error rows
    before): ``--attn-p-bf16`` credits kernel E's ``p_bf16`` route and
    ``--vmem-credit`` charges the marked loops' block I/O; each row is
    ``ok`` and counts what it charged (``tests/
    test_torch_flash_p_bf16.py`` and ``test_torch_vmem_credit.py`` hold
    them against the reference)."""
    out = tmp_path / "rows.json"
    rc = dryrun.main(["--arch", "qwen2-0.5b", "--shape", "prefill_32k",
                      "--mesh-shape", "2x4", "--out", str(out), flag])
    rows = json.loads(out.read_text())
    assert rc == 0
    assert [r["status"] for r in rows] == ["ok"]
    cost = rows[0]["cost_analysis"]
    assert message in cost["flops_by_op"] | cost["bytes_top"]
