"""A configuration of kind ``lm``, added by files and ``BENCHMARK.json``
entries alone: a small phi4-mini-3.8b (the port's reduced config) with a
traffic mix, the ``dense`` reference and the LM metrics, in a temporary
root.  Its run is correct and reports both token rates; a broken decode
path, a skipped layer, logits scaled where they are produced and the
float8 control each fail the check; nothing loads the JAX package; the
reference is the port's forward; the frozen work is a hand count."""

import dataclasses
import filecmp
import itertools
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import cells, control, lm, lm_check, lm_program, run, tracing
from portbench.reference.lm import dense, opcount
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.models import attention as A
from repro_torch.models import transformer as T

ROOT = cells.ROOT
ARCH = "phi4-mini-3.8b"
CELL = "phi4-mini-small.chat"
SEED = 2**31 + 23
#: The port's ModelConfig keys that its reduced config cuts, and the
#: published config.json keys they stand for.
FILE_KEY = {"num_layers": "num_hidden_layers", "d_model": "hidden_size",
            "num_heads": "num_attention_heads",
            "num_kv_heads": "num_key_value_heads",
            "d_ff": "intermediate_size", "vocab_size": "vocab_size"}
#: Limits of the small model on the CPU, from sound runs (logits_rel_err
#: 1.1-1.5e-2, p50 0.71-0.87e-2, scale 3e-6-2.4e-4, token gap 0) and the
#: float8 control (0.13-0.21, 0.099-0.12, 4.5e-3-1.2e-2).
LIMITS = {"logits_rel_err": 0.04, "logits_rel_err_p50": 0.03,
          "logits_scale_err": 5e-4, "token_gap": 0.02, "nonfinite": 0}
#: The LM metrics' BENCHMARK.json entries, which the first LM cell adds
#: with its own name under ``workloads`` (an empty list is refused).
LM_END_TO_END = [
    {"name": "prefill_tokens_per_s", "unit": "tokens/s", "better": "higher",
     "bound": 0.25, "source": "host_clock"},
    {"name": "decode_tokens_per_s", "unit": "tokens/s", "better": "higher",
     "bound": 0.25, "source": "host_clock"}]
LM_PER_LAYER = [
    {"name": "mfu.lm", "unit": "%", "better": "higher",
     "source": "device_trace", "layer": "whole window",
     "moves": "decode_tokens_per_s"}]
#: What each cell of the benchmark reports today.
TODAY = {
    "grid-1e8.argmin": (
        {"configs_per_s", "setup_s"},
        {"plan_share.grid", "host_merge_share.grid", "dispatch_share.grid",
         "kernel_a_roofline", "device_idle_share.grid", "fp64_mfu.grid",
         "device_wait_share.grid", "prefilter_pass_share.grid",
         "fold_us_per_chunk.grid"}),
    "sessions-1m.long": (
        {"pairs_per_s", "setup_s"},
        {"plan_share.sessions", "host_merge_share.sessions",
         "session_step_roofline", "device_idle_share.sessions",
         "fp64_mfu.sessions", "probe_share.sessions",
         "device_wait_share.sessions"}),
}
TODAY["sessions-1m.default"] = TODAY["sessions-1m.long"]


def small_lm_config() -> dict:
    full, small = get_config(ARCH), get_reduced_config(ARCH)
    over = {k: {"value": getattr(small, k), "published": getattr(full, k),
                "file_key": key} for k, key in FILE_KEY.items()
            if getattr(small, k) != getattr(full, k)}
    return {"name": "phi4-mini-small", "kind": "lm", "arch": ARCH,
            "reference": "dense", "hidden_size": small.d_model,
            "intermediate_size": small.d_ff,
            "num_attention_heads": small.num_heads,
            "num_key_value_heads": small.num_kv_heads,
            "num_hidden_layers": small.num_layers,
            "vocab_size": small.vocab_size, "rms_norm_eps": small.norm_eps,
            "rope_theta": small.rope_theta, "tie_word_embeddings": False,
            "hidden_act": "silu",
            "reduced": sorted(o["file_key"] for o in over.values()),
            "overrides": over, "limits": LIMITS,
            "limits_why": dict.fromkeys(LIMITS, "set from the readings in "
                                        "this module's note on LIMITS")}


@pytest.fixture(scope="module")
def lm_root(tmp_path_factory):
    """A root whose portbench/ is this one's with files added, and whose
    BENCHMARK.json adds the LM cell's entries."""
    tmp = tmp_path_factory.mktemp("lm_root")
    shutil.copytree(ROOT / "portbench", tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "src").symlink_to(ROOT / "src")
    cfg = small_lm_config()
    (tmp / "portbench/configs/phi4-mini-small.json").write_text(
        json.dumps(cfg))
    (tmp / "portbench/traffic/chat-small.json").write_text(json.dumps(
        {"mix": "closed loop, one client", "batch": 2, "prompt_len": "5-9",
         "gen_len": 4, "check_requests": 2, "trace_requests": 1}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": "the port's",
                             "file": "portbench/configs/phi4-mini-small.json",
                             "reduced": cfg["reduced"], "why": "small"})
    bench["workloads"].append({"name": CELL, "config": cfg["name"],
                               "traffic": "chat-small", "chips": 1,
                               "why": "small"})
    bench["end_to_end"] += [dict(m, workloads=[CELL]) for m in LM_END_TO_END]
    bench["per_layer"] += [dict(m, workloads=[CELL]) for m in LM_PER_LAYER]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def _run(root, seed=SEED, control_run=False):
    cell = cells.resolve(CELL, root)
    if control_run:
        return control.lm_control_numbers(cell, seed, "cpu", 0.0, root)
    return run.run(cell, seed, 0.0, False, device="cpu", root=root)


def test_lm_cell_is_added_by_files_alone(lm_root):
    old = sorted(p.relative_to(ROOT) for p in (ROOT / "portbench").rglob("*")
                 if p.is_file() and "__pycache__" not in p.parts)
    for rel in old:
        assert filecmp.cmp(ROOT / rel, lm_root / rel, shallow=False), rel
    out = _run(lm_root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"setup_s", "prefill_tokens_per_s",
                                   "decode_tokens_per_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["checks"]["nonfinite"] == {"value": 0, "limit": 0}
    # the reservoir's draw and the longest prompt, checked
    assert 1 <= len(out["checked"]) <= 3


def _stale_cache(monkeypatch):
    attend = A.decode_attention

    def stale(q, k, v, cache_len, **kw):
        return attend(q, k, v, max(cache_len - 1, 1), **kw)
    monkeypatch.setattr(A, "decode_attention", stale)


def _layer_skipped(monkeypatch):
    block, calls = T._block_decode, itertools.count()
    n = get_reduced_config(ARCH).num_layers

    def skip(cfg, kind, use_moe, params, x, cache, *args):
        if next(calls) % n == n - 1:
            return x, cache
        return block(cfg, kind, use_moe, params, x, cache, *args)
    monkeypatch.setattr(T, "_block_decode", skip)


def _logits_scaled(monkeypatch):
    logits = T._logits
    monkeypatch.setattr(T, "_logits", lambda cfg, params, h: logits(
        cfg, params, h).float() * (1.0 + 1e-3))


@pytest.mark.parametrize("fault", [_stale_cache, _layer_skipped,
                                   _logits_scaled])
def test_broken_lm_path_is_not_correct(lm_root, fault, monkeypatch):
    fault(monkeypatch)
    assert not _run(lm_root)["correct"]


@pytest.mark.parametrize("seed", [SEED, 5])
def test_float8_control_is_not_correct(lm_root, seed):
    found = _run(lm_root, seed, control_run=True)
    assert not lm_check.verdict(found, LIMITS)
    assert found["logits_rel_err"] > 3 * LIMITS["logits_rel_err"]


def test_lm_run_loads_no_forbidden_module(lm_root):
    script = (
        "import json, sys\n"
        "from pathlib import Path\n"
        f"root = Path({str(lm_root)!r})\n"
        "sys.path.insert(0, str(root))\n"
        "from portbench import cells, run\n"
        f"out = run.run(cells.resolve({CELL!r}, root), {SEED}, 0.0, False, "
        "device='cpu', root=root)\n"
        "print(json.dumps([out['correct'], run.forbidden_modules()]))\n")
    p = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=300, cwd=lm_root)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.splitlines()[-1]) == [True, []]


def test_forbidden_modules_are_named(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro.core.fake", sys)
    monkeypatch.setitem(sys.modules, "flax.fake", sys)
    found = run.forbidden_modules()
    assert {"repro", "flax"} <= set(found)
    assert "repro_torch" not in found


@pytest.mark.parametrize("name", sorted(TODAY))
def test_existing_cells_assemble_to_todays_metrics(name):
    cell = cells.resolve(name)
    e2e, per_layer = TODAY[name]
    assert {m["name"] for m in cell.end_to_end} == e2e
    assert {m["name"] for m in cell.per_layer} == per_layer
    assert cell.config.get("kind") != "lm"


def test_trace_check_counts_kernels_d_and_e():
    def rec(name, dev, s, e):
        return (name, dev, 0, s, e)
    records = [rec(tracing.WINDOW, False, 0, 100),
               rec("void rmsnorm_kernel<bf16>", True, 10, 20),
               rec("void rmsnorm_kernel<bf16>", True, 30, 40),
               rec("gemm", True, 50, 60)]
    tr = tracing.read(records, {"graph replays": 0, "D": 2, "E": 0})
    assert tr["busy_s"] == pytest.approx(30e-9)
    with pytest.raises(tracing.TraceIncomplete):
        tracing.read(records, {"graph replays": 0, "D": 3, "E": 0})


def test_mfu_reads_the_traced_work():
    read = cells.reader("mfu.lm")
    ctx = {"kind": "lm", "flops": 989e12, "rates": {"bf16_flops_per_s":
                                                    989e12},
           "trace": {"window_s": 4.0}}
    assert read(ctx) == pytest.approx(25.0)
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, kind="grid")) is None


def test_prompt_lengths_fill_every_stratum():
    trf = {"prompt_len": "128-255"}
    for seed in (3, 2**31 + 5):
        lens = [lm.prompt_len(trf, seed, i) for i in range(lm.STRATA)]
        strata = sorted((n - 128) * lm.STRATA // 128 for n in lens)
        assert strata == list(range(lm.STRATA))
    assert lm.prompt_len({"prompt_len": 7}, 1, 0) == 7


CASES = [  # layers, kv heads, positions, reference block, tied
    (2, 2, 7, 512, False), (1, 4, 12, 5, False), (3, 1, 9, 4, True)]


@pytest.mark.parametrize("case", CASES)
def test_dense_reference_is_the_ports_forward(case):
    layers, kv, s, block, tied = case
    cfg = dataclasses.replace(
        get_reduced_config(ARCH), num_layers=layers, num_kv_heads=kv,
        tie_embeddings=tied, dtype="float32")
    weights = lm_program.make_weights(T.init_params(cfg, device="meta"),
                                      11 + layers, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, s),
                           generator=torch.Generator().manual_seed(s))
    want = T.forward(cfg, weights, T.Batch(tokens=tokens))
    spec = {"hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
            "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": kv, "num_hidden_layers": layers,
            "vocab_size": cfg.vocab_size, "rms_norm_eps": cfg.norm_eps,
            "rope_theta": cfg.rope_theta, "tie_word_embeddings": tied}
    got = dense.logits(spec, weights, tokens, 2, block=block)
    top = want[:, 2:].abs().max()
    assert (got - want[:, 2:]).abs().max() <= 1e-5 * top


def test_request_work_is_a_hand_count():
    spec = {"reference": "dense", "hidden_size": 8, "intermediate_size": 16,
            "num_attention_heads": 2, "num_key_value_heads": 1,
            "head_dim": 4, "num_hidden_layers": 1, "vocab_size": 10,
            "rms_norm_eps": 1e-6, "rope_theta": 1e4}
    # a token: q, k, v 2*8*(2+1+1)*4; o 2*(2*4)*8; FFN 3 * 2*8*16;
    # q.k and p.v 2 * 2*2*4 a position of context; the logits 2*8*10
    token = 2 * 8 * 4 * 4 + 2 * 8 * 8 + 3 * 2 * 8 * 16
    attn, head = 2 * 2 * 2 * 4, 2 * 8 * 10
    # prompt of 2 (contexts 1, 2; logits at the last), then 2 decode
    # steps (contexts 3, 4)
    want = 3 * (4 * token + (1 + 2 + 3 + 4) * attn + 3 * head)
    assert opcount.request_flops(spec, 3, 2, 3) == want
