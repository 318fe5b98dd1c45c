"""``chip_smoke.py``'s phase selection, rehearsed on the CPU: the
``--phases`` argument (names, order, unknown names refused before any
work), the dependency rule of the ``kernels`` line (a row needs the
phases it is measured in, a launch field its phase; what a run could
not fill is named under ``left_out``), and ``run``'s wiring with every
phase stood in by a stub that records its call."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402


def test_no_flag_selects_every_phase_in_order():
    assert CS.parse_phases([]) == CS.PHASES
    assert len(set(CS.PHASES)) == len(CS.PHASES) == 21
    assert "roofline" in CS.PHASES


def test_named_phases_run_in_the_scripts_order():
    assert CS.parse_phases(["--phases", "roofline"]) == ("roofline",)
    assert CS.parse_phases(["--phases", "mla, kernels,roofline"]) == (
        "kernels", "roofline", "mla")
    assert CS.parse_phases(["--phases", ",".join(reversed(CS.PHASES))]) \
        == CS.PHASES


@pytest.mark.parametrize("argv", [["--phases", "roofline,nope"],
                                  ["--phases", ""], ["--phases", ","],
                                  ["--bogus"]])
def test_unknown_phases_are_refused(argv, capsys):
    with pytest.raises(SystemExit) as e:
        CS.parse_phases(argv)
    assert e.value.code == 2
    if "nope" in argv[-1]:
        assert "unknown phase(s) nope" in capsys.readouterr().err


def test_the_script_refuses_an_unknown_phase_before_any_work(tmp_path):
    """Exit status 2 from the argument parser, before the CUDA check and
    the build (neither of which says anything here)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--phases", "stream,warp"], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert out.returncode == 2
    assert "unknown phase(s) warp" in out.stderr
    assert "no CUDA device" not in out.stderr and not out.stdout


def test_left_out_is_empty_for_the_default_run():
    assert CS.left_out(CS.PHASES) == {}


def test_left_out_names_rows_and_fields():
    only = CS.left_out(("roofline",))
    assert set(only["rows"]) == set("ABCDE")
    assert only["rows"]["A"] == ["kernels", "dense_engine", "stream"]
    assert only["rows"]["D"] == ["rmsnorm", "flash", "lm"]
    assert only["fields"] == {}
    no_service = CS.left_out(tuple(p for p in CS.PHASES if p != "service"))
    assert no_service["rows"] == {}
    assert no_service["fields"] == {"A": {"launches_service": "service"},
                                    "B": {"launches_service": "service"}}
    lm_only = CS.left_out(("rmsnorm", "flash", "lm"))
    assert set(lm_only["rows"]) == set("ABC")
    assert lm_only["fields"]["D"] == {
        f: CS.FIELD_PHASE[f] for f in CS.ROW_FIELDS["D"]}


def _stub_phases(monkeypatch):
    """Every phase of ``run`` (and the reports built from them) stood in
    by a stub that records its call and returns the shapes ``run``
    reads."""
    calls = []

    def rec(name, value):
        def stub(*a, **k):
            calls.append(name)
            return value() if callable(value) else value
        return stub

    counts = {"A": 1, "B": 2, "C": 3, "D": 4, "E": 5}
    paths = {k: {} for k in ("default", "synchronous", "plain",
                             "bitwise_plain")}
    for name, value in {
            "phase_kernels": {"A": 0.0, "B": 0.0},
            "phase_dense": None, "phase_dense_engine": {"dense": 1},
            "phase_stream": lambda: (None, counts, paths, [None, None]),
            "phase_stream_resilience": {"ok": 1},
            "phase_scenario": None,
            "phase_optimize": {"launches": counts},
            "phase_stream_devices": None,
            "phase_service": {"in_process": {"launches": counts}},
            "phase_rbe": 0.0, "phase_pipeline": (counts, {"ht": 1}),
            "phase_rmsnorm": 0.0, "phase_flash": 0.0,
            "kernel_report": lambda: ([{"name": "A"}, {"name": "B"}], {}),
            "rbe_report": lambda: ({"name": "C"}, {"rbe_shapes": 1}),
            "lm_kernel_report": lambda: (
                [{"name": "D", "kernel": "D"}, {"name": "E", "kernel": "E"}],
                {"flash_shapes": 1}),
            "phase_train": (counts, counts,
                            {"train": 1, "p_bf16": {"launches_p_bf16": 6}}),
            "phase_lm": (counts, {"lm": 1,
                                  "forward_p_bf16": {"launches_p_bf16": 7}}),
            "phase_roofline": {"roofline": 1},
            "phase_sharding": ({"plain": counts, "seq_parallel": counts},
                               {"kernels": {"D": {"ms": 1.0},
                                            "E": {"ms": 2.0}},
                                "runs": {"p_bf16": {
                                    "launches_p_bf16": 8}}}),
            "phase_stub": ({"qwen2-vl-2b": {"forward": counts}}, {"s": 1}),
            "phase_ssm": ({"xlstm-350m": {"forward": counts}}, {"s": 1}),
            "phase_moe": (counts, counts, {"m": 1}),
            "phase_mla": (counts, counts, {"m": 1})}.items():
        monkeypatch.setattr(CS, name, rec(name, value))
    monkeypatch.setattr(CS, "device_busy", lambda run: (run(), {"k": 1.0})[1])

    class _Res:
        stats = {"total_s": 2.0}

    from repro_torch.core import stream as ST
    monkeypatch.setattr(ST, "stream_grid", lambda **kw: _Res())
    return calls


def _run(monkeypatch, capsys, phases):
    calls = _stub_phases(monkeypatch)
    CS.run("cpu", {}, "card", None, phases=phases)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    return calls, lines


def test_the_default_run_calls_every_phase_and_fills_every_row(
        monkeypatch, capsys):
    calls, lines = _run(monkeypatch, capsys, CS.PHASES)
    assert [c for c in calls if c.startswith("phase_")] == [
        "phase_" + p for p in CS.PHASES]
    keys = [next(iter(line)) for line in lines]
    assert keys == ["host_ms_per_call", "stream", "stream_resilience",
                    "rbe_shapes", "handtracking", "flash_shapes", "lm",
                    "stub", "train", "ssm", "moe", "mla", "roofline",
                    "sharding", "kernels"]
    rows = lines[-1]["kernels"]
    assert "left_out" not in lines[-1]
    assert [r["name"] for r in rows] == list("ABCDE")
    assert rows[1]["launches_grid_argmin"] == 2
    assert rows[0]["launches_service"] == 1
    assert list(rows[3]) == ["name", "launches", "launches_train",
                             "launches_train_step", "launches_ssm",
                             "launches_moe", "launches_mla",
                             "launches_stub", "launches_sharding",
                             "sharding_shape"]
    assert rows[4]["launches_sharding"] == {"plain": 5, "seq_parallel": 5}
    assert rows[4]["sharding_shape"] == {"ms": 2.0}
    assert rows[4]["launches"] == 5
    assert rows[4]["launches_p_bf16"] == {
        "lm_forward": 7, "train_steps": 6, "sharding_steps": 8}
    assert rows[4]["launches_ssm"] == {"xlstm-350m": {"forward": 5}}
    assert rows[3]["launches_moe"] == {"forward": 4, "decode_step": 4}


def test_roofline_alone_runs_nothing_else(monkeypatch, capsys):
    calls, lines = _run(monkeypatch, capsys, ("roofline",))
    assert calls == ["phase_roofline"]
    assert [next(iter(line)) for line in lines] == ["roofline", "kernels"]
    assert lines[-1]["kernels"] == []
    assert lines[-1]["left_out"] == CS.left_out(("roofline",))


def test_a_row_is_reported_once_its_phases_ran(monkeypatch, capsys):
    calls, lines = _run(monkeypatch, capsys,
                        ("rmsnorm", "flash", "train", "lm"))
    assert calls == ["phase_rmsnorm", "phase_flash", "lm_kernel_report",
                     "phase_train", "phase_lm"]
    last = lines[-1]
    assert [r["name"] for r in last["kernels"]] == ["D", "E"]
    assert set(last["kernels"][0]) == {"name", "launches", "launches_train",
                                       "launches_train_step"}
    assert last["left_out"]["fields"]["D"] == {
        "launches_ssm": "ssm", "launches_moe": "moe", "launches_mla": "mla",
        "launches_stub": "stub", "launches_sharding": "sharding"}
