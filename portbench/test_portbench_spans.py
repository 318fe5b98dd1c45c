"""The readers of the program's spans and counters: each reads a small
cell's sweeps on the CPU as a share in [0, 100], and reads nothing, with
no error, from sweeps whose program kept none of them."""

import copy
import json

import pytest

from portbench import cells, run, small

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NEW = ("probe_share.sessions", "device_wait_share.grid",
       "device_wait_share.sessions", "prefilter_pass_share.grid")
#: The keys the readers above read that a program before them lacked.
NEW_KEYS = ("probe_s", "survivors")


def _ctx(name):
    cell = small.small_cell(name)
    out = run.run(cell, 2**31 + 11, 0.0, False, device="cpu")
    assert out["correct"]
    sweeps = out["sweeps"]
    # A window no longer than the sweeps' own times: every share of it
    # still reads at most 100 %.
    window = sum(s["stats"]["total_s"] + s["plan_s"] for s in sweeps)
    ctx = {"kind": cell.config["kind"], "sweeps": sweeps,
           "window_s": window}
    entries = [m for m in BENCH["per_layer"]
               if m["name"] in NEW and name in m["workloads"]]
    return ctx, entries


@pytest.mark.parametrize("name", ["grid-1e8.argmin", "sessions-1m.long"])
def test_new_readers_read_a_small_cell(name):
    ctx, entries = _ctx(name)
    got = cells.read_metrics(entries, ctx)
    assert set(got) == {m["name"] for m in entries} and len(got) == 2
    for m, v in got.items():
        assert 0.0 <= v["value"] <= 100.0, m
        assert v["unit"] == "%"
    if ctx["kind"] == "sessions":
        assert got["probe_share.sessions"]["value"] > 0.0
    else:
        assert 0.0 < got["prefilter_pass_share.grid"]["value"] < 100.0
    # the parent's program: no probe time, no survivors counted
    old = copy.deepcopy(ctx)
    for s in old["sweeps"]:
        for k in NEW_KEYS:
            del s["stats"][k]
    left = cells.read_metrics(entries, old)
    assert set(left) == {m["name"] for m in entries
                         if m["name"].startswith("device_wait_share")}
