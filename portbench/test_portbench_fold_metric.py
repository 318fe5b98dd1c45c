"""The reader of ``fold_us_per_chunk.grid`` on synthetic contexts: the
graph's device time less kernel A's over the chunks the traced sweeps'
replays folded, and nothing where there is no grid trace to read."""

import json

import pytest

from portbench import cells

NAME = "fold_us_per_chunk.grid"


def _ctx(kind="grid", trace=True, a_s=0.03):
    tr = {"graph_s": 0.05, "a_s": a_s} if trace else None
    return {"kind": kind, "trace": tr,
            "sweeps": [{"stats": {"graph_replays": 96.0}, "scan": 8}] * 3}


def test_reads_the_fold_share_of_the_graph_a_chunk():
    v = cells.reader(NAME)(_ctx())
    assert v == pytest.approx(1e6 * 0.02 / (3 * 96 * 8))


@pytest.mark.parametrize("ctx", [_ctx(kind="sessions"), _ctx(trace=False),
                                 _ctx(a_s=0.0)],
                         ids=["sessions", "untraced", "no_kernel_a"])
def test_reads_nothing_without_a_grid_trace_of_kernel_a(ctx):
    assert cells.reader(NAME)(ctx) is None


def test_its_entry_names_the_argmin_cell():
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    (m,) = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert m["workloads"] == ["grid-1e8.argmin"]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "us", "lower", "device_trace", "configs_per_s")
