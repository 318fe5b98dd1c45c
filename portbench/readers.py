"""What the metric readers of ``portbench/metrics/`` share: the window's
sums and the frozen work over the trace."""

from __future__ import annotations


def percent_of_window(ctx: dict, kind: str, value) -> float | None:
    """``100 * value(sweep)`` summed over the window's sweeps, over the
    window's seconds, in a cell of configuration kind ``kind``."""
    if ctx["kind"] != kind or not ctx["sweeps"]:
        return None
    return 100.0 * sum(value(s) for s in ctx["sweeps"]) / ctx["window_s"]


def rate(ctx: dict, kind: str) -> float | None:
    """Points (configurations, or pairs) of every sweep of the window
    over its seconds."""
    if ctx["kind"] != kind or not ctx["sweeps"]:
        return None
    return sum(s["n_total"] for s in ctx["sweeps"]) / ctx["window_s"]


def bound_s(ctx: dict) -> float | None:
    """The seconds the frozen float64 operations of the window's sweeps
    take at the card's float64 peak (their bytes are kilobytes of tables
    and the reductions' results: the operations bound them)."""
    if ctx["ops_per_sweep"] is None:
        return None
    return (ctx["ops_per_sweep"] * len(ctx["sweeps"])
            / ctx["rates"]["fp64_flops_per_s"])


def traced(ctx: dict, kind: str) -> dict | None:
    """The trace's reading, in a traced run of a cell of kind ``kind``."""
    return ctx["trace"] if ctx["kind"] == kind else None
