"""The traced window: torch.profiler (CUPTI) around a few sweeps, read
from the trace's raw records.

The trace opens with a warm-up step whose records are dropped and a
sleep kernel that the host waits out, since the records nearest a
trace's start were lost on some machines.  The harness marks the window
and each sweep's calls with ``record_function`` ranges (``portbench.*``);
their device mirrors are no device work.  :func:`read` checks the trace
against the program's own counts (graph replays, and the launches of
the kernels that the configuration's kind runs: A and B for a sweep, D
and E for an LM) and refuses a trace that lost records.
"""

from __future__ import annotations

import bisect
import contextlib

WINDOW = "portbench.window"
_MIRRORS = ("portbench.", "ProfilerStep")
KERNEL_A = "chunk_kernel"
KERNEL_B = "eval_kernel"
#: The kernels whose device records :func:`read` counts, by the label
#: the caller's ``expect`` gives them: a substring of the record's name.
KERNELS = {"A": KERNEL_A, "B": KERNEL_B, "D": "rmsnorm_kernel",
           "E": "flash_fwd_kernel"}
GRAPH_LAUNCH = "cudaGraphLaunch"


class TraceIncomplete(RuntimeError):
    """The trace's counts disagree with the program's: records were
    lost, and no trace metric may be read from it."""


def sleep_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` a millisecond on this card."""
    import torch
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    torch.cuda._sleep(10**8)
    ev[1].record()
    ev[1].synchronize()
    return 1e8 / ev[0].elapsed_time(ev[1])


@contextlib.contextmanager
def profiled(records: list):
    """Profile the body; on exit ``records`` holds the active step's raw
    records as tuples ``(name, on_device, correlation, start_ns, end_ns)``.
    The body runs inside the :data:`WINDOW` range, after a 5 ms sleep
    kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    def keep(p):
        for ev in p.profiler.kineto_results.events():
            start = ev.start_ns()
            records.append((ev.name(), ev.device_type() == DeviceType.CUDA,
                            ev.correlation_id(), start,
                            start + ev.duration_ns()))

    spacer = int(5.0 * sleep_cycles_per_ms())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=keep) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        torch.cuda._sleep(spacer)
        torch.cuda.synchronize()
        with record_function(WINDOW):
            yield
            torch.cuda.synchronize()
        prof.step()


def span(name: str):
    """A host range in the trace (``torch.profiler.record_function``)."""
    from torch.profiler import record_function
    return record_function(name)


def _union(intervals) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(records: list, expect: dict) -> dict:
    """Device busy time, kernel times and idle gaps inside the window.

    ``expect`` holds the program's own counts over the window: ``graph
    replays``, and the launches of each kernel of :data:`KERNELS` that
    the run counts (``A`` and ``B`` on a kernel sweep, ``D`` and ``E`` on
    an LM).  The trace's cudaGraphLaunch calls must equal the replays,
    and every replay must show the same number of kernels (a replay of
    one graph runs the same kernels); each kernel's records must equal
    its launches."""
    win = [r for r in records if not r[1] and r[0] == WINDOW]
    if len(win) != 1:
        raise TraceIncomplete(f"{len(win)} window ranges in the trace")
    ws, we = win[0][3], win[0][4]
    host, device, launches = [], [], {}
    for name, on_dev, corr, s, e in records:
        if on_dev:
            if not name.startswith(_MIRRORS) and e > ws and s < we:
                device.append((name, corr, max(s, ws), min(e, we)))
        elif ws <= s <= we:
            host.append((s, e, name))
            if name.startswith(GRAPH_LAUNCH):
                launches[corr] = launches.get(corr, 0)
    if not device:
        raise TraceIncomplete("no device records in the window")
    per_launch = dict.fromkeys(launches, 0)
    by_name: dict = {}
    graph_s = 0.0
    for name, corr, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
        if corr in per_launch:
            per_launch[corr] += 1
            graph_s += (e - s) / 1e9
    found = {"graph replays": len(launches),
             "kernels a replay": sorted(set(per_launch.values()))}
    want = {"graph replays": expect["graph replays"],
            "kernels a replay": found["kernels a replay"][:1]}
    for label, n in expect.items():
        if label in KERNELS:
            found[label] = sum(1 for d in device if KERNELS[label] in d[0])
            want[label] = n
    if found != want or 0 in found["kernels a replay"]:
        raise TraceIncomplete(f"trace {found} != program {want}")
    busy = _union((s, e) for _, _, s, e in device)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps, last = [], ws
    for s, e in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if we > last:
        gaps.append((last, we))
    return {"window_s": (we - ws) / 1e9, "busy_s": busy_s,
            "kernel_s": by_name, "graph_s": graph_s,
            "a_s": sum(t for n, t in by_name.items() if KERNEL_A in n),
            "idle_by_host": _idle_by_host(gaps, host), "counts": found}


def _idle_by_host(gaps, host) -> dict:
    """Idle seconds of the device by what the host was doing: the
    innermost host record (the latest to start) that covers a gap's
    middle, among the nearest few thousand; else the harness's range
    that covers it."""
    host.sort()
    starts = [h[0] for h in host]
    spans = [h for h in host if h[2].startswith("portbench.")]
    out: dict = {}
    for s, e in gaps:
        mid = (s + e) // 2
        label = next((h[2] for h in reversed(spans)
                      if h[0] <= mid <= h[1]), WINDOW)
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 4096), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        out[label] = out.get(label, 0.0) + (e - s) / 1e9
    return out


def breakdown(tr: dict) -> dict:
    """The ten device operations that took most time and the ten largest
    idle shares by host activity, as the result line carries them."""
    def top(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(tr["kernel_s"]),
            "idle_gaps": top(tr["idle_by_host"])}
