"""A configuration of kind ``lm``: the port's language model serving
requests (:mod:`portbench.lm_program`), held to a plain reference
(:mod:`portbench.reference.lm`) by :mod:`portbench.lm_check`.

The traffic file gives ``batch`` (sequences a request), ``prompt_len``
(a number, or ``"lo-hi"``), ``gen_len`` (tokens a sequence generates),
``check_requests``, ``trace_requests`` and optionally ``vocab_slice``
(prompt ids are drawn from the vocabulary's first ``vocab_slice``).  A
request's prompt length is drawn from the seed, one uniformly inside
each of ``STRATA`` equal strata of ``lo..hi`` in every ``STRATA``
requests, in an order drawn from the seed: every run serves the same
spread of lengths, and no two runs the same prompts.

Set-up builds the model and its weights from the seed and serves one
warm request of the longest prompt.  The window is a closed loop with
one client: a request is issued when the previous request's tokens are
on the host, until ``--seconds`` have passed (with ``--trace 1``, the
first ``trace_requests`` requests under the profiler).  Afterwards
``check_requests`` of the requests served, drawn from the seed while
they are served (a reservoir), and the one with the longest prompt are
run again through the reference by teacher forcing on the served tokens.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np

from . import cells

#: Strata of a prompt-length range.
STRATA = 8


def rng(seed: int, *key: int) -> np.random.Generator:
    """The generator of stream ``key`` of a run under ``seed``: (1, i)
    request i, (2, c) the order of cycle c's strata, (3,) the draw of
    the requests checked, (5,) the warm request."""
    return np.random.default_rng([int(seed) % 2**64, *key])


def length_range(trf: dict) -> tuple:
    spec = trf["prompt_len"]
    if isinstance(spec, int):
        return spec, spec
    lo, hi = (int(v) for v in str(spec).split("-"))
    return lo, hi


def prompt_len(trf: dict, seed: int, i: int) -> int:
    """The prompt length of request ``i``."""
    lo, hi = length_range(trf)
    cycle, slot = divmod(i, STRATA)
    stratum = rng(seed, 2, cycle).permutation(STRATA)[slot]
    u = rng(seed, 1, i).random()
    return min(hi, lo + int((stratum + u) * (hi - lo + 1) / STRATA))


def prompts(config: dict, trf: dict, g: np.random.Generator,
            length: int) -> np.ndarray:
    """(batch, length) prompt ids drawn from ``g``."""
    vocab = min(int(trf.get("vocab_slice", config["vocab_size"])),
                int(config["vocab_size"]))
    return g.integers(0, vocab, size=(int(trf["batch"]), length))


class Sample:
    """``k`` of the requests offered, drawn uniformly from the seed as
    they come (reservoir sampling), and the one with the longest prompt
    (the first of equals)."""

    def __init__(self, k: int, g: np.random.Generator):
        self.k, self.g = k, g
        self.slots: list = []
        self.longest = None
        self.seen = 0

    def offer(self, i: int, length: int, item) -> None:
        if len(self.slots) < self.k:
            self.slots.append((i, item))
        else:
            j = int(self.g.integers(0, self.seen + 1))
            if j < self.k:
                self.slots[j] = (i, item)
        self.seen += 1
        if self.longest is None or length > self.longest[1]:
            self.longest = (i, length, item)

    def chosen(self) -> dict:
        out = dict(self.slots)
        if self.longest is not None:
            out[self.longest[0]] = self.longest[2]
        return dict(sorted(out.items()))


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool,
        device, root, t_start: float, control: bool = False) -> dict:
    """One run of an ``lm`` cell; the result line's fields and the
    context its metrics read, as :func:`portbench.run.run` returns them.
    With ``control`` the check puts the reference at float8 in the
    program's place (:mod:`portbench.control`)."""
    import torch

    from . import lm_check, lm_program, tracing
    from .reference import lm as ref_lm
    from .reference.lm import opcount

    cfg, trf = cell.config, cell.traffic
    batch, gen = int(trf["batch"]), int(trf["gen_len"])
    _, hi = length_range(trf)
    prog = lm_program.Program(root, cfg, seed, device, hi + gen)
    on_card = torch.device(device).type == "cuda"

    def dev(a):
        return torch.as_tensor(a, device=device)

    prog.serve(dev(prompts(cfg, trf, rng(seed, 5), hi)), gen)
    setup_s = time.perf_counter() - t_start

    records: list = []
    window = (tracing.profiled(records) if trace
              else contextlib.nullcontext())
    served, failed, error = [], 0, None
    sample = Sample(int(trf["check_requests"]), rng(seed, 3))
    before = prog.launches()
    t0 = time.perf_counter()
    with window:
        while True:
            i = len(served)
            n = prompt_len(trf, seed, i)
            p = prompts(cfg, trf, rng(seed, 1, i), n)
            try:
                out = prog.serve(dev(p), gen)
                tokens = out["tokens"].cpu()
            except Exception as e:         # a request that raised failed
                failed, error = 1, f"{type(e).__name__}: {e}"
                break
            served.append({"prompt_len": n, "prefill_s": out["prefill_s"],
                           "decode_s": out["decode_s"]})
            sample.offer(i, n, (p, tokens, out["logits"]))
            del out
            if len(served) >= trf["trace_requests"] if trace else (
                    time.perf_counter() - t0 >= seconds):
                break
    window_s = time.perf_counter() - t0
    after = prog.launches()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    tr = None
    if trace and not failed:
        expect = {"graph replays": 0}
        expect.update((k, after[k] - before[k]) for k in after)
        tr = tracing.read(records, expect)
        window_s = tr["window_s"]
    weights = prog.weights
    del prog, records
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    ref = ref_lm.module(cfg["reference"])
    readings, checked = [], []
    for i, (p, tokens, rows) in sample.chosen().items():
        seq = dev(np.concatenate([p, tokens[:, :-1].numpy()], axis=1))
        want = ref.logits(cfg, weights, seq, p.shape[1] - 1)
        if control:
            got = ref.logits(cfg, weights, seq, p.shape[1] - 1, low=True)
            tokens = got.argmax(dim=-1)
        else:
            got = torch.cat(rows, dim=1)
        readings.append(lm_check.numbers(got, want, tokens))
        checked.append(i)
        del got, want
    check_s = time.perf_counter() - t_check
    found = (lm_check.worst(readings) if readings
             else dict.fromkeys(lm_check.NAMES, float("inf")))
    limits = cfg["limits"]
    correct = (not failed and bool(readings)
               and lm_check.verdict(found, limits))
    flops = sum(opcount.request_flops(cfg, batch, r["prompt_len"], gen)
                for r in served)
    ctx = {"kind": "lm", "config": cfg, "traffic": trf, "rates": cell.rates,
           "setup_s": setup_s, "window_s": window_s, "requests": served,
           "batch": batch, "gen_len": gen, "flops": flops, "trace": tr}
    entries = cell.per_layer if trace else cell.end_to_end
    return {"correct": correct, "attempted": len(served) + failed,
            "failed": failed, "metrics": cells.read_metrics(entries, ctx,
                                                            root),
            "checks": {k: {"value": found[k], "limit": limits[k]}
                       for k in lm_check.NAMES},
            "memory_peak_bytes": int(peak), "trace": tr, "error": error,
            "check_s": check_s, "checked": checked, "readings": readings,
            "requests": served}


def log(out: dict) -> list:
    """Standard error's lines on an LM run: each request's prompt and
    seconds, the trace's counts and the requests checked."""
    lines = [f"portbench: request {i}: prompt {r['prompt_len']}, prefill "
             f"{r['prefill_s']:.4f} s, decode {r['decode_s']:.4f} s"
             for i, r in enumerate(out["requests"])]
    if out["trace"] is not None:
        lines.append(f"portbench: trace counts {out['trace']['counts']}")
    lines.append(f"portbench: checked requests {out['checked']} in "
                 f"{out['check_s']:.3f} s; readings {out['readings']}")
    return lines
