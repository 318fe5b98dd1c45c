"""Assigned input shapes and the per-(arch x shape) applicability matrix.

Four shapes per architecture:
    train_4k     seq_len=4096    global_batch=256   (training)
    prefill_32k  seq_len=32768   global_batch=32    (inference prefill)
    decode_32k   seq_len=32768   global_batch=128   (one-token decode
                                                     against a 32k cache)
    long_500k    seq_len=524288  global_batch=1     (long-context decode)

``decode_*``/``long_*`` lower ``serve_step`` (one new token with a KV cache
of seq_len), not ``train_step``.  ``long_500k`` requires sub-quadratic
attention: it runs on the SSM/hybrid archs only (skips recorded here and in
DESIGN.md / EXPERIMENTS.md).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

# long_500k runs only on sub-quadratic (SSM / hybrid) stacks.
LONG_CONTEXT_ARCHS = {"xlstm-350m", "jamba-v0.1-52b"}

SKIP_REASONS = {
    "long_500k": ("pure full-attention stack: 500k-token cell requires "
                  "sub-quadratic attention (see DESIGN.md §4)"),
}


def cell_is_runnable(arch_id: str, shape_name: str) -> tuple[bool, str]:
    """(runnable?, reason-if-skipped) for one (arch x shape) cell."""
    if shape_name == "long_500k" and arch_id not in LONG_CONTEXT_ARCHS:
        return False, SKIP_REASONS["long_500k"]
    return True, ""


def all_cells() -> list[tuple[str, str]]:
    from .registry import ARCH_IDS
    return [(a, s) for a in ARCH_IDS for s in SHAPES]
