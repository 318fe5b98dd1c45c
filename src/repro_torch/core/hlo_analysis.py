"""Static analysis of lowered/compiled XLA HLO text (the port's own copy
of the reference package's ``core/hlo_analysis.py``, unchanged but for
this note).

The reference consumes a compiled program's ``cost_analysis()`` plus a
textual parse of its HLO for collective operations, as the paper's
GVSoC step extracts #MAC_j and #(Read/Write).  The port keeps the parse,
so that it reads the same HLO text to the same results, and adds the
counterpart for a torch program in :mod:`.hlo_cost`
(``analyze_program``), which issues :class:`CollectiveOp` records with
the same opcode names and ring formulas.

For every ``all-gather`` / ``all-reduce`` / ``reduce-scatter`` /
``all-to-all`` / ``collective-permute`` op we record the participating-group
size (from ``replica_groups``) and both:

* ``payload_bytes`` — the sum of operand sizes (the deliverable's metric), and
* ``wire_bytes``    — per-device bytes actually serialized on links under a
  ring algorithm (all-reduce 2(n-1)/n, all-gather/reduce-scatter (n-1)/n,
  all-to-all (n-1)/n, collective-permute 1x), used by the energy model.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Iterable

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "f8e4m3": 1, "f8e3m4": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# one shape token, e.g. ``bf16[256,4096]{1,0}`` or ``f32[]``
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\](?:\{[^}]*\})?")
# an HLO instruction line:  %name = <shapes> opcode(
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w\.\-]+\s*=\s*(\(?[^)=]*?\)?)\s*"
    r"([\w\-]+)(?:-start|-done)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([\d,\s]*)\}")
# e.g. replica_groups=[16,32]<=[512] — iota tile format: groups of size 32
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        ids = [x for x in m.group(1).split(",") if x.strip()]
        return max(1, len(ids))
    return 1


@dataclasses.dataclass
class CollectiveOp:
    opcode: str
    payload_bytes: int   # sum of operand/result sizes
    group_size: int

    @property
    def wire_bytes(self) -> float:
        n = max(self.group_size, 1)
        if n == 1:
            return 0.0
        ring = (n - 1) / n
        if self.opcode == "all-reduce":
            return 2.0 * ring * self.payload_bytes
        if self.opcode in ("all-gather", "reduce-scatter", "all-to-all"):
            return ring * self.payload_bytes
        if self.opcode == "collective-permute":
            return float(self.payload_bytes)
        return float(self.payload_bytes)


@dataclasses.dataclass
class CollectiveSummary:
    ops: list[CollectiveOp]

    @property
    def total_payload_bytes(self) -> int:
        return sum(o.payload_bytes for o in self.ops)

    @property
    def total_wire_bytes(self) -> float:
        return sum(o.wire_bytes for o in self.ops)

    def by_opcode(self) -> dict[str, dict[str, float]]:
        agg: dict[str, dict[str, float]] = defaultdict(
            lambda: {"count": 0, "payload_bytes": 0, "wire_bytes": 0.0})
        for o in self.ops:
            a = agg[o.opcode]
            a["count"] += 1
            a["payload_bytes"] += o.payload_bytes
            a["wire_bytes"] += o.wire_bytes
        return dict(agg)

    def by_group_size(self) -> dict[int, float]:
        """wire bytes keyed by participating-group size.

        Group size is how we tell mesh tiers apart: on the (pod, data, model)
        mesh, collectives whose groups span the ``pod`` axis have group sizes
        that are multiples spanning pods — the DOSC 'MIPI-tier' traffic.
        """
        agg: dict[int, float] = defaultdict(float)
        for o in self.ops:
            agg[o.group_size] += o.wire_bytes
        return dict(agg)


def parse_collectives(hlo_text: str) -> CollectiveSummary:
    """Extract every collective op from HLO text (lowered or compiled)."""
    ops: list[CollectiveOp] = []
    seen_started: set[str] = set()
    for line in hlo_text.splitlines():
        m = _INSTR_RE.match(line)
        if not m:
            continue
        shapes_text, opcode = m.groups()
        base = opcode
        if base.endswith("-start"):
            base = base[: -len("-start")]
        if base not in COLLECTIVE_OPS:
            continue
        # async pairs appear as op-start/op-done: count the -start only;
        # plain (sync) ops have no suffix and are counted directly.
        if "-done(" in line:
            continue
        payload = _shape_bytes(shapes_text)
        # -start ops carry (operand, result) tuples; take result size once.
        if "-start(" in line and payload:
            payload //= 2 if base != "all-gather" else 1
        ops.append(CollectiveOp(base, payload, _group_size(line)))
    return CollectiveSummary(ops)


def count_op(hlo_text: str, opcode: str) -> int:
    """Count occurrences of an HLO opcode (e.g. 'fusion', 'convolution')."""
    pat = re.compile(rf"=\s*[^=]*?\b{re.escape(opcode)}(?:\.\d+)?\(")
    return sum(1 for line in hlo_text.splitlines() if pat.search(line))
