"""Trip-count-aware static cost analysis over compiled (post-SPMD) HLO
text, and its counterpart for a torch program.

The text analysis (:func:`analyze`, :class:`HLOCost`,
:func:`top_bytes_breakdown`) is the port's own copy of the reference
package's ``core/hlo_cost.py``, unchanged: on the same HLO text it
gives the reference's results field for field.
:func:`analyze_program` counts a torch program the same way, from the
aten operations it dispatches (see its docstring); with
``vmem_credit=True`` it is ``analyze``'s ``vmem_credit_depth=2`` over
the loops marked by :func:`.loop_marks.fused_loop`.

``compiled.cost_analysis()`` counts each computation ONCE — a program whose
layers live inside a ``lax.scan`` (a ``while`` op) reports one layer's
FLOPs.  This module re-derives per-step counts honestly:

* computations are parsed from the HLO text;
* a call-graph walk assigns each computation a **multiplicity** — while
  bodies multiply by the loop's ``known_trip_count`` (XLA records it in
  ``backend_config``), fusions/calls inherit the caller's multiplicity;
* per-instruction costs:
    - ``dot``:  2 x out_elems x prod(contracting dims)   (from real shapes)
    - ``convolution``: 2 x out_elems x window x chan/group
    - arithmetic elementwise: out_elems
    - bytes: operands + outputs for memory-moving ops; fusion internals are
      charged at the fusion's call-site I/O (what a fused kernel reads and
      writes);
* collectives are returned as a :class:`CollectiveSummary` with payloads
  scaled by multiplicity — fixing the same undercount for comm bytes.

This is the TPU analogue of the paper's GVSoC step: a static,
whole-program extraction of #ops / #bytes / #link-bytes that the
semi-analytical layer then turns into roofline terms and energy.
"""

from __future__ import annotations

import dataclasses
import re
import sys
import weakref
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _credit

from . import loop_marks
from .hlo_analysis import (COLLECTIVE_OPS, CollectiveOp, CollectiveSummary,
                           _DTYPE_BYTES, _GROUPS_IOTA_RE, _GROUPS_RE,
                           _SHAPE_RE)

# ---------------------------------------------------------------------------
# text parsing
# ---------------------------------------------------------------------------

_COMP_HDR = re.compile(r"^(ENTRY\s+)?%?([\w\.\-]+)\s+\((.*)\)\s+->")
_INSTR = re.compile(
    r"^\s+(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*"
    r"(\([^)]*\)|\S+)\s+"      # tuple shape (single-level) or tensor shape
    r"([\w\-]+)\(")
_TRIP = re.compile(r'known_trip_count\\?":\{\\?"n\\?":\\?"(\d+)')
_DOT_CONTRACT = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_WINDOW = re.compile(r"window=\{[^}]*size=([\dx]+)")
_FGC = re.compile(r"feature_group_count=(\d+)")
_CALLS = re.compile(r"calls=%?([\w\.\-]+)")
_BODY = re.compile(r"body=%?([\w\.\-]+)")
_COND = re.compile(r"condition=%?([\w\.\-]+)")
_TO_APPLY = re.compile(r"to_apply=%?([\w\.\-]+)")

_ARITH_OPS = frozenset((
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "power",
    "exponential", "tanh", "log", "rsqrt", "sqrt", "negate", "abs",
    "compare", "select", "and", "or", "xor", "floor", "ceil", "sign",
    "exponential-minus-one", "log-plus-one", "atan2", "clamp", "convert",
    "cosine", "sine", "reduce", "reduce-window",
))

_BYTE_OPS = frozenset((
    "dot", "convolution", "copy", "transpose", "reshape", "reduce",
    "broadcast", "dynamic-slice", "dynamic-update-slice", "scatter",
    "gather", "concatenate", "pad", "sort", "convert", "slice", "iota",
    "reduce-window", "select-and-scatter", "rng", "cholesky",
    "triangular-solve",
)) | set(COLLECTIVE_OPS) | {f"{c}-start" for c in COLLECTIVE_OPS}

_SKIP_OPS = frozenset((
    "parameter", "constant", "tuple", "get-tuple-element", "bitcast",
    "after-all", "partition-id", "replica-id", "tuple-select",
    "get-dimension-size", "custom-call", "while", "call", "conditional",
    "fusion", "opt-barrier",
))


def _shape_elems_bytes(shape_text: str) -> Tuple[int, int]:
    """(elements, bytes) across all shape tokens in ``shape_text``."""
    elems = total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        elems += n
        total += n * _DTYPE_BYTES[dtype]
    return elems, total


@dataclasses.dataclass
class _Instr:
    name: str
    out_shape: str
    opcode: str
    line: str
    operands: Tuple[str, ...]


@dataclasses.dataclass
class _Comp:
    name: str
    is_entry: bool
    instrs: List[_Instr]


_OPERANDS_RE = re.compile(r"%([\w\.\-]+)")


def _parse_computations(text: str) -> Tuple[Dict[str, _Comp], str,
                                            Dict[str, str]]:
    comps: Dict[str, _Comp] = {}
    shapes: Dict[str, str] = {}
    entry = ""
    cur: Optional[_Comp] = None
    for line in text.splitlines():
        if not line.startswith(" "):
            m = _COMP_HDR.match(line)
            if m:
                cur = _Comp(name=m.group(2), is_entry=bool(m.group(1)),
                            instrs=[])
                comps[cur.name] = cur
                if cur.is_entry:
                    entry = cur.name
                # record parameter shapes: "pname: shape, pname2: shape"
                for pm in re.finditer(r"([\w\.\-]+):\s*((?:\([^)]*\)|"
                                      r"[\w\[\]\{\},]+))", m.group(3) or ""):
                    shapes[pm.group(1)] = pm.group(2)
            elif line.startswith("}"):
                cur = None
            continue
        if cur is None:
            continue
        mi = _INSTR.match(line)
        if not mi:
            continue
        name, out_shape, opcode = mi.group(1), mi.group(2), mi.group(3)
        # operand names: everything inside the first (...) after opcode
        rest = line[mi.end():]
        depth, i = 1, 0
        while i < len(rest) and depth:
            if rest[i] == "(":
                depth += 1
            elif rest[i] == ")":
                depth -= 1
            i += 1
        ops = tuple(_OPERANDS_RE.findall(rest[:i]))
        instr = _Instr(name, out_shape.strip(), opcode, line, ops)
        cur.instrs.append(instr)
        shapes[name] = out_shape.strip()
    return comps, entry, shapes


# ---------------------------------------------------------------------------
# cost walk
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HLOCost:
    flops: float = 0.0
    bytes: float = 0.0
    collectives: CollectiveSummary = dataclasses.field(
        default_factory=lambda: CollectiveSummary([]))
    flops_by_op: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    bytes_by_op: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    unrolled_whiles: int = 0
    unknown_trip_whiles: int = 0


def _dot_flops(instr: _Instr, shapes: Dict[str, str]) -> float:
    out_elems, _ = _shape_elems_bytes(instr.out_shape)
    m = _DOT_CONTRACT.search(instr.line)
    contract = 1
    if m and instr.operands:
        lhs_shape = shapes.get(instr.operands[0], "")
        sm = _SHAPE_RE.search(lhs_shape)
        if sm and sm.group(2):
            dims = [int(d) for d in sm.group(2).split(",")]
            for idx_s in m.group(1).split(","):
                if idx_s.strip():
                    idx = int(idx_s)
                    if idx < len(dims):
                        contract *= dims[idx]
    return 2.0 * out_elems * contract


def _conv_flops(instr: _Instr, shapes: Dict[str, str]) -> float:
    out_elems, _ = _shape_elems_bytes(instr.out_shape)
    window = 1
    m = _WINDOW.search(instr.line)
    if m:
        for w in m.group(1).split("x"):
            window *= int(w)
    # channels per group: lhs feature dim / feature_group_count (depthwise
    # convs — the only ones in this codebase — give 1)
    return 2.0 * out_elems * window


def _group_size_from_line(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        ids = [x for x in m.group(1).split(",") if x.strip()]
        return max(1, len(ids))
    return 1


def _fusion_io_bytes(comp: _Comp, operands: Tuple[str, ...],
                     out_shape: str, shapes: Dict[str, str]) -> float:
    """Slice-aware I/O bytes for one fusion call site.

    A fusion parameter consumed only by ``dynamic-slice`` is charged at the
    slice size (the scan-over-stacked-params pattern would otherwise charge
    the full stacked tensor once per iteration); a fusion whose root is a
    ``dynamic-update-slice`` is charged at the update size (in-place
    accumulation into a scan carry).
    """
    # param index -> instr name, and slice charges
    param_names: Dict[int, str] = {}
    by_name: Dict[str, _Instr] = {}
    used_by: Dict[str, List[_Instr]] = defaultdict(list)
    root: Optional[_Instr] = None
    for ins in comp.instrs:
        by_name[ins.name] = ins
        if ins.opcode == "parameter":
            m = re.search(r"parameter\((\d+)\)", ins.line)
            if m:
                param_names[int(m.group(1))] = ins.name
        for o in ins.operands:
            used_by[o].append(ins)
        if "ROOT" in ins.line:
            root = ins
    # walk through bitcast/copy chains to the real root producer
    seen = 0
    while root is not None and root.opcode in ("bitcast", "copy", "tuple") \
            and root.operands and seen < 8:
        root = by_name.get(root.operands[0], root)
        seen += 1
        if root.opcode not in ("bitcast", "copy", "tuple"):
            break
    total = 0.0
    for idx, opnd in enumerate(operands):
        pname = param_names.get(idx)
        users = used_by.get(pname, []) if pname else []
        if users and all(u.opcode in ("dynamic-slice", "gather")
                         for u in users):
            total += sum(_shape_elems_bytes(u.out_shape)[1] for u in users)
        else:
            total += _shape_elems_bytes(shapes.get(opnd, ""))[1]
    if root is not None and root.opcode == "dynamic-update-slice" \
            and len(root.operands) >= 2:
        # charge the update tensor, not the full buffer
        upd = root.operands[1]
        total += _shape_elems_bytes(shapes.get(upd, ""))[1]
    else:
        total += _shape_elems_bytes(out_shape)[1]
    return total


def analyze(text: str, vmem_credit_depth: Optional[int] = None) -> HLOCost:
    """Static cost walk.

    ``vmem_credit_depth``: if set (e.g. 2), instructions nested inside
    >= that many ``while`` levels are assumed to execute inside a fused
    TPU kernel whose intermediates live in VMEM: their HBM byte charges
    are dropped EXCEPT block loads/stores (dynamic-slice /
    dynamic-update-slice / gather) and collectives.  FLOPs are always
    charged in full.  In this codebase depth >= 2 is exactly the inner
    loop of blockwise attention / mLSTM / the Mamba scan — the bodies the
    Pallas kernels fuse — so this mode prices the kernel-deployed program
    (§Perf 'pallas-credit' rows).
    """
    comps, entry, shapes = _parse_computations(text)
    cost = HLOCost()
    if not entry:
        return cost
    coll_ops: List[CollectiveOp] = []
    _SLICE_OPS = ("dynamic-slice", "dynamic-update-slice", "gather")

    # multiplicity-aware walk; fusion bodies contribute flops only
    def walk(comp_name: str, mult: float, in_fusion: bool,
             depth: int = 0):
        comp = comps.get(comp_name)
        if comp is None:
            return
        credited = (vmem_credit_depth is not None
                    and depth >= vmem_credit_depth)
        for ins in comp.instrs:
            op = ins.opcode
            base = op[:-6] if op.endswith("-start") else op
            if base in COLLECTIVE_OPS:
                if op.endswith("-done") or "-done(" in ins.line:
                    continue
                _, payload = _shape_elems_bytes(ins.out_shape)
                if op.endswith("-start") and payload:
                    payload //= 2 if base != "all-gather" else 1
                g = _group_size_from_line(ins.line)
                coll_ops.append(CollectiveOp(base, int(payload * mult), g))
                _, b = _shape_elems_bytes(ins.out_shape)
                cost.bytes += b * mult
                cost.bytes_by_op[base] += b * mult
                continue
            if op == "while":
                tm = _TRIP.search(ins.line)
                trips = int(tm.group(1)) if tm else 1
                if not tm:
                    cost.unknown_trip_whiles += 1
                cost.unrolled_whiles += 1
                bm = _BODY.search(ins.line)
                cm = _COND.search(ins.line)
                if bm:
                    walk(bm.group(1), mult * trips, in_fusion, depth + 1)
                if cm:
                    walk(cm.group(1), mult * trips, in_fusion, depth + 1)
                continue
            if op == "fusion":
                cm = _CALLS.search(ins.line)
                body = comps.get(cm.group(1)) if cm else None
                if cm:
                    walk(cm.group(1), mult, True, depth)
                if credited:
                    # VMEM-resident fused body: charge only block I/O
                    if body is not None:
                        io = 0.0
                        for bins in body.instrs:
                            if bins.opcode in _SLICE_OPS:
                                io += _shape_elems_bytes(bins.out_shape)[1]
                            if bins.opcode == "dynamic-update-slice" and \
                                    len(bins.operands) > 1:
                                io += _shape_elems_bytes(
                                    shapes.get(bins.operands[1], ""))[1]
                        cost.bytes += io * mult
                        cost.bytes_by_op["vmem-block-io"] += io * mult
                    continue
                if not in_fusion:
                    if body is not None:
                        io = _fusion_io_bytes(body, ins.operands,
                                              ins.out_shape, shapes)
                    else:
                        _, ob = _shape_elems_bytes(ins.out_shape)
                        io = ob + sum(
                            _shape_elems_bytes(shapes.get(o, ""))[1]
                            for o in ins.operands)
                    cost.bytes += io * mult
                    cost.bytes_by_op["fusion"] += io * mult
                continue
            if op in ("call", "conditional", "async-start"):
                cm = _CALLS.search(ins.line) or _TO_APPLY.search(ins.line)
                if cm:
                    walk(cm.group(1), mult, in_fusion, depth)
                continue
            # ---- flops ----
            if op == "dot":
                f = _dot_flops(ins, shapes) * mult
                cost.flops += f
                cost.flops_by_op["dot"] += f
            elif op == "convolution":
                f = _conv_flops(ins, shapes) * mult
                cost.flops += f
                cost.flops_by_op["convolution"] += f
            elif op in _ARITH_OPS:
                elems, _ = _shape_elems_bytes(ins.out_shape)
                cost.flops += elems * mult
                cost.flops_by_op["elementwise"] += elems * mult
            # ---- bytes (top level only; fusion internals via call site) --
            if credited and op not in _SLICE_OPS:
                continue
            if not in_fusion and op in _BYTE_OPS and op not in _SKIP_OPS:
                _, ob = _shape_elems_bytes(ins.out_shape)
                if op == "dynamic-slice":
                    io = 2.0 * ob            # read slice + write out
                elif op == "dynamic-update-slice":
                    ub = _shape_elems_bytes(
                        shapes.get(ins.operands[1], "")
                    )[1] if len(ins.operands) > 1 else ob
                    io = 2.0 * ub            # read update + write window
                else:
                    ib = 0.0
                    for o in ins.operands:
                        _, b = _shape_elems_bytes(shapes.get(o, ""))
                        ib += b
                    io = ib + ob
                cost.bytes += io * mult
                cost.bytes_by_op[op] += io * mult

    walk(entry, 1.0, False)
    cost.collectives = CollectiveSummary(coll_ops)
    return cost


def top_bytes_breakdown(cost: HLOCost, n: int = 6) -> dict:
    items = sorted(cost.bytes_by_op.items(), key=lambda kv: -kv[1])[:n]
    return {k: v for k, v in items}


# ---------------------------------------------------------------------------
# the counterpart for a torch program
# ---------------------------------------------------------------------------

#: Inside a mark, with the credit on, the aten operations that load a
#: block (their outputs are charged) and those that store one (the
#: argument at the index given, the update, is charged); ``copy_``
#: stores only into a view (``x[i] = y``).
BLOCK_LOADS = frozenset((
    "select", "slice", "narrow", "unbind", "split", "split_with_sizes",
    "index_select", "gather", "index",
))
BLOCK_STORES = {"copy_": 1, "index_put_": 2, "index_put": 2,
                "_index_put_impl_": 2, "slice_scatter": 1,
                "select_scatter": 1}

#: aten operations (in-place forms too) that count one flop an output
#: element, each beside the HLO opcode of the reference's ``_ARITH_OPS``
#: it stands for.  ``_to_copy`` counts only where it changes the dtype
#: (a ``convert``); a reduction's output elements are counted, as the
#: reference counts a ``reduce``.
ARITH_ATEN = {
    "add": "add", "sub": "subtract", "rsub": "subtract",
    "mul": "multiply", "square": "multiply", "div": "divide",
    "reciprocal": "divide", "maximum": "maximum", "minimum": "minimum",
    "pow": "power", "exp": "exponential", "tanh": "tanh", "log": "log",
    "rsqrt": "rsqrt", "sqrt": "sqrt", "neg": "negate", "abs": "abs",
    "eq": "compare", "ne": "compare", "lt": "compare", "le": "compare",
    "gt": "compare", "ge": "compare", "where": "select",
    "masked_fill": "select", "logical_and": "and", "bitwise_and": "and",
    "logical_or": "or", "bitwise_or": "or", "logical_xor": "xor",
    "bitwise_xor": "xor", "floor": "floor", "ceil": "ceil",
    "sign": "sign", "expm1": "exponential-minus-one",
    "log1p": "log-plus-one", "atan2": "atan2", "clamp": "clamp",
    "clamp_min": "clamp", "clamp_max": "clamp", "cos": "cosine",
    "sin": "sine", "_to_copy": "convert", "silu": "multiply",
    "sum": "reduce", "amax": "reduce", "amin": "reduce", "max": "reduce",
    "min": "reduce", "prod": "reduce", "any": "reduce", "all": "reduce",
    "argmax": "reduce", "argmin": "reduce", "cumsum": "reduce-window",
}


def _softmax_flops(out, args) -> float:
    """XLA's softmax: a max and a sum over the rows (``reduce``), a
    subtract, an exp and a divide an element."""
    n = out.numel()
    return 3.0 * n + 2.0 * (n // max(out.shape[args[1]], 1) if n else 0)


def _log_softmax_flops(out, args) -> float:
    """XLA's log-softmax: a max, a sum and a log over the rows, two
    subtracts and an exp an element."""
    n = out.numel()
    return 3.0 * n + 3.0 * (n // max(out.shape[args[1]], 1) if n else 0)


#: aten operations that stand for several of the reference's opcodes.
COMPOSITE_ATEN = {
    "mean": lambda out, args: 2.0 * out.numel(),      # reduce + divide
    "_softmax": _softmax_flops,
    "_log_softmax": _log_softmax_flops,
}

#: aten operations that move no data: views and the allocations whose
#: contents nothing writes (``_unsafe_view`` is a view its schema does
#: not mark).
NO_BYTES_ATEN = frozenset((
    "_unsafe_view", "alias", "lift_fresh", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "set_", "resize_",
    "record_stream",
))

#: ``torch.distributed`` operations as they reach the dispatcher, each
#: as the reference's opcode; the payload is the output's bytes (the
#: argument at the index given, or the op's result), the group size the
#: process group's.  A point-to-point ``send`` is a
#: ``collective-permute``; the receiving side is not counted again.
C10D_OPS = {
    "allreduce_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_": ("all-gather", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "alltoall_base_": ("all-to-all", 0),
    "alltoall_": ("all-to-all", 0),
    "send": ("collective-permute", 0),
}
#: The functional collectives (``torch.distributed._functional_collectives``,
#: which DTensor issues), each as the reference's opcode; the payload is
#: the result's bytes.
FUNCTIONAL_OPS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensors(x) -> list:
    """The tensors in an argument or result (nested lists and tuples)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def _group_size(func, args, kwargs) -> int:
    """The size of the process group a collective runs over."""
    from torch.distributed import ProcessGroup
    from torch.distributed import distributed_c10d as c10d

    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except (RuntimeError, TypeError):
                continue
    names = [a for a in list(args) + list(kwargs.values())
             if isinstance(a, str)]
    if names:
        return c10d._resolve_process_group(names[-1]).size()
    raise ValueError(f"{func}: no process group among its arguments")


def analyze_program(fn, *args, vmem_credit: bool = False,
                    **kw) -> HLOCost:
    """Run ``fn(*args, **kw)`` once and count what it does, as
    :func:`analyze` counts a compiled program's HLO.

    The count is taken from the aten operations the program dispatches
    (a ``TorchDispatchMode``), so it holds whatever the device:

    * flops: ``dot`` (``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
      attention ops) and ``convolution`` by the formulas of
      ``torch.utils.flop_counter`` (2 a multiply-add; a depthwise
      convolution ``2 x out_elems x window``, as the reference); an
      ``elementwise`` flop an output element of each operation in
      :data:`ARITH_ATEN` (the reference's ``_ARITH_OPS``), and
      :data:`COMPOSITE_ATEN` as the opcodes XLA lowers them to; other
      operations count bytes only.
    * bytes: each operation's tensor arguments once and its outputs
      once, by aten name in ``bytes_by_op``; views and bare allocations
      move none (:data:`NO_BYTES_ATEN`).  This is op I/O, not the
      reference's fusion I/O (HLO charges a fused kernel at its call
      site), so the two packages' bytes are not comparable; flops and
      collective payloads are.
    * collectives: the ``c10d`` operations ``torch.distributed``
      dispatches (:data:`C10D_OPS`, :data:`FUNCTIONAL_OPS`), each a
      :class:`CollectiveOp` under the reference's opcode, its payload
      the output's bytes and its group the process group's size.  A
      ``send`` is a ``collective-permute`` of group size 1: the
      reference's parse gives every permute that size (it carries
      ``source_target_pairs``, not ``replica_groups``), so its wire
      bytes are 0 as there.
    * kernels: a hand-written kernel launched through ``ctypes``
      dispatches nothing; its wrapper reports the launch
      (:mod:`repro_torch.kernels._credit`), and the count credits it
      with its plain twin's flops at the same arguments (counted once
      for each set of shapes on the ``meta`` device) and with its own
      bytes, its inputs read and its outputs written once
      (``bytes_by_op["kernel <name>"]``).

    A program on DTensors is counted per device, as the reference counts
    the SPMD-partitioned program: the count lets DTensor unwrap each
    operation (as ``CommDebugMode`` does) and sees the local operations
    at the local shapes and the collectives DTensor issues; a kernel run
    on a local shard is credited at the local shapes.

    An eager loop runs its body once a trip and each trip is counted,
    so the undercount of a ``while`` body counted once, which
    :func:`analyze` repairs by trip counts, cannot arise:
    ``unrolled_whiles`` and ``unknown_trip_whiles`` stay 0.

    ``vmem_credit=True`` is the reference's ``vmem_credit_depth=2``
    (``analyze``): an operation inside a
    :func:`.loop_marks.fused_loop` mark is
    charged its flops in full, and bytes only where it loads a block (a
    slicing operation, :data:`BLOCK_LOADS`: its outputs) or stores one
    (:data:`BLOCK_STORES`: the update; ``x[i] = y`` makes the view
    ``x[i]`` only to write it, so that view is not also a load), under
    ``bytes_by_op["vmem-block-io"]``; collectives as always.  A tensor
    made inside the marked loop (an intermediate of the fused body,
    which stays in VMEM) is neither loaded nor stored: slicing it or
    writing into it moves no bytes.  A kernel
    whose twin runs a mark (kernel E's blockwise twin) is charged the
    twin's block I/O so counted, in place of its own inputs and outputs.
    """
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    cost = HLOCost()
    coll_ops: List[CollectiveOp] = []
    # block loads charged inside marks and alive, by id: (weak
    # reference, bytes); an entry goes when its view is freed
    loads: dict = {}
    # tensors made inside the marked loop now running (the fused body's
    # intermediates, which stay in VMEM), by id: (weak reference, loop)
    made: dict = {}

    def remember(outs) -> None:
        for t in outs:
            made[id(t)] = (weakref.ref(t, lambda _, i=id(t): made.pop(i,
                                                                     None)),
                           loop_marks.loops)

    def inside(t) -> bool:
        for x in (t, getattr(t, "_base", None)):
            ref, loop = made.get(id(x), (None, -1))
            if ref is not None and ref() is x and loop == loop_marks.loops:
                return True
        return False

    def block_io(name, args, outs) -> None:
        if name in BLOCK_LOADS and not inside(args[0]):
            b = _nbytes(outs)
            for t in outs:
                loads[id(t)] = (weakref.ref(
                    t, lambda _, i=id(t): loads.pop(i, None)),
                    t.numel() * t.element_size())
        elif (name in BLOCK_STORES and len(args) > BLOCK_STORES[name]
              and not inside(args[0])):
            dest = args[0]
            if name == "copy_" and dest._base is None:
                return
            b = _nbytes(_tensors(args[BLOCK_STORES[name]]))
            ref, made = loads.pop(id(dest), (None, 0))
            if ref is not None and ref() is dest:
                b -= made
        else:
            remember(outs)
            return
        cost.bytes += b
        cost.bytes_by_op["vmem-block-io"] += b

    def count(func, args, kwargs, out) -> None:
        name = func.overloadpacket.__name__
        packet = func.overloadpacket
        if func.namespace == "c10d":
            if name in C10D_OPS:
                opcode, at = C10D_OPS[name]
                payload = _nbytes(_tensors(args[at]))
                group = 1 if opcode == "collective-permute" else \
                    _group_size(func, args, kwargs)
                coll_ops.append(CollectiveOp(opcode, payload, group))
                cost.bytes += payload
                cost.bytes_by_op[opcode] += payload
            return
        if func.namespace == "_c10d_functional":
            if name in FUNCTIONAL_OPS:
                opcode = FUNCTIONAL_OPS[name]
                payload = _nbytes(_tensors(out))
                coll_ops.append(CollectiveOp(
                    opcode, payload, _group_size(func, args, kwargs)))
                cost.bytes += payload
                cost.bytes_by_op[opcode] += payload
            return
        outs = _tensors(out)
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            key = "convolution" if "conv" in name else "dot"
            cost.flops += f
            cost.flops_by_op[key] += f
        else:
            base = name[:-1] if name.endswith("_") and \
                name[:-1] in ARITH_ATEN else name
            f = 0.0
            if base in COMPOSITE_ATEN and outs:
                f = COMPOSITE_ATEN[base](outs[0], args)
            elif base in ARITH_ATEN and outs:
                ins = _tensors(args)
                if base != "_to_copy" or (ins and ins[0].dtype
                                          != outs[0].dtype):
                    f = float(outs[0].numel())
            if f:
                cost.flops += f
                cost.flops_by_op["elementwise"] += f
        if vmem_credit and loop_marks.depth:
            block_io(name, args, outs)
            return
        if func.is_view or name in NO_BYTES_ATEN:
            return
        b = _nbytes(_tensors(args) + _tensors(kwargs) + outs)
        cost.bytes += b
        cost.bytes_by_op[name] += b

    dtensor = _dtensor_type()

    class _Counting(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if dtensor is not None and any(issubclass(t, dtensor)
                                           for t in types):
                # let DTensor unwrap first: its local operations and its
                # collectives come back here, counted per device
                return NotImplemented
            kwargs = kwargs or {}
            if func is torch.ops.aten.equal.default and \
                    args[0].device.type == "meta":
                # a meta tensor has no values to compare: DTensor asks
                # whether two embedding masks it made from the same ids
                # agree (a sharded table's backward), which they do
                return True
            out = func(*args, **kwargs)
            if any(issubclass(t, FakeTensor) for t in types):
                # DTensor's sharding propagation runs each operation on
                # fake tensors of the global shapes: no device runs it
                return out
            count(func, args, kwargs, out)
            return out

    def sink(name, twin, targs, tkw, inputs, outputs) -> None:
        flops, nbytes = _twin_cost(twin, targs, tkw, vmem_credit)
        for key, f in flops.items():
            cost.flops += f
            cost.flops_by_op[key] += f
        if "vmem-block-io" in nbytes:
            b, key = nbytes["vmem-block-io"], "vmem-block-io"
        else:
            b = _nbytes([t for t in list(inputs) + list(outputs)
                         if t is not None])
            key = f"kernel {name}"
        cost.bytes += b
        cost.bytes_by_op[key] += b

    _credit._SINKS.append(sink)
    loop_marks.credit_counts += vmem_credit
    try:
        with _Counting():
            fn(*args, **kw)
    finally:
        loop_marks.credit_counts -= vmem_credit
        _credit._SINKS.remove(sink)
    cost.collectives = CollectiveSummary(coll_ops)
    return cost


def _dtensor_type():
    """``DTensor``, if ``torch.distributed.tensor`` is imported (no
    DTensor exists before it is)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


#: Flops and bytes of a kernel's plain twin, by the twin, its arguments'
#: shapes and the credit.
_TWIN_COST: dict = {}


def _meta_key(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype))
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple(sorted((k, _meta_key(v)) for k, v in x.items()))
    return x


def _twin_cost(twin, args: tuple, kwargs: dict,
               vmem_credit: bool = False) -> tuple:
    """(``flops_by_op``, ``bytes_by_op``) of ``twin(*args, **kwargs)``,
    run on ``meta`` tensors of the arguments' shapes and dtypes outside
    every active count (a kernel's work depends on its shapes and
    settings alone), with the credit or not.  A twin that loops over
    block pairs doing the same work in each (``twin.pair_count``, the
    blockwise attention) is counted over its first two pairs and its
    first three (loops of more than one trip either way, so marked
    alike), and the difference times the rest added: the count of every
    pair, without running 2,080 of them operation by operation at
    32,768 tokens."""
    from torch.utils._python_dispatch import _disable_current_modes

    key = (twin.__module__, twin.__qualname__, _meta_key(args),
           _meta_key(kwargs), vmem_credit)
    if key not in _TWIN_COST:
        def meta(x):
            if isinstance(x, torch.Tensor):
                return torch.empty(x.shape, dtype=x.dtype, device="meta")
            return x

        def count(**extra) -> tuple:
            with _disable_current_modes(), torch.no_grad():
                c = analyze_program(twin, *(meta(a) for a in args),
                                    vmem_credit=vmem_credit, **kwargs,
                                    **extra)
            return dict(c.flops_by_op), dict(c.bytes_by_op)

        def extrapolate(two: dict, three: dict, n: int) -> dict:
            return {k: two.get(k, 0.0) + (n - 2) * (three[k]
                                                    - two.get(k, 0.0))
                    for k in three}

        pair_count = getattr(twin, "pair_count", None)
        n = pair_count(*args, **kwargs) if pair_count else 0
        sinks = list(_credit._SINKS)
        _credit._SINKS.clear()
        try:
            if n > 3:
                two, three = count(first_pairs=2), count(first_pairs=3)
                got = tuple(extrapolate(a, b, n) for a, b in zip(two, three))
            else:
                got = count()
        finally:
            _credit._SINKS[:] = sinks
        _TWIN_COST[key] = got
    return _TWIN_COST[key]
