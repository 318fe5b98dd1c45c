"""The frozen work count: float64 operations a configuration must take.

The reference's lane expression (:mod:`.model`) is run once on symbols.
Each symbol carries the set of swept axes its value depends on; a table
gather depends on its index's axes, a constant or an axis with one value
on none.  An operation is counted when its result depends on every swept
axis: anything that depends on fewer can be hoisted out of the lanes and
computed once per value of those axes.  Identical operations on identical
operands are one (common subexpressions are shared), and only operations
that an output of the cell needs are counted.

Counted as one operation each: add, subtract, multiply, divide, minimum,
maximum, a float comparison, exp and pow.  Not counted: selects
(``where``), gathers, integer arithmetic and boolean logic.  A division,
an exp or a pow takes several float64 instructions on any machine, so the
count is a lower bound on what a correct implementation executes, and a
share of the float64 peak computed from it cannot pass 100 %.
"""

from __future__ import annotations

from . import model as M


class Graph:
    """The operations recorded while the expression runs, hash-consed."""

    def __init__(self, swept: frozenset):
        self.swept = swept
        self.nodes: dict = {}       # key -> Sym

    def op(self, name: str, kind: str, args: tuple, counted: bool):
        syms = tuple(a for a in args if isinstance(a, Sym))
        key = (name, tuple(id(a) if isinstance(a, Sym) else ("c", a)
                           for a in args))
        hit = self.nodes.get(key)
        if hit is not None:
            return hit
        deps = frozenset().union(*(s.deps for s in syms)) if syms else \
            frozenset()
        s = Sym(self, deps, kind, syms,
                counted and kind != "i" and len(deps & self.swept) >= 2
                and any(a.kind == "f" for a in syms))
        self.nodes[key] = s
        return s

    def count(self, outputs) -> int:
        """Counted operations that the symbols ``outputs`` need."""
        seen, stack, n = set(), list(outputs), 0
        while stack:
            s = stack.pop()
            if id(s) in seen:
                continue
            seen.add(id(s))
            n += s.counted
            stack.extend(s.parents)
        return n


class Sym:
    """A lane value: the axes it depends on and the operation that made
    it.  ``kind`` is ``"f"`` (float), ``"i"`` (integer) or ``"b"``."""

    def __init__(self, g: Graph, deps: frozenset, kind: str, parents: tuple,
                 counted: bool):
        self.g, self.deps, self.kind = g, deps, kind
        self.parents, self.counted = parents, counted

    def _bin(self, name, other, rev=False, kind=None):
        args = (other, self) if rev else (self, other)
        if kind is None:
            kinds = {a.kind if isinstance(a, Sym) else
                     ("f" if isinstance(a, float) else "i") for a in args}
            kind = "f" if "f" in kinds else "i"
        return self.g.op(name, kind, args, True)

    def __add__(self, o): return self._bin("add", o)
    def __radd__(self, o): return self._bin("add", o, True)
    def __sub__(self, o): return self._bin("sub", o)
    def __rsub__(self, o): return self._bin("sub", o, True)
    def __mul__(self, o): return self._bin("mul", o)
    def __rmul__(self, o): return self._bin("mul", o, True)
    def __truediv__(self, o): return self._bin("div", o)
    def __neg__(self): return self._bin("neg", -1.0)
    def __gt__(self, o): return self._bin("gt", o, kind="b")
    def __lt__(self, o): return self._bin("lt", o, kind="b")
    def __le__(self, o): return self._bin("le", o, kind="b")

    def __and__(self, o):
        return self.g.op("and", "b", (self, o), False)

    __rand__ = __and__


class _Table:
    """A table whose gathers depend on their index's axes."""

    def __init__(self, g: Graph, name: str, shape=()):
        self.g, self.name, self.shape = g, name, shape

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        return self.g.op("take:" + self.name, "f", idx, False)


class _Tables(dict):
    def __init__(self, g: Graph, scalars: dict):
        super().__init__()
        self.g, self.scalars = g, scalars

    def __missing__(self, name):
        return self.scalars[name] if name in self.scalars else \
            _Table(self.g, name)


class SymOps:
    """:class:`.model.TorchOps`'s operations on symbols."""

    def __init__(self, g: Graph):
        self.g = g

    def div(self, a, b):
        return self.g.op("div", "f", (a, b), True)

    def minimum(self, a, b):
        return self.g.op("min", "f", (a, b), True)

    def maximum(self, a, b):
        return self.g.op("max", "f", (a, b), True)

    def where(self, cond, a, b):
        return self.g.op("where", "f", (cond, a, b), False)

    def exp(self, a):
        return self.g.op("exp", "f", (a,), True)

    def isfinite(self, a):
        return self.g.op("isfinite", "b", (a,), False)

    def pow(self, a, p):
        return self.g.op("pow", "f", (a, p), True)

    def clamp_int(self, a, lo, hi):
        return self.g.op("clamp", "i", (a, lo, hi), False)

    def full_like(self, like, v):
        return v


def _lanes(g: Graph, sizes: dict, names, kinds):
    """One symbol a lane argument: its axis if it varies, else none."""
    return [Sym(g, frozenset([n]) if sizes.get(n, 1) > 1 else frozenset(),
                k, (), False) for n, k in zip(names, kinds)]


_AXES = ("cut", "agg_node", "sensor_node", "weight_mem", "detnet_fps",
         "keynet_fps", "num_cameras", "mipi_energy_scale", "camera_fps")
_KINDS = ("i", "i", "i", "i", "f", "f", "f", "f", "f")


def _setup(sizes: dict, scalars: dict):
    swept = frozenset(n for n, s in sizes.items() if s > 1)
    g = Graph(swept)
    return g, SymOps(g), _Tables(g, scalars)


def config_ops(sizes: dict, fields, n_det: int, n_key: int,
               scalars: dict) -> int:
    """Counted operations of one configuration's ``fields``; ``sizes``
    gives each axis's number of values (an axis left out has one)."""
    g, X, T = _setup(sizes, scalars)
    out = M.config_eval(X, T, n_det, n_key,
                        *_lanes(g, sizes, _AXES, _KINDS))
    return g.count([out[f] for f in fields])


def session_ops(sizes: dict, fields, n_det: int, n_key: int, scalars: dict,
                sess: dict, n_steps: int) -> int:
    """Counted operations of one (configuration x trace) pair's
    ``fields`` over a session of ``n_steps`` steps, every step table
    depending on the trace axis."""
    g, X, T = _setup(sizes, scalars)
    lanes = _lanes(g, sizes, _AXES + ("trace",), _KINDS + ("i",))
    steps = {c: _Table(g, "step." + c, (1, n_steps))
             for c in M.STEP_COLUMNS}
    out = M.session_eval(X, T, n_det, n_key, sess, steps, *lanes)
    return g.count([out[f] for f in fields])
