"""Tree helpers of the port: the part of ``jax.tree`` it needs, over
nested dicts, lists, tuples and named tuples of tensors.

As in ``jax.tree``, ``None`` is an empty subtree (it has no leaves and
maps to ``None``), a named tuple is a node rebuilt by its fields, and
``is_leaf`` stops the descent at the nodes it accepts (the gradient
compression's ``Compressed`` pairs, for one).  A mapping is rebuilt as a
dict in its own key order; :func:`tree_leaves` takes mapping keys
sorted, the reference's flatten order.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of ``tree``'s structure), rebuilding ``tree``'s
    structure; ``fn`` never sees a ``None``."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, *vs, is_leaf=is_leaf)
                for vs in zip(tree, *rest)]
        return type(tree)._make(vals) if is_namedtuple(tree) \
            else type(tree)(vals)
    return fn(tree, *rest)


def tree_leaves(tree: Any,
                is_leaf: Callable[[Any], bool] | None = None) -> list:
    """The leaves of ``tree`` in the reference's flatten order (mapping
    keys sorted, sequences in order), ``None`` contributing none."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k],
                                                             is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v, is_leaf)]
    return [tree]
