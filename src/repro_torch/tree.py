"""Nested containers of tensors ("trees"): the port's stand-in for JAX
pytrees.

A tree is a dict, list, tuple or NamedTuple of trees, or a leaf (a tensor,
array or scalar).  `map_with_path` is the one walker; every other function
here and in `repro_torch.interop` is built on it.  It visits dict entries
in sorted key order, as `jax.tree` does, so leaf order matches the JAX
package's everywhere, while rebuilt dicts keep their own key order.  ``()``
is an empty tree with no leaves (stateless optimizer or mixing state).
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any
Path = tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn: Callable, tree: Tree, *rest: Tree, path: Path = (),
                  is_leaf: Callable[[Path, Any], bool] | None = None) -> Tree:
    """``fn(path, leaf, *matching leaves of rest)`` over the leaves of
    ``tree``, rebuilding its structure.  ``path`` holds dict keys,
    ``"." + field`` for NamedTuple fields and ints for list / tuple
    positions, from the root (or from ``path``).  A node for which
    ``is_leaf(path, node)`` holds is handed to ``fn`` whole."""
    if is_leaf is not None and is_leaf(path, tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        out = dict.fromkeys(tree)
        for k in sorted(tree):
            out[k] = map_with_path(fn, tree[k], *(r[k] for r in rest),
                                   path=path + (k,), is_leaf=is_leaf)
        return out
    if _is_namedtuple(tree):
        return type(tree)(*(
            map_with_path(fn, *xs, path=path + ("." + f,), is_leaf=is_leaf)
            for f, *xs in zip(tree._fields, tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            map_with_path(fn, *xs, path=path + (i,), is_leaf=is_leaf)
            for i, xs in enumerate(zip(tree, *rest)))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure)."""
    return map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def tree_leaves(tree: Tree) -> list:
    """The leaves in `map_with_path` order."""
    leaves: list = []
    map_with_path(lambda _, x: leaves.append(x), tree)
    return leaves
