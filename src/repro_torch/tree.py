"""Nested dict/list/tuple trees, flattened in JAX's leaf order.

Cell states are plain nested containers of tensors, exactly as in the
JAX package.  Fault specs (``FaultSpec.leaf``), fingerprint leaf salts
and ledger attribution all index leaves by their position in the
flattened tree, so the order here must be ``jax.tree.leaves``' order:
dict keys SORTED, lists and tuples in sequence, ``None`` an empty node.
(``torch.utils._pytree`` keeps dict insertion order, which differs.)
"""

from __future__ import annotations

from typing import Any, Callable

Tree = Any

_LEAF = "*"


def _flatten(node: Tree, leaves: list, path: tuple, paths: list | None):
    if isinstance(node, dict):
        keys = tuple(sorted(node))
        return ("d", keys, tuple(_flatten(node[k], leaves, path + (k,), paths) for k in keys))
    if isinstance(node, (list, tuple)):
        kids = tuple(_flatten(x, leaves, path + (i,), paths) for i, x in enumerate(node))
        return ("l" if isinstance(node, list) else "t", type(node), kids)
    if node is None:
        return ("n",)
    leaves.append(node)
    if paths is not None:
        paths.append(path)
    return _LEAF


def tree_flatten(tree: Tree) -> tuple[list, tuple]:
    """``(leaves, treedef)``; treedefs compare equal iff structures do."""
    leaves: list = []
    return leaves, _flatten(tree, leaves, (), None)


def tree_leaves(tree: Tree) -> list:
    return tree_flatten(tree)[0]


def tree_paths(tree: Tree) -> list[tuple]:
    """Key path of every leaf (dict keys and sequence indices), in leaf
    order."""
    paths: list = []
    _flatten(tree, [], (), paths)
    return paths


def _build(td, it):
    if td == _LEAF:
        return next(it)
    kind = td[0]
    if kind == "d":
        return {k: _build(c, it) for k, c in zip(td[1], td[2])}
    if kind == "l":
        return [_build(c, it) for c in td[2]]
    if kind == "t":
        kids = [_build(c, it) for c in td[2]]
        cls = td[1]
        return cls(*kids) if hasattr(cls, "_fields") else cls(kids)
    return None


def tree_unflatten(treedef: tuple, leaves) -> Tree:
    it = iter(leaves)
    out = _build(treedef, it)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("too many leaves for this treedef")
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over corresponding leaves of trees of equal structure."""
    leaves, td = tree_flatten(tree)
    others = []
    for r in rest:
        rl, rtd = tree_flatten(r)
        if rtd != td:
            raise ValueError("tree_map: trees differ in structure")
        others.append(rl)
    return tree_unflatten(td, [fn(*xs) for xs in zip(leaves, *others)])


def leaf_index(tree: Tree, key: str) -> int:
    """Flat index of the first leaf whose path contains dict key ``key``
    (how a caller aims a ``FaultSpec`` at a named state leaf)."""
    for i, path in enumerate(tree_paths(tree)):
        if key in path:
            return i
    raise KeyError(key)
