"""Nested-dict trees of tensors, walked as ``jax.tree_util`` walks the
reference's: dict keys in sorted order, depth first.  A tuple is a leaf
(an int8 optimizer-state leaf is the pair (q, scale)); an empty dict (a
``nonparam_ln`` norm) has no leaf and is kept."""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple

Tree = Dict[str, Any]


def flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in the reference's order; paths join keys with
    "/" as its checkpoints do."""
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += flatten(v, f"{prefix}{k}/")
        else:
            out.append((prefix + k, v))
    return out


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(like: Tree, values: Iterable[Any]) -> Tree:
    """A tree shaped like ``like`` whose leaves are ``values``, taken in
    :func:`flatten`'s order."""
    it = iter(values)

    def build(node):
        return {k: build(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}
    return build(like)


def tree_map_with_path(fn: Callable, tree: Tree, prefix: str = "") -> Tree:
    """``fn(path, leaf)`` on every leaf, paths as :func:`flatten` gives
    them."""
    return {k: tree_map_with_path(fn, v, f"{prefix}{k}/")
            if isinstance(v, dict) else fn(prefix + k, v)
            for k, v in tree.items()}


def get_path(tree: Tree, path: str) -> Any:
    """The leaf (or subtree) at a "/"-joined ``path``."""
    for k in path.split("/"):
        tree = tree[k]
    return tree


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` on the leaves of ``tree`` and the same places of ``rest``."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
