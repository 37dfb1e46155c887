"""Nested dicts and lists of tensors (the port's parameter and optimizer
trees), walked as JAX walks its pytrees: dict keys in sorted order, list
items in order.  A leaf is anything that is not a dict or a list."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple


def leaves(tree) -> Iterator[Any]:
    """The leaves in JAX's order (sorted dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    elif isinstance(tree, list):
        for t in tree:
            yield from leaves(t)
    else:
        yield tree


def items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in ``leaves`` order; a path joins the keys and list
    indices with "/" (the checkpoint's key names)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from items(t, f"{prefix}/{i}" if prefix else str(i))
    else:
        yield prefix, tree


def map_tree(fn: Callable, tree, *rest):
    """``fn(leaf, *matching)`` over the leaves of ``tree``, where each of
    ``rest`` has ``tree``'s structure down to those leaves (what it holds
    there may be a subtree, as an int8 moment's {"q", "s"}).  → a tree of
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
