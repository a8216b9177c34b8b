"""Nested containers of tensors ("trees"), walked in the reference's order.

A tree is a dict, tuple, list or NamedTuple of trees, or a leaf. The
order is ``jax.tree_util``'s: a dict's keys sorted, a sequence's items in
order, a NamedTuple's fields in order; ``None`` is an empty subtree.
Path names are the reference checkpoint's: dict keys, sequence indices and
NamedTuple field names joined by ``/`` (``"1/m/blocks/mlp/w_up"`` for a
``(params, AdamWState)`` pair), so a checkpoint written by either package
lists the same leaves under the same names.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    """(name, child) pairs of an inner node, or [] for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    return []


def _is_node(node) -> bool:
    return isinstance(node, (dict, tuple, list))


def leaves_with_paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) in the reference's flatten order; ``None`` yields
    nothing."""
    if tree is None:
        return
    if not _is_node(tree):
        yield prefix, tree
        return
    for name, child in _children(tree):
        yield from leaves_with_paths(child,
                                     f"{prefix}/{name}" if prefix else name)


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(template, values) -> Any:
    """A tree of ``template``'s structure holding ``values`` (in flatten
    order) at its leaves."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        items = [build(c) for c in node]
        if _is_namedtuple(node):
            return type(node)(*items)
        return type(node)(items)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def map_leaves(fn: Callable, tree, *rest) -> Any:
    """``fn(leaf, *same-path leaves of rest)`` over ``tree``'s leaves,
    into a tree of ``tree``'s structure; the other trees are read by
    position, so a ``None`` there reaches ``fn`` as ``None``."""
    if tree is None:
        return None
    if not _is_node(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    items = [map_leaves(fn, c, *(r[i] for r in rest))
             for i, c in enumerate(tree)]
    if _is_namedtuple(tree):
        return type(tree)(*items)
    return type(tree)(items)
