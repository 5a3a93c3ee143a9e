"""Trees of tensors walked in ``jax.tree``'s order.

The port keeps its parameters, gradients and optimizer state as the
reference's trees: nested dicts, tuples and NamedTuples with tensors at the
leaves.  These helpers walk them as ``jax.tree`` does (dict keys sorted,
sequences and NamedTuple fields in order), so leaf lists, norms summed leaf
by leaf and checkpoint manifests come out in the reference's order.  Paths
are spelled as the reference's checkpoint spells them: a dict key as
itself, a sequence index as its number, a NamedTuple field as ``.field``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

__all__ = ["leaves", "leaves_with_paths", "tree_map", "unflatten"]


def _children(node) -> Optional[List[Tuple[str, Any]]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in ``jax.tree`` order; a path joins its parts
    with ``/``, as ``repro.checkpoint`` names its leaves."""
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for name, sub in kids:
        out.extend(leaves_with_paths(sub, prefix + (name,)))
    return out


def leaves(tree) -> list:
    """The leaves in ``jax.tree`` order."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over ``tree``'s structure; the
    other trees are indexed by ``tree``'s keys, so a leaf of ``tree`` may
    face a whole subtree of another (a ``QuantState``, say)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, flat) -> Any:
    """A tree shaped as ``like`` whose leaves are ``flat``, given in
    ``jax.tree`` order.

    Raises:
        ValueError: ``flat`` holds another number of leaves than ``like``.
    """
    flat = list(flat)
    if len(flat) != len(leaves(like)):
        raise ValueError(f"{len(flat)} leaves for a tree of "
                         f"{len(leaves(like))}")
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            got = {k: build(node[k]) for k in sorted(node)}
            return {k: got[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)
