"""Trees of dicts, lists, tuples and NamedTuples, the one place the port
keeps their node rules: children are walked in ``jax.tree_util`` order
(sorted dict keys, sequences and NamedTuple fields in order), ``None`` is
a node without children, as in JAX, and anything else is a leaf. Leaves of
a port tree and of the JAX package's tree of the same structure line up
one for one, which ``torch.utils._pytree`` (dicts in insertion order) does
not give.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def is_node(tree) -> bool:
    return tree is None or isinstance(tree, (dict, list, tuple))


def children(node) -> list:
    """``node``'s children in flatten order."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    return list(node)


def rebuild(node, kids) -> Any:
    """A node of ``node``'s type holding ``kids`` (in :func:`children`
    order); a dict keeps ``node``'s key order, a NamedTuple takes its
    fields as positional arguments."""
    kids = list(kids)
    if node is None:
        return None
    if isinstance(node, dict):
        built = dict(zip(sorted(node), kids, strict=True))
        return {k: built[k] for k in node}
    if is_namedtuple(node):
        return type(node)(*kids)
    return type(node)(kids)


def keys(node) -> List[str]:
    """Keys of a node's children in flatten order, as ``jax.tree_util``
    prints them: sorted dict keys, NamedTuple fields as ``.field``,
    sequence indices; ``None`` has none."""
    if node is None:
        return []
    if isinstance(node, dict):
        return [str(k) for k in sorted(node)]
    if is_namedtuple(node):
        return [f".{f}" for f in node._fields]
    return [str(i) for i in range(len(node))]


def tree_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(``/``-joined key path, leaf) pairs in flatten order (the JAX
    package's path strings: ``blocks/0/attn/wq``)."""
    if not is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in zip(keys(tree), children(tree)):
        out.extend(tree_paths(child, f"{prefix}/{key}" if prefix else key))
    return out


def tree_map_with_path(fn: Callable, tree) -> Any:
    """``tree``'s structure holding ``fn(path, leaf)``."""
    return tree_unflatten(tree, iter([fn(p, x) for p, x in tree_paths(tree)]))


def tree_leaves(tree) -> List[Any]:
    if not is_node(tree):
        return [tree]
    return [leaf for child in children(tree) for leaf in tree_leaves(child)]


def tree_unflatten(template, leaves: Iterator) -> Any:
    """``template``'s structure holding the next leaves of the iterator
    ``leaves`` (in :func:`tree_leaves` order)."""
    if not is_node(template):
        return next(leaves)
    return rebuild(template, [tree_unflatten(c, leaves) for c in children(template)])


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``tree``'s structure holding ``fn(leaf, *matching leaves of rest)``."""
    if not is_node(tree):
        return fn(tree, *rest)
    kids = zip(children(tree), *(children(r) for r in rest), strict=True)
    return rebuild(tree, [tree_map(fn, *k) for k in kids])
