"""Trees of tensors: nested dicts, lists, tuples and named tuples.

The port keeps parameters and optimizer state as the JAX package keeps its
pytrees, so these helpers walk them in JAX's order (dict keys sorted) and
name each leaf as ``jax.tree_util.keystr`` does: ``['down'][0]['res']`` for
dict keys and sequence indices, ``.m`` for a named tuple's field.  ``None``
is an empty subtree, as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of ``rest``),
    in a tree of the same structure and container types.  A node of
    ``tree`` for which ``is_leaf`` holds is a leaf, as in ``jax.tree.map``."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs, is_leaf=is_leaf) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs, is_leaf=is_leaf) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves_with_path(tree: Any, path: str = "",
                          is_leaf: Callable[[Any], bool] | None = None) -> list[tuple[str, Any]]:
    """(key string, leaf) pairs in JAX's flatten order."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_leaves_with_path(tree[k], f"{path}[{k!r}]", is_leaf)]
    if _is_namedtuple(tree):
        return [kv for f, v in zip(tree._fields, tree)
                for kv in tree_leaves_with_path(v, f"{path}.{f}", is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_leaves_with_path(v, f"{path}[{i}]", is_leaf)]
    return [(path, tree)]


def tree_leaves(tree: Any) -> list[Any]:
    """The leaves of ``tree`` in JAX's flatten order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(template: Any, leaves: list[Any]) -> Any:
    """A tree of ``template``'s structure whose leaves are ``leaves``, taken
    in JAX's flatten order (the inverse of :func:`tree_leaves`)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the template holds")
    return out
