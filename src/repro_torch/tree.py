"""Trees of tensors (the port's pytrees): nested dicts, tuples / lists and
NamedTuples with tensors (or any other object) at the leaves.

The leaf order is JAX's: a dict's keys sorted, a NamedTuple's fields, a
tuple's items in order; ``None`` is an empty subtree.  Checkpoints and the
optimizer walk leaves in this order, so that a tree flattens here as the
reference's ``jax.tree`` flattens its twin.  A key path is a tuple of
``("key", k)`` (dict), ``("attr", name)`` (NamedTuple field) and
``("index", i)`` (tuple / list item) entries.
"""

from __future__ import annotations

from typing import Any, Callable

__all__ = ["tree_map", "tree_flatten_with_path", "tree_leaves",
           "tree_unflatten", "tree_structure"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, *trees):
    """Map ``fn`` over the leaves of nested dicts / tuples / NamedTuples."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if _is_namedtuple(t0):
        return type(t0)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    if t0 is None:
        return None
    return fn(*trees)


def tree_flatten_with_path(tree, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(key path, leaf)] in JAX's leaf order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_flatten_with_path(tree[k],
                                                   path + (("key", k),))]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in tree_flatten_with_path(getattr(tree, f),
                                                   path + (("attr", f),))]
    if isinstance(tree, (tuple, list)):
        return [item for i, x in enumerate(tree)
                for item in tree_flatten_with_path(x, path + (("index", i),))]
    if tree is None:
        return []
    return [(path, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure with ``leaves`` (JAX order) at its
    leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_structure(tree) -> str:
    """The tree's shape as a string, ``*`` for a leaf (dict keys sorted)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}("
                + ", ".join(f"{f}={tree_structure(getattr(tree, f))}"
                            for f in tree._fields) + ")")
    if isinstance(tree, (tuple, list)):
        open_, close = ("(", ")") if isinstance(tree, tuple) else ("[", "]")
        return open_ + ", ".join(tree_structure(x) for x in tree) + close
    return "None" if tree is None else "*"
