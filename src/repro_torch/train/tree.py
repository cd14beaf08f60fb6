"""Nested parameter trees (dicts, lists and tuples of tensors), walked as
``jax.tree_util`` walks a pytree: dict keys in sorted order, sequences
by index.  A leaf's path names it as the reference's checkpoints do
(``train/checkpoint.py::_path_str`` there): dict keys as themselves,
sequence positions as ``[i]``, joined by ``.``."""
from __future__ import annotations


def flatten_with_path(tree, path=()):
    """``[(path, leaf), ...]`` in pytree order; a path is a tuple of dict
    keys and ``(i,)`` one-tuples for sequence positions."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, t in enumerate(tree)
                for item in flatten_with_path(t, path + ((i,),))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves):
    """A tree of ``like``'s structure holding ``new_leaves`` (in
    :func:`leaves`' order)."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of the
    same structure, leaf by leaf."""
    flat = [leaves(t) for t in (tree, *rest)]
    if len({len(f) for f in flat}) != 1:
        raise ValueError("trees of different structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])


def path_str(path) -> str:
    """The reference's checkpoint name of a leaf's path."""
    return ".".join(f"[{p[0]}]" if isinstance(p, tuple) else str(p)
                    for p in path)
