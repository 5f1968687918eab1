"""Trees of tensors: nested dicts, lists and tuples (None an empty
subtree), flattened in the reference's order — JAX flattens a dict by
sorted key — with paths joined by ``/`` (a tuple member, such as an int8
state's ``(q, scale)``, as ``.../0`` and ``.../1``).  The optimizer maps
over them and the checkpointer keys its arrays by their paths."""
from __future__ import annotations


def flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} in the reference's leaf order."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    elif tree is None:
        return {}
    else:
        return {prefix: tree}
    out = {}
    for k, t in items:
        out.update(flatten(t, f"{prefix}/{k}" if prefix else k))
    return out


def leaves(tree) -> list:
    return list(flatten(tree).values())


def rebuild(like, by_path: dict, prefix: str = ""):
    """``like``'s structure with the leaf at each path taken from ``by_path``."""
    def sub(k):
        return f"{prefix}/{k}" if prefix else str(k)

    if isinstance(like, dict):
        return {k: rebuild(v, by_path, sub(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(rebuild(v, by_path, sub(i)) for i, v in enumerate(like))
    return None if like is None else by_path[prefix]


def unflatten(like, new_leaves):
    """``like``'s structure with ``new_leaves`` in `leaves` order."""
    return rebuild(like, dict(zip(flatten(like), new_leaves)))


def tree_map(fn, tree, *rest):
    """``fn`` over ``tree``'s leaves; each tree of ``rest`` is read down to
    ``tree``'s leaves only (an int8 state's ``(q, scale)`` pair reaches
    ``fn`` whole), as JAX's ``flatten_up_to``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)
