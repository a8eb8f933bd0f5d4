"""Nested dict/list trees in the JAX package's flatten order.

``jax.tree_util`` flattens a dict in sorted key order and a list or
tuple by index; the BSQ state, its checkpoint files and the regulariser's
sum over tensors all follow that order, so the port flattens the same
way.  A leaf is anything that is not a dict, list or tuple; its name is
the "/"-joined path of keys and indices, as ``repro.core.bsq._path_str``
and ``repro.ckpt.checkpoint._flatten`` write it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def flatten_with_path(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in JAX's flatten order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out.extend(flatten_with_path(v, f"{prefix}/{k}" if prefix else k))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten_like(template, by_name: Dict[str, Any], prefix: str = ""):
    """``template``'s structure with the leaf named ``n`` replaced by
    ``by_name[n]`` (the inverse of :func:`flatten_with_path`)."""
    if isinstance(template, dict):
        return {k: unflatten_like(v, by_name, f"{prefix}/{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(unflatten_like(v, by_name, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(template))
    return by_name[prefix]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)
