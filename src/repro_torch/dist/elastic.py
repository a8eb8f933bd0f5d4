"""Placing a tree on a mesh: the serving half of ``repro.dist.elastic``.

Checkpoints and param draws hold whole (unsharded) tensors, so placing a
tree on a mesh is cutting: compute each leaf's spec from the same
name/shape rules (:mod:`repro_torch.dist.sharding`) and keep this rank's
block.  Values are untouched.  The training half (restoring a train state
onto another mesh, the trainer's elastic resume) comes with the training
mesh slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core.packing import PACKABLE_SUFFIXES, FloatBlock, PackedWeight
from .sharding import dp_axes, local_block, tree_param_specs

PyTree = Any


def _block(leaf, spec, mesh):
    # a copy: a view would keep the whole tensor's storage alive
    return local_block(leaf, spec, mesh).clone() if isinstance(leaf, torch.Tensor) else leaf


def local_scale(scale: torch.Tensor, scale_spec, n_ax, n: int, mesh) -> torch.Tensor:
    """This rank's block of a packed weight's scale, which on a mesh always
    describes the rank's own output columns: the rule's block where the
    row's groups split over the N shards, else the row expanded to one
    scale per column (exact: each column keeps its group's value) and cut
    to this rank's columns.  ``n`` is the whole weight's N."""
    if scale.ndim >= 2 and scale.shape[-1] > 1 and n_ax is not None \
            and tuple(scale_spec)[-1:] != (n_ax,):
        cols = torch.repeat_interleave(scale, n // scale.shape[-1], dim=-1)
        spec = (None,) * (scale.ndim - 1) + (n_ax,)
        return local_block(cols, spec, mesh).clone()
    return _block(scale, scale_spec, mesh)


def _sharded(spec) -> bool:
    return any(ax is not None for ax in spec)


def reshard_tree(tree: PyTree, mesh, spec_tree: Optional[PyTree] = None) -> PyTree:
    """Keep this rank's block of every leaf of ``tree`` under the dist
    rules (``spec_tree`` overrides the derived specs; it mirrors ``tree``).

    A PackedWeight keeps its ``kn_spec`` (annotate it first,
    ``sharding.annotate_packed_specs``) and the whole weight's ``k``, its
    scale cut by :func:`local_scale`; a
    float matmul (a packable leaf name) whose rule shards its trailing
    (K, N) axes becomes a :class:`~repro_torch.core.packing.FloatBlock`,
    the form ``models.common.dense_apply`` stitches.  Other leaves are
    plain blocks (the embedding: the model reads its rule by name)."""
    if spec_tree is None:
        spec_tree = tree_param_specs(tree, mesh)

    def walk(t, s, path=""):
        if isinstance(t, dict):
            return {k: walk(v, s[k], f"{path}/{k}" if path else str(k)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, sv, f"{path}/{i}" if path else str(i))
                           for i, (v, sv) in enumerate(zip(t, s)))
        if isinstance(t, PackedWeight):
            n_ax = tuple(s.sign)[-1] if len(s.sign) else None
            return dataclasses.replace(
                t, planes=_block(t.planes, s.planes, mesh), sign=_block(t.sign, s.sign, mesh),
                scale=local_scale(t.scale, s.scale, n_ax, t.sign.shape[-1], mesh))
        block = _block(t, s, mesh)
        if (isinstance(t, torch.Tensor) and t.ndim >= 2 and _sharded(s)
                and path.rsplit("/", 1)[-1] in PACKABLE_SUFFIXES):
            spec = tuple(s) + (None,) * (t.ndim - len(s))
            return FloatBlock(block, (spec[-2], spec[-1]))
        return block

    return walk(tree, spec_tree)


def validate_batch_divisibility(global_batch: int, mesh) -> bool:
    """True iff the global batch splits evenly over the mesh's DP axes,
    the precondition for running a batch on this mesh."""
    return dp_axes(mesh, global_batch) is not None



