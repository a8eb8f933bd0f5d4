"""Placing a tree on a mesh: ``repro.dist.elastic``.

Checkpoints and param draws hold whole (unsharded) tensors, so placing a
tree on a mesh is cutting: compute each leaf's spec from the same
name/shape rules (:mod:`repro_torch.dist.sharding`) and keep this rank's
block.  Values are untouched.  :func:`gather_tree` is the inverse, so a
train state saved from one mesh restores on another (elastic resume,
``ckpt.checkpoint.restore(mesh=)``) bit for bit.

A train state (a dict with a ``"step"``) keeps plain blocks for every
leaf, its planes and moments included: the train step builds the
forward's weights itself.  Its specs are the rules' on the whole shapes
(:func:`train_state_specs`), except a compressed data-parallel state
(one with a ``"residual"``), whose leaves are whole on every rank but
the residual, split over "data" on its leading shard axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ..core.packing import (PACKABLE_SUFFIXES, RECURRENT_MATRICES, FloatBlock, PackedWeight,
                            RowsBlock)
from ..tree import flatten_with_path, unflatten_like
from .sharding import (P, _canonical, _map_with_path, axis_index, dp_axes, local_block,
                       tree_param_specs)

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


class _Shape:
    """A stand-in leaf with a whole tensor's shape, for the rules."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def is_train_state(tree) -> bool:
    return isinstance(tree, dict) and "step" in tree


def _whole_shapes(state: PyTree, template: PyTree, mesh) -> PyTree:
    """``state`` (this rank's blocks) with each leaf replaced by a stand-in
    of the whole leaf's shape, read off ``template`` (the model's param
    tree of whole shapes, ``BSQTrainContext.template``) by name: planes
    are a plane axis in front of their weight, a float leaf, moment or
    param its own whole shape; rep scales, masks and counters are whole
    on every rank already."""
    whole = {n: tuple(x.shape) for n, x in flatten_with_path(template)}

    def shape(name, leaf):
        segs = _canonical(name)
        local = tuple(leaf.shape)
        if name.startswith("masks/") or not segs:
            return _Shape(local)
        if segs[-1] in ("wp", "wn") and "/".join(segs[:-1]) in whole:
            return _Shape(local[:1] + whole["/".join(segs[:-1])])
        key = "/".join(segs)
        if key in whole:
            return _Shape(local[:len(local) - len(whole[key])] + whole[key])
        return _Shape(local)

    return _map_with_path(shape, state)


def train_state_specs(state: PyTree, mesh, template: Optional[PyTree] = None) -> PyTree:
    """The spec of every leaf of a train state on ``mesh``: of a whole state
    (``template`` None), or of this rank's blocks of one, whose whole shapes
    ``template`` gives (:func:`_whole_shapes`).  The masks are whole on
    every rank (the experts' too, whose planes split E over "model").  A
    compressed data-parallel state: every leaf whole, ``residual`` over
    "data" on its shard axis."""
    if "residual" in state:
        return {k: _map_with_path(lambda _n, _l, k=k: P("data") if k == "residual" else P(), v)
                for k, v in state.items()}
    like = state if template is None else _whole_shapes(state, template, mesh)
    specs = tree_param_specs(like, mesh)
    if "masks" in like:  # whole on every rank, whatever the weight's rule says
        specs["masks"] = _map_with_path(lambda _n, _l: P(), like["masks"])
    return specs


def specs_for_shapes(tree_like: PyTree, shapes: Dict[str, Tuple[int, ...]], mesh) -> dict:
    """name -> spec of every leaf of ``tree_like`` on ``mesh``, from the whole
    shapes ``shapes`` gives by name (a checkpoint's manifest): the rules of
    :func:`reshard_tree` for that tree."""
    from .sharding import flatten_specs

    whole = unflatten_like(tree_like, {n: _Shape(shapes[n])
                                       for n, _ in flatten_with_path(tree_like)})
    specs = train_state_specs(whole, mesh) if is_train_state(whole) else \
        tree_param_specs(whole, mesh)
    return dict(flatten_specs(specs))


def gather_tree(tree: PyTree, mesh, spec_tree: PyTree) -> PyTree:
    """The whole tensors of a tree of this rank's blocks (every rank gets
    them): the inverse of :func:`reshard_tree` under the same specs.  Call
    it on every rank: each leaf is one collective or more."""
    from .sharding import flatten_specs

    specs = dict(flatten_specs(spec_tree))
    return unflatten_like(tree, {n: mesh.gather_block(x, specs[n]) if isinstance(x, torch.Tensor)
                                 else x for n, x in flatten_with_path(tree)})


# Float matrices the model runs through ``models.common.dense_apply``: the
# packable projections, the recurrent mixers' matrices and the MoE router.
_STITCHED = frozenset(PACKABLE_SUFFIXES) | RECURRENT_MATRICES | {"router"}


def _stitched(path: str) -> bool:
    """Whether a float leaf is a (K, N) matmul ``dense_apply`` stitches.  The
    stacked MoE experts are not: their expert axis splits over "model",
    and ``models.moe`` runs each rank's experts on their blocks itself."""
    segs = path.split("/")
    expert = "moe" in segs and "shared" not in segs and segs[-1] in ("w_gate", "w_up",
                                                                     "w_down")
    return segs[-1] in _STITCHED and not expert


def placed_leaf(path: str, block, spec, mesh):
    """The form in which the model reads this rank's block of a float leaf
    (its model-param ``path``) under ``spec``: the one rule of serving
    (:func:`reshard_tree`) and of the training forward
    (``train.step._forward_leaf``, on the training view).  A matmul
    ``dense_apply`` stitches (a packable projection, a recurrent mixer's
    matrix, the MoE router) whose rule shards it becomes a
    :class:`~repro_torch.core.packing.FloatBlock`; a stacked vector whose
    rule splits it (RG-LRU's ``b_rgate``/``b_igate``) a
    :class:`~repro_torch.core.packing.RowsBlock` from its first layer on
    ``mesh``; anything else (the embedding, the MoE experts: the model
    reads their rules by name) stays the plain block."""
    if not (isinstance(block, torch.Tensor) and block.ndim >= 2 and _sharded(spec)):
        return block
    spec = tuple(spec) + (None,) * (block.ndim - len(spec))
    if _stitched(path):
        return FloatBlock(block, (spec[-2], spec[-1]))
    if block.ndim == 2 and path.startswith("blocks/"):
        return RowsBlock(block, axis_index(mesh, spec[0]) * block.shape[0], spec)
    return block


def reshard_tree(tree: PyTree, mesh, spec_tree: Optional[PyTree] = None) -> PyTree:
    """Keep this rank's block of every leaf of ``tree`` under the dist
    rules (``spec_tree`` overrides the derived specs; it mirrors ``tree``).

    A PackedWeight keeps its ``kn_spec`` (annotate it first,
    ``sharding.annotate_packed_specs``) and the whole weight's ``k``, its
    scale cut by :func:`local_scale`; a float leaf takes the form
    :func:`placed_leaf` gives it; every leaf of a train state
    (:func:`is_train_state`), whose specs default to
    :func:`train_state_specs`, is a plain block (the train step places
    them itself)."""
    train = is_train_state(tree)
    if spec_tree is None:
        spec_tree = train_state_specs(tree, mesh) if train else tree_param_specs(tree, mesh)

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
        return block if train else placed_leaf(path, block, s, mesh)

    return walk(tree, spec_tree)


def validate_batch_divisibility(global_batch: int, mesh) -> bool:
    """True iff the global batch splits evenly over the mesh's DP axes,
    the precondition for running a batch on this mesh."""
    return dp_axes(mesh, global_batch) is not None



