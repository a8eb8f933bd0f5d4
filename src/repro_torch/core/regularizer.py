"""Bit-level group Lasso regulariser with memory-aware reweighing:
PyTorch port of ``repro.core.regularizer``.

Paper Eq. 4:  B_GL(W^g) = sum_b || [Wp^(b); Wn^(b)] ||_2
Paper Eq. 5:  L = L_CE + alpha * sum_l  (#Para_l * #Bit_l / #Para_total) * B_GL(W^l)

Norms are taken per (bit, group) over all non-group weight axes; masked
(inactive) planes contribute nothing.  The per-(bit, group) sums of
squares of every tensor's ``wp`` and ``wn`` go through one
``kernels.ops.bgl_sumsq_grouped`` call per evaluation: one launch of the
hand-written kernel on the card (and one of its backward), the plain
version on the CPU (the JAX package's regulariser computes the same sums
in jnp, ``sum wp^2 + sum wn^2``).

On a ("data", "model") mesh each rank holds its block of every plane
tensor.  Its one grouped call runs on the rows of its own blocks; where a
rule splits a group axis (the stacked experts' E over "model") a
tensor's rows are placed at their groups' offsets in the whole tensor's
(bit, group) rows, zeros at the other ranks' groups
(``dist.sharding.place_block``).  One ``all_reduce`` over the mesh (a
``HostMesh.all_reduce`` with ``keep``, whose backward is the identity)
sums the flat partial sums before any square root: a tensor's rows count
on every rank that holds a distinct block of it and on one rank of each
axis it is whole along (``dist.sharding.counted_once``).  Every rank then
holds the whole tensors' per-group sums, so the per-group epilogue is the
same on every rank and equals one process's; its weights take the whole
tensor's elements per group.  The backward is the kernel's on the local
rows, fed this rank's slice of the upstream gradient.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from ..kernels import ops
from .bitrep import (BitRep, effective_bits, group_shape, numel_per_group, splits_groups,
                     total_numel)

_EPS = 1e-12


def _rows(planes: torch.Tensor, group_axes) -> torch.Tensor:
    """``(n_bits * n_groups, rest)`` view of an ``(n_bits, *w_shape)``
    plane tensor, rows ordered (bit, group).  Free for leading group axes
    (the default); other group axes are moved to the front (a copy)."""
    ga = sorted(group_axes)
    if ga != list(range(len(ga))):
        planes = torch.movedim(planes, [a + 1 for a in ga], list(range(1, len(ga) + 1)))
    n_groups = math.prod(planes.shape[1:1 + len(ga)])
    return planes.reshape(planes.shape[0] * n_groups, -1)


def _sumsq(reps: List[BitRep], mesh=None, keep: Optional[List[float]] = None,
           specs: Optional[List] = None) -> Tuple[torch.Tensor, ...]:
    """Per tensor, ``sum wp^2 + sum wn^2`` per (bit, group), flat in (bit,
    group) order: one grouped call over ``[wp_1 .. wp_n, wn_1 .. wn_n]``,
    its two halves added in one op, split per tensor.  With ``keep`` the
    rows are this rank's blocks' (under the weight specs ``specs``), each
    placed in its tensor's whole (bit, group) rows and summed over
    ``mesh`` in one collective with tensor i's rows counted where
    ``keep[i]`` is 1."""
    wp = [_rows(r.wp, r.group_axes) for r in reps]
    wn = [_rows(r.wn, r.group_axes) for r in reps]
    flat = ops.bgl_sumsq_grouped(wp + wn)
    half = flat.shape[0] // 2
    sqs = torch.split(flat[:half] + flat[half:], [x.shape[0] for x in wp])
    if keep is None:
        return sqs
    sqs = [_placed(sq, r, spec, mesh) for sq, r, spec in zip(sqs, reps, specs)]
    k = torch.cat([torch.full((sq.shape[0],), float(c), device=flat.device)
                   for sq, c in zip(sqs, keep)])
    whole = mesh.all_reduce(torch.cat(sqs), tuple(mesh.shape), keep=k)
    return torch.split(whole, [sq.shape[0] for sq in sqs])


def _placed(sq: torch.Tensor, rep: BitRep, spec, mesh) -> torch.Tensor:
    """A block's flat (bit, group) sums in its tensor's whole rows, zeros
    at the groups other ranks hold; ``sq`` itself where ``spec`` splits
    no group axis."""
    if not splits_groups(rep, spec):
        return sq
    from ..dist.sharding import P, place_block

    ga = sorted(rep.group_axes)
    local = tuple(rep.w_shape[i] for i in ga)
    block_spec = P(None, *(spec[i] if i < len(spec) else None for i in ga))
    return place_block(sq.reshape((rep.n_bits,) + local), block_spec,
                       (rep.n_bits,) + group_shape(rep), mesh).reshape(-1)


def _norms(rep: BitRep, sq: torch.Tensor) -> torch.Tensor:
    gshape = group_shape(rep)
    sq = sq.reshape((rep.n_bits,) + gshape)
    mask = rep.mask.reshape((rep.n_bits,) + gshape)
    return torch.sqrt(sq + _EPS) * mask.to(sq.dtype)


def bit_group_norms(rep: BitRep) -> torch.Tensor:
    """L2 norm of ``[wp_b; wn_b]`` per (bit, group): shape ``(n_bits, *group_shape)``."""
    return _norms(rep, _sumsq([rep])[0])


def bgl(rep: BitRep) -> torch.Tensor:
    """B_GL per group (Eq. 4): sum of per-bit norms. Shape ``group_shape``."""
    return torch.sum(bit_group_norms(rep), dim=0)


def memory_reweighed_bgl(
    reps: Dict[str, BitRep],
    total_params: Optional[int] = None,
    reweigh: bool = True,
    mesh=None,
    specs: Optional[Dict] = None,
    group_numel: Optional[Dict[str, int]] = None,
) -> torch.Tensor:
    """Eq. 5 regulariser over a dict of bit representations.

    ``#Bit`` per group comes from the *current* active mask (updated at
    every re-quantisation, constant in between), detached.  With
    ``reweigh=False`` it is the plain sum of B_GL terms (the Fig. 2
    ablation baseline).  The sums of squares of every tensor are one
    grouped call; the per-tensor epilogue follows.

    On ``mesh`` (more than one rank; a 1x1 mesh is the identity) each rep
    holds this rank's block and ``specs`` maps each name to its weight's
    spec; ``group_numel`` maps each name to the whole tensor's elements per
    group (the module docstring).
    """
    if total_params is None:
        total_params = sum(total_numel(r) for r in reps.values())
    if not reps:
        return torch.zeros((), dtype=torch.float32)
    keep = wspecs = None
    if mesh is not None and mesh.size() > 1:
        from ..dist.sharding import counted_once

        wspecs = [tuple(specs[k]) for k in reps]
        keep = [counted_once(s, mesh) for s in wspecs]
    sqs = _sumsq(list(reps.values()), mesh, keep, wspecs)
    total = torch.zeros((), dtype=torch.float32, device=sqs[0].device)
    for (name, r), sq in zip(reps.items(), sqs):
        g = torch.sum(_norms(r, sq), dim=0).to(torch.float32)  # (group_shape)
        if reweigh:
            n_el = numel_per_group(r) if group_numel is None else group_numel[name]
            # group-broadcast shape, as in the JAX code: against the
            # group-shaped norms of a stacked tensor it broadcasts to every
            # (i, j) pair of groups (ROADMAP queue 3); kept for parity
            bits = effective_bits(r).detach().to(torch.float32)
            weight = (n_el * bits) / float(total_params)
            total = total + torch.sum(weight * g)
        else:
            total = total + torch.sum(g)
    return total


def scheme_summary(reps: Dict[str, BitRep]) -> Dict[str, torch.Tensor]:
    """Per-tensor active precision (group-shaped int tensors) for logging."""
    return {name: effective_bits(r) for name, r in reps.items()}
