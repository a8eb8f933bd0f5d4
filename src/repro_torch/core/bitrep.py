"""Bit-plane representation of weight tensors (paper Eq. 2): PyTorch port
of ``repro.core.bitrep``.

A float tensor ``W`` is factored as::

    W = s * Round[ sum_b (Wp^(b) - Wn^(b)) 2^b ] / (2^n - 1)

where ``Wp^(b)``/``Wn^(b)`` are the b-th bit-planes of the positive /
negative magnitudes and ``s`` is a per-group scale.  Plane tensors carry
the bit axis FIRST: ``planes.shape == (n_bits, *w.shape)``, f32.

Groups are "group axes" of the weight tensor (the leading layer axis of
a stacked ``(L, d_in, d_out)`` kernel, or none for one group per
tensor); the scale has the group-broadcast shape.

The plane loops below run one plane at a time, so a full-width tensor
never holds an ``(n_bits, *w_shape)`` integer temporary besides its
planes; the values are those of the JAX package's whole-tensor
expressions, summed in the same order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch


def _group_broadcast_shape(w_shape: Tuple[int, ...], group_axes: Tuple[int, ...]) -> Tuple[int, ...]:
    """Shape that broadcasts a per-group quantity against ``w_shape``."""
    return tuple(w_shape[i] if i in group_axes else 1 for i in range(len(w_shape)))


def _reduce_axes(w_ndim: int, group_axes: Tuple[int, ...]) -> Tuple[int, ...]:
    return tuple(i for i in range(w_ndim) if i not in group_axes)


def _amax_keepdim(x: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    """``jnp.max(x, axis=dims, keepdims=True)``; over no axes it is ``x``
    (``torch.amax`` reads ``dim=()`` as every axis)."""
    return torch.amax(x, dim=dims, keepdim=True) if dims else x


@dataclasses.dataclass
class BitRep:
    """Trainable bit representation of one (possibly stacked) weight tensor.

    Attributes:
      wp / wn: ``(n_bits, *w_shape)`` float planes, constrained to [0, 2].
      scale:   per-group scale, shape broadcastable to ``w_shape``.
      mask:    ``(n_bits, *group_bcast_shape)`` {0,1} active-plane mask.
      n_denom: the ``n`` in the ``1/(2^n - 1)`` denominator.
      group_axes: axes of ``w_shape`` that index groups.
    """

    wp: torch.Tensor
    wn: torch.Tensor
    scale: torch.Tensor
    mask: torch.Tensor
    n_denom: int
    group_axes: Tuple[int, ...]

    @property
    def n_bits(self) -> int:
        return self.wp.shape[0]

    @property
    def w_shape(self) -> Tuple[int, ...]:
        return tuple(self.wp.shape[1:])

    def trainable(self):
        """The leaves the optimiser should update."""
        return {"wp": self.wp, "wn": self.wn, "scale": self.scale}


def extract_scale(w: torch.Tensor, group_axes: Sequence[int]) -> torch.Tensor:
    """Per-group dynamic range ``s = max |w|`` (paper §3.1), broadcastable."""
    s = _amax_keepdim(torch.abs(w), _reduce_axes(w.ndim, tuple(group_axes)))
    # Guard all-zero groups: scale 1 keeps the representation well-defined.
    return torch.where(s == 0, torch.ones_like(s), s)


def int_to_planes(q: torch.Tensor, n_bits: int, dtype=torch.float32) -> torch.Tensor:
    """Decompose a non-negative integer tensor into ``(n_bits, *shape)`` {0,1} planes."""
    q = q.to(torch.int32)
    out = torch.empty((n_bits,) + tuple(q.shape), dtype=dtype, device=q.device)
    for b in range(n_bits):
        out[b] = (q >> b) & 1
    return out


def planes_to_int(planes: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact inverse of :func:`int_to_planes` for binary planes;
    ``mask`` multiplies each plane first (``planes_to_int(planes * mask)``
    without the plane-sized product)."""
    q = torch.zeros(planes.shape[1:], dtype=torch.int32, device=planes.device)
    for b in range(planes.shape[0]):
        p = planes[b] if mask is None else planes[b] * mask[b]
        q += torch.round(p).to(torch.int32) * (2**b)
    return q


def accumulate_planes(planes: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sum_b planes[b] * 2^b`` for continuous planes (no rounding), in
    plane order; ``mask`` multiplies each plane first."""
    acc = None
    for b in range(planes.shape[0]):
        t = planes[b] if mask is None else planes[b] * mask[b]
        t = t * (2.0**b)
        acc = t if acc is None else acc + t
    return acc


def decompose(
    w: torch.Tensor,
    n_bits: int,
    group_axes: Sequence[int] = (),
    n_max: Optional[int] = None,
    dtype=torch.float32,
    scale: Optional[torch.Tensor] = None,
) -> BitRep:
    """Convert a float tensor to its bit representation (paper Fig. 1a).

    Scale extraction -> |.| quantisation to ``n_bits`` levels -> binary
    decomposition, with the sign split into Wp/Wn.  ``n_max`` (default
    ``n_bits + 1``) planes are allocated so precision adjustment has one
    bit of MSB headroom (paper §3.3); the headroom planes start masked.
    ``scale``: the whole tensor's per-group scale where ``w`` is a block
    of it (on a mesh; every other step is elementwise).
    """
    group_axes = tuple(group_axes)
    if n_max is None:
        n_max = n_bits + 1
    w = w.to(dtype)
    s = extract_scale(w, group_axes) if scale is None else scale
    levels = 2**n_bits - 1
    q = torch.round(torch.abs(w / s) * levels).to(torch.int32)  # in [0, levels]
    pos = (w >= 0).to(dtype)
    neg = 1.0 - pos
    wp = torch.empty((n_max,) + tuple(w.shape), dtype=dtype, device=w.device)
    wn = torch.empty_like(wp)
    for b in range(n_max):
        bit = ((q >> b) & 1).to(dtype)
        wp[b] = bit * pos
        wn[b] = bit * neg
    gshape = _group_broadcast_shape(tuple(w.shape), group_axes)
    mask = torch.ones((n_max,) + gshape, dtype=dtype, device=w.device)
    if n_max > n_bits:
        mask[n_bits:] = 0.0
    return BitRep(wp=wp, wn=wn, scale=s, mask=mask, n_denom=n_bits, group_axes=group_axes)


def reconstruct_exact(rep: BitRep) -> torch.Tensor:
    """Exact float weights from *binary* planes (no STE): ``s * q / (2^n - 1)``."""
    m = rep.mask.to(rep.wp.dtype)
    q = (planes_to_int(rep.wp, m) - planes_to_int(rep.wn, m)).to(rep.scale.dtype)
    return rep.scale * q / (2.0**rep.n_denom - 1.0)


def effective_bits(rep: BitRep) -> torch.Tensor:
    """Active precision per group from the mask: ``msb_idx - lsb_idx + 1``
    (int32 of the group-broadcast shape, 0 for all-masked groups).
    Interior all-zero planes still count (the paper only strips outer
    planes)."""
    m = rep.mask
    nb = m.shape[0]
    idx = torch.arange(nb, device=m.device).reshape((nb,) + (1,) * (m.ndim - 1))
    active = m > 0
    any_active = torch.any(active, dim=0)
    msb = torch.amax(torch.where(active, idx, -1), dim=0)
    lsb = torch.amin(torch.where(active, idx, nb), dim=0)
    return torch.where(any_active, msb - lsb + 1, 0).to(torch.int32)


def group_shape(rep: BitRep) -> Tuple[int, ...]:
    """The whole tensor's groups, in group-axis order, read off the mask
    (whole on every mesh rank, where the planes may be a block)."""
    return tuple(rep.mask.shape[1 + i] for i in sorted(rep.group_axes))


def splits_groups(rep: BitRep, spec) -> bool:
    """Whether the weight spec ``spec`` splits a group axis of ``rep``."""
    return any(i < len(spec) and spec[i] is not None for i in rep.group_axes)


def local_groups(rep: BitRep, spec, mesh, scale: Optional[torch.Tensor] = None) -> BitRep:
    """``rep`` (this rank's planes under its weight's ``spec``; scale and
    mask whole) with the scale (``scale`` in its place where given) and
    the mask cut to the groups its planes hold: the rep of the block.
    ``rep`` itself where ``spec`` splits no group axis."""
    scale = rep.scale if scale is None else scale
    if not splits_groups(rep, spec):
        return dataclasses.replace(rep, scale=scale)
    from ..dist.sharding import group_spec, local_block

    nd = len(rep.w_shape)
    return dataclasses.replace(
        rep, scale=local_block(scale, group_spec(spec, rep.group_axes, nd), mesh),
        mask=local_block(rep.mask, group_spec(spec, rep.group_axes, nd, lead=1), mesh))


def numel_per_group(rep: BitRep) -> int:
    """Weight elements represented by each group."""
    return math.prod(d for i, d in enumerate(rep.w_shape) if i not in rep.group_axes)


def num_groups(rep: BitRep) -> int:
    return math.prod(rep.w_shape[i] for i in rep.group_axes)


def total_numel(rep: BitRep) -> int:
    return math.prod(rep.w_shape)
