"""Re-quantisation and precision adjustment (paper §3.3): PyTorch port of
``repro.core.requant``.

* ``requantize_static`` — plane tensors keep their allocated ``n_max``
  shape; precision is tracked by the {0,1} plane mask.  Re-binarises the
  continuous planes and recomputes the active [lsb, msb] window per
  group.  Forward-equivalent to the paper's physical resize (Eq. 6)
  because masked planes are exactly zero.
* ``requantize_dynamic`` — paper-faithful: physically strips all-zero
  MSB/LSB planes and rescales ``s' = s * 2^k_lsb * (2^{n'}-1)/(2^n-1)``
  so the represented weights are bit-exact before and after (Eq. 6).

Both re-split the re-quantised integer ``q' = Round[sum wp 2^b] -
Round[sum wn 2^b]`` into fresh positive/negative binary planes.  The
work runs on the rep's device, one plane at a time.

On a mesh a rep holds this rank's block: everything is elementwise but
the per-(bit, group) any-nonzero, a maximum over axes the mesh splits.
:func:`static_nonzero` gives a block's part, :func:`mesh_nonzero` ors the
parts over the mesh (one ``HostMesh.any``) and hands the result to
:func:`requantize_static`, so the masks are the same bits on every rank;
where a rule splits a group axis (the experts' E over "model") each
rank's flags sit at its groups' offsets in the whole group shape, False
elsewhere, before the or.  :func:`requantize_dynamic` takes the mesh for
its whole-tensor test.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .bitrep import (BitRep, _group_broadcast_shape, accumulate_planes, local_groups,
                     splits_groups)


def _requantized_int(rep: BitRep, clamp: bool = True) -> torch.Tensor:
    """``q' = Round[sum_b wp_b 2^b - sum_b wn_b 2^b]`` over active planes.

    Static mode clamps into the allocated-plane window; dynamic mode
    re-decomposes into n+1 bits instead."""
    m = rep.mask.to(rep.wp.dtype)
    acc = accumulate_planes(rep.wp, m) - accumulate_planes(rep.wn, m)
    if clamp:
        limit = 2.0**rep.n_bits - 1.0
        acc = torch.clamp(torch.round(acc), -limit, limit)
    return torch.round(acc).to(torch.int32)


def _split_sign(q: torch.Tensor, n_bits: int, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    mag = torch.abs(q)
    pos = (q > 0).to(dtype)
    neg = (q < 0).to(dtype)
    wp = torch.empty((n_bits,) + tuple(q.shape), dtype=dtype, device=q.device)
    wn = torch.empty_like(wp)
    for b in range(n_bits):
        bit = ((mag >> b) & 1).to(dtype)
        wp[b] = bit * pos
        wn[b] = bit * neg
    return wp, wn


def _any_nonzero_planes(mag: torch.Tensor, n_bits: int, red: Tuple[int, ...]) -> torch.Tensor:
    """``(n_bits, *gbcast)`` bool: does bit b of ``mag`` occur in the group."""
    out = []
    for b in range(n_bits):
        bit = ((mag >> b) & 1).to(torch.uint8)
        out.append((torch.amax(bit, dim=red, keepdim=True) if red else bit) > 0)
    return torch.stack(out)


def _static_nonzero(rep: BitRep, q: torch.Tensor) -> torch.Tensor:
    # per-(bit, group) any-nonzero: a plane of wp + wn is set exactly where
    # that bit of |q| is
    red = tuple(i for i in range(len(rep.w_shape)) if i not in rep.group_axes)
    return _any_nonzero_planes(torch.abs(q), rep.n_bits, red)


def static_nonzero(rep: BitRep) -> torch.Tensor:
    """``(n_bits, *gbcast)`` bool: which bits occur in each group of the
    re-quantised codes of ``rep`` (on a mesh: of this rank's block, the
    rep's mask cut to its groups, ``bitrep.local_groups``)."""
    return _static_nonzero(rep, _requantized_int(rep))


def mesh_nonzero(reps, mesh, specs: Optional[dict] = None) -> dict:
    """:func:`static_nonzero` of every rep's block, or-ed over ``mesh`` in
    one collective: the whole tensors' per-(bit, group) any-nonzero, the
    same bits on every rank, in the shape of each whole mask.  ``reps``
    hold whole masks; ``specs`` maps a name to its weight's spec (None:
    no rule splits a group axis).  Each rank's flags are placed at its
    groups' offsets (False at other ranks' groups), and or-ing a flag that
    copies of a block share changes nothing, so one reduction over the
    whole mesh serves tensors split over any of its axes (a pod's flags
    are a copy of every other pod's)."""
    from ..dist.sharding import group_spec, place_block

    specs = specs or {}
    nzs = {}
    for k, r in reps.items():
        spec = tuple(specs.get(k, ()))
        nz = static_nonzero(local_groups(r, spec, mesh)).to(torch.uint8)
        if splits_groups(r, spec):
            nz = place_block(nz, group_spec(spec, r.group_axes, len(r.w_shape), lead=1),
                             tuple(r.mask.shape), mesh)
        nzs[k] = nz
    if not nzs:
        return nzs
    flat = mesh.any(torch.cat([nz.reshape(-1) for nz in nzs.values()]))
    out, off = {}, 0
    for k, nz in nzs.items():
        out[k] = flat[off:off + nz.numel()].reshape(nz.shape)
        off += nz.numel()
    return out


def requantize_static(rep: BitRep, nz: Optional[torch.Tensor] = None) -> BitRep:
    """Mask-mode re-quantisation + precision adjustment.  ``nz``: the
    whole tensor's :func:`static_nonzero` where ``rep`` is a block (its
    mask the block's groups'); the new mask is ``nz``'s shape."""
    q = _requantized_int(rep)
    wp, wn = _split_sign(q, rep.n_bits, rep.wp.dtype)
    if nz is None:
        nz = _static_nonzero(rep, q)
    nb = rep.n_bits
    idx = torch.arange(nb, device=q.device).reshape((nb,) + (1,) * (nz.ndim - 1))
    any_nz = torch.any(nz, dim=0, keepdim=True)
    msb = torch.amax(torch.where(nz, idx, -1), dim=0, keepdim=True)
    lsb = torch.amin(torch.where(nz, idx, nb), dim=0, keepdim=True)
    # Active window [lsb, msb]; interior all-zero planes stay active
    # (the paper only strips *outer* planes).
    new_mask = ((idx >= lsb) & (idx <= msb) & any_nz).to(rep.mask.dtype)
    return dataclasses.replace(rep, wp=wp, wn=wn, mask=new_mask)


def requantize_dynamic(rep: BitRep, mesh=None) -> BitRep:
    """Paper-faithful physical precision adjustment.

    Strips all-zero MSB planes (the scale shrinks by
    ``(2^{n'}-1)/(2^n-1)``) and all-zero LSB planes (each removal
    doubles the scale), then re-splits signs.  Returns a BitRep whose
    plane count equals the new precision ``n'`` (>= 1: an all-zero tensor
    keeps a single zero plane so the shapes stay valid).  On ``mesh``
    ``rep`` is this rank's block and which bits occur is decided over the
    whole tensor (one ``HostMesh.any``).
    """
    if rep.group_axes:
        raise ValueError(
            "requantize_dynamic physically resizes the plane axis, which must "
            "be uniform across the tensor — it therefore only supports single-"
            "group tensors (group_axes=()), i.e. one BitRep per layer, which "
            "is the paper's setting. Use requantize_static for stacked groups.")
    q = _requantized_int(rep, clamp=False)
    nb = rep.n_bits + 1  # paper: q' needs (n+1) bits
    mag = torch.abs(q)
    occurs = torch.stack([((mag >> b) & 1).any() for b in range(nb)])
    if mesh is not None:
        occurs = mesh.any(occurs)
    nz = [b for b in range(nb) if bool(occurs[b])]
    msb_keep, lsb_drop = (max(nz) + 1, min(nz)) if nz else (0, 0)
    n_new = max(msb_keep - lsb_drop, 1)
    q_shift = ((mag >> lsb_drop) * torch.sign(q)).to(torch.int32)
    wp, wn = _split_sign(q_shift, n_new, rep.wp.dtype)
    old_denom = 2.0**rep.n_denom - 1.0
    new_denom = 2.0**n_new - 1.0
    new_scale = rep.scale * (2.0**lsb_drop) * new_denom / old_denom
    gshape = _group_broadcast_shape(rep.w_shape, rep.group_axes)
    mask = torch.ones((n_new,) + gshape, dtype=rep.mask.dtype, device=rep.mask.device)
    return BitRep(wp=wp, wn=wn, scale=new_scale, mask=mask, n_denom=n_new,
                  group_axes=rep.group_axes)


def grow_headroom(rep: BitRep, n_extra: int = 1) -> BitRep:
    """Append ``n_extra`` zero MSB planes (dynamic mode, before resuming
    training) so carries have room — the paper's n -> n+1 window."""
    def pad(x, value):
        extra = torch.full((n_extra,) + tuple(x.shape[1:]), value, dtype=x.dtype, device=x.device)
        return torch.cat([x, extra])

    return dataclasses.replace(rep, wp=pad(rep.wp, 0.0), wn=pad(rep.wn, 0.0),
                               mask=pad(rep.mask, 1.0))


def forward_value(rep: BitRep) -> torch.Tensor:
    """The ``s * W_q`` the forward STE sees (paper Eq. 3), no gradient."""
    m = rep.mask.to(rep.wp.dtype)
    acc = accumulate_planes(rep.wp, m) - accumulate_planes(rep.wn, m)
    return rep.scale * torch.round(acc) / (2.0**rep.n_denom - 1.0)


def verify_equivalence(before: BitRep, after: BitRep, atol: float = 1e-6) -> bool:
    """Eq. 6: the forward-pass weights are identical across an adjustment."""
    return bool(torch.max(torch.abs(forward_value(before) - forward_value(after))) <= atol)
