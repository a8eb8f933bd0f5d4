"""End-to-end BSQ API: attach bit representations to a model's params.
PyTorch port of ``repro.core.bsq``.

Usage pattern (what ``train/step.py`` does)::

    qp, fp = partition_params(params, predicate)          # split the tree
    reps   = init_bitreps(qp, BSQConfig(n_init=8))
    w      = reconstruct(reps, cfg)                       # STE forward, trainable
    loss   = task_loss(merge_params(template, w, fp), batch) \\
             + cfg.alpha * memory_reweighed_bgl(reps, total)
    reps   = requantize_tree(reps, mode="static")         # every K steps
    scheme = scheme_from_reps(reps)                       # final scheme
    packed = export_packed(reps)                          # serving artefact

``reps`` is a flat dict name -> BitRep; names are the "/"-joined tree
paths of the JAX package, in its flatten order (sorted dict keys).
On a mesh, :func:`export_packed_sharded` packs only this rank's slice of
whole reps, and :func:`export_packed_blocks` packs the blocks of a state
trained on the mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import tree as tree_util
from . import packing
from .bitrep import (BitRep, _group_broadcast_shape, decompose, extract_scale, local_groups,
                     planes_to_int, splits_groups, total_numel)
from .regularizer import memory_reweighed_bgl
from .requant import mesh_nonzero, requantize_dynamic, requantize_static
from .scheme import QuantScheme, scheme_from_reps
from .ste import bitrep_forward


@dataclasses.dataclass(frozen=True)
class BSQConfig:
    n_init: int = 8  # initial precision (paper: 8 for CIFAR, 6/8 for ImageNet)
    n_max: Optional[int] = None  # allocated planes; default n_init + 1 (MSB headroom)
    alpha: float = 5e-3  # regularisation strength — THE hyperparameter
    reweigh: bool = True  # memory-aware reweighing (Eq. 5); False = Fig. 2 ablation
    mode: str = "static"  # "static" (mask) | "dynamic" (paper resize)
    trainable_scale: bool = True
    compute_dtype: torch.dtype = torch.bfloat16  # dtype of reconstructed weights

    @property
    def planes(self) -> int:
        return self.n_max if self.n_max is not None else self.n_init + 1


# --------------------------------------------------------------------------
# Param-tree partitioning
# --------------------------------------------------------------------------


def default_quant_predicate(path: str, x) -> bool:
    """Quantise matmul-like weights; keep norms/biases/scalars float
    (norm scales, RoPE, PACT alphas, SSM recurrence scalars stay float)."""
    if x.ndim < 2:
        return False
    name = path.lower()
    banned = ("norm", "rope", "pact", "a_log", "dt_bias", "lambda", "pos_emb",
              # stacking makes 1-D recurrence params 2-D, so the ndim check
              # alone does not exclude them
              "conv_w", "conv_b", "d_skip", "bias", "router")
    return not any(b in name for b in banned)


def partition_params(
    params, predicate: Callable[[str, torch.Tensor], bool] = default_quant_predicate
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Split a param tree into (to-quantise, keep-float) flat dicts keyed by path."""
    qp, fp = {}, {}
    for name, leaf in tree_util.flatten_with_path(params):
        (qp if predicate(name, leaf) else fp)[name] = leaf
    return qp, fp


def merge_params(template, quantized: Dict[str, torch.Tensor], floats: Dict[str, torch.Tensor]):
    """Rebuild the template's tree structure from the two flat dicts."""
    return tree_util.unflatten_like(template, {**floats, **quantized})


# --------------------------------------------------------------------------
# BSQ over a dict of tensors
# --------------------------------------------------------------------------


def default_group_axes(name: str, w: torch.Tensor) -> Tuple[int, ...]:
    """Layer-wise groups: for stacked (L, ...) tensors the leading axis
    indexes layers (both leading axes for stacked experts): group over
    all leading axes until <= 2 trailing matmul dims remain."""
    if w.ndim <= 2:
        return ()
    return tuple(range(w.ndim - 2))


def init_bitreps(
    qparams: Dict[str, torch.Tensor],
    cfg: BSQConfig,
    group_axes_fn: Callable[[str, torch.Tensor], Tuple[int, ...]] = default_group_axes,
    mesh=None,
) -> Dict[str, BitRep]:
    """Each weight's bit representation.  On ``mesh`` each rep is this
    rank's block of the whole weight's (its rule's ``local_block``): the
    scale and the mask are the whole weight's, the planes are decomposed
    on the block only (by the scales of its groups), so no rank holds a
    whole tensor's planes."""
    reps = {}
    for name, w in qparams.items():
        ga = group_axes_fn(name, w)
        n_max = cfg.planes if cfg.mode == "static" else cfg.n_init
        if mesh is None:
            reps[name] = decompose(w, cfg.n_init, group_axes=ga, n_max=n_max)
            continue
        from ..dist.sharding import group_spec, local_block, param_spec

        spec = param_spec(name, tuple(w.shape), mesh)
        scale = extract_scale(w.to(torch.float32), ga)
        r = decompose(local_block(w, spec, mesh), cfg.n_init, group_axes=ga, n_max=n_max,
                      scale=local_block(scale, group_spec(spec, ga, w.ndim), mesh))
        mask = torch.ones((n_max,) + _group_broadcast_shape(tuple(w.shape), ga),
                          dtype=r.mask.dtype, device=r.mask.device)
        mask[cfg.n_init:] = 0.0  # the headroom planes start masked, as decompose's
        reps[name] = dataclasses.replace(r, scale=scale, mask=mask)
    return reps


def reconstruct(reps: Dict[str, BitRep], cfg: BSQConfig, mesh=None,
                specs: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """STE forward for every rep -> float weights dict (paper Eq. 3).  On
    ``mesh`` each rep is this rank's block under its weight's spec in
    ``specs``: the scale, whole on every rank, enters with its gradient
    summed over the axes that split the weight, and its groups that the
    block holds scale the block (``bitrep.local_groups``: the rank's
    experts' scales and masks, where "model" splits the expert axis), so
    its gradient comes back whole on every rank."""
    from ..dist.sharding import spec_axes

    out = {}
    for name, r in reps.items():
        scale = r.scale if cfg.trainable_scale else r.scale.detach()
        if mesh is not None:
            spec = specs.get(name, ())
            r = local_groups(r, spec, mesh, mesh.enter(scale, spec_axes(spec)))
            scale = r.scale
        w = bitrep_forward(r.wp, r.wn, scale, r.mask, r.n_denom)
        out[name] = w.to(cfg.compute_dtype)
    return out


def regularizer(reps: Dict[str, BitRep], cfg: BSQConfig, total_params: Optional[int] = None,
                mesh=None, specs: Optional[Dict] = None,
                group_numel: Optional[Dict[str, int]] = None):
    """Eq. 5's regulariser; ``mesh``, ``specs``, ``group_numel`` as
    :func:`~repro_torch.core.regularizer.memory_reweighed_bgl` takes them."""
    return memory_reweighed_bgl(reps, total_params=total_params, reweigh=cfg.reweigh,
                                mesh=mesh, specs=specs, group_numel=group_numel)


def requantize_tree(reps: Dict[str, BitRep], mode: str = "static", mesh=None
                    ) -> Dict[str, BitRep]:
    """Re-quantise every rep.  ``mesh`` (dynamic mode): each rep is this
    rank's block and the whole-tensor test is or-ed over the mesh.  The
    static mode on a mesh is ``train.step.make_requant_step``'s, which
    writes each rank's blocks in place."""
    if mode == "static":
        if mesh is not None:
            raise NotImplementedError("static requant on a mesh: train.step.make_requant_step")
        return {k: requantize_static(r) for k, r in reps.items()}
    return {k: requantize_dynamic(r, mesh) for k, r in reps.items()}


def extract_scheme(reps: Dict[str, BitRep], float_params: int = 0,
                   group_numel: Optional[Dict[str, int]] = None) -> QuantScheme:
    return scheme_from_reps(reps, float_params=float_params, group_numel=group_numel)


def total_quantized_params(reps: Dict[str, BitRep]) -> int:
    return sum(total_numel(r) for r in reps.values())


# --------------------------------------------------------------------------
# Export for serving
# --------------------------------------------------------------------------


def _export_codes(r: BitRep, nz=None, mesh=None):
    """Export arithmetic: ``(q_shift, n_bits, scale)``.

    The integer codes shifted into the whole-tensor ``[lsb, msb]`` window
    (int32, on the rep's device), the packed precision, and the PER-GROUP
    scale (group-broadcast shape, f32) updated exactly as in the dynamic
    precision adjustment, in float64 as the JAX package computes it::

        scale'_g * q' / (2^{n'} - 1)  ==  s_g * q / (2^{n_denom} - 1)

    On ``mesh`` ``r`` is this rank's block, ``nz`` the whole tensor's
    ``requant.mesh_nonzero``, and which bits occur is or-ed over the mesh:
    the window is the whole tensor's, the codes this block's.
    """
    r2 = requantize_static(r, nz)  # binary planes and a fresh mask
    m = r2.mask.to(r2.wp.dtype)
    q = planes_to_int(r2.wp, m) - planes_to_int(r2.wn, m)
    mag = torch.abs(q)
    occurs = torch.stack([((mag >> b) & 1).any() for b in range(r2.n_bits)])
    if mesh is not None:
        occurs = mesh.any(occurs)
    nz = [b for b in range(r2.n_bits) if bool(occurs[b])]
    lsb, msb = (min(nz), max(nz)) if nz else (0, 0)
    n_bits = msb - lsb + 1
    q_shift = ((mag >> lsb) * torch.sign(q)).to(torch.int32)
    s = r2.scale.to(torch.float64)
    scale = s * (2.0**lsb) * (2.0**n_bits - 1.0) / (2.0**r2.n_denom - 1.0)
    if scale.shape[-2] != 1:
        raise NotImplementedError(
            f"per-K-row scale groups (shape {tuple(scale.shape)}) have no packed row "
            "form; regroup over leading/output axes")
    return q_shift, n_bits, scale.to(torch.float32)


def _pack_grouped(q: torch.Tensor, scale: torch.Tensor, n_bits: int) -> packing.PackedWeight:
    """Pack codes ``q`` (..., K, N) with a per-group ``scale`` (group-
    broadcast shape, q's ndim) into one PackedWeight.

    2D tensors pack directly; stacked tensors keep their leading axes, the
    scale broadcast to ``lead + (1, G)``.  Byte-aligned stacks
    (K % 8 == 0) pack every slice in one pass (slice byte boundaries
    coincide with stack boundaries); ragged K packs slice by slice."""
    if q.ndim == 2:
        return packing.pack_quantized(q, scale, n_bits)
    lead = tuple(q.shape[:-2])
    K, N = q.shape[-2:]
    sc = scale.expand(lead + tuple(scale.shape[-2:])).contiguous()
    if K % 8 == 0:
        flat = packing.pack_quantized(q.reshape(-1, N), 1.0, n_bits)
        planes = torch.movedim(flat.planes.reshape((n_bits,) + lead + (K // 8, N)), 0, -3)
        return packing.PackedWeight(planes=planes.contiguous(),
                                    sign=flat.sign.reshape(lead + (K // 8, N)),
                                    scale=sc, n_bits=n_bits, k=K)
    sf = sc.reshape((-1,) + tuple(sc.shape[-2:]))
    qf = q.reshape((-1, K, N))
    packs = [packing.pack_quantized(qf[i], sf[i], n_bits) for i in range(qf.shape[0])]
    planes = torch.stack([p.planes for p in packs]).reshape(lead + tuple(packs[0].planes.shape))
    sign = torch.stack([p.sign for p in packs]).reshape(lead + tuple(packs[0].sign.shape))
    return packing.PackedWeight(planes=planes, sign=sign, scale=sc, n_bits=n_bits, k=K)


def export_packed(reps: Dict[str, BitRep]) -> Dict[str, packing.PackedWeight]:
    """Freeze each rep to a PackedWeight — exact by construction, and
    byte-identical to the JAX package's ``export_packed`` on the same reps.

    One static precision per tensor (the whole-tensor ``[lsb, msb]``
    window); the per-group scales ride along as the PackedWeight's scale
    (a ``(1, G)`` row for output-axis groups; ``lead + (1, G)`` per-slice
    rows for stacked tensors).  The layout is ``docs/packed_format.md``.
    """
    out = {}
    for name, r in reps.items():
        q_shift, n_bits, scale = _export_codes(r)
        out[name] = _pack_grouped(q_shift, scale, n_bits)
    return out


def export_packed_sharded(reps: Dict[str, BitRep], mesh) -> Dict[str, packing.PackedWeight]:
    """Shard-aware packed export: this rank packs only its own slice of
    each rep's integer codes.

    The layouts come from the dist rules (``dist.sharding.param_spec`` on
    the ``.../sign`` and ``.../scale`` leaf names).  The ``[lsb, msb]``
    window is global per tensor and packing is elementwise along
    byte-aligned K rows, so slice-then-pack equals pack-then-slice: each
    rank's planes, sign and scale are the block of :func:`export_packed`'s
    that the rules give it (a scale row the N shards do not divide is
    held per column, ``dist.elastic.local_scale``).  Returns this rank's
    PackedWeights, the whole tensor's ``k`` and ``kn_spec`` set."""
    from ..dist.elastic import local_scale
    from ..dist.sharding import local_block, param_spec

    out = {}
    for name, r in reps.items():
        q_shift, n_bits, scale = _export_codes(r)
        lead = tuple(q_shift.shape[:-2])
        K, N = q_shift.shape[-2:]
        qp = torch.nn.functional.pad(q_shift, (0, 0, 0, (-K) % 8))
        K8 = qp.shape[-2] // 8
        scale = scale.expand(lead + tuple(scale.shape[-2:])).contiguous()
        s_spec = tuple(param_spec(f"{name}/sign", lead + (K8, N), mesh))
        s_spec += (None,) * (len(lead) + 2 - len(s_spec))
        k_ax, n_ax = s_spec[-2], s_spec[-1]
        # the codes of this rank's byte rows (K8 blocks of 8 rows) and columns
        q_local = local_block(qp, s_spec, mesh)
        local = _pack_grouped(q_local, torch.ones(lead + (1, 1)), n_bits)
        sc = local_scale(scale, param_spec(f"{name}/scale", tuple(scale.shape), mesh), n_ax, N,
                         mesh)
        out[name] = packing.PackedWeight(planes=local.planes, sign=local.sign, scale=sc,
                                         n_bits=n_bits, k=K, kn_spec=(k_ax, n_ax))
    return out


def export_packed_blocks(reps: Dict[str, BitRep], mesh, w_shapes: Dict[str, Tuple[int, ...]]
                         ) -> Dict[str, packing.PackedWeight]:
    """:func:`export_packed_sharded` from a state trained on the mesh: each
    rep is this rank's block of the weight whose whole shape ``w_shapes``
    gives.  The requant's tests and the ``[lsb, msb]`` window are the whole
    tensor's (or-ed over the mesh), packing is elementwise along
    byte-aligned K rows, so each rank's bytes are the block of
    :func:`export_packed`'s on the gathered reps.  A weight whose block is
    not whole bytes of K, whose sign rule splits otherwise than its
    weight's, or whose rule splits a group axis (the MoE experts, which
    serving holds float), raises."""
    from ..dist.elastic import local_scale
    from ..dist.sharding import param_spec

    w_specs = {}
    for name, r in reps.items():
        shape = tuple(w_shapes[name])
        w_specs[name] = (tuple(param_spec(name, shape, mesh)) + (None,) * len(shape))[:len(shape)]
        if splits_groups(r, w_specs[name]):
            raise NotImplementedError(f"{name}: its rule {w_specs[name]} splits a group axis; "
                                      "export the gathered reps")
    nz = mesh_nonzero(reps, mesh, w_specs)
    out = {}
    for name, r in reps.items():
        q_shift, n_bits, scale = _export_codes(r, nz[name], mesh)
        shape = tuple(w_shapes[name])
        lead, (K, N) = shape[:-2], shape[-2:]
        pad = (None,) * len(shape)
        w_spec = w_specs[name]
        s_spec = (tuple(param_spec(f"{name}/sign", lead + (-(-K // 8), N), mesh))
                  + pad)[:len(shape)]
        if w_spec != s_spec or q_shift.shape[-2] % 8:
            raise NotImplementedError(
                f"{name}: its block ({w_spec}, {tuple(q_shift.shape)}) is not whole bytes of "
                f"the packed rows ({s_spec}); export the gathered reps")
        scale = scale.expand(lead + tuple(scale.shape[-2:])).contiguous()
        local = _pack_grouped(q_shift, torch.ones(lead + (1, 1)), n_bits)
        sc = local_scale(scale, param_spec(f"{name}/scale", tuple(scale.shape), mesh),
                         s_spec[-1], N, mesh)
        out[name] = packing.PackedWeight(planes=local.planes, sign=local.sign, scale=sc,
                                         n_bits=n_bits, k=K, kn_spec=(s_spec[-2], s_spec[-1]))
    return out
