"""Train steps: BSQ bit-representation training (Eq. 5) and the plain
baseline.  PyTorch port of ``repro.train.step``.

State layout (a plain nested dict, the JAX package's, so checkpoints see
the same flat leaves)::

    state = {
      "trainable": {
         "reps":  {name: {"wp","wn","scale"}},   # bit-planes + scales
         "float": {name: tensor},                # norms, scalars, ...
      },
      "masks":  {name: (nb, *gshape) {0,1}},     # active-plane masks (not trained)
      "opt":    optimizer state over `trainable`,
      "step":   int32 scalar on the CPU,
    }

Gradients come from ``torch.autograd.grad`` over the trainable leaves
(``requires_grad`` is switched on only inside a step).  A step and a
requant update the state's tensors IN PLACE (optimizer, projection, new
planes and masks), so the state passed in is consumed; a full-width
state (32 GB of planes and momentum at 2 layers) is never held twice.
:func:`abstract_bsq_state` and :func:`abstract_plain_state` build the
same states on the ``meta`` device (shapes and dtypes, no data) for the
dry run.

On a ("data", "model") or ("pod", "data", "model") mesh (``mesh=``, a
:class:`~repro_torch.launch.mesh.HostMesh`, one process per rank) the
state is this rank's block of every leaf under the partition rules
(``dist.elastic.train_state_specs``): planes, moments, float leaves;
rep scales, masks and the step are whole.  The rules never name "pod"
for a leaf, so each pod holds a copy of every block.  The batch is this
rank's block over the data axes ("pod" and "data"), laid out in
microbatch order (``dist.sharding.batch_block``).  A step is JAX's
``jit`` of the same step over that placement, written out:

* the data axis is FSDP: each weight block is reconstructed on its own
  planes, gathered over "data" (``HostMesh.shard_gather``, whose backward
  is a reduce-scatter of the data ranks' gradients, summed over the pods
  too); a leaf whole along "data" enters by ``HostMesh.enter`` (its
  gradient summed over the data axes);
* the model axis keeps the serving path's Megatron pairs: the forward
  runs under a training view of the mesh ("data" hidden), each leaf in
  the form serving gives it (``dist.elastic.placed_leaf``), whose
  collectives carry their conjugates (``models.common.dense_apply``);
* a rep's scale and mask, whole on every rank, scale this rank's block:
  the scale enters by ``HostMesh.enter`` over the axes that split its
  weight, and both are cut to the groups the block holds where a rule
  splits a group axis (the MoE experts' E over "model");
* the task loss is each data rank's token NLL sum over the token count
  of the whole batch, so the data ranks' losses add up to JAX's mean;
  the MoE router loss is the whole batch's on every rank, each data
  rank's share carrying its part; the regulariser is the same on every
  rank (``core.regularizer``);
* the gradient norm sums each leaf once over the weight axes
  (``optim.global_norm``); the update and the projection are elementwise;
* every sum over a weight's blocks (the regulariser's norms, the clip's
  norm, requant's flags) runs over the weight axes, never over "pod",
  whose ranks hold copies (a mesh's ``weight_axes``);
* with ``microbatches`` the rank's rows split into that many blocks in
  order, block i its part of JAX's microbatch i; hoisted, the
  reconstruction, the regulariser and the gathers run once per step and
  the microbatches' task gradients add up against the gathered blocks
  before one backward through them.

Off a mesh the same step runs on the
:class:`~repro_torch.launch.mesh.LocalMesh`, whose collectives are the
identity: every leaf is whole and the share of the loss is all of it.

:func:`make_compressed_dp_step` and :func:`make_compressed_bsq_dp_step`
are JAX's int8 + error-feedback data-parallel steps on an (n, 1) mesh:
params whole on every rank, each rank's residual its own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core import bsq as bsq_mod
from ..core.bitrep import BitRep
from ..core.bsq import BSQConfig
from ..device import resolve_device
from ..launch.mesh import LocalMesh
from ..models import transformer
from ..models.common import cross_entropy_sums, packed_shard_mesh
from ..optim.optimizers import clip_by_global_norm, project_bitplanes
from ..tree import flatten_with_path, tree_map, unflatten_like

PyTree = Any


@dataclasses.dataclass
class BSQTrainContext:
    cfg: ModelConfig
    bsq_cfg: BSQConfig
    template: PyTree  # the model's param tree with meta-device leaves
    meta: Dict[str, Tuple[int, Tuple[int, ...]]]  # name -> (n_denom, group_axes)
    total_quant_params: int


def _meta_template(params) -> PyTree:
    return tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), params)


def init_bsq_state(generator: torch.Generator, cfg: ModelConfig, bsq_cfg: BSQConfig, optimizer,
                   device=None, predicate=None, mesh=None) -> Tuple[Dict, BSQTrainContext]:
    """Draw model params on ``device`` (the card unless ``device="cpu"``)
    from ``generator``, convert them to bit representation, build the state.

    On ``mesh`` every rank draws the same whole params and keeps the state's
    blocks: each weight's scale from the whole weight, its planes
    decomposed on this rank's block only (the bits of the whole state's
    block), so no rank holds a whole tensor's planes."""
    device = resolve_device(mesh.device if mesh is not None else device)
    params = transformer.init_params(cfg, generator, device)
    qp, fp = bsq_mod.partition_params(params, predicate or bsq_mod.default_quant_predicate)
    template = _meta_template(params)
    total = sum(x.numel() for x in qp.values())
    reps = bsq_mod.init_bitreps(qp, bsq_cfg, mesh=mesh)
    fp = {k: _block(k, v, mesh) for k, v in fp.items()}
    del params, qp
    trainable = {"reps": {k: r.trainable() for k, r in reps.items()}, "float": fp}
    state = {
        "trainable": trainable,
        "masks": {k: r.mask for k, r in reps.items()},
        "opt": optimizer.init(trainable),
        "step": torch.zeros((), dtype=torch.int32),
    }
    ctx = BSQTrainContext(
        cfg=cfg, bsq_cfg=bsq_cfg, template=template,
        meta={k: (r.n_denom, r.group_axes) for k, r in reps.items()},
        total_quant_params=total,
    )
    return state, ctx


def _block(name: str, x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block (a copy) of a whole param ``x`` under its rule; ``x``
    itself off a mesh."""
    from ..dist.sharding import local_block, param_spec

    if mesh is None:
        return x
    return local_block(x, param_spec(name, tuple(x.shape), mesh), mesh).clone()


def _reps_from_state(trainable, masks, meta) -> Dict[str, BitRep]:
    return {
        k: BitRep(wp=t["wp"], wn=t["wn"], scale=t["scale"], mask=masks[k],
                  n_denom=meta[k][0], group_axes=meta[k][1])
        for k, t in trainable["reps"].items()
    }


def group_numel(ctx: BSQTrainContext) -> Dict[str, int]:
    """Each rep's whole-tensor elements per group (from the template)."""
    shapes = {n: tuple(x.shape) for n, x in flatten_with_path(ctx.template)}
    return {k: math.prod(d for i, d in enumerate(shapes[k]) if i not in ga)
            for k, (_, ga) in ctx.meta.items()}


def state_scheme(state, ctx: BSQTrainContext):
    """The quant scheme of a state (of this rank's blocks, on a mesh: the
    masks are whole, the element counts the template's)."""
    return bsq_mod.extract_scheme(state_reps(state, ctx), group_numel=group_numel(ctx))


# ---------------------------------------------------------------------------
# The loss: the weights the forward reads, on a mesh or on the LocalMesh
# ---------------------------------------------------------------------------


def _gathered_leaf(name: str, x: torch.Tensor, spec, mesh):
    """This rank's block of a param gathered for the training forward:
    gathered over "data" where the rule splits it there (FSDP, the
    gradient reduce-scattered back and summed over the pods), else
    entering with its gradient summed over the data axes.  Off a mesh
    (``spec`` None) ``x`` itself."""
    if spec is None:
        return x
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    if any(isinstance(ax, tuple) for ax in spec):  # JAX's rules give a param none
        raise NotImplementedError(f"{name}: a param dim split over several axes ({spec})")
    if "data" in spec:
        pods = tuple(ax for ax in mesh.data_axes if ax != "data")
        for dim, ax in enumerate(spec):
            if ax == "data":
                x = mesh.shard_gather(x, "data", dim, also=pods)
    else:
        x = mesh.enter(x, mesh.data_axes)
    return x


def _placed(name: str, x, spec, mesh):
    """A gathered block in the form serving gives it
    (``dist.elastic.placed_leaf`` on the training view, where the data
    axes have size 1): a FloatBlock that ``models.common.dense_apply``
    stitches, a RowsBlock of a stacked gate bias, or the plain block (the
    embedding, the MoE experts).  Off a mesh ``x`` itself."""
    from ..dist.elastic import placed_leaf

    if spec is None:
        return x
    spec = tuple(spec) + (None,) * (x.ndim - len(spec))
    return placed_leaf(name, x, spec, mesh.training_view())


def _forward_leaf(name: str, x: torch.Tensor, spec, mesh):
    """This rank's block of a param as the training forward reads it:
    :func:`_gathered_leaf`, then :func:`_placed`."""
    return _placed(name, _gathered_leaf(name, x, spec, mesh), spec, mesh)


def _task_loss(params, batch, cfg: ModelConfig, mesh):
    """(this data rank's share of the task loss, {"ce", "aux"} of the whole
    batch): each data rank's NLL sum over the whole batch's token count,
    so the shares add up to ``transformer.loss_fn``'s mean; on a mesh the
    forward runs under the training view, its heads local.  The MoE
    router loss is the whole batch's on every rank (``models.moe`` sums
    its statistics over the data axes), so each data rank's share carries
    its part of it and the shares count it once."""
    sharded = mesh.size() > 1
    view = mesh.training_view() if sharded else None
    with packed_shard_mesh(view, local_heads=True):
        logits, aux = transformer.forward(params, batch, cfg)
    total, count = cross_entropy_sums(logits, batch["labels"])
    share = total / torch.clamp(mesh.all_reduce(count, mesh.data_axes), min=1.0)
    ce = mesh.all_reduce(share.detach(), mesh.data_axes)
    n_data = mesh.size() // view.size() if sharded else 1
    return share + cfg.router_aux_weight * aux / n_data, {"ce": ce, "aux": aux}


def _weight_specs(specs, reps) -> Dict[str, tuple]:
    """Each rep's weight spec (its planes' without the plane axis) from the
    flat ``name -> spec`` map of a train state; empty off a mesh."""
    return {k: tuple(specs[f"trainable/reps/{k}/wp"])[1:] for k in reps} if specs else {}


def bsq_loss(trainable, masks, batch, ctx: BSQTrainContext, mesh=None, specs=None):
    """(this rank's part of the objective, metrics) of the BSQ objective,
    Eq. 5.  Off a mesh the part is the whole objective.  On ``mesh`` (a
    :class:`~repro_torch.launch.mesh.HostMesh`, ``specs`` the flat ``name
    -> spec`` map of the state) the parts add up over the data ranks to
    Eq. 5, and the metrics are the whole objective's."""
    mesh, specs = mesh if mesh is not None else LocalMesh(), specs or {}
    reps = _reps_from_state(trainable, masks, ctx.meta)
    wspecs = _weight_specs(specs, reps)
    w = bsq_mod.reconstruct(reps, ctx.bsq_cfg, mesh, wspecs)
    w = {k: _forward_leaf(k, v, wspecs.get(k), mesh) for k, v in w.items()}
    floats = {k: _forward_leaf(k, v, specs.get(f"trainable/float/{k}"), mesh)
              for k, v in trainable["float"].items()}
    task, metrics = _task_loss(bsq_mod.merge_params(ctx.template, w, floats), batch, ctx.cfg,
                               mesh)
    reg = _regularizer(reps, ctx, mesh, wspecs)
    alpha = ctx.bsq_cfg.alpha
    whole = metrics["ce"] + ctx.cfg.router_aux_weight * metrics["aux"].detach()
    return task + alpha * reg, dict(metrics, reg=reg.detach(),
                                    total=whole + alpha * reg.detach())


def _regularizer(reps, ctx: BSQTrainContext, mesh, wspecs):
    return bsq_mod.regularizer(reps, ctx.bsq_cfg, ctx.total_quant_params, mesh=mesh,
                               specs=wspecs, group_numel=group_numel(ctx))


def value_and_grad(fn: Callable, tree):
    """``fn(tree) -> (loss, metrics)``; returns (loss, metrics) detached and
    the gradient tree (zeros where ``fn`` does not depend on a leaf)."""
    named = flatten_with_path(tree)
    leaves = [x for _, x in named]
    for x in leaves:
        x.requires_grad_(True)
    try:
        loss, metrics = fn(tree)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for x in leaves:
            x.requires_grad_(False)
    grads = {n: torch.zeros_like(x) if g is None else g
             for (n, x), g in zip(named, grads)}
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten_like(tree, grads))


def flat_leaves(tree) -> list:
    return [x for _, x in flatten_with_path(tree)]


def _split(batch, microbatches: int):
    return [{k: v.reshape((microbatches, v.shape[0] // microbatches) + tuple(v.shape[1:]))[i]
             for k, v in batch.items()} for i in range(microbatches)]


def make_bsq_train_step(
    ctx: BSQTrainContext,
    optimizer,
    lr_fn: Callable,
    grad_clip: Optional[float] = 1.0,
    microbatches: int = 1,
    hoist_reconstruct: bool = True,
    decouple_reg_clip: bool = False,
    mesh=None,
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``hoist_reconstruct``: with gradient accumulation, the bit-plane ->
    weight reconstruction and its backward are microbatch-invariant, so
    they run once per step instead of once per microbatch.  Gradients are
    mathematically identical (linearity of accumulation).

    ``mesh``: the state and the batch are this rank's blocks (the module
    docstring), the batch's rows in microbatch order
    (``dist.sharding.batch_block``).  Off a mesh the step runs on the
    :class:`~repro_torch.launch.mesh.LocalMesh`.
    """
    alpha = ctx.bsq_cfg.alpha
    mesh = mesh if mesh is not None else LocalMesh()
    specs, tree_specs = _specs_cache(mesh, lambda: ctx.template)

    def single_grads(trainable, masks, batch):
        loss, metrics, grads = value_and_grad(
            lambda tr: bsq_loss(tr, masks, batch, ctx, mesh, specs), trainable)
        return (loss, metrics), grads

    def hoisted_grads(trainable, masks, batch):
        named = flatten_with_path(trainable)
        leaves = [x for _, x in named]
        for x in leaves:
            x.requires_grad_(True)
        try:
            # once per step: the reconstruction, the regulariser, the gathers
            reps = _reps_from_state(trainable, masks, ctx.meta)
            wspecs = _weight_specs(specs, reps)
            w = bsq_mod.reconstruct(reps, ctx.bsq_cfg, mesh, wspecs)
            reg = _regularizer(reps, ctx, mesh, wspecs)
            fspecs = {k: specs.get(f"trainable/float/{k}") for k in trainable["float"]}
            gathered = {**{k: _gathered_leaf(k, v, wspecs.get(k), mesh) for k, v in w.items()},
                        **{k: _gathered_leaf(k, v, fspecs[k], mesh)
                           for k, v in trainable["float"].items()}}
            leaf_spec = {**{k: wspecs.get(k) for k in w}, **fspecs}
            acc = {k: torch.zeros(v.shape, dtype=torch.float32 if k in fspecs else v.dtype,
                                  device=v.device) for k, v in gathered.items()}
            acc_m = {"ce": 0.0, "aux": 0.0}
            for mb in _split(batch, microbatches):
                g_ = {k: v.detach().requires_grad_(True) for k, v in gathered.items()}
                placed = {k: _placed(k, v, leaf_spec[k], mesh) for k, v in g_.items()}
                params = bsq_mod.merge_params(ctx.template, {k: placed[k] for k in w},
                                              {k: placed[k] for k in fspecs})
                task, m = _task_loss(params, mb, ctx.cfg, mesh)
                # an input a model never reads (musicgen's embedding, fed
                # embeds) has no gradient: zero, as JAX's grad gives it
                g = torch.autograd.grad(task, list(g_.values()), allow_unused=True)
                for k, gk in zip(g_, g):
                    if gk is not None:
                        acc[k] += gk
                acc_m = {k: acc_m[k] + m[k].detach() for k in acc_m}
            inv = 1.0 / microbatches
            # one backward through the gathers, reconstruct and the regulariser
            outs = list(gathered.values()) + [reg]
            g_leaves = torch.autograd.grad(
                outs, leaves, allow_unused=True,
                grad_outputs=[v * inv for v in acc.values()]
                + [torch.tensor(alpha, dtype=torch.float32, device=reg.device)])
        finally:
            for x in leaves:
                x.requires_grad_(False)
        grads = unflatten_like(trainable, {n: torch.zeros_like(x) if g is None else g
                                           for (n, x), g in zip(named, g_leaves)})
        grads["float"] = {k: v.to(torch.float32) for k, v in grads["float"].items()}
        reg = reg.detach()
        m = {k: v * inv for k, v in acc_m.items()}
        total = m["ce"] + ctx.cfg.router_aux_weight * m["aux"] + alpha * reg
        return (total, dict(m, reg=reg, total=total)), grads

    def accumulated_grads(trainable, masks, batch):
        if microbatches == 1:
            return single_grads(trainable, masks, batch)
        if hoist_reconstruct:
            return hoisted_grads(trainable, masks, batch)
        acc_g, acc_l = None, 0.0
        acc_m = {"ce": 0.0, "aux": 0.0, "reg": 0.0, "total": 0.0}
        for mb in _split(batch, microbatches):
            (l, m), g = single_grads(trainable, masks, mb)
            if acc_g is None:
                acc_g = g
            else:
                torch._foreach_add_(flat_leaves(acc_g), flat_leaves(g))
            acc_l = acc_l + l
            acc_m = {k: acc_m[k] + m[k] for k in acc_m}
        inv = 1.0 / microbatches
        torch._foreach_mul_(flat_leaves(acc_g), inv)
        return (acc_l * inv, {k: v * inv for k, v in acc_m.items()}), acc_g

    def reg_only_grads(trainable, masks):
        def reg_loss(tr):
            reps = _reps_from_state(tr, masks, ctx.meta)
            return alpha * _regularizer(reps, ctx, mesh, _weight_specs(specs, reps)), {}

        return value_and_grad(reg_loss, trainable)[2]

    def train_step(state, batch):
        clip_specs = tree_specs(state).get("trainable")
        (loss, metrics), grads = accumulated_grads(state["trainable"], state["masks"], batch)
        if decouple_reg_clip and grad_clip is not None:
            # clip the TASK gradient only; the regulariser's gradient is added
            # back unclipped so compression pressure is not crushed by the clip
            g_reg = flat_leaves(reg_only_grads(state["trainable"], state["masks"]))
            g = flat_leaves(grads)
            torch._foreach_sub_(g, g_reg)
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, grad_clip, mesh, clip_specs)
            torch._foreach_add_(g, g_reg)
        elif grad_clip is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, grad_clip, mesh, clip_specs)
        lr = lr_fn(state["step"])
        trainable, opt = optimizer.update(grads, state["opt"], state["trainable"], lr)
        del grads
        # paper §3.1: trim planes to [0, 2] after the update
        project_bitplanes(_reps_from_state(trainable, state["masks"], ctx.meta))
        metrics["lr"] = lr
        return {"trainable": trainable, "masks": state["masks"], "opt": opt,
                "step": state["step"] + 1}, metrics

    return train_step


def make_requant_step(ctx: BSQTrainContext, mesh=None):
    """Periodic re-quantisation + precision adjustment (static mode).  The
    new planes and masks are written into the state's tensors, one tensor
    at a time, so a full-width state never holds two sets of planes.  On
    ``mesh`` the whole tensors' per-(bit, group) tests are or-ed over the
    mesh first (one collective), so every rank writes the same whole
    masks; each block re-quantises by its own groups' mask."""
    from ..core.bitrep import local_groups
    from ..core.requant import mesh_nonzero, requantize_static

    specs, tree_specs = _specs_cache(mesh if mesh is not None else LocalMesh(),
                                     lambda: ctx.template)

    @torch.no_grad()
    def requant(state):
        reps = _reps_from_state(state["trainable"], state["masks"], ctx.meta)
        tree_specs(state)
        wspecs = _weight_specs(specs, reps)
        nz = mesh_nonzero(reps, mesh, wspecs) if mesh is not None else {}
        for k, r in reps.items():
            new = requantize_static(local_groups(r, wspecs.get(k, ()), mesh), nz.get(k))
            r.wp.copy_(new.wp)
            r.wn.copy_(new.wn)
            r.mask.copy_(new.mask)
        return state

    return requant


def state_reps(state, ctx: BSQTrainContext) -> Dict[str, BitRep]:
    return _reps_from_state(state["trainable"], state["masks"], ctx.meta)


# ---------------------------------------------------------------------------
# Abstract (meta-device) states: the dry run's; nothing is allocated
# ---------------------------------------------------------------------------


def abstract_bsq_state(cfg: ModelConfig, bsq_cfg: BSQConfig, optimizer, predicate=None,
                       mesh=None):
    """Meta-device twin of :func:`init_bsq_state`: ``(state, ctx)`` with
    every leaf's path, shape and dtype, and ``state["step"]`` a real CPU
    int32 scalar, as the optimizers read it on the host; on ``mesh`` (a
    mesh on ``meta``, ``launch.mesh.meta_mesh``) this rank's blocks."""
    return init_bsq_state(torch.Generator(), cfg, bsq_cfg, optimizer, device="meta",
                          predicate=predicate, mesh=mesh)


def abstract_plain_state(cfg: ModelConfig, optimizer, mesh=None):
    """Meta-device twin of :func:`init_plain_state`."""
    return init_plain_state(torch.Generator(), cfg, optimizer, device="meta", mesh=mesh)


# ---------------------------------------------------------------------------
# Plain (non-BSQ) baseline training
# ---------------------------------------------------------------------------


def init_plain_state(generator: torch.Generator, cfg: ModelConfig, optimizer, device=None,
                     mesh=None):
    """The plain state; on ``mesh`` this rank's block of every param (each
    rank draws the same whole params)."""
    device = resolve_device(mesh.device if mesh is not None else device)
    params = transformer.init_params(cfg, generator, device)
    params = unflatten_like(params, {n: _block(n, x, mesh) for n, x in flatten_with_path(params)})
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def plain_loss(params, batch, cfg: ModelConfig, mesh=None, specs=None):
    """(this rank's part of the task loss, metrics): ``bsq_loss`` without
    bit representations, on the same placement."""
    mesh, specs = mesh if mesh is not None else LocalMesh(), specs or {}
    placed = unflatten_like(params, {n: _forward_leaf(n, x, specs.get(f"params/{n}"), mesh)
                                     for n, x in flatten_with_path(params)})
    task, metrics = _task_loss(placed, batch, cfg, mesh)
    whole = metrics["ce"] + cfg.router_aux_weight * metrics["aux"].detach()
    return task, dict(metrics, total=whole)


def make_plain_train_step(cfg: ModelConfig, optimizer, lr_fn, grad_clip: Optional[float] = 1.0,
                          mesh=None):
    """Plain training; ``mesh`` as :func:`make_bsq_train_step` takes it."""
    mesh = mesh if mesh is not None else LocalMesh()
    specs, tree_specs = _specs_cache(mesh, lambda: abstract_plain_state(cfg, optimizer)["params"])

    def train_step(state, batch):
        clip_specs = tree_specs(state).get("params")
        _, metrics, grads = value_and_grad(lambda p: plain_loss(p, batch, cfg, mesh, specs),
                                           state["params"])
        if grad_clip is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, grad_clip, mesh, clip_specs)
        lr = lr_fn(state["step"])
        params, opt = optimizer.update(grads, state["opt"], state["params"], lr)
        metrics["lr"] = lr
        return {"params": params, "opt": opt, "step": state["step"] + 1}, metrics

    return train_step


def _specs_cache(mesh, template_fn):
    """``(specs, tree_specs)``: the flat ``name -> spec`` map a step's loss
    reads (filled on the first step) and ``tree_specs(state)``, the spec
    tree of the train state under the partition rules.  Both are empty
    off a mesh: every leaf is whole."""
    specs, tree = {}, {}

    def tree_specs(state):
        if not tree and mesh.size() > 1:
            from ..dist.elastic import train_state_specs
            from ..dist.sharding import flatten_specs

            tree.update(train_state_specs(state, mesh, template_fn()))
            specs.update(flatten_specs(tree))
        return tree

    return specs, tree_specs


# ---------------------------------------------------------------------------
# Compressed data parallelism (int8 + error feedback), on an (n, 1) mesh
# ---------------------------------------------------------------------------


def _pmean(mesh, axis: str, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each value's mean over the ranks of ``axis``, in one collective."""
    keys = list(values)
    summed = mesh.all_reduce(torch.stack([values[k].to(torch.float32) for k in keys]), axis)
    n = float(mesh.shape[axis])
    return {k: summed[i] / n for i, k in enumerate(keys)}


def _local_residual(residual):
    return tree_map(lambda r: r[0], residual)


def _check_compressed_mesh(mesh, axis: str) -> None:
    if any(n > 1 for ax, n in mesh.shape.items() if ax != axis):
        raise ValueError(f"the compressed data-parallel step runs on an (n, 1) mesh, params "
                         f"whole on every rank; got {mesh.shape}")


def make_compressed_dp_step(cfg: ModelConfig, optimizer, lr_fn, mesh, axis: str = "data"):
    """Pure data-parallel train step with an int8 + error-feedback gradient
    all-reduce (``dist.collectives``).  Params whole on every rank; the
    batch is this rank's block over ``axis``; the state gains a
    ``residual`` tree, this rank's (1, ...) block of JAX's (n, ...) one.
    Returns ``(init_state, train_step)``; ``init_state(generator,
    device=None)`` draws the params (the same on every rank)."""
    from ..dist.collectives import init_residuals, tree_compressed_psum_ef

    _check_compressed_mesh(mesh, axis)

    def init_state(generator, device=None):
        params = transformer.init_params(cfg, generator, resolve_device(device or mesh.device))
        return {"params": params, "opt": optimizer.init(params),
                "residual": init_residuals(params, n_shards=1),
                "step": torch.zeros((), dtype=torch.int32)}

    def train_step(state, batch):
        loss, _, grads = value_and_grad(lambda p: transformer.loss_fn(p, batch, cfg),
                                        state["params"])
        grads, residual = tree_compressed_psum_ef(grads, _local_residual(state["residual"]),
                                                  mesh, axis)
        loss = _pmean(mesh, axis, {"total": loss})["total"]
        lr = lr_fn(state["step"])
        params, opt = optimizer.update(grads, state["opt"], state["params"], lr)
        return ({"params": params, "opt": opt, "residual": tree_map(lambda r: r[None], residual),
                 "step": state["step"] + 1}, {"total": loss, "lr": lr})

    return init_state, train_step


def make_compressed_bsq_dp_step(ctx: BSQTrainContext, optimizer, lr_fn: Callable, mesh,
                                axis: str = "data", grad_clip: Optional[float] = None):
    """BSQ train step with the int8 + error-feedback gradient all-reduce.

    Bit-plane gradients are the natural int8 candidates: the planes live in
    [0, 2] after projection, and they are the largest leaves of the state.
    The state (from :func:`init_bsq_state` without a mesh) is whole on
    every rank; the batch is this rank's block over ``axis``.  Returns
    ``(add_residuals, train_step)``: call ``state = add_residuals(state)``
    once before the first step."""
    from ..dist.collectives import init_residuals, tree_compressed_psum_ef

    _check_compressed_mesh(mesh, axis)

    def add_residuals(state):
        return dict(state, residual=init_residuals(state["trainable"], n_shards=1))

    def train_step(state, batch):
        _, metrics, grads = value_and_grad(
            lambda tr: bsq_loss(tr, state["masks"], batch, ctx), state["trainable"])
        grads, residual = tree_compressed_psum_ef(grads, _local_residual(state["residual"]),
                                                  mesh, axis)
        metrics = _pmean(mesh, axis, metrics)
        if grad_clip is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(state["step"])
        trainable, opt = optimizer.update(grads, state["opt"], state["trainable"], lr)
        del grads
        project_bitplanes(_reps_from_state(trainable, state["masks"], ctx.meta))
        metrics["lr"] = lr
        return {"trainable": trainable, "masks": state["masks"], "opt": opt,
                "residual": tree_map(lambda r: r[None], residual),
                "step": state["step"] + 1}, metrics

    return add_residuals, train_step
