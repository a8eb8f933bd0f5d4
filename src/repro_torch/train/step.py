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
dry run.  The compressed data-parallel steps come with the training mesh slice of
the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from ..core import bsq as bsq_mod
from ..core.bitrep import BitRep
from ..core.bsq import BSQConfig
from ..device import resolve_device
from ..models import transformer
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
                   device=None, predicate=None) -> Tuple[Dict, BSQTrainContext]:
    """Draw model params on ``device`` (the card unless ``device="cpu"``)
    from ``generator``, convert them to bit representation, build the state."""
    device = resolve_device(device)
    params = transformer.init_params(cfg, generator, device)
    qp, fp = bsq_mod.partition_params(params, predicate or bsq_mod.default_quant_predicate)
    reps = bsq_mod.init_bitreps(qp, bsq_cfg)
    template = _meta_template(params)
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
        total_quant_params=bsq_mod.total_quantized_params(reps),
    )
    return state, ctx


def _reps_from_state(trainable, masks, meta) -> Dict[str, BitRep]:
    return {
        k: BitRep(wp=t["wp"], wn=t["wn"], scale=t["scale"], mask=masks[k],
                  n_denom=meta[k][0], group_axes=meta[k][1])
        for k, t in trainable["reps"].items()
    }


def bsq_loss(trainable, masks, batch, ctx: BSQTrainContext):
    """(total, metrics) of the BSQ objective, Eq. 5."""
    reps = _reps_from_state(trainable, masks, ctx.meta)
    w = bsq_mod.reconstruct(reps, ctx.bsq_cfg)
    params = bsq_mod.merge_params(ctx.template, w, trainable["float"])
    task_loss, metrics = transformer.loss_fn(params, batch, ctx.cfg)
    reg = bsq_mod.regularizer(reps, ctx.bsq_cfg, ctx.total_quant_params)
    total = task_loss + ctx.bsq_cfg.alpha * reg
    return total, dict(metrics, reg=reg, total=total)


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
):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``hoist_reconstruct``: with gradient accumulation, the bit-plane ->
    weight reconstruction and its backward are microbatch-invariant, so
    they run once per step instead of once per microbatch.  Gradients are
    mathematically identical (linearity of accumulation).
    """
    alpha = ctx.bsq_cfg.alpha

    def single_grads(trainable, masks, batch):
        loss, metrics, grads = value_and_grad(lambda tr: bsq_loss(tr, masks, batch, ctx),
                                              trainable)
        return (loss, metrics), grads

    def hoisted_grads(trainable, masks, batch):
        rep_tree = trainable["reps"]
        named = flatten_with_path(rep_tree)
        rep_leaves = [x for _, x in named]
        for x in rep_leaves:
            x.requires_grad_(True)
        try:
            reps = _reps_from_state(trainable, masks, ctx.meta)
            w = bsq_mod.reconstruct(reps, ctx.bsq_cfg)
            reg = bsq_mod.regularizer(reps, ctx.bsq_cfg, ctx.total_quant_params)
            gw = {k: torch.zeros_like(v) for k, v in w.items()}
            gf = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                  for k, v in trainable["float"].items()}
            acc_l, acc_m = 0.0, {"ce": 0.0, "aux": 0.0}
            for mb in _split(batch, microbatches):
                w_ = {k: v.detach().requires_grad_(True) for k, v in w.items()}
                f_ = {k: v.detach().requires_grad_(True) for k, v in trainable["float"].items()}
                params = bsq_mod.merge_params(ctx.template, w_, f_)
                l, m = transformer.loss_fn(params, mb, ctx.cfg)
                # an input a model never reads (musicgen's embedding, fed
                # embeds) has no gradient: zero, as JAX's grad gives it
                g = torch.autograd.grad(l, list(w_.values()) + list(f_.values()),
                                        allow_unused=True)
                for k, gk in zip(list(w_) + list(f_), g):
                    if gk is not None:
                        (gw if k in w_ else gf)[k] += gk
                acc_l = acc_l + l.detach()
                acc_m = {k: acc_m[k] + m[k].detach() for k in acc_m}
            inv = 1.0 / microbatches
            gw = {k: v * inv for k, v in gw.items()}
            gf = {k: (v * inv).to(torch.float32) for k, v in gf.items()}
            # one backward through reconstruct + regulariser for the whole step
            g_reps = torch.autograd.grad(
                list(w.values()) + [reg], rep_leaves,
                grad_outputs=list(gw.values()) + [torch.tensor(alpha, dtype=torch.float32,
                                                               device=reg.device)])
        finally:
            for x in rep_leaves:
                x.requires_grad_(False)
        grads = {"reps": unflatten_like(rep_tree, dict(zip([n for n, _ in named], g_reps))),
                 "float": gf}
        reg = reg.detach()
        l = acc_l * inv
        m = {k: v * inv for k, v in acc_m.items()}
        total = l + alpha * reg
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
            return alpha * bsq_mod.regularizer(reps, ctx.bsq_cfg, ctx.total_quant_params), {}

        return value_and_grad(reg_loss, trainable)[2]

    def train_step(state, batch):
        (loss, metrics), grads = accumulated_grads(state["trainable"], state["masks"], batch)
        if decouple_reg_clip and grad_clip is not None:
            # clip the TASK gradient only; the regulariser's gradient is added
            # back unclipped so compression pressure is not crushed by the clip
            g_reg = flat_leaves(reg_only_grads(state["trainable"], state["masks"]))
            g = flat_leaves(grads)
            torch._foreach_sub_(g, g_reg)
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, grad_clip)
            torch._foreach_add_(g, g_reg)
        elif grad_clip is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(state["step"])
        trainable, opt = optimizer.update(grads, state["opt"], state["trainable"], lr)
        del grads
        # paper §3.1: trim planes to [0, 2] after the update
        project_bitplanes(_reps_from_state(trainable, state["masks"], ctx.meta))
        metrics["lr"] = lr
        return {"trainable": trainable, "masks": state["masks"], "opt": opt,
                "step": state["step"] + 1}, metrics

    return train_step


def make_requant_step(ctx: BSQTrainContext):
    """Periodic re-quantisation + precision adjustment (static mode).  The
    new planes and masks are written into the state's tensors, one tensor
    at a time, so a full-width state never holds two sets of planes."""
    from ..core.requant import requantize_static

    @torch.no_grad()
    def requant(state):
        for k, r in _reps_from_state(state["trainable"], state["masks"], ctx.meta).items():
            new = requantize_static(r)
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


def abstract_bsq_state(cfg: ModelConfig, bsq_cfg: BSQConfig, optimizer, predicate=None):
    """Meta-device twin of :func:`init_bsq_state`: ``(state, ctx)`` with
    every leaf's path, shape and dtype, and ``state["step"]`` a real CPU
    int32 scalar, as the optimizers read it on the host."""
    return init_bsq_state(torch.Generator(), cfg, bsq_cfg, optimizer, device="meta",
                          predicate=predicate)


def abstract_plain_state(cfg: ModelConfig, optimizer):
    """Meta-device twin of :func:`init_plain_state`."""
    return init_plain_state(torch.Generator(), cfg, optimizer, device="meta")


# ---------------------------------------------------------------------------
# Plain (non-BSQ) baseline training
# ---------------------------------------------------------------------------


def init_plain_state(generator: torch.Generator, cfg: ModelConfig, optimizer, device=None):
    params = transformer.init_params(cfg, generator, resolve_device(device))
    return {"params": params, "opt": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32)}


def make_plain_train_step(cfg: ModelConfig, optimizer, lr_fn, grad_clip: Optional[float] = 1.0):
    def train_step(state, batch):
        loss, metrics, grads = value_and_grad(lambda p: transformer.loss_fn(p, batch, cfg),
                                              state["params"])
        if grad_clip is not None:
            grads, metrics["grad_norm"] = clip_by_global_norm(grads, grad_clip)
        lr = lr_fn(state["step"])
        params, opt = optimizer.update(grads, state["opt"], state["params"], lr)
        metrics["total"] = loss
        metrics["lr"] = lr
        return {"params": params, "opt": opt, "step": state["step"] + 1}, metrics

    return train_step
