"""Paper-faithful pipeline: ResNet-20 + BSQ (one group per conv/fc
tensor, 4-bit activations, SGD momentum 0.9 / wd 1e-4, paper Appendix
A.1) on synthetic CIFAR-shaped data, then the §3.3 DoReFa finetune under
the scheme BSQ found.  PyTorch port of ``examples/resnet20_bsq_paper.py``.

    PYTHONPATH=src python -m repro_torch.examples.resnet20_bsq_paper

:func:`main` runs BSQ from 8 bits: the STE reconstruction, the forward
with ``train=False, act_bits=4``, CE plus alpha times the memory-
reweighed bit-level group Lasso (whose per-(bit, group) sums of squares
run through the grouped ``bgl_sumsq`` kernel on the card: one launch
over wp and wn of all 22 quantised tensors per step, and one for its
backward), SGDM, the planes trimmed to [0, 2], a
static requantisation every 20 steps, and the per-layer scheme at the
end.  :func:`finetune` trains the float weights through
``core.qat.finetune_loss_fn`` under that frozen scheme.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import BSQConfig, extract_scheme
from ..core.bsq import (
    default_quant_predicate,
    init_bitreps,
    merge_params,
    partition_params,
    reconstruct,
    regularizer,
    requantize_tree,
)
from ..core.qat import apply_scheme_dorefa, finetune_loss_fn
from ..data import gaussian_blobs
from ..device import resolve_device
from ..models.resnet import classification_loss, init_resnet20, merge_bn_stats, resnet20_forward
from ..optim import SGDM
from ..train.step import value_and_grad

ALPHA = 2e-2  # regularisation strength of the JAX example
LR = 0.05
# the finetune starts from BSQ's weights; at LR its DoReFa steps diverged
# on the card (CE 5.9 -> 13.0 in 30 steps), a fifth of it settles
FT_LR = 0.01
ACT_BITS = 4
REQUANT_INTERVAL = 20
EVAL_SEED, EVAL_BATCH = 1000, 256  # the held-out batch, drawn apart from training's


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to(batch, device):
    return (torch.from_numpy(batch["images"]).to(device),
            torch.from_numpy(batch["labels"]).long().to(device))


def _eval_batch(device):
    return _to(gaussian_blobs(np.random.default_rng(EVAL_SEED), EVAL_BATCH), device)


class PaperBSQ:
    """The BSQ state of the paper's run: bit representations of the conv
    and fc tensors (one group each), the float rest (BN, ``fc_bias``, BN
    statistics, not trained), and SGDM's momentum.  :meth:`step` and
    :meth:`requant` update it in place."""

    def __init__(self, params, width: int):
        self.template, self.width = params, width
        qp, self.fp = partition_params(params, default_quant_predicate)
        self.cfg = BSQConfig(n_init=8, alpha=ALPHA, mode="static", compute_dtype=torch.float32)
        # layer-wise groups exactly as the paper: one group per conv/fc tensor
        self.reps = init_bitreps(qp, self.cfg, group_axes_fn=lambda n, w: ())
        self.opt = SGDM(momentum=0.9, weight_decay=1e-4)
        self.trainable = {k: r.trainable() for k, r in self.reps.items()}
        self.opt_state = self.opt.init(self.trainable)

    def _reps(self, trainable):
        return {k: dataclasses.replace(self.reps[k], wp=t["wp"], wn=t["wn"], scale=t["scale"])
                for k, t in trainable.items()}

    def loss(self, trainable, images, labels):
        rs = self._reps(trainable)
        p = merge_params(self.template, reconstruct(rs, self.cfg), self.fp)
        logits, _ = resnet20_forward(p, images, train=False, act_bits=ACT_BITS, width=self.width)
        ce = classification_loss(logits, labels)
        acc = torch.mean((torch.argmax(logits, -1) == labels).float())
        return ce + self.cfg.alpha * regularizer(rs, self.cfg), {"ce": ce, "acc": acc}

    def grads(self, images, labels):
        """(loss, metrics, gradient tree over ``trainable``)."""
        return value_and_grad(lambda tr: self.loss(tr, images, labels), self.trainable)

    def apply(self, grads, lr: float = LR) -> None:
        """SGDM on ``trainable`` (``grads`` is used as scratch), then the
        planes trimmed to [0, 2] (paper §3.1)."""
        self.opt.update(grads, self.opt_state, self.trainable, lr)
        with torch.no_grad():
            for t in self.trainable.values():
                t["wp"].clamp_(0, 2)
                t["wn"].clamp_(0, 2)

    def step(self, images, labels, lr: float = LR):
        loss, metrics, g = self.grads(images, labels)
        self.apply(g, lr)
        return dict(metrics, loss=loss)

    @torch.no_grad()
    def requant(self):
        """Static requantisation of every rep; returns the scheme."""
        rs = requantize_tree(self._reps(self.trainable), "static")
        self.reps.update(rs)
        self.trainable = {k: r.trainable() for k, r in rs.items()}
        return extract_scheme(rs)

    @torch.no_grad()
    def params(self):
        """The float param tree the bit representation stands for."""
        return merge_params(self.template, reconstruct(self.reps, self.cfg), self.fp)


@torch.no_grad()
def accuracy(params, images, labels, width: int) -> float:
    """Top-1 accuracy of the eval-mode forward with 4-bit activations."""
    logits, _ = resnet20_forward(params, images, train=False, act_bits=ACT_BITS, width=width)
    return float(torch.mean((torch.argmax(logits, -1) == labels).float()))


def main(device=None, steps: int = 60, width: int = 16, batch: int = 64, seed: int = 0):
    """BSQ on ResNet-20.  Returns ``scheme``, ``history`` (one record per
    step: loss, ce, acc, dt in seconds; bits/param and compression at
    each requant), ``params`` (the float tree of the final scheme),
    ``eval_acc`` (top-1 on a held-out batch) and ``width``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    run = PaperBSQ(init_resnet20(gen, width=width, device=device), width)
    rng = np.random.default_rng(seed)
    history = []
    for i in range(steps):
        images, labels = _to(gaussian_blobs(rng, batch), device)
        t0 = time.perf_counter()
        m = run.step(images, labels)
        _sync(device)
        rec = {"step": i + 1, "dt": time.perf_counter() - t0,
               **{k: float(v) for k, v in m.items()}}
        if (i + 1) % REQUANT_INTERVAL == 0:
            s = run.requant()
            rec.update(bits_per_param=s.bits_per_param, compression=s.compression)
            print(f"step {i+1}: ce={rec['ce']:.3f} acc={rec['acc']:.2f} "
                  f"bits/para={s.bits_per_param:.2f} comp={s.compression:.2f}x")
        history.append(rec)

    s = run.requant()
    print("\nper-layer precision (paper Fig. 3 analogue):")
    for name, bits in s.layer_bits().items():
        print(f"  {name:20s} {bits:.0f} bits")
    print(f"bits/para={s.bits_per_param:.2f} comp={s.compression:.2f}x")
    params = run.params()
    eval_acc = accuracy(params, *_eval_batch(device), width)
    print(f"held-out top-1 (gaussian_blobs, {EVAL_BATCH} images): {eval_acc:.3f}")
    return {"scheme": s, "history": history, "params": params, "eval_acc": eval_acc,
            "width": width}


def finetune(scheme, params, device=None, steps: int = 30, width: int = 16, batch: int = 64,
             seed: int = 1, lr: float = FT_LR):
    """The paper's §3.3 step: DoReFa finetuning under the frozen
    ``scheme``, from ``params`` (the float tree BSQ ends with).

    The conv and fc weights train through ``finetune_loss_fn`` (each
    quantised by ``apply_scheme_dorefa`` at its scheme precision); BN
    normalises with batch statistics and updates its running statistics,
    which absorb the DoReFa weights' [-1, 1] range; BN's scale and bias
    stay fixed.  Returns ``history``, ``params`` (quantised, with the
    running statistics) and ``eval_acc`` (top-1 on :func:`main`'s
    held-out batch)."""
    device = resolve_device(device)
    qp, fp = partition_params(params, default_quant_predicate)
    qp = {k: v.detach().clone() for k, v in qp.items()}
    stats = {}

    def task_loss(p, images, labels):
        logits, s = resnet20_forward(p, images, train=True, act_bits=ACT_BITS, width=width)
        stats.update({k: {n: v.detach() for n, v in d.items()} for k, d in s.items()})
        acc = torch.mean((torch.argmax(logits, -1) == labels).float())
        return classification_loss(logits, labels), {"acc": acc}

    def merge(wq, f):
        return merge_params(params, wq, f)

    loss_fn = finetune_loss_fn(task_loss, scheme, merge)
    opt = SGDM(momentum=0.9, weight_decay=1e-4)
    opt_state = opt.init(qp)
    rng = np.random.default_rng(seed)
    history = []
    for i in range(steps):
        images, labels = _to(gaussian_blobs(rng, batch), device)
        t0 = time.perf_counter()
        loss, metrics, g = value_and_grad(lambda q: loss_fn(q, fp, images, labels), qp)
        opt.update(g, opt_state, qp, lr)
        fp = partition_params(merge_bn_stats(merge(qp, fp), stats), default_quant_predicate)[1]
        _sync(device)
        history.append({"step": i + 1, "dt": time.perf_counter() - t0, "ce": float(loss),
                        "acc": float(metrics["acc"])})
    with torch.no_grad():
        out = merge(apply_scheme_dorefa(qp, scheme), fp)
    eval_acc = accuracy(out, *_eval_batch(device), width)
    print(f"finetune: {steps} DoReFa steps under the scheme, ce={history[-1]['ce']:.3f}; "
          f"held-out top-1 {eval_acc:.3f}")
    return {"history": history, "params": out, "eval_acc": eval_acc}


if __name__ == "__main__":
    out = main()
    finetune(out["scheme"], out["params"])
