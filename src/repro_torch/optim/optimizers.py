"""Optimizers and schedules: PyTorch port of ``repro.optim.optimizers``.

SGD+momentum is the paper's optimizer (App. A: momentum 0.9, wd 1e-4);
AdamW is provided for LM-scale runs.  The interface is the JAX
package's: ``init(params) -> state``; ``update(grads, state, params, lr)
-> (new_params, new_state)`` over nested dict trees.  The port updates
IN PLACE under ``torch.no_grad()`` with the ``torch._foreach_*`` ops: the
returned trees are the ones passed in, their tensors overwritten, and
``grads`` is used as scratch.  A full-width BSQ state holds 72 B of
planes per parameter, so a functional update's copies would not fit.
The values are the JAX package's up to f32 rounding (a fused
multiply-add where JAX rounds twice).

Schedules return Python floats computed in f32, as the JAX schedules
compute them on the step array.  The BSQ projection (trim bit-planes to
[0, 2] after each update, paper §3.1) is :func:`project_bitplanes`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..tree import leaves, tree_map

PyTree = Any
_f32 = np.float32


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, f32."""
    ls = [x.float() for x in leaves(tree)]
    norms = torch._foreach_norm(ls)
    return torch.sqrt(torch.sum(torch.stack(norms) ** 2))


@torch.no_grad()
def clip_by_global_norm(grads: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-9))``;
    returns (grads, norm).  No host sync: the factor stays on the device."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    torch._foreach_mul_(leaves(grads), scale)
    return grads, norm


@dataclasses.dataclass(frozen=True)
class SGDM:
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False

    def init(self, params: PyTree) -> PyTree:
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(self, grads, state, params, lr: float):
        g, m, p = leaves(grads), leaves(state), leaves(params)
        if self.weight_decay:
            torch._foreach_add_(g, p, alpha=self.weight_decay)  # g + wd * p
        torch._foreach_mul_(m, self.momentum)
        torch._foreach_add_(m, g)  # m_new = momentum * m + g
        step = m
        if self.nesterov:
            torch._foreach_add_(g, m, alpha=self.momentum)  # momentum * m_new + g
            step = g
        torch._foreach_add_(p, step, alpha=-float(lr))
        return params, state


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params: PyTree) -> Dict[str, PyTree]:
        return {
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
            "count": torch.zeros((), dtype=torch.int32),
        }

    @torch.no_grad()
    def update(self, grads, state, params, lr: float):
        count = state["count"] + 1
        n = _f32(int(count))
        c1 = float(_f32(1.0) - _f32(self.b1) ** n)
        c2 = float(_f32(1.0) - _f32(self.b2) ** n)
        g, mu, nu, p = leaves(grads), leaves(state["mu"]), leaves(state["nu"]), leaves(params)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        denom = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, c1)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(step, p, alpha=self.weight_decay)
        torch._foreach_add_(p, step, alpha=-float(lr))
        return params, {"mu": state["mu"], "nu": state["nu"], "count": count}


# ---------------------------------------------------------------------------
# Schedules (f32 arithmetic, as the JAX schedules do it on the step array)
# ---------------------------------------------------------------------------


def step_decay(base_lr: float, boundaries, factor: float = 0.1) -> Callable[[int], float]:
    """Paper's schedule: decay by ``factor`` at each boundary step."""

    def fn(step) -> float:
        step = int(step)
        lr = _f32(base_lr)
        for b in boundaries:
            if step >= b:
                lr = lr * _f32(factor)
        return float(lr)

    return fn


def cosine_warmup(base_lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step) -> float:
        s = _f32(int(step))
        if s < warmup:
            return float(_f32(base_lr) * s / _f32(max(warmup, 1)))
        frac = np.clip((s - _f32(warmup)) / _f32(max(total - warmup, 1)), _f32(0), _f32(1))
        # (1 - floor) * 0.5 is one Python float in the JAX expression too
        cos = _f32(base_lr) * (_f32(floor) + _f32((1 - floor) * 0.5)
                               * (_f32(1) + np.cos(_f32(math.pi) * frac)))
        return float(cos)

    return fn


# ---------------------------------------------------------------------------
# BSQ-specific projection (paper §3.1: trim planes to [0, 2] post-step)
# ---------------------------------------------------------------------------


@torch.no_grad()
def project_bitplanes(reps: Dict[str, Any]) -> Dict[str, Any]:
    """Clamp every rep's planes to [0, 2] and its scale to >= 1e-8, in place."""
    for r in reps.values():
        r.wp.clamp_(0.0, 2.0)
        r.wn.clamp_(0.0, 2.0)
        r.scale.clamp_(min=1e-8)
    return reps
