"""BSQ training (the paper's Eq. 3-5) followed step by step in float32.

Each quantised weight W becomes ``n_max`` planes of its positive and of
its negative part: s = max|W| per group (a stacked weight's layer, the
whole tensor otherwise), q = round(|W| / s * (2^n - 1)), bit b of q in
plane b of wp where W >= 0 and of wn elsewhere; planes past ``n_init``
start masked.  The forward uses s * round(sum_b (wp_b - wn_b) m_b 2^b) /
(2^n - 1), the rounding passed straight through by the gradient.  The
objective is the mean next-token cross-entropy over the padded vocabulary
plus alpha times the memory-reweighed bit-level group Lasso: per tensor,
sum over groups of sqrt(sum wp_b^2 + sum wn_b^2) of each active plane,
weighed by (elements per group * active bits / all quantised elements);
for a stacked tensor, as the configured objective has it, the sum of the
weights times the sum of the groups' terms.  Then the gradient's global
norm is clipped, SGD with momentum and weight decay updates every leaf,
and the planes are clamped to [0, 2], the scales to at least 1e-8.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .lm import Model


def group_axes(w: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(w.ndim - 2)) if w.ndim > 2 else ()


def decompose(w: torch.Tensor, n_init: int, n_max: int):
    """(wp, wn, scale, mask) of ``w`` in f32."""
    w = w.to(torch.float32)
    ga = group_axes(w)
    red = tuple(i for i in range(w.ndim) if i not in ga)
    s = torch.amax(torch.abs(w), dim=red, keepdim=True)
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.round(torch.abs(w / s) * (2**n_init - 1)).to(torch.int64)
    bits = torch.stack([((q >> b) & 1).to(torch.float32) for b in range(n_max)])
    pos = (w >= 0).to(torch.float32)
    mask = torch.ones((n_max,) + tuple(s.shape), dtype=torch.float32, device=w.device)
    mask[n_init:] = 0.0
    return bits * pos, bits * (1.0 - pos), s, mask


def reconstruct(wp, wn, scale, mask, n_init: int) -> torch.Tensor:
    acc = sum((wp[b] - wn[b]) * mask[b] * (2.0**b) for b in range(wp.shape[0]))
    q = acc + (torch.round(acc) - acc).detach()
    return scale * q / (2.0**n_init - 1.0)


def regulariser(reps: Dict[str, dict], masks: Dict[str, torch.Tensor], total: int
                ) -> torch.Tensor:
    out = 0.0
    for name, r in reps.items():
        wp, wn, m = r["wp"], r["wn"], masks[name]
        ga = group_axes(wp[0])
        red = tuple(1 + i for i in range(wp.ndim - 1) if i not in ga)
        sq = torch.sum(wp * wp, dim=red) + torch.sum(wn * wn, dim=red)  # (n_max, *groups)
        mg = m.reshape(sq.shape)
        g = torch.sum(torch.sqrt(sq + 1e-12) * mg, dim=0)  # per group
        active = mg > 0
        idx = torch.arange(mg.shape[0], device=mg.device).reshape((-1,) + (1,) * (mg.ndim - 1))
        msb = torch.amax(torch.where(active, idx, -1), dim=0)
        lsb = torch.amin(torch.where(active, idx, mg.shape[0]), dim=0)
        bits = torch.where(active.any(dim=0), msb - lsb + 1, 0).to(torch.float32)
        n_el = 1
        for i, d in enumerate(wp.shape[1:]):
            if i not in ga:
                n_el *= d
        weight = n_el * bits / float(total)
        out = out + torch.sum(weight) * torch.sum(g)
    return out


class Trainer:
    """The BSQ state and its steps, from the float weights ``w0`` (flat
    key paths, f32) and the names of the quantised leaves."""

    def __init__(self, program: dict, w0: Dict[str, torch.Tensor], quantised: Sequence[str],
                 bsq: dict, precision: str = "f32"):
        self.program, self.bsq, self.precision = program, bsq, precision
        self.n_init, self.n_max = int(bsq["n_init"]), int(bsq["n_max"])
        self.reps, self.masks, self.floats = {}, {}, {}
        for name, w in w0.items():
            if name in quantised:
                wp, wn, s, m = decompose(w, self.n_init, self.n_max)
                self.reps[name] = {"wp": wp, "wn": wn, "scale": s}
                self.masks[name] = m
            else:
                self.floats[name] = w.to(torch.float32).clone()
        self.total = sum(w0[n].numel() for n in self.reps)
        self.mom = {k: torch.zeros_like(v) for k, v in self.leaves().items()}

    def leaves(self) -> Dict[str, torch.Tensor]:
        """Every trainable leaf by name: ``reps/<w>/wp|wn|scale``, ``float/<w>``."""
        out = {f"reps/{n}/{k}": t for n, r in self.reps.items() for k, t in r.items()}
        out.update({f"float/{n}": t for n, t in self.floats.items()})
        return out

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor):
        w = {n: reconstruct(r["wp"], r["wn"], r["scale"], self.masks[n], self.n_init)
             for n, r in self.reps.items()}
        w.update(self.floats)
        model = Model(self.program, w, packed=(), precision=self.precision)
        logits = torch.cat([model.padded_logits(t) for t in tokens])
        ce = torch.nn.functional.cross_entropy(logits, labels.reshape(-1))
        reg = regulariser(self.reps, self.masks, self.total)
        return ce + float(self.bsq["alpha"]) * reg

    def step(self, tokens: torch.Tensor, labels: torch.Tensor):
        """One step; returns (objective, {leaf: the gradient the optimiser
        gets, after the clip})."""
        leaves = self.leaves()
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            loss = self.loss(tokens, labels)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            clip = torch.clamp(float(self.bsq["grad_clip"]) / (norm + 1e-9), max=1.0)
            grads = {k: g * clip for k, g in grads.items()}
            lr, mu, wd = (float(self.bsq[k]) for k in ("lr", "momentum", "weight_decay"))
            for k, p in leaves.items():
                m = self.mom[k]
                m.mul_(mu).add_(grads[k] + wd * p)
                p.add_(m, alpha=-lr)
            for r in self.reps.values():
                r["wp"].clamp_(0.0, 2.0)
                r["wn"].clamp_(0.0, 2.0)
                r["scale"].clamp_(min=1e-8)
        return float(loss.detach()), grads


def initial_leaves(w0: Dict[str, torch.Tensor], quantised: Sequence[str], bsq: dict):
    """Each trainable leaf's value before the first step, one at a time:
    yields (leaf name, tensor)."""
    for name, w in w0.items():
        if name in quantised:
            wp, wn, s, _ = decompose(w, int(bsq["n_init"]), int(bsq["n_max"]))
            yield f"reps/{name}/wp", wp
            yield f"reps/{name}/wn", wn
            yield f"reps/{name}/scale", s
            del wp, wn
        else:
            yield f"float/{name}", w.to(torch.float32)


def follow(program: dict, w0, quantised, bsq: dict, batches: List[Tuple[torch.Tensor, torch.Tensor]],
           precision: str = "f32") -> dict:
    """The reference's readings of the first len(batches) steps: each
    step's objective, each leaf's norm of the first step's clipped
    gradient, and each leaf's norm of its change over all the steps."""
    tr = Trainer(program, w0, quantised, bsq, precision)
    losses, grad_norms = [], None
    for i, (tok, lab) in enumerate(batches):
        loss, grads = tr.step(tok, lab)
        losses.append(loss)
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        del grads
    now = tr.leaves()
    change = {}
    for name, t0 in initial_leaves(w0, quantised, bsq):
        change[name] = float(torch.linalg.vector_norm(now[name] - t0))
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
