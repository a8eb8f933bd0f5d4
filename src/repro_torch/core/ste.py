"""Straight-through estimators and fixed-scheme quantisers: PyTorch port
of ``repro.core.ste``.

Implements paper Eq. 1 (DoReFa-style uniform quantisation STE), Eq. 3
(bit-representation STE) and the activation quantisers of §3.3
(ReLU6-uniform for >=4-bit activations, PACT below).  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) in the forward pass, identity in the backward pass."""
    return x + (torch.round(x) - x).detach()


def ste_clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """clip in the forward pass, identity gradient inside AND outside."""
    return x + (torch.clamp(x, lo, hi) - x).detach()


def uniform_quantize(x: torch.Tensor, k_bits: int) -> torch.Tensor:
    """Quantise x in [0,1] to ``2^k - 1`` uniform levels with round-STE (Eq. 1)."""
    levels = 2.0**k_bits - 1.0
    return ste_round(x * levels) / levels


class _BitRepSTE(torch.autograd.Function):
    """``scale * Round[sum_b (wp_b - wn_b) m_b 2^b] / (2^n - 1)``.

    The forward sums the planes one at a time in plane order and saves
    only the rounded code (one weight-sized tensor) and the scale, never
    a plane-sized temporary: a full-width embedding's planes are 3.6 GB
    each.  The backward is JAX's derivative of ``bitrep_forward``: with
    ``g1 = g / (2^n - 1)``, plane b of wp gets ``(g1 * scale) * 2^b * m_b``
    and wn its negation (products by powers of two and {0,1}, exact in
    any order), the scale ``sum(g1 * q)`` over its broadcast axes.
    """

    @staticmethod
    def forward(ctx, wp, wn, scale, mask, n_denom: int):
        m = mask.to(wp.dtype)
        acc = None
        for b in range(wp.shape[0]):
            t = ((wp[b] - wn[b]) * m[b]) * (2.0**b)
            acc = t if acc is None else acc + t
        q = torch.round(acc)
        denom = 2.0**n_denom - 1.0
        ctx.save_for_backward(q, scale, m)
        ctx.denom = denom
        return scale * q / denom

    @staticmethod
    def backward(ctx, g):
        q, scale, m = ctx.saved_tensors
        g1 = g / ctx.denom
        g_wp = g_wn = g_scale = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            g_q = g1 * scale
            nb = m.shape[0]
            g_wp = torch.empty((nb,) + tuple(g_q.shape), dtype=g_q.dtype, device=g_q.device)
            for b in range(nb):
                # m_b 2^b is 0 or a power of two: the product is exact, so
                # it equals JAX's (g_q 2^b) m_b without a weight-sized temporary
                torch.mul(g_q, m[b] * (2.0**b), out=g_wp[b])
            g_wn = torch.neg(g_wp) if ctx.needs_input_grad[1] else None
            if not ctx.needs_input_grad[0]:
                g_wp = None
        if ctx.needs_input_grad[2]:
            g_scale = (g1 * q).sum_to_size(scale.shape)
        return g_wp, g_wn, g_scale, None, None


def bitrep_forward(wp, wn, scale, mask, n_denom: int) -> torch.Tensor:
    """Bit-representation STE forward (paper Eq. 3).

    ``W_q = Round[sum_b (wp_b - wn_b) 2^b] / (2^n - 1)``; the backward
    routes ``2^b/(2^n-1) * dL/dW_q`` to plane ``b`` (the Round is an STE).
    Returns the reconstructed weight ``scale * W_q``.
    """
    return _BitRepSTE.apply(wp, wn, scale, mask, n_denom)


# ---------------------------------------------------------------------------
# DoReFa weight quantiser (post-BSQ finetune, §3.3, and the Table 1
# "train from scratch under the same scheme" baseline).
# ---------------------------------------------------------------------------


def dorefa_weight(w: torch.Tensor, k_bits: int) -> torch.Tensor:
    """DoReFa-Net k-bit weight quantiser (Zhou et al. 2016).

    ``w_q = 2 * quantize_k( tanh(w) / (2 max|tanh(w)|) + 1/2 ) - 1``.
    k_bits == 32 returns w unchanged; k_bits == 0 returns zeros.
    """
    if k_bits >= 32:
        return w
    if k_bits == 0:
        return torch.zeros_like(w)
    t = torch.tanh(w)
    t = t / (2.0 * torch.amax(torch.abs(t)) + 1e-12) + 0.5
    return 2.0 * uniform_quantize(t, k_bits) - 1.0


def fixed_scheme_weight(w: torch.Tensor, k_bits: int, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric k-bit quantiser with a frozen scale (serving-style QAT)."""
    if k_bits >= 32:
        return w
    if k_bits == 0:
        return torch.zeros_like(w)
    levels = 2.0**k_bits - 1.0
    ws = torch.clamp(w / scale, -1.0, 1.0)
    return scale * ste_round(ws * levels) / levels


# ---------------------------------------------------------------------------
# Activation quantisers (paper §3.3 "Activation quantization").
# ---------------------------------------------------------------------------


def relu6_act_quantize(x: torch.Tensor, k_bits: int) -> torch.Tensor:
    """ReLU6 + uniform quantisation, for activation precision >= 4 bits."""
    if k_bits >= 32:
        return F.relu(x)
    y = torch.clamp(x, 0.0, 6.0) / 6.0
    return uniform_quantize(y, k_bits) * 6.0


def pact_act_quantize(x: torch.Tensor, alpha: torch.Tensor, k_bits: int) -> torch.Tensor:
    """PACT (Choi et al. 2018): trainable clip value ``alpha``.

    Forward: clip to [0, alpha], quantise uniformly.  Gradient flows to
    ``alpha`` for x >= alpha through the clip itself.
    """
    y = torch.minimum(torch.clamp(x, min=0.0), alpha)
    if k_bits >= 32:
        return y
    return uniform_quantize(y / alpha, k_bits) * alpha


def act_quantize(x: torch.Tensor, k_bits: int, pact_alpha=None) -> torch.Tensor:
    """Paper policy: ReLU6-uniform for >=4-bit, PACT below."""
    if k_bits >= 4 or pact_alpha is None:
        return relu6_act_quantize(x, k_bits)
    return pact_act_quantize(x, pact_alpha, k_bits)
