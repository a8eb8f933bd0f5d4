"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427):
PyTorch port of ``repro.models.rglru``.

Recurrence (per channel):
    r_t = sigmoid(x_t W_r + b_r)            # recurrence gate
    i_t = sigmoid(x_t W_i + b_i)            # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  # c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train/prefill runs the elementwise linear recurrence as a doubling scan
(log2(S) steps of JAX's ``associative_scan`` combine, f32); decode is a
single step.  The full Griffin block is: gate branch (GeLU) x recurrent
branch (conv1d -> RG-LRU), then the output projection.  Recurrence width
R = d_model.  Prefill convolves in ``x.dtype``; decode convolves in f32
and casts before the gates, as JAX does.  No Pallas kernel is on this
path in JAX, and none is here.

On a ("data", "model") mesh (``common.packed_shard_mesh``; ``lane_ax``,
the state's batch entry under the cache rules) every matrix is a block
whose products are stitched whole (the gate and input branches in one
reduction and one gather, the two gates likewise, their biases' blocks
added into the partial products where the rules split the stacked
biases' layer axis: ``core.packing.RowsBlock``); the conv, whose
weights replicate, the gates' elementwise part and the scan run on this
rank's lanes with whole channels and their state; the conv's output is
gathered for the gate products and the lanes' outputs for the
row-parallel ``w_out``.  This lane split is serving's (no gradient flows
through it): the training forward passes no ``lane_ax`` and runs every
lane on each rank, its products stitched under the training view.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import (causal_conv, causal_conv_window, conv_tail, dense_apply, dense_init,
                     dense_whole, gather_lanes, lanes)

Params = Dict[str, torch.Tensor]

_C = 8.0


def rglru_init(gen: torch.Generator, d_model: int, width: int, device,
               conv_w: int = 4) -> Params:
    """JAX ``rglru_init``'s distributions, drawn from ``gen``."""
    f32 = dict(dtype=torch.float32, device=device)
    # Lambda init so a^(1/c) ~ U[0.9, 0.999] (paper App. A)
    u = torch.rand((width,), generator=gen, **f32) * (0.999 - 0.9) + 0.9
    lam = torch.log(torch.expm1(-torch.log(u)))  # softplus^{-1}(-log u)
    return {
        "w_gate_branch": dense_init(gen, d_model, width, device),
        "w_x": dense_init(gen, d_model, width, device),
        "conv_w": torch.randn((conv_w, width), generator=gen, **f32) * 0.1,
        "conv_b": torch.zeros((width,), **f32),
        "w_rgate": dense_init(gen, width, width, device),
        "b_rgate": torch.zeros((width,), **f32),
        "w_igate": dense_init(gen, width, width, device),
        "b_igate": torch.zeros((width,), **f32),
        "rg_lambda": lam,
        "w_out": dense_init(gen, width, d_model, device),
    }


def _gates(p: Params, xr: torch.Tensor, lane_ax=None):
    """(a, b) of the recurrence, f32, of ``xr``'s lanes (this rank's on a
    mesh: ``xr`` is gathered for the two products, which are then cut back
    to its lanes)."""
    whole = gather_lanes(xr, lane_ax)
    rg, ig = dense_whole(whole, [p["w_rgate"], p["w_igate"]],
                         biases=[p["b_rgate"], p["b_igate"]])
    b0, b1 = lanes(lane_ax, whole.shape[0])
    r = torch.sigmoid(rg[b0:b1])
    i = torch.sigmoid(ig[b0:b1])
    log_a = -_C * F.softplus(p["rg_lambda"])[None] * r.to(torch.float32)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    b = beta * (i.to(torch.float32) * xr.to(torch.float32))
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """h_t = a_t h_{t-1} + b_t along axis 1 (f32 (B, S, R) each).

    A doubling scan: after the step of offset d every position holds the
    combine of the 2d inputs ending at it, under JAX's
    ``associative_scan`` combine ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 +
    b2)``; log2(S) steps of whole-tensor ops.  The sums run in another
    order than JAX's tree, so the two agree within f32 rounding."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, :-d] * a[:, d:]], dim=1)
        d *= 2
    return b


def _out(p: Params, gate: torch.Tensor, h: torch.Tensor, dtype, lane_ax=None) -> torch.Tensor:
    return dense_apply(gather_lanes((gate.to(torch.float32) * h).to(dtype), lane_ax), p["w_out"])


def _branches(p: Params, x: torch.Tensor, lane_ax):
    """The gate branch (GeLU) and the recurrent branch's input, of this
    rank's lanes."""
    g, xr = dense_whole(x, [p["w_gate_branch"], p["w_x"]])
    b0, b1 = lanes(lane_ax, x.shape[0])
    return F.gelu(g[b0:b1], approximate="tanh"), xr[b0:b1]


def rglru_apply(p: Params, x: torch.Tensor, lane_ax=None):
    """Train/prefill. x: (B, S, D). Returns (y, (h_final, conv_tail)), the
    state and tail of this rank's lanes on a mesh (``lane_ax``)."""
    gate, conv_in = _branches(p, x, lane_ax)
    a, b = _gates(p, causal_conv(conv_in, p["conv_w"], p["conv_b"]), lane_ax)
    h = rglru_scan(a, b)
    W = p["conv_w"].shape[0]
    # the pre-conv tail, the state decode continues from
    return _out(p, gate, h, x.dtype, lane_ax), (h[:, -1], conv_in[:, -(W - 1):, :])


def rglru_prefill_chunk(p: Params, x: torch.Tensor, h0: torch.Tensor, conv_state: torch.Tensor,
                        n_valid: torch.Tensor, lane_ax=None):
    """Chunked prefill (``x`` (B, C, D)) with the state (B, R) f32 and
    the pre-conv ``xr`` tail (B, W-1, R) carried across chunks.

    Pad positions (``i >= n_valid[b]``) are forced to the recurrence's
    identity (``a = 1, b = 0``), so the scan's last entry is the state at
    each lane's last real token, and a lane with ``n_valid = 0`` passes
    its state and conv tail through unchanged.  The zero tail a fresh
    lane starts from matches ``causal_conv``'s zero padding.  Returns (y
    (B, C, D), final state, new conv tail), new tensors.  On a mesh the
    state, tail and ``n_valid`` are this rank's lanes' (``lane_ax``)."""
    C = x.shape[1]
    gate, xr = _branches(p, x, lane_ax)  # (B_l, C, R)
    W = p["conv_w"].shape[0]
    window = torch.cat([conv_state.to(x.dtype), xr], dim=1)
    a, b = _gates(p, causal_conv_window(window, p["conv_w"], p["conv_b"], C), lane_ax)
    b0, b1 = lanes(lane_ax, x.shape[0])
    nv = n_valid[b0:b1].to(device=x.device, dtype=torch.int64)
    pad = (torch.arange(C, device=x.device)[None, :] >= nv[:, None])[..., None]  # (B, C, 1)
    a = a.masked_fill(pad, 1.0)
    b = b.masked_fill(pad, 0.0)
    h = rglru_scan(a, b, h0)
    return _out(p, gate, h, x.dtype, lane_ax), h[:, -1], conv_tail(window, nv, W - 1)


def rglru_decode(p: Params, x: torch.Tensor, h: torch.Tensor, conv_state: torch.Tensor,
                 lane_ax=None):
    """One token (``x`` (B, 1, D)); ``h`` (B, R) f32, ``conv_state`` (B,
    W-1, R).  Returns (y (B, 1, D), new state, new conv tail), new
    tensors; the inputs are not written.  On a mesh the state and tail
    are this rank's lanes' (``lane_ax``)."""
    gate, xr = _branches(p, x, lane_ax)  # (B_l, 1, R)
    wdt = torch.promote_types(conv_state.dtype, xr.dtype)
    window = torch.cat([conv_state.to(wdt), xr.to(wdt)], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", window.to(torch.float32), p["conv_w"]) + p["conv_b"]
    new_conv = window[:, 1:]
    a, b = _gates(p, conv_out.to(x.dtype), lane_ax)
    h_new = a * h + b
    return _out(p, gate[:, 0], h_new, x.dtype, lane_ax)[:, None], h_new, new_conv
