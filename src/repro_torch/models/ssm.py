"""Mamba-2 SSD (state-space duality) block: PyTorch port of
``repro.models.ssm``, the chunked train/prefill path and the O(1)-per-token
recurrent decode path.

Shapes: d_inner = expand * d_model, H = d_inner // head_dim heads, state
size N, B/C shared across heads (G = 1 group).  The chunked algorithm
(Dao & Gu 2024, §6) splits the sequence into chunks of Q tokens:
quadratic attention-like math within a chunk, a linear recurrence across
chunk boundaries (a Python loop over the chunks where JAX scans).  All
decay math is f32 (decays are exp of non-positive sums, so in (0, 1]).

The dtypes are JAX's: prefill convolves in ``x.dtype``, decode convolves
in f32 and casts after the SiLU; ``dt``, the state and the inter-chunk
term are f32; the gated norm is ``rmsnorm`` at its default eps.  No
Pallas kernel is on this path in JAX, and none is here.

On a ("data", "model") mesh (``common.packed_shard_mesh``; ``lane_ax``,
the state's batch entry under the cache rules) ``in_proj``'s output is
stitched whole before the z | x | B | C | dt split (its N block would cut
across the pieces); the conv, the SSD scan, the skip and the gated norm
(over all of d_inner) run on this rank's lanes and their state; the
lanes' outputs are gathered before the row-parallel ``out_proj``.
This lane split is serving's (no gradient flows through it): the
training forward passes no ``lane_ax`` and runs every lane on each
rank, its products stitched under the training view.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .common import (causal_conv, causal_conv_window, conv_tail, dense_apply, dense_init,
                     gather_lanes, lanes, rmsnorm)

Params = Dict[str, torch.Tensor]


def ssm_dims(d_model: int, expand: int, head_dim: int, state: int):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * state  # xs + B + C  (G = 1 group)
    return d_inner, n_heads, conv_dim


def ssm_init(gen: torch.Generator, d_model: int, expand: int, head_dim: int, state: int,
             conv_w: int, device) -> Params:
    """JAX ``ssm_init``'s distributions, drawn from ``gen``."""
    d_inner, H, conv_dim = ssm_dims(d_model, expand, head_dim, state)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection -> [z (d_inner), xBC (conv_dim), dt (H)]
        "in_proj": dense_init(gen, d_model, 2 * d_inner + 2 * state + H, device),
        "conv_w": torch.randn((conv_w, conv_dim), generator=gen, **f32) * 0.1,
        "conv_b": torch.zeros((conv_dim,), **f32),
        "a_log": torch.log(torch.arange(1, H + 1, **f32)),
        "dt_bias": torch.zeros((H,), **f32),
        "d_skip": torch.ones((H,), **f32),
        "norm": {"scale": torch.zeros((d_inner,), **f32)},
        "out_proj": dense_init(gen, d_inner, d_model, device),
    }


def _split(p: Params, x: torch.Tensor, d_inner: int, state: int, H: int, lane_ax=None):
    """z, xBC, dt of this rank's lanes (every lane off a mesh)."""
    proj = dense_apply(x, p["in_proj"])
    b0, b1 = lanes(lane_ax, proj.shape[0])
    proj = proj[b0:b1]
    z = proj[..., :d_inner]
    xBC = proj[..., d_inner:2 * d_inner + 2 * state]
    dt = proj[..., -H:]
    return z, xBC, dt


def ssd_chunked(xs: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int = 256,
                h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """xs (B, S, H, P), dt (B, S, H) post-softplus f32, a (H,) negative
    f32, Bm/Cm (B, S, N).  Returns (y (B, S, H, P), final state (B, H, P,
    N) f32)."""
    Bsz, S, H, P = xs.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q
    f32 = torch.float32

    la = (dt * a[None, None]).to(f32).reshape(Bsz, nc, Q, H)  # log-decay
    cum = torch.cumsum(la, dim=2)  # inclusive
    dtx = (xs * dt[..., None].to(xs.dtype)).reshape(Bsz, nc, Q, H, P)
    Bc = Bm.reshape(Bsz, nc, Q, N).to(f32)
    Cc = Cm.reshape(Bsz, nc, Q, N).to(f32)

    # --- intra-chunk (quadratic within Q) ---------------------------------
    # L[q, k] = exp(cum_q - cum_k) for q >= k else 0 (per head)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Qk, H)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xs.device))
    mask = mask[None, None, :, :, None]
    # mask BEFORE exp: exp(diff) overflows for the (discarded) k > q
    # entries, and where(mask, inf, 0) gives NaN gradients (0 * inf)
    L = torch.exp(diff.masked_fill(~mask, -60.0))
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    M = CB[..., None] * L  # (B, nc, Q, Qk, H)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M.to(xs.dtype), dtx)

    # --- chunk states and inter-chunk recurrence --------------------------
    seg_end = torch.exp(cum[:, :, -1:, :] - cum)  # decay from position k to chunk end
    S_c = torch.einsum("bckn,bckhp->bchpn", Bc, dtx.to(f32) * seg_end[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B, nc, H)

    h = torch.zeros((Bsz, H, P, N), dtype=f32, device=xs.device) if h0 is None else h0
    h_in = []  # the state entering each chunk
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B, nc, H, P, N)

    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, torch.exp(cum), h_in).to(xs.dtype)
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y, h


def _gated_out(p: Params, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
               d_inner: int, lane_ax=None) -> torch.Tensor:
    """The skip term, the SiLU gate, the gated norm and ``out_proj`` (the
    lanes gathered before it on a mesh)."""
    d_skip = p["d_skip"].to(xs.dtype)
    y = y + xs * d_skip.reshape((1,) * (xs.ndim - 2) + (-1, 1))
    y = y.reshape(*z.shape[:-1], d_inner)
    y = rmsnorm(p["norm"], y * F.silu(z))
    return dense_apply(gather_lanes(y, lane_ax), p["out_proj"])


def _xs_b_c(conv_out: torch.Tensor, d_inner: int, state: int, H: int, head_dim: int):
    xs = conv_out[..., :d_inner].reshape(*conv_out.shape[:-1], H, head_dim)
    return xs, conv_out[..., d_inner:d_inner + state], conv_out[..., d_inner + state:]


def ssm_apply(p: Params, x: torch.Tensor, *, expand: int, head_dim: int, state: int,
              chunk: int = 256, lane_ax=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Train/prefill forward. Returns (y, final_state); on a mesh the
    final state of this rank's lanes (``lane_ax``)."""
    d_inner, H, _ = ssm_dims(x.shape[-1], expand, head_dim, state)
    z, xBC, dt = _split(p, x, d_inner, state, H, lane_ax)
    xs, Bm, Cm = _xs_b_c(F.silu(causal_conv(xBC, p["conv_w"], p["conv_b"])), d_inner, state,
                         H, head_dim)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])
    y, hT = ssd_chunked(xs, dt, a, Bm, Cm, chunk=chunk)
    return _gated_out(p, y, xs, z, d_inner, lane_ax), hT


def ssm_prefill_chunk(p: Params, x: torch.Tensor, ssm_state: torch.Tensor,
                      conv_state: torch.Tensor, n_valid: torch.Tensor, *, expand: int,
                      head_dim: int, state: int, lane_ax=None):
    """Chunked prefill: C tokens per lane (``x`` (B, C, D)) with the state
    (B, H, P, N) f32 and the pre-conv xBC tail (B, W-1, conv_dim) carried
    across chunks (the continuous-batching slot pool).

    Trailing pad positions (``i >= n_valid[b]``) get dt = 0: decay
    ``exp(0 a) = 1`` and input ``dt x = 0`` make them exact no-ops on the
    recurrence, so the returned state is the state at each lane's last
    real token, and a lane with ``n_valid = 0`` passes its state and conv
    tail through unchanged.  Returns (y (B, C, D), final state, new conv
    tail), new tensors; the inputs are not written.  On a mesh the state,
    tail and ``n_valid`` are this rank's lanes' (``lane_ax``)."""
    C, d_model = x.shape[1:]
    d_inner, H, _ = ssm_dims(d_model, expand, head_dim, state)
    z, xBC, dt = _split(p, x, d_inner, state, H, lane_ax)
    b0, b1 = lanes(lane_ax, x.shape[0])
    n_valid = n_valid[b0:b1]
    W = p["conv_w"].shape[0]
    # causal conv with the previous chunk's tail as left context (zeros at
    # admission == causal_conv's zero padding, so chunk 0 matches prefill)
    window = torch.cat([conv_state.to(x.dtype), xBC], dim=1)
    conv_out = F.silu(causal_conv_window(window, p["conv_w"], p["conv_b"], C))
    nv = n_valid.to(device=x.device, dtype=torch.int64)
    new_conv = conv_tail(window, nv, W - 1)
    xs, Bm, Cm = _xs_b_c(conv_out, d_inner, state, H, head_dim)
    dtv = F.softplus(dt.to(torch.float32) + p["dt_bias"])  # (B, C, H)
    valid = torch.arange(C, device=x.device)[None, :] < nv[:, None]
    dtv = dtv.masked_fill(~valid[..., None], 0.0)
    a = -torch.exp(p["a_log"])
    y, hT = ssd_chunked(xs, dtv, a, Bm, Cm, chunk=C, h0=ssm_state)
    return _gated_out(p, y, xs, z, d_inner, lane_ax), hT, new_conv


def ssm_decode(p: Params, x: torch.Tensor, ssm_state: torch.Tensor, conv_state: torch.Tensor,
               *, expand: int, head_dim: int, state: int, lane_ax=None):
    """Single-token recurrent step: h' = exp(dt a) h + dt x (x) B; y = C.h.
    ``x`` (B, 1, D).  Returns (y (B, 1, D), new state, new conv tail), new
    tensors; the inputs are not written.  On a mesh the state and tail
    are this rank's lanes' (``lane_ax``)."""
    d_inner, H, _ = ssm_dims(x.shape[-1], expand, head_dim, state)
    z, xBC, dt = _split(p, x, d_inner, state, H, lane_ax)
    f32 = torch.float32
    # conv over [conv_state ; xBC] in f32, as JAX's einsum over the
    # promoted window
    wdt = torch.promote_types(conv_state.dtype, xBC.dtype)
    window = torch.cat([conv_state.to(wdt), xBC.to(wdt)], dim=1)  # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window.to(f32), p["conv_w"]) + p["conv_b"]
    conv_out = F.silu(conv_out).to(x.dtype)
    new_conv = window[:, 1:]
    xs, Bm, Cm = _xs_b_c(conv_out, d_inner, state, H, head_dim)  # xs (B, H, P)
    dtv = F.softplus(dt[:, 0].to(f32) + p["dt_bias"])  # (B, H)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dtv * a[None])  # (B, H)
    inp = torch.einsum("bhp,bn->bhpn", xs.to(f32) * dtv[..., None], Bm.to(f32))
    h = ssm_state * decay[:, :, None, None] + inp
    y = torch.einsum("bhpn,bn->bhp", h, Cm.to(f32)).to(x.dtype)
    return _gated_out(p, y[:, None], xs[:, None], z, d_inner, lane_ax), h, new_conv
