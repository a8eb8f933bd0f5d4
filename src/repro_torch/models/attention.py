"""Attention, "attn" kind (full causal GQA): PyTorch port of the prefill
and contiguous-cache decode paths of ``repro.models.attention``.

Scores and softmax run in f32.  Sliding-window ring buffers, the paged
block pool and cross-attention come with later slices of the port.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import apply_rope, dense_apply, dense_init

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def attn_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int, head_dim: int,
              device) -> Params:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, device),
        "wk": dense_init(gen, d_model, n_kv * head_dim, device),
        "wv": dense_init(gen, d_model, n_kv * head_dim, device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, device),
    }


def _qkv(p: Params, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int,
         active_planes=None):
    B, S, _ = x.shape
    q = dense_apply(x, p["wq"], active_planes).reshape(B, S, n_heads, head_dim)
    k = dense_apply(x, p["wk"], active_planes).reshape(B, S, n_kv, head_dim)
    v = dense_apply(x, p["wv"], active_planes).reshape(B, S, n_kv, head_dim)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, K, G, d); k: (B, Sk, K, d) -> (B, K, G, Sq, Sk) in f32
    (products of the inputs summed in f32, as preferred_element_type=f32)."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32), k.to(torch.float32))


def _gqa_combine(w: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """w: (B, K, G, Sq, Sk); v: (B, Sk, K, d) -> (B, Sq, K*G*d)."""
    o = torch.einsum("bkgqs,bskd->bqkgd", w.to(dtype), v.to(dtype))
    return o.reshape(o.shape[0], o.shape[1], -1)


def _softmax_masked(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    s = torch.where(valid, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    s = s - torch.amax(s, dim=-1, keepdim=True)
    return torch.softmax(s, dim=-1)


def attention(
    p: Params,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    q_chunk: int = 1024,
    active_planes=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal self-attention for prefill.  q is pre-scaled by
    ``head_dim**-0.5``; queries run in chunks of ``q_chunk``.  Returns
    (out, (k, v)) so prefill can seed the decode cache."""
    B, S, _ = x.shape
    G = n_heads // n_kv
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, active_planes)
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    q = q.reshape(B, S, n_kv, G, head_dim) * (head_dim**-0.5)
    kpos = torch.arange(S, device=x.device)
    if S > q_chunk and S % q_chunk:
        raise ValueError(f"prefill length {S} is not a multiple of q_chunk={q_chunk}")
    outs = []
    for q0 in range(0, S, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        qpos = q0 + torch.arange(qc.shape[1], device=x.device)
        s = _gqa_scores(qc, k)
        w = _softmax_masked(s, (qpos[:, None] >= kpos[None, :])[None, None, None])
        outs.append(_gqa_combine(w, v, x.dtype))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return dense_apply(out, p["wo"], active_planes), (k, v)


def decode_attention(
    p: Params,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    pos,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    active: Optional[torch.Tensor] = None,
    active_planes=None,
) -> torch.Tensor:
    """One-token decode over a contiguous cache.  x: (B, 1, D);
    cache_[kv]: (B, Smax, K, d), UPDATED IN PLACE (the JAX version returns
    new caches); returns the attention output (B, 1, D).

    ``pos`` is a scalar position shared by every lane (an int or a 0-d
    tensor: the bucketed path) or a (B,) tensor of per-slot positions.
    ``active`` (per-slot only, (B,) bool) keeps inactive lanes' cache
    rows untouched."""
    B = x.shape[0]
    G = n_heads // n_kv
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, active_planes)
    per_slot = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if per_slot:
        posb = pos.to(device=x.device, dtype=torch.int64)[:, None]
    else:
        posb = torch.full((B, 1), int(pos), dtype=torch.int64, device=x.device)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    if per_slot:
        bidx = torch.arange(B, device=x.device)
        lane_pos = posb[:, 0]
        k_row, v_row = k[:, 0].to(cache_k.dtype), v[:, 0].to(cache_v.dtype)
        if active is not None:
            keep = active[:, None, None]
            k_row = torch.where(keep, k_row, cache_k[bidx, lane_pos])
            v_row = torch.where(keep, v_row, cache_v[bidx, lane_pos])
        cache_k[bidx, lane_pos] = k_row
        cache_v[bidx, lane_pos] = v_row
    else:
        cache_k[:, int(pos)] = k[:, 0].to(cache_k.dtype)
        cache_v[:, int(pos)] = v[:, 0].to(cache_v.dtype)
    q = q.reshape(B, 1, n_kv, G, head_dim) * (head_dim**-0.5)
    s = _gqa_scores(q, cache_k.to(x.dtype))  # (B, K, G, 1, Smax)
    kpos = torch.arange(cache_k.shape[1], device=x.device)
    valid = (kpos[None, :] <= posb)[:, None, None, None, :]
    w = torch.softmax(torch.where(valid, s, torch.full((), NEG_INF, device=s.device)), dim=-1)
    out = _gqa_combine(w, cache_v.to(x.dtype), x.dtype)
    return dense_apply(out, p["wo"], active_planes)
