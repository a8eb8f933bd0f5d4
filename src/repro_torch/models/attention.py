"""Attention, "attn" kind (full causal GQA): PyTorch port of the prefill,
decode (contiguous and paged) and chunked-prefill paths of
``repro.models.attention``.

Scores and softmax run in f32.  Caches are updated IN PLACE (the JAX
functions return new ones).  JAX drops out-of-range scatter writes
(``mode="drop"``); PyTorch has no such mode, so the pool layouts carry a
sentinel instead: a paged pool has one spare block past the allocator's
``n_blocks`` (index ``n_blocks``, never granted, never in a live table
range) and the slot pool's contiguous cache one spare row past
``max_len``.  Writes JAX would drop are redirected there, so every write
of a call lands on a distinct row except the sentinel's, which nothing
reads.  Sliding-window ring buffers, the sharded paged path and
cross-attention come with later slices of the port.
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


def _pool_gather(cache_k: torch.Tensor, cache_v: torch.Tensor, block_table: torch.Tensor,
                 n_kv: int, head_dim: int):
    """Lane-logical (B, nb_lane*bs, K, d) views of both pools; one flat
    table index shared by the K and V gathers."""
    B = block_table.shape[0]
    idx = block_table.reshape(-1).long()
    keys = cache_k[idx].reshape(B, -1, n_kv, head_dim)
    vals = cache_v[idx].reshape(B, -1, n_kv, head_dim)
    return keys, vals


def _paged_update_attend(q_heads, k_row, v_row, cache_k, cache_v, block_table, pos, active, *,
                         n_kv: int, head_dim: int, use_kernel: bool, x_dtype):
    """Write one decode row through the block table, then attend.

    ``q_heads``/``k_row``/``v_row``: (B, H, d) / (B, K, d) post-RoPE,
    unscaled; the pools carry the drop sentinel block ``n_blocks`` as
    their last block.  Returns the attention output (B, K, G, d).

    ``use_kernel=False`` is the gather reference; ``use_kernel=True``
    reads through ``kernels.ops.paged_attention`` (the CUDA kernel on the
    card).  The two differ on inactive lanes (the kernel returns exact
    zeros, the gather garbage); both are discarded."""
    from ..kernels import ops as kernel_ops

    B = q_heads.shape[0]
    nb, bs = cache_k.shape[0] - 1, cache_k.shape[1]
    nb_lane = block_table.shape[1]
    pos = pos.to(torch.int64)
    # a lane's row pos lives at [table[b, pos // bs], pos % bs] (the block
    # index clamped as JAX's gather clamps it); inactive lanes write to the
    # sentinel block, since their table row may name blocks another lane
    # owns now
    bi = torch.clamp(pos // bs, 0, nb_lane - 1)
    blk = block_table.gather(1, bi[:, None])[:, 0].long()
    if active is not None:
        blk = torch.where(active, blk, torch.full_like(blk, nb))
    row = pos % bs
    cache_k[blk, row] = k_row.to(cache_k.dtype)
    cache_v[blk, row] = v_row.to(cache_v.dtype)
    qh = q_heads.reshape(B, n_kv, -1, head_dim)
    if use_kernel:
        pos_eff = pos if active is None else torch.where(active, pos, torch.full_like(pos, -1))
        return kernel_ops.paged_attention(qh, cache_k, cache_v, block_table,
                                          pos_eff.to(torch.int32)).to(x_dtype)
    keys, vals = _pool_gather(cache_k, cache_v, block_table, n_kv, head_dim)
    q5 = (qh * (head_dim**-0.5))[:, None]  # (B, 1, K, G, d)
    s = _gqa_scores(q5, keys.to(x_dtype))  # (B, K, G, 1, L)
    kpos = torch.arange(keys.shape[1], device=pos.device)
    valid = kpos[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, None, None, :], s, torch.full((), NEG_INF, device=s.device))
    w = torch.softmax(s, dim=-1)
    out = _gqa_combine(w, vals.to(x_dtype), x_dtype)  # (B, 1, K*G*d)
    return out.reshape(B, n_kv, -1, head_dim)


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
    block_table: Optional[torch.Tensor] = None,
    paged_kernel: bool = False,
) -> torch.Tensor:
    """One-token decode.  x: (B, 1, D); the caches are UPDATED IN PLACE
    (the JAX version returns new caches); returns the attention output
    (B, 1, D).

    ``pos`` is a scalar position shared by every lane (an int or a 0-d
    tensor: the bucketed path) or a (B,) tensor of per-slot positions.
    ``active`` (per-slot only, (B,) bool) keeps inactive lanes' cache
    rows untouched.

    ``block_table`` ((B, blocks_per_lane) int32, per-slot ``pos`` only)
    selects the PAGED layout: the caches are a pool of blocks
    ``(n_blocks + 1, block_size, K, d)`` shared by every lane, the last
    block being the drop sentinel, and lane b's row ``r`` lives at
    ``[table[b, r // bs], r % bs]``.  ``paged_kernel=True`` reads through
    the paged-attention kernel instead of gathering each lane's whole
    logical view."""
    B = x.shape[0]
    G = n_heads // n_kv
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, active_planes)
    per_slot = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if block_table is not None and not per_slot:
        raise ValueError("paged decode needs per-slot positions (a slot pool)")
    if per_slot:
        posb = pos.to(device=x.device, dtype=torch.int64)[:, None]
    else:
        posb = torch.full((B, 1), int(pos), dtype=torch.int64, device=x.device)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    if block_table is not None:
        out = _paged_update_attend(q[:, 0], k[:, 0], v[:, 0], cache_k, cache_v, block_table,
                                   posb[:, 0], active, n_kv=n_kv, head_dim=head_dim,
                                   use_kernel=paged_kernel, x_dtype=x.dtype)
        return dense_apply(out.reshape(B, 1, -1), p["wo"], active_planes)
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


def prefill_chunk_attention(
    p: Params,
    x: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    start: torch.Tensor,
    n_valid: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    block_table: Optional[torch.Tensor] = None,
    active_planes=None,
) -> torch.Tensor:
    """Chunked prefill: C prompt-token queries per lane against the lane's
    own rows of the pooled cache, which is UPDATED IN PLACE.

    ``x`` (B, C, D), one fixed-size chunk per lane; ``start`` (B,) the
    chunk's first absolute position; ``n_valid`` (B,) how many of the C
    tokens are real.  The chunk's K/V are written first and the queries
    then attend the updated cache, so the causal mask alone confines
    query ``i`` to the lane's processed prefix.  Lanes not prefilling
    pass ``n_valid = 0`` and ``start = max_len``.

    Contiguous caches (the slot pool's ``(B, max_len + 1, K, d)``) write
    every row below ``max_len``, pads included as JAX does (they sit past
    the lane's position until overwritten), and send rows at or past
    ``max_len`` to the spare last row.  Paged pools (``block_table``
    given) write only real tokens inside the lane's table; pads and idle
    lanes go to the sentinel block, and scores run over the lane-logical
    gather view.  The caller must have granted the blocks of rows
    ``[start, start + n_valid)``.  Returns the attention output (B, C, D)."""
    B, C, _ = x.shape
    G = n_heads // n_kv
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, active_planes)
    dev = x.device
    ci = torch.arange(C, device=dev)
    qpos = start.to(device=dev, dtype=torch.int64)[:, None] + ci[None, :]  # (B, C)
    q = apply_rope(q, qpos, rope_theta)
    k = apply_rope(k, qpos, rope_theta)
    qs = q.reshape(B, C, n_kv, G, head_dim) * (head_dim**-0.5)
    if block_table is not None:
        nb, bs = cache_k.shape[0] - 1, cache_k.shape[1]
        nb_lane = block_table.shape[1]
        bi = torch.clamp(qpos // bs, 0, nb_lane - 1)  # (B, C) logical blocks
        blk = block_table.gather(1, bi).long()
        ok = (ci[None, :] < n_valid.to(dev)[:, None]) & (qpos < nb_lane * bs)
        blk = torch.where(ok, blk, torch.full_like(blk, nb))
        cache_k[blk, qpos % bs] = k.to(cache_k.dtype)
        cache_v[blk, qpos % bs] = v.to(cache_v.dtype)
        keys, vals = _pool_gather(cache_k, cache_v, block_table, n_kv, head_dim)
    else:
        limit = cache_k.shape[1] - 1  # max_len: the spare row
        rows = torch.clamp(qpos, max=limit)
        bidx = torch.arange(B, device=dev)[:, None].expand(B, C)
        cache_k[bidx, rows] = k.to(cache_k.dtype)
        cache_v[bidx, rows] = v.to(cache_v.dtype)
        keys, vals = cache_k, cache_v
    s = _gqa_scores(qs, keys.to(x.dtype))  # (B, K, G, C, Smax)
    kpos = torch.arange(keys.shape[1], device=dev)
    valid = kpos[None, None, :] <= qpos[:, :, None]  # (B, C, Smax)
    w = _softmax_masked(s, valid[:, None, None])
    out = _gqa_combine(w, vals.to(x.dtype), x.dtype)
    return dense_apply(out, p["wo"], active_planes)
