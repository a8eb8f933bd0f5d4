"""Attention, "attn" (full causal GQA) and "local" (sliding-window GQA
over a ring buffer) kinds and the "+cross" sublayer: PyTorch port of the
prefill, decode (contiguous, ring and paged), chunked-prefill and
cross-attention paths of ``repro.models.attention``.

Scores and softmax run in f32 unless ``scores_dtype`` (the config's
``attn_scores_dtype``) asks for bfloat16: then whole-sequence and
chunked prefill on the plain path round the f32-summed scores to bf16
and take the mask constant and the softmax in bf16, as JAX does.  The
flash kernel keeps f32 scores, so ``attention(flash=True)`` raises for
bfloat16.  Decode computes f32 scores whatever the setting, as JAX's
decode functions do (they take no scores dtype), so the paged kernel
agrees with the reference there.  Caches are updated IN PLACE (the JAX
functions return new ones).  JAX drops out-of-range scatter writes
(``mode="drop"``); PyTorch has no such mode, so the pool layouts carry a
sentinel instead: a paged pool has one spare block past the allocator's
``n_blocks`` (index ``n_blocks``, never granted, never in a live table
range) and the slot pool's contiguous cache one spare row past
``max_len``.  Writes JAX would drop are redirected there, so every write
of a call lands on a distinct row except the sentinel's, which nothing
reads.  Ring buffers need no sentinel: their writes are either masked
by ``active`` or rebuilt by a gather.

Serving prefill (``attention(flash=True)``) computes its scores,
softmax and combine through ``kernels.ops.flash_attention``: the Hopper
kernel on the card, its plain version on the CPU.  This is a choice
beyond the JAX package, whose prefill never calls its flash kernel; the
two agree within the kernel's tolerance (the JAX tests pin the kernel
to this function).  Training keeps the plain q-chunked path: the kernel
has no backward.  Cross-attention (:func:`cross_attention`) stays plain
PyTorch, as JAX's does.

On a ("data", "model") mesh (``common.packed_shard_mesh``) the inputs
are whole on every rank and each cache leaf is this rank's block, its
spec passed in as ``shard_spec``: every path attends over its local
lanes and K/V heads and gathers the output, so no cache or pool is ever
gathered on the co-sharded paths.  Where the K/V heads split over the
projections' N axis, decode and chunked prefill keep q, k, v and the
output on this rank's heads end to end (:func:`_qkv_sharded`; ``wo``
then contracts its K block), the Megatron layout.  A sequence axis split over the mesh
(the cache rules' fallbacks for indivisible K/V heads and for batch 1)
combines each rank's partial softmax.  The paged paths run shard-local
under ``common.paged_shard_mesh`` (:func:`_paged_attend_sharded`: lanes
and their pool blocks co-shard, block ids translated by a subtraction
and a clip, as JAX's ``_paged_attend_sharded``); a pool split over data
without its lanes gathers the pool for the read.  Ring buffers split as
the contiguous cache does: over K/V heads, or over their slots where the
K/V heads do not (a decode row lands on the rank holding slot ``pos mod
Wc``; reads combine partial softmaxes).  Prefill runs the flash kernel
on each rank's lanes and heads, or, where the K/V heads do not split, on
its share of each K/V head's query heads.  The "+cross" sublayer is a
Megatron pair on each rank's heads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .common import (
    apply_rope,
    dense_apply,
    dense_group,
    dense_init,
    local_heads_ok,
    packed_mesh,
    packed_placement,
    paged_mesh,
)

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30
SCORES_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _scores_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``attn_scores_dtype``."""
    if name not in SCORES_DTYPES:
        raise ValueError(f"attn_scores_dtype={name!r}: want one of {sorted(SCORES_DTYPES)}")
    return SCORES_DTYPES[name]


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


def _qkv_sharded(p: Params, x: torch.Tensor, n_heads: int, n_kv: int, head_dim: int,
                 active_planes, spec):
    """q, k, v on a mesh, with the head counts and cache spec the attention
    then runs on.  Where the K/V heads split over the same axis as the
    projections' N (``common.local_heads_ok``), the three products stay
    this rank's heads (one reduction for the three) and the caller runs
    ``wo`` on its K block: returns ``(q, k, v, H_l, KV_l, spec with the
    head axis now local, True)``.  Else q, k, v come back whole."""
    mesh = packed_mesh()
    kv_ax = spec[2]
    ws = [p["wq"], p["wk"], p["wv"]]
    if kv_ax is not None and local_heads_ok(mesh, ws, p["wo"], heads=n_kv) \
            and ws[0].kn_spec[1] == kv_ax:
        from ..dist.sharding import axis_size

        d = axis_size(mesh, kv_ax)
        B, S, _ = x.shape
        q, k, v = dense_group(x, ws, active_planes)
        return (q.reshape(B, S, n_heads // d, head_dim), k.reshape(B, S, n_kv // d, head_dim),
                v.reshape(B, S, n_kv // d, head_dim), n_heads // d, n_kv // d,
                (spec[0], spec[1], None) + tuple(spec[3:]), True)
    q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, active_planes)
    return q, k, v, n_heads, n_kv, spec, False


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """q: (B, Sq, K, G, d); k: (B, Sk, K, d) -> (B, K, G, Sq, Sk) in
    ``dtype``: products of the inputs summed in f32, then rounded to
    ``dtype``, as JAX's ``preferred_element_type=dtype``."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32), k.to(torch.float32)).to(dtype)


def _gqa_combine(w: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    """w: (B, K, G, Sq, Sk); v: (B, Sk, K, d) -> (B, Sq, K*G*d)."""
    o = torch.einsum("bkgqs,bskd->bqkgd", w.to(dtype), v.to(dtype))
    return o.reshape(o.shape[0], o.shape[1], -1)


def _softmax_masked(s: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked softmax over the last axis in the dtype of ``s``.  Below f32
    it runs op by op as ``jax.nn.softmax`` does, each op rounded to that
    dtype: exp of the max-shifted scores, their sum, the quotient."""
    s = torch.where(valid, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    s = s - torch.amax(s, dim=-1, keepdim=True)
    if s.dtype == torch.float32:
        return torch.softmax(s, dim=-1)
    e = torch.exp(s)
    return e / e.sum(dim=-1, keepdim=True)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) boolean: causal, optionally sliding-window."""
    m = q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> torch.Tensor:
    """Scores, softmax and combine of prefill through the flash kernel.

    ``q`` (B, S, K, G, d) already scaled by ``d**-0.5`` (so the kernel
    runs at ``sm_scale=1.0`` on the plain path's operands); ``k``/``v``
    (B, S, K, d).  Rows go to the kernel's (BH, S, d) layout, q as
    ``(b, kv, g)`` and K/V as ``(b, kv)``, so query row r reads K/V row
    ``r // G`` with no broadcast copy.  Returns (B, S, K*G*d)."""
    from ..kernels import ops as kernel_ops

    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("the flash prefill path has no backward; training runs the plain "
                         "attention (flash=False)")
    B, S, n_kv, G, d = q.shape
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * n_kv * G, S, d).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * n_kv, S, d).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * n_kv, S, d).contiguous()
    o = kernel_ops.flash_attention(qf, kf, vf, causal=True, window=window, sm_scale=1.0)
    return o.reshape(B, n_kv, G, S, d).permute(0, 3, 1, 2, 4).reshape(B, S, n_kv * G * d)


# ---------------------------------------------------------------------------
# Mesh helpers: local lanes, heads and sequence rows of a cache block
# ---------------------------------------------------------------------------


def _ranges(mesh, spec, B: int, n_kv: int, s_local: int):
    """This rank's lanes ``[b0, b1)``, K/V heads ``[h0, h1)`` and first
    sequence row ``s0`` under a (B, S, KV, hd) cache block's spec."""
    from ..dist.sharding import axis_index, block_range

    b0, b1 = block_range(mesh, spec[0], B)
    h0, h1 = block_range(mesh, spec[2], n_kv)
    return b0, b1, h0, h1, axis_index(mesh, spec[1]) * s_local


def _gather_heads(out: torch.Tensor, mesh, b_ax, kv_ax, g_ax=None) -> torch.Tensor:
    """(B_l, Sq, KV_l, G_l, d) local output -> the whole (B, Sq, KV*G*d)."""
    if g_ax is not None:
        out = mesh.all_gather(out, g_ax, dim=3)
    if kv_ax is not None:
        out = mesh.all_gather(out, kv_ax, dim=2)
    if b_ax is not None:
        out = mesh.all_gather(out, b_ax, dim=0)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _attend_local(qs, keys, vals, valid, s_ax, mesh, dtype, sdt, decode: bool):
    """Attention of ``qs`` (B, Sq, K, G, d), scaled, over this rank's key
    rows ``keys``/``vals`` (B, Sk, K, d) under ``valid`` (B, Sq, Sk).
    Returns (B, Sq, K, G, d) in ``dtype``.

    With the sequence unsplit (``s_ax`` None) the ops are the unsharded
    path's (``decode``: an f32 softmax as ``decode_attention``, else
    ``_softmax_masked`` as the chunk path).  Split over ``s_ax``, each
    rank's partial softmax (its max, sum and unnormalised output, f32) is
    gathered and combined; a lane no rank has a key for gets zeros."""
    s = _gqa_scores(qs, keys.to(dtype), sdt)  # (B, K, G, Sq, Sk)
    v5 = valid[:, None, None]
    if s_ax is None:
        if decode:
            w = torch.softmax(torch.where(v5, s, torch.full((), NEG_INF, device=s.device)), -1)
        else:
            w = _softmax_masked(s, v5)
        return torch.einsum("bkgqs,bskd->bqkgd", w.to(dtype), vals.to(dtype))
    s32 = s.to(torch.float32)
    m = torch.amax(torch.where(v5, s32, torch.full((), NEG_INF, device=s.device)), -1,
                   keepdim=True)
    e = torch.where(v5, torch.exp(s32 - m), torch.zeros((), device=s.device))
    o = torch.einsum("bkgqs,bskd->bkgqd", e, vals.to(torch.float32))
    parts = mesh.all_gather(torch.cat([m, e.sum(-1, keepdim=True), o], -1)[None], s_ax, dim=0)
    scale = torch.exp(parts[..., :1] - parts[..., :1].amax(0))
    num, den = (scale * parts[..., 2:]).sum(0), (scale * parts[..., 1:2]).sum(0)
    out = torch.where(den > 0, num / torch.clamp(den, min=1e-30), torch.zeros((), device=s.device))
    return out.permute(0, 3, 1, 2, 4).to(dtype)


def attention(
    p: Params,
    x: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float,
    window: Optional[int] = None,
    q_chunk: int = 1024,
    active_planes=None,
    flash: bool = False,
    scores_dtype="float32",
    shard_spec=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Causal (``window``: sliding-window) self-attention for prefill and
    training: query ``i`` attends keys ``j <= i`` with ``i - j < window``.
    q is pre-scaled by ``head_dim**-0.5``.  Returns (out, (k, v)) so
    prefill can seed the decode cache.

    ``flash=False`` (training, ``forward``) runs queries in chunks of
    ``q_chunk`` through plain PyTorch; ``flash=True`` (serving prefill,
    ``transformer.prefill``) runs the whole sequence through
    ``kernels.ops.flash_attention`` and raises for inputs that require
    grad.  Both check ``S % q_chunk``, as the JAX function does.

    ``scores_dtype`` (``cfg.attn_scores_dtype``) sets the dtype of
    the plain path's scores, mask constant and softmax; the flash kernel
    keeps f32 scores and so raises for ``"bfloat16"``.

    On a mesh ``shard_spec`` (the spec of the cache block prefill seeds)
    picks this rank's lanes and K/V heads for the flash kernel; the output
    is gathered, and ``(k, v)`` are returned whole.  Under
    ``packed_shard_mesh(mesh, local_heads=True)`` (training) the plain
    path keeps q, k, v and the output on this rank's heads where the
    projections allow (``_qkv_sharded``), ``wo`` contracting its K block,
    and ``(k, v)`` are this rank's heads."""
    sdt = _scores_dtype(scores_dtype)
    if flash and sdt != torch.float32:
        raise ValueError(
            f"attn_scores_dtype={scores_dtype!r}: the flash kernel computes its scores "
            "and softmax in float32; serve with attn_scores_dtype='float32', or run this "
            "prefill on the plain path (flash=False, or chunked prefill)")
    B, S, _ = x.shape
    G = n_heads // n_kv
    mesh = packed_mesh()
    local = False
    if not flash and mesh is not None and packed_placement()[1]:
        # training on a mesh: q, k, v keep this rank's heads into wo's K block
        from ..dist.sharding import axis_size

        n_ax = getattr(p["wq"], "kn_spec", (None, None))[1]
        kv_ax = n_ax if n_ax is not None and n_kv % axis_size(mesh, n_ax) == 0 else None
        q, k, v, n_heads, n_kv, _, local = _qkv_sharded(p, x, n_heads, n_kv, head_dim,
                                                        active_planes, (None, None, kv_ax))
    else:
        q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, active_planes)
    positions = torch.arange(S, device=x.device)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    q = q.reshape(B, S, n_kv, G, head_dim) * (head_dim**-0.5)
    if S > q_chunk and S % q_chunk:
        raise ValueError(f"prefill length {S} is not a multiple of q_chunk={q_chunk}")
    if flash:
        if mesh is not None and shard_spec is not None:
            from ..dist.sharding import axis_size, block_range

            b0, b1, h0, h1, _ = _ranges(mesh, shard_spec, B, n_kv, 0)
            # K/V heads that do not split (the rule moved "model" to the
            # sequence): this rank's share of each K/V head's query heads
            g_ax = shard_spec[1] if shard_spec[2] is None and shard_spec[1] is not None \
                and G % axis_size(mesh, shard_spec[1]) == 0 else None
            g0, g1 = block_range(mesh, g_ax, G)
            out = _flash(q[b0:b1, :, h0:h1, g0:g1], k[b0:b1, :, h0:h1], v[b0:b1, :, h0:h1],
                         window)
            out = _gather_heads(out.reshape(b1 - b0, S, h1 - h0, g1 - g0, head_dim), mesh,
                                shard_spec[0], shard_spec[2], g_ax)
        else:
            out = _flash(q, k, v, window)
        return dense_apply(out, p["wo"], active_planes), (k, v)
    kpos = torch.arange(S, device=x.device)
    outs = []
    for q0 in range(0, S, q_chunk):
        qc = q[:, q0:q0 + q_chunk]
        qpos = q0 + torch.arange(qc.shape[1], device=x.device)
        s = _gqa_scores(qc, k, sdt)
        w = _softmax_masked(s, _mask(qpos, kpos, window)[None, None, None])
        outs.append(_gqa_combine(w, v, x.dtype))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return dense_apply(out, p["wo"], active_planes, k_local=local), (k, v)


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
    _paged_write(k_row, v_row, cache_k, cache_v, block_table, pos, active)
    return _paged_read(q_heads, cache_k, cache_v, block_table, pos, active, n_kv=n_kv,
                       head_dim=head_dim, use_kernel=use_kernel, x_dtype=x_dtype)


def _paged_write(k_row, v_row, cache_k, cache_v, block_table, pos, active) -> None:
    """Write one decode row per lane through the block table, IN PLACE."""
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


def _paged_read(q_heads, cache_k, cache_v, block_table, pos, active, *, n_kv: int,
                head_dim: int, use_kernel: bool, x_dtype):
    """The decode read of :func:`_paged_update_attend`: (B, K, G, d)."""
    from ..kernels import ops as kernel_ops

    B = q_heads.shape[0]
    pos = pos.to(torch.int64)
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


def _own_table(block_table: torch.Tensor, off: int, local_nb: int) -> torch.Tensor:
    """Global block ids -> this rank's pool slice ``[off, off + local_nb)``:
    the ids it owns translated, every other id sent to its local sentinel
    block ``local_nb``, so writes through them drop."""
    mine = (block_table >= off) & (block_table < off + local_nb)
    return torch.where(mine, block_table - off, torch.full_like(block_table, local_nb))


def _paged_attend_sharded(mesh, spec, q_heads, k_row, v_row, cache_k, cache_v, block_table,
                          pos, active, *, n_kv: int, head_dim: int, use_kernel: bool, x_dtype):
    """The paged update and read over this rank's LOCAL pool slice: lanes
    and their blocks co-shard over the data axes, so each rank writes and
    reads only its own slice and the pool is never gathered.

    The allocator grants lane b's blocks from lane b's shard range
    (``BlockAllocator(n_shards=D)``), so global ids translate with a
    subtraction; stale entries of other shards clip into the local range
    and are masked by the causal bound like any stale entry.  Returns the
    whole (B, KV*G*d) output, or None when lanes and blocks do not
    co-shard (the caller takes :func:`_paged_attend_gathered`)."""
    from ..dist.sharding import axis_index, block_range, dp_axes

    B = q_heads.shape[0]
    blk_ax, kv_ax = spec[0], spec[2]
    lane_ax = dp_axes(mesh, B)
    if blk_ax is None or lane_ax != blk_ax:
        return None
    local_nb = cache_k.shape[0] - 1  # the local sentinel block is the last
    b0, b1 = block_range(mesh, lane_ax, B)
    h0, h1 = block_range(mesh, kv_ax, n_kv)
    G = q_heads.shape[1] // n_kv
    table = torch.clamp(block_table[b0:b1] - axis_index(mesh, blk_ax) * local_nb, 0,
                        local_nb - 1)
    out = _paged_update_attend(
        q_heads[b0:b1, h0 * G:h1 * G].contiguous(), k_row[b0:b1, h0:h1], v_row[b0:b1, h0:h1],
        cache_k, cache_v, table, pos[b0:b1], None if active is None else active[b0:b1],
        n_kv=h1 - h0, head_dim=head_dim, use_kernel=use_kernel, x_dtype=x_dtype)
    return _gather_heads(out[:, None], mesh, lane_ax, kv_ax)


def _paged_attend_gathered(mesh, spec, q_heads, k_row, v_row, cache_k, cache_v, block_table,
                           pos, active, *, n_kv: int, head_dim: int, use_kernel: bool,
                           x_dtype):
    """The paged update and read where lanes do not co-shard with the
    pool's blocks: every lane on this rank's K/V heads; each rank writes
    the rows whose blocks it owns, and a pool split over the data axes is
    gathered for the read (JAX's GSPMD gathers it there too)."""
    from ..dist.sharding import axis_index, block_range

    blk_ax, kv_ax = spec[0], spec[2]
    h0, h1 = block_range(mesh, kv_ax, n_kv)
    G = q_heads.shape[1] // n_kv
    q_l, k_l, v_l = q_heads[:, h0 * G:h1 * G].contiguous(), k_row[:, h0:h1], v_row[:, h0:h1]
    kw = dict(n_kv=h1 - h0, head_dim=head_dim, use_kernel=use_kernel, x_dtype=x_dtype)
    if blk_ax is None:  # the whole pool is here
        out = _paged_update_attend(q_l, k_l, v_l, cache_k, cache_v, block_table, pos, active,
                                   **kw)
    else:
        local_nb = cache_k.shape[0] - 1
        own = _own_table(block_table, axis_index(mesh, blk_ax) * local_nb, local_nb)
        _paged_write(k_l, v_l, cache_k, cache_v, own, pos, active)
        whole_k = mesh.all_gather(cache_k[:local_nb], blk_ax, dim=0)
        whole_v = mesh.all_gather(cache_v[:local_nb], blk_ax, dim=0)
        out = _paged_read(q_l, whole_k, whole_v, block_table, pos, active, **kw)
    return _gather_heads(out[:, None], mesh, None, kv_ax)


def _decode_contiguous_sharded(mesh, spec, q, k, v, cache_k, cache_v, posb, active, *,
                               n_kv: int, head_dim: int, x_dtype, ring: bool = False,
                               window: Optional[int] = None) -> torch.Tensor:
    """One-token decode over this rank's block of a contiguous cache or a
    ring ((B, S, KV, hd) under ``spec``): its lanes and K/V heads write
    their row where it falls in the local rows (a ring's slot ``pos mod
    Wc``, Wc the whole ring's) and attend; the output (B, 1, KV*G*d)
    comes back whole."""
    from ..dist.sharding import axis_size

    B = q.shape[0]
    G = q.shape[2] // n_kv
    S_l = cache_k.shape[1]
    b0, b1, h0, h1, s0 = _ranges(mesh, spec, B, n_kv, S_l)
    lane_pos = posb[b0:b1, 0]
    Wc = S_l * axis_size(mesh, spec[1])
    rows = (torch.remainder(lane_pos, Wc) if ring else lane_pos) - s0
    own = (rows >= 0) & (rows < S_l)
    if active is not None:
        own &= active[b0:b1]
    r = torch.clamp(rows, 0, S_l - 1)
    bidx = torch.arange(b1 - b0, device=q.device)
    keep = own[:, None, None]
    cache_k[bidx, r] = torch.where(keep, k[b0:b1, 0, h0:h1].to(cache_k.dtype), cache_k[bidx, r])
    cache_v[bidx, r] = torch.where(keep, v[b0:b1, 0, h0:h1].to(cache_v.dtype), cache_v[bidx, r])
    qs = q[b0:b1, :, h0 * G:h1 * G].reshape(b1 - b0, 1, h1 - h0, G, head_dim) * (head_dim**-0.5)
    kpos = s0 + torch.arange(S_l, device=q.device)
    if ring:  # slot s holds the absolute position pos - ((pos - s) mod Wc)
        kpos = lane_pos[:, None] - torch.remainder(lane_pos[:, None] - kpos[None, :], Wc)
        valid = kpos >= 0
        if window is not None and window < Wc:
            valid &= (lane_pos[:, None] - kpos) < window
        valid = valid[:, None, :]
    else:
        valid = (kpos[None, :] <= lane_pos[:, None])[:, None, :]
    out = _attend_local(qs, cache_k, cache_v, valid, spec[1], mesh, x_dtype, torch.float32,
                        decode=True)
    return _gather_heads(out, mesh, spec[0], spec[2])


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
    window: Optional[int] = None,
    ring: bool = False,
    active: Optional[torch.Tensor] = None,
    active_planes=None,
    block_table: Optional[torch.Tensor] = None,
    paged_kernel: bool = False,
    shard_spec=None,
) -> torch.Tensor:
    """One-token decode (JAX ``decode_attention_cache``).  x: (B, 1, D);
    the caches are UPDATED IN PLACE (the JAX version returns new caches);
    returns the attention output (B, 1, D).

    ``pos`` is a scalar position shared by every lane (an int or a 0-d
    tensor: the bucketed path) or a (B,) tensor of per-slot positions.
    ``active`` (per-slot only, (B,) bool) keeps inactive lanes' cache
    rows untouched.

    ``ring=True`` (sliding-window layers): the caches are ring buffers of
    ``Wc = cache_k.shape[1]`` slots, position ``p`` in slot ``p % Wc``;
    keys are stored post-RoPE, so slot ``s`` stands for the absolute
    position ``p_s = pos - ((pos - s) mod Wc)``, masked when negative (a
    slot this lane never wrote, or its last occupant's) or outside
    ``window``.  Rings are bounded already, never page, and ignore
    ``block_table``.  Full-length caches serve the full-attention kind,
    which has no window.

    ``block_table`` ((B, blocks_per_lane) int32, per-slot ``pos`` only)
    selects the PAGED layout: the caches are a pool of blocks
    ``(n_blocks + 1, block_size, K, d)`` shared by every lane, the last
    block being the drop sentinel, and lane b's row ``r`` lives at
    ``[table[b, r // bs], r % bs]``.  ``paged_kernel=True`` reads through
    the paged-attention kernel instead of gathering each lane's whole
    logical view.  On a mesh ``shard_spec`` is the spec of this rank's
    cache blocks (the module docstring)."""
    B = x.shape[0]
    G = n_heads // n_kv
    mesh = packed_mesh() if shard_spec is not None else None
    local = False
    if mesh is None:
        q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, active_planes)
    else:
        q, k, v, n_heads, n_kv, shard_spec, local = _qkv_sharded(
            p, x, n_heads, n_kv, head_dim, active_planes, shard_spec)
    per_slot = isinstance(pos, torch.Tensor) and pos.ndim == 1
    if window is not None and not ring:
        raise ValueError("a window needs a ring buffer (ring=True)")
    if ring:
        block_table = None
    if block_table is not None and not per_slot:
        raise ValueError("paged decode needs per-slot positions (a slot pool)")
    if per_slot:
        posb = pos.to(device=x.device, dtype=torch.int64)[:, None]
    else:
        posb = torch.full((B, 1), int(pos), dtype=torch.int64, device=x.device)
    q = apply_rope(q, posb, rope_theta)
    k = apply_rope(k, posb, rope_theta)
    if block_table is not None:
        args = (q[:, 0], k[:, 0], v[:, 0], cache_k, cache_v, block_table, posb[:, 0], active)
        kw = dict(n_kv=n_kv, head_dim=head_dim, use_kernel=paged_kernel, x_dtype=x.dtype)
        if mesh is None:
            out = _paged_update_attend(*args, **kw)
        else:
            out = None
            if paged_mesh() is not None:
                out = _paged_attend_sharded(mesh, shard_spec, *args, **kw)
            if out is None:  # lanes and blocks do not co-shard
                out = _paged_attend_gathered(mesh, shard_spec, *args, **kw)
        return dense_apply(out.reshape(B, 1, -1), p["wo"], active_planes, k_local=local)
    if mesh is not None:
        out = _decode_contiguous_sharded(mesh, shard_spec, q, k, v, cache_k, cache_v, posb,
                                         active, n_kv=n_kv, head_dim=head_dim, x_dtype=x.dtype,
                                         ring=ring, window=window)
        return dense_apply(out, p["wo"], active_planes, k_local=local)
    Wc = cache_k.shape[1]
    if per_slot:
        bidx = torch.arange(B, device=x.device)
        lane_pos = torch.remainder(posb[:, 0], Wc) if ring else posb[:, 0]
        k_row, v_row = k[:, 0].to(cache_k.dtype), v[:, 0].to(cache_v.dtype)
        if active is not None:
            keep = active[:, None, None]
            k_row = torch.where(keep, k_row, cache_k[bidx, lane_pos])
            v_row = torch.where(keep, v_row, cache_v[bidx, lane_pos])
        cache_k[bidx, lane_pos] = k_row
        cache_v[bidx, lane_pos] = v_row
    else:
        row = int(pos) % Wc if ring else int(pos)
        cache_k[:, row] = k[:, 0].to(cache_k.dtype)
        cache_v[:, row] = v[:, 0].to(cache_v.dtype)
    q = q.reshape(B, 1, n_kv, G, head_dim) * (head_dim**-0.5)
    s = _gqa_scores(q, cache_k.to(x.dtype))  # (B, K, G, 1, Smax or Wc)
    kpos = torch.arange(Wc, device=x.device)
    if ring:
        kpos = posb - torch.remainder(posb - kpos[None, :], Wc)  # (B, Wc) absolute
        valid = kpos >= 0
        if window is not None and window < Wc:
            valid &= (posb - kpos) < window
    else:
        valid = kpos[None, :] <= posb
    valid = valid[:, None, None, None, :]
    w = torch.softmax(torch.where(valid, s, torch.full((), NEG_INF, device=s.device)), dim=-1)
    out = _gqa_combine(w, cache_v.to(x.dtype), x.dtype)
    return dense_apply(out, p["wo"], active_planes)


def _ring_chunk_attend(qs, k, v, cache_k, cache_v, start, qpos, n_valid, window, dtype,
                       sdt=torch.float32):
    """The ring branch of :func:`prefill_chunk_attention`: attend, then
    rebuild the ring IN PLACE.  ``qs`` (B, C, K, G, d) scaled; ``k``/``v``
    (B, C, K, d) post-RoPE; returns (B, C, K*G*d)."""
    B, C = qpos.shape
    dev = qs.device
    Wc = cache_k.shape[1]
    ci = torch.arange(C, device=dev)
    # intra-chunk keys: causal (+ window) on chunk-relative offsets
    m1 = _mask(ci, ci, window)[None].expand(B, C, C)
    # pre-chunk ring keys: slot s holds the absolute position
    # r_s = (start - 1) - ((start - 1 - s) mod Wc), the latest processed
    # position congruent to s; r_s < 0: the lane never reached that slot
    slots = torch.arange(Wc, device=dev)
    r = (start[:, None] - 1) - torch.remainder(start[:, None] - 1 - slots[None, :], Wc)
    m2 = (r >= 0)[:, None, :].expand(B, C, Wc)
    if window is not None:
        m2 = m2 & ((qpos[:, :, None] - r[:, None, :]) < window)
    s = torch.cat([_gqa_scores(qs, k, sdt), _gqa_scores(qs, cache_k.to(dtype), sdt)], dim=-1)
    w = _softmax_masked(s, torch.cat([m1, m2], dim=-1)[:, None, None])
    out = _gqa_combine(w, torch.cat([v, cache_v.to(dtype)], dim=1), dtype)
    # rebuild: slot s's occupant is the latest real chunk position
    # congruent to it (p_s >= start), else the old content stays
    last = start + n_valid - 1
    p_s = last[:, None] - torch.remainder(last[:, None] - slots[None, :], Wc)  # (B, Wc)
    in_chunk = (p_s >= start[:, None])[..., None, None]
    i_s = torch.clamp(p_s - start[:, None], 0, C - 1)
    idx = i_s[..., None, None].expand(B, Wc, *k.shape[2:])
    cache_k.copy_(torch.where(in_chunk, k.to(cache_k.dtype).gather(1, idx), cache_k))
    cache_v.copy_(torch.where(in_chunk, v.to(cache_v.dtype).gather(1, idx), cache_v))
    return out


def _ring_chunk_sharded(mesh, spec, qs, k, v, cache_k, cache_v, start, qpos, n_valid, window,
                        dtype, sdt) -> torch.Tensor:
    """:func:`_ring_chunk_attend` over this rank's block of the rings
    ((B, Wc, KV, hd) under ``spec``): its lanes and K/V heads, and its
    slots where the rule splits them (one K/V head: "model" on the slot
    axis).  The chunk's own keys count on the first slot shard; split
    slots combine each shard's partial softmax.  Then each rank rebuilds
    its own slots.  Returns the whole (B, C, KV*G*d)."""
    from ..dist.sharding import axis_index, axis_size

    B, C = qpos.shape
    n_kv = k.shape[2]
    S_l = cache_k.shape[1]
    b0, b1, h0, h1, s0 = _ranges(mesh, spec, B, n_kv, S_l)
    s_ax = spec[1]
    Wc = S_l * axis_size(mesh, s_ax)
    qs, k, v = qs[b0:b1, :, h0:h1], k[b0:b1, :, h0:h1], v[b0:b1, :, h0:h1]
    start, qpos, n_valid = start[b0:b1], qpos[b0:b1], n_valid[b0:b1]
    Bl, dev = b1 - b0, qs.device
    # this rank's slots: slot s holds the latest processed position
    # congruent to it, r_s < 0 where the lane never reached it
    slots = s0 + torch.arange(S_l, device=dev)
    r = (start[:, None] - 1) - torch.remainder(start[:, None] - 1 - slots[None, :], Wc)
    valid = (r >= 0)[:, None, :].expand(Bl, C, S_l)
    if window is not None:
        valid = valid & ((qpos[:, :, None] - r[:, None, :]) < window)
    keys, vals = cache_k.to(dtype), cache_v.to(dtype)
    if axis_index(mesh, s_ax) == 0:
        ci = torch.arange(C, device=dev)
        valid = torch.cat([_mask(ci, ci, window)[None].expand(Bl, C, C), valid], dim=-1)
        keys, vals = torch.cat([k.to(dtype), keys], dim=1), torch.cat([v.to(dtype), vals], dim=1)
    out = _attend_local(qs, keys, vals, valid, s_ax, mesh, dtype, sdt, decode=False)
    # rebuild this rank's slots: each takes the latest real chunk position
    # congruent to it, else keeps its content
    last = start + n_valid - 1
    p_s = last[:, None] - torch.remainder(last[:, None] - slots[None, :], Wc)
    in_chunk = (p_s >= start[:, None])[..., None, None]
    idx = torch.clamp(p_s - start[:, None], 0, C - 1)[..., None, None].expand(Bl, S_l,
                                                                              *k.shape[2:])
    cache_k.copy_(torch.where(in_chunk, k.to(cache_k.dtype).gather(1, idx), cache_k))
    cache_v.copy_(torch.where(in_chunk, v.to(cache_v.dtype).gather(1, idx), cache_v))
    return _gather_heads(out, mesh, spec[0], spec[2])


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
    window: Optional[int] = None,
    ring: bool = False,
    block_table: Optional[torch.Tensor] = None,
    active_planes=None,
    scores_dtype="float32",
    shard_spec=None,
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
    ``[start, start + n_valid)``.

    Ring buffers (``ring=True``, sliding-window layers; ``block_table``
    ignored): a chunk longer than the ring would overwrite keys its own
    queries still need, so scores run over ``[chunk K/V ; pre-chunk
    ring]``, and the ring is then rebuilt by a gather: slot ``s`` takes
    the latest real chunk position congruent to it, else keeps its
    content (deterministic where a scatter with duplicate slots is not).
    Idle lanes (``n_valid = 0``) leave their ring as it is.  Returns the
    attention output (B, C, D).  ``scores_dtype`` sets the dtype of
    the scores, mask constant and softmax, as in :func:`attention`.  On a
    mesh ``shard_spec`` is the spec of this rank's cache blocks."""
    if window is not None and not ring:
        raise ValueError("a window needs a ring buffer (ring=True)")
    sdt = _scores_dtype(scores_dtype)
    B, C, _ = x.shape
    G = n_heads // n_kv
    mesh = packed_mesh() if shard_spec is not None else None
    local = False
    if mesh is None:
        q, k, v = _qkv(p, x, n_heads, n_kv, head_dim, active_planes)
    else:
        q, k, v, n_heads, n_kv, shard_spec, local = _qkv_sharded(
            p, x, n_heads, n_kv, head_dim, active_planes, shard_spec)
    dev = x.device
    ci = torch.arange(C, device=dev)
    start = start.to(device=dev, dtype=torch.int64)
    qpos = start[:, None] + ci[None, :]  # (B, C)
    q = apply_rope(q, qpos, rope_theta)
    k = apply_rope(k, qpos, rope_theta)
    qs = q.reshape(B, C, n_kv, G, head_dim) * (head_dim**-0.5)
    if ring:
        n_valid = n_valid.to(device=dev, dtype=torch.int64)
        if mesh is not None:
            out = _ring_chunk_sharded(mesh, shard_spec, qs, k, v, cache_k, cache_v, start, qpos,
                                      n_valid, window, x.dtype, sdt)
            return dense_apply(out, p["wo"], active_planes, k_local=local)
        return dense_apply(
            _ring_chunk_attend(qs, k, v, cache_k, cache_v, start, qpos, n_valid, window,
                               x.dtype, sdt),
            p["wo"], active_planes)
    n_valid = n_valid.to(dev)
    if mesh is not None:
        out = _chunk_sharded(mesh, shard_spec, qs, k, v, cache_k, cache_v, block_table, qpos,
                             n_valid, n_kv=n_kv, head_dim=head_dim, x_dtype=x.dtype, sdt=sdt)
        return dense_apply(out, p["wo"], active_planes, k_local=local)
    if block_table is not None:
        _chunk_paged_write(k, v, cache_k, cache_v, block_table, qpos, n_valid)
        keys, vals = _pool_gather(cache_k, cache_v, block_table, n_kv, head_dim)
    else:
        limit = cache_k.shape[1] - 1  # max_len: the spare row
        rows = torch.clamp(qpos, max=limit)
        bidx = torch.arange(B, device=dev)[:, None].expand(B, C)
        cache_k[bidx, rows] = k.to(cache_k.dtype)
        cache_v[bidx, rows] = v.to(cache_v.dtype)
        keys, vals = cache_k, cache_v
    s = _gqa_scores(qs, keys.to(x.dtype), sdt)  # (B, K, G, C, Smax)
    kpos = torch.arange(keys.shape[1], device=dev)
    valid = kpos[None, None, :] <= qpos[:, :, None]  # (B, C, Smax)
    w = _softmax_masked(s, valid[:, None, None])
    out = _gqa_combine(w, vals.to(x.dtype), x.dtype)
    return dense_apply(out, p["wo"], active_planes)


def _chunk_paged_write(k, v, cache_k, cache_v, block_table, qpos, n_valid) -> None:
    """Write a chunk's real rows (``k``/``v`` (B, C, K, d) at positions
    ``qpos``) through the block table, IN PLACE; pads, idle lanes and rows
    past the table go to the sentinel block."""
    nb, bs = cache_k.shape[0] - 1, cache_k.shape[1]
    nb_lane = block_table.shape[1]
    ci = torch.arange(qpos.shape[1], device=qpos.device)
    bi = torch.clamp(qpos // bs, 0, nb_lane - 1)  # (B, C) logical blocks
    blk = block_table.gather(1, bi).long()
    ok = (ci[None, :] < n_valid[:, None]) & (qpos < nb_lane * bs)
    blk = torch.where(ok, blk, torch.full_like(blk, nb))
    cache_k[blk, qpos % bs] = k.to(cache_k.dtype)
    cache_v[blk, qpos % bs] = v.to(cache_v.dtype)


def _chunk_sharded(mesh, spec, qs, k, v, cache_k, cache_v, block_table, qpos, n_valid, *,
                   n_kv: int, head_dim: int, x_dtype, sdt) -> torch.Tensor:
    """:func:`prefill_chunk_attention`'s write and read over this rank's
    cache blocks; returns the whole (B, C, KV*G*d) output.

    Paged: lanes and blocks co-sharded (under ``paged_shard_mesh``) run on
    the local lanes and pool slice with block ids translated by a
    subtraction and a clip; a pool split over data without its lanes
    writes the rows of the blocks it owns and gathers the pool for the
    read; a pool whole on every rank needs neither.  Contiguous: each rank
    writes the rows that fall in its sequence block and a split sequence
    combines partial softmaxes.  Every path runs this rank's K/V heads."""
    from ..dist.sharding import axis_index, axis_size, block_range, dp_axes

    B = qpos.shape[0]
    if block_table is not None:
        blk_ax, kv_ax = spec[0], spec[2]
        local_nb = cache_k.shape[0] - 1
        off = axis_index(mesh, blk_ax) * local_nb
        lane_ax = None
        pool_k, pool_v = cache_k, cache_v
        if blk_ax is not None and paged_mesh() is not None and dp_axes(mesh, B) == blk_ax:
            lane_ax = blk_ax
            b0, b1 = block_range(mesh, lane_ax, B)
            table = torch.clamp(block_table[b0:b1] - off, 0, local_nb - 1)
            write_table = table
        else:
            b0, b1 = 0, B
            table = block_table
            write_table = table if blk_ax is None else _own_table(table, off, local_nb)
        h0, h1 = block_range(mesh, kv_ax, n_kv)
        _chunk_paged_write(k[b0:b1, :, h0:h1], v[b0:b1, :, h0:h1], cache_k, cache_v,
                           write_table, qpos[b0:b1], n_valid[b0:b1])
        if lane_ax is None and blk_ax is not None:
            pool_k = mesh.all_gather(cache_k[:local_nb], blk_ax, dim=0)
            pool_v = mesh.all_gather(cache_v[:local_nb], blk_ax, dim=0)
        keys, vals = _pool_gather(pool_k, pool_v, table, h1 - h0, head_dim)
        s_ax, s0, b_ax = None, 0, lane_ax
    else:
        S_l = cache_k.shape[1]
        b0, b1, h0, h1, s0 = _ranges(mesh, spec, B, n_kv, S_l)
        rows = torch.clamp(qpos[b0:b1], max=S_l * axis_size(mesh, spec[1]) - 1) - s0
        own = (rows >= 0) & (rows < S_l)
        bidx = torch.arange(b1 - b0, device=qpos.device)[:, None].expand_as(rows)
        cache_k[bidx[own], rows[own]] = k[b0:b1, :, h0:h1][own].to(cache_k.dtype)
        cache_v[bidx[own], rows[own]] = v[b0:b1, :, h0:h1][own].to(cache_v.dtype)
        keys, vals = cache_k, cache_v
        s_ax, b_ax = spec[1], spec[0]
    kpos = s0 + torch.arange(keys.shape[1], device=qpos.device)
    valid = kpos[None, None, :] <= qpos[b0:b1, :, None]  # (B_l, C, Sk)
    out = _attend_local(qs[b0:b1, :, h0:h1], keys, vals, valid, s_ax, mesh, x_dtype, sdt,
                        decode=False)
    return _gather_heads(out, mesh, b_ax, kv_ax if block_table is not None else spec[2])


def cross_attention(
    p: Params,
    x: torch.Tensor,
    kv_src: torch.Tensor,
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    active_planes=None,
) -> torch.Tensor:
    """Unmasked cross-attention: x (B, S, D) queries attend to every row of
    kv_src (B, T, D), the vision layers' precomputed patch embeddings,
    which are the same at train and decode time: no cache, so decode
    projects K and V of all T rows at every step, as JAX does.

    JAX's order of rounding: q scaled by ``head_dim**-0.5`` in the compute
    dtype (the constant rounded to it first) after the projection; f32
    scores whatever ``cfg.attn_scores_dtype`` says; a plain softmax over
    all T keys; the combine in ``x.dtype``.  Scores and combine stay plain
    PyTorch (JAX computes them outside any kernel, and its flash kernel
    takes one length for q and k).  ``active_planes`` reaches all four
    projections, as JAX's ``active_plane_count`` context does.

    On a mesh whose blocks allow it (``common.local_heads_ok``) the four
    projections are a Megatron pair on this rank's K/V heads: q from the
    whole ``x`` and k, v from the whole ``kv_src``, their partial
    products summed in one reduction, the scores and combine on its
    heads, ``wo`` on its K block; else every product is stitched whole."""
    B, S, _ = x.shape
    G = n_heads // n_kv
    mesh = packed_mesh()
    local = local_heads_ok(mesh, [p["wq"], p["wk"], p["wv"]], p["wo"], heads=n_kv)
    if local:
        from ..dist.sharding import axis_size

        n_kv //= axis_size(mesh, p["wq"].kn_spec[1])
        q, k, v = dense_group([x, kv_src, kv_src], [p["wq"], p["wk"], p["wv"]], active_planes)
    else:
        q = dense_apply(x, p["wq"], active_planes)
        k = dense_apply(kv_src, p["wk"], active_planes)
        v = dense_apply(kv_src, p["wv"], active_planes)
    q = q.reshape(B, S, n_kv, G, head_dim)
    q = q * torch.tensor(head_dim**-0.5, dtype=q.dtype)
    k = k.reshape(B, -1, n_kv, head_dim)
    v = v.reshape(B, -1, n_kv, head_dim)
    w = torch.softmax(_gqa_scores(q, k), dim=-1)
    out = _gqa_combine(w, v, x.dtype)
    del w  # (B, K, G, S, T) f32: free it before the output projection
    return dense_apply(out, p["wo"], active_planes, k_local=local)

