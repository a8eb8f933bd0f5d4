"""Plain PyTorch versions of the port's kernels (the correctness contract).

Ported from ``repro.kernels.ref``.  The CPU path runs them; on the card
they are what each kernel is held against.
"""
from __future__ import annotations

import torch

from ..core.packing import scale_row, unpack_bits_axis0


def bitserial_matmul_ref(x, planes, sign, scale, n_bits: int,
                         denom_bits: int | None = None, active_planes=None):
    """x (M,K) @ dequant(planes, sign) * scale_row / (2^denom_bits - 1).

    ``scale`` is a scalar or a per-group ``(1, G)`` row applied as an
    output-column epilogue; ``denom_bits`` (default ``n_bits``) carries a
    truncated view's original denominator.

    ``active_planes`` (an int or an int32 tensor) keeps the ``a`` most
    significant planes: dropped planes are multiplied by exact ``+0.0``
    and added in the same order as the truncated static path, live
    planes weigh ``2^(b-lo)``, and the shift folds into the epilogue as
    ``2^lo``, so the result is BITWISE equal to the static path over
    ``core.packing.truncate_packed(pw, a)``.

    The epilogue multiplies the already-rounded ``x @ w`` by the scale in
    x's dtype, as ``repro.kernels.ref`` does; the CUDA kernel applies it
    to the f32 accumulator, as the Pallas kernel does.
    """
    K = x.shape[1]
    denom = 2.0 ** (n_bits if denom_bits is None else denom_bits) - 1.0
    N = sign.shape[-1]
    if active_planes is None:
        mag = sum(
            unpack_bits_axis0(planes[b], K).to(torch.float32) * (2.0**b)
            for b in range(n_bits)
        )
        s = scale_row(scale, N) / denom
    else:
        a = torch.as_tensor(active_planes, dtype=torch.int32, device=x.device).reshape(())
        lo = n_bits - torch.clamp(a, 1, n_bits)  # first live plane
        mag = torch.zeros((K, N), dtype=torch.float32, device=x.device)
        for b in range(n_bits):
            t = unpack_bits_axis0(planes[b], K).to(torch.float32)
            # integer powers of two, exact: 0.0 for a dropped plane
            w_b = torch.where(lo <= b, (2 ** torch.clamp(b - lo, min=0)).to(torch.float32),
                              torch.zeros((), dtype=torch.float32, device=x.device))
            mag = mag + t * w_b
        s = (scale_row(scale, N) * (2**lo).to(torch.float32)) / denom
    sgn = 1.0 - 2.0 * unpack_bits_axis0(sign, K).to(torch.float32)
    w = (sgn * mag).to(x.dtype)
    return (x @ w) * s.to(x.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_table, pos, *, window=None, sm_scale=None):
    """Naive f32 softmax decode attention over the block-table gather.

    ``q`` (B, KV, G, d) single-query heads (kv-major GQA layout); pools
    (n_blocks, block_size, KV, d); ``block_table`` (B, blocks_per_lane)
    int32; ``pos`` (B,) int32.  Lane b attends its lane-logical rows
    ``[0, pos[b]]`` (optionally windowed) gathered out of the pool; stale
    table entries sit past ``pos`` and are masked with -1e30 (so a NaN in
    a stale block still reaches the output through ``0 * NaN``: this
    version is not NaN-safe, the kernel is).  ``pos[b] < 0`` marks an
    inactive lane and yields exact zeros.
    """
    B, KV, G, d = q.shape
    bs = k_pool.shape[1]
    L = block_table.shape[1] * bs
    if sm_scale is None:
        sm_scale = d**-0.5
    idx = block_table.reshape(-1).long()
    keys = k_pool[idx].reshape(B, L, KV, d)
    vals = v_pool[idx].reshape(B, L, KV, d)
    s = torch.einsum("bkgd,bskd->bkgs", q.to(torch.float32), keys.to(torch.float32)) * sm_scale
    pos = pos.to(device=q.device, dtype=torch.int64)
    kpos = torch.arange(L, device=q.device)
    valid = kpos[None, :] <= pos[:, None]
    if window is not None:
        valid &= (pos[:, None] - kpos[None, :]) < window
    s = torch.where(valid[:, None, None, :], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, vals.to(torch.float32))
    out = torch.where((pos >= 0)[:, None, None, None], out, torch.zeros((), device=q.device))
    return out.to(q.dtype)


def bgl_sumsq_ref(x: torch.Tensor) -> torch.Tensor:
    """Per-row sum of squares of an (R, C) matrix, summed in f32 (float64
    input stays float64, so ``gradcheck`` can hold the gradient)."""
    x = x if x.dtype == torch.float64 else x.float()
    return x.pow(2).sum(1)


def bgl_sumsq_grouped_ref(xs) -> torch.Tensor:
    """:func:`bgl_sumsq_ref` of each (R_i, C_i) input, concatenated: the
    rows of ``xs[0]``, then those of ``xs[1]``, ..."""
    return torch.cat([bgl_sumsq_ref(x) for x in xs])


def bgl_sumsq_grad_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient ``2 x g[:, None]`` of :func:`bgl_sumsq_ref` for the
    output gradient ``g`` (R,): ``x * (2 g)[:, None]`` in x's dtype, and
    for bf16 the f32 product rounded to bf16 once (the JAX package
    differentiates its jnp sum the same way)."""
    g2 = (2.0 * g)[:, None]
    if x.dtype == torch.bfloat16:
        return (x.float() * g2).to(x.dtype)
    return x * g2.to(x.dtype)


def flash_attention_ref(q, k, v, *, causal=True, window=None, sm_scale=None):
    """Naive f32 softmax attention over (BH, S, d): scores in f32, the
    causal and window mask filled with -1e30, softmax, then ``p`` cast to
    V's dtype before the product with V (the result in V's dtype).

    ``k``/``v`` may hold ``BH // G`` rows: query row ``r`` reads row
    ``r // G`` (the JAX callers broadcast K/V beforehand; the result is
    the same)."""
    BH, S, d = q.shape
    G = BH // k.shape[0]
    if G > 1:
        k = k.repeat_interleave(G, dim=0)
        v = v.repeat_interleave(G, dim=0)
    if sm_scale is None:
        sm_scale = d**-0.5
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32), k.to(torch.float32)) * sm_scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask[None], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype), v)
