"""Public kernel entry points: the CUDA kernel for a tensor on the card,
the plain PyTorch version for a tensor on the CPU.

The choice follows the device of the first tensor alone: no switch,
and no fallback when a kernel fails (it raises).  Ported from
``repro.kernels.ops``: the bitserial matmul (static and with a runtime
plane count), paged attention, the bit-group sum of squares and flash
attention; the mesh-sharded entry comes with the mesh slice.

On the ``meta`` device (the dry run, ``roofline.analysis``) an entry
returns an empty output of its kernel's shape and dtype and reports the
kernel's FLOPs, bytes and one launch to the active counter, by the bound
formulas of ``chip_smoke.py``; paged attention, whose work depends on
positions a meta tensor lacks, raises there.
"""
from __future__ import annotations

import torch

from ..core.packing import PackedWeight
from ..roofline.analysis import record_kernel
from . import ref


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _active_tensor(active_planes, device) -> torch.Tensor:
    """The kernel's one-element int32 ``active`` operand.  On the card it
    must already be a device tensor: a Python int would cost a host to
    device copy at every launch (callers make one tensor per plane count
    once), so it raises."""
    if not isinstance(active_planes, torch.Tensor):
        raise TypeError(
            f"active_planes={active_planes!r} on {device}: pass an int32 tensor on the "
            "device (made once per plane count), not a Python int")
    return active_planes.to(device=device, dtype=torch.int32).reshape(1)


def bitserial_matmul(x: torch.Tensor, pw: PackedWeight, active_planes=None) -> torch.Tensor:
    """x (..., K) @ packed weight (K, N) with on-the-fly dequantisation.

    ``active_planes`` (None = every plane) keeps the ``a`` most
    significant planes, bitwise equal to the static path over
    ``core.packing.truncate_packed(pw, a)``.  On the card it is an int32
    device tensor, read by the kernel on the device; on the CPU an int
    or a tensor.
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x2.device.type == "cuda":
        from .bitserial_matmul import bitserial_matmul_cuda

        active = None if active_planes is None else _active_tensor(active_planes, x2.device)
        out = bitserial_matmul_cuda(
            x2.contiguous(), pw.planes, pw.sign, pw.scale, pw.n_bits, pw.k,
            denom_bits=pw.denom_bits, active=active)
    elif x2.device.type == "meta":
        out = _bitserial_meta(x2, pw, active_planes)
    else:
        out = ref.bitserial_matmul_ref(
            x2, pw.planes, pw.sign, pw.scale, pw.n_bits,
            denom_bits=pw.denom_bits, active_planes=active_planes)
    return out.reshape(*lead, -1)


def _bitserial_meta(x2: torch.Tensor, pw: PackedWeight, active_planes) -> torch.Tensor:
    """2MKN FLOPs; x read, the live planes, sign and scale read, the
    output written once.  ``active_planes`` is an int here: a meta tensor
    holds no count."""
    if isinstance(active_planes, torch.Tensor):
        raise TypeError("active_planes on meta must be a Python int: a meta tensor has no value")
    M, K = x2.shape
    N = pw.sign.shape[-1]
    live = pw.n_bits if active_planes is None else min(max(int(active_planes), 1), pw.n_bits)
    planes_bytes = (live + 1) * pw.sign.numel()  # live planes + sign, K/8 x N bytes each
    out = torch.empty((M, N), dtype=x2.dtype, device="meta")
    record_kernel("bitserial_matmul", 2.0 * M * K * N,
                  _nbytes(x2, out) + planes_bytes + 4 * pw.scale.numel())
    return out


def live_pairs(S: int, window, causal: bool) -> int:
    """The (query, key) pairs of one head that a causal or windowed mask
    keeps: query i sees keys [max(0, i - window + 1), i] (causal) or
    [max(0, i - window + 1), S - 1]."""
    w = S if not window else min(window, S)
    if causal:  # sum over i of min(i + 1, w)
        return w * (w + 1) // 2 + (S - w) * w
    # sum over i of S - max(0, i - w + 1)
    return S * S - (S - w) * (S - w + 1) // 2


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                    block_table: torch.Tensor, pos: torch.Tensor, *,
                    window=None, sm_scale=None) -> torch.Tensor:
    """Paged decode attention: q (B, KV, G, d) against the block pools.

    On the card the kernel walks each lane's live blocks in place, so
    device-memory reads scale with live tokens; on the CPU the plain
    version gathers each lane's whole logical view.  ``pos < 0`` lanes
    return exact zeros on both paths.
    """
    if q.device.type == "cuda":
        from .paged_attention import paged_attention_cuda

        return paged_attention_cuda(q, k_pool, v_pool, block_table, pos,
                                    window=window, sm_scale=sm_scale)
    if q.device.type == "meta":
        raise NotImplementedError("paged_attention on meta: its work depends on the lanes' "
                                  "positions, which a meta tensor does not hold")
    return ref.paged_attention_ref(q, k_pool, v_pool, block_table, pos, window=window,
                                   sm_scale=sm_scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None, sm_scale=None) -> torch.Tensor:
    """(BH, S, d) causal, optionally windowed, attention forward.

    ``k``/``v`` may come with ``BH // G`` rows: query row ``r`` reads
    key/value row ``r // G``, which equals JAX's "broadcast kv
    beforehand" without the copy.  On the card the kernel skips the
    tiles the mask empties; it has no backward and raises for inputs
    that require grad."""
    if q.device.type == "cuda":
        from .flash_attention import flash_attention_cuda

        return flash_attention_cuda(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    if q.device.type == "meta":
        BH, S, d = q.shape
        out = torch.empty_like(q)
        record_kernel("flash_attention", 4.0 * d * live_pairs(S, window, causal) * BH,
                      _nbytes(q, k, v, out))
        return out
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale)


class _BglSumsqGrouped(torch.autograd.Function):
    """Per-row sums of squares of a group of (R_i, C_i) views, one flat
    output: the grouped kernel on the card, the plain version on the CPU.
    The backward, ``2 x_i g[row]`` for each view that needs it, is one
    kernel launch on the card and the plain version's bits (the JAX
    package differentiates its jnp sum the same way; it has no backward
    kernel)."""

    @staticmethod
    def forward(ctx, *xs):
        ctx.save_for_backward(*xs)
        if xs[0].device.type == "cuda":
            from .bgl_sumsq import bgl_sumsq_grouped_cuda

            return bgl_sumsq_grouped_cuda(xs)
        if xs[0].device.type == "meta":
            rows = sum(x.shape[0] for x in xs)
            out = torch.empty((rows,), dtype=torch.float32, device="meta")
            record_kernel("bgl_sumsq", 2.0 * sum(x.numel() for x in xs), _nbytes(*xs, out))
            return out
        return ref.bgl_sumsq_grouped_ref(xs)

    @staticmethod
    def backward(ctx, g):
        xs = ctx.saved_tensors
        needs = ctx.needs_input_grad
        if xs[0].device.type == "cuda":
            from .bgl_sumsq import bgl_sumsq_grouped_backward_cuda

            return tuple(bgl_sumsq_grouped_backward_cuda(xs, g, needs))
        if xs[0].device.type == "meta":
            grads = tuple(torch.empty_like(x) if need else None for x, need in zip(xs, needs))
            live = [x for x, need in zip(xs, needs) if need]
            record_kernel("bgl_sumsq_backward", 2.0 * sum(x.numel() for x in live),
                          2 * _nbytes(*live) + _nbytes(g))
            return grads
        gs = torch.split(g, [x.shape[0] for x in xs])
        return tuple(ref.bgl_sumsq_grad_ref(x, gi) if need else None
                     for x, gi, need in zip(xs, gs, needs))


def bgl_sumsq_grouped(xs) -> torch.Tensor:
    """(R_i, C_i) views -> flat (sum R_i,) f32 per-row sums of squares:
    the rows of ``xs[0]``, then those of ``xs[1]``, ...  Rows are (bit,
    group) pairs of the bit-level group Lasso; on the card the whole
    group is one launch (one dtype per group).  Differentiable."""
    return _BglSumsqGrouped.apply(*xs)


def bgl_sumsq(x: torch.Tensor) -> torch.Tensor:
    """(R, C) -> (R,) f32 per-row sum of squares: the one-view group of
    :func:`bgl_sumsq_grouped`.  Differentiable."""
    return _BglSumsqGrouped.apply(x)
