"""Public kernel entry points: the CUDA kernel for a tensor on the card,
the plain PyTorch version for a tensor on the CPU.

The choice follows the device of the first tensor alone: no switch,
and no fallback when a kernel fails (it raises).  Ported from
``repro.kernels.ops``: the bitserial matmul (static and with a runtime
plane count), paged attention, the bit-group sum of squares and flash
attention; the mesh-sharded entry comes with the mesh slice.
"""
from __future__ import annotations

import torch

from ..core.packing import PackedWeight
from . import ref


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
    else:
        out = ref.bitserial_matmul_ref(
            x2, pw.planes, pw.sign, pw.scale, pw.n_bits,
            denom_bits=pw.denom_bits, active_planes=active_planes)
    return out.reshape(*lead, -1)


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
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale)


class _BglSumsq(torch.autograd.Function):
    """Per-row sum of squares, the kernel on the card and the plain
    version on the CPU; the backward is ``2 x g[:, None]`` on both (the
    JAX package differentiates its jnp sum the same way; there is no
    backward kernel)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        if x.device.type == "cuda":
            from .bgl_sumsq import bgl_sumsq_cuda

            return bgl_sumsq_cuda(x)
        return ref.bgl_sumsq_ref(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        g2 = (2.0 * g)[:, None]
        if x.dtype == torch.bfloat16:
            return (x.float() * g2).to(x.dtype)
        return x * g2.to(x.dtype)


def bgl_sumsq(x: torch.Tensor) -> torch.Tensor:
    """(R, C) -> (R,) f32 per-row sum of squares; rows are (bit, group)
    pairs of the bit-level group Lasso.  Differentiable."""
    return _BglSumsq.apply(x)
