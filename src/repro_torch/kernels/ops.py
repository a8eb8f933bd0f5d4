"""Public kernel entry points: the CUDA kernel for a tensor on the card,
the plain PyTorch version for a tensor on the CPU.

The choice follows the device of the first tensor alone: no switch,
and no fallback when a kernel fails (it raises).  Ported from
``repro.kernels.ops``: the bitserial matmul (static and with a runtime
plane count), paged attention, the bit-group sum of squares and flash
attention, and on a ("data", "model") mesh the bitserial matmul over this
rank's block of the packed bytes (:func:`bitserial_matmul_sharded`).

On the ``meta`` device (the dry run, ``roofline.analysis``) an entry
returns an empty output of its kernel's shape and dtype and reports the
kernel's FLOPs, bytes and one launch to the active counter, by the bound
formulas of ``chip_smoke.py``; paged attention, whose work depends on
positions a meta tensor lacks, raises there.
"""
from __future__ import annotations

import dataclasses

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


def stitch(y: torch.Tensor, mesh, k_ax, n_ax) -> torch.Tensor:
    """The whole ``x @ W`` from this rank's partial product ``y`` (..., N/dn)
    over its K block: summed over the K axis's ranks (one ``all_reduce``,
    whose result is the same bits on every rank), then gathered over the
    N axis's ranks."""
    if k_ax is not None:
        y = mesh.all_reduce(y, k_ax)
    if n_ax is not None:
        y = mesh.all_gather(y, n_ax, dim=-1)
    return y


def k_slice(x: torch.Tensor, mesh, k_ax, k_local: int) -> torch.Tensor:
    """The K columns of a whole ``x`` (..., K) that line up with this
    rank's K block of a weight."""
    if k_ax is None:
        return x
    from ..dist.sharding import axis_index

    lo = axis_index(mesh, k_ax) * k_local
    return x[..., lo:lo + k_local]


def local_product(x: torch.Tensor, w, mesh, active_planes=None,
                  k_local: bool = False) -> torch.Tensor:
    """This rank's partial product of ``x`` by its block of ``w`` (a
    PackedWeight with a ``kn_spec``, or a FloatBlock), no collective:
    the bitserial kernel on the local planes, sign and scale, or a local
    ``torch.matmul``.  ``x`` is whole on every rank and its K slice is
    taken here, or with ``k_local`` already this rank's K block."""
    k_ax = w.kn_spec[0]
    if isinstance(w, PackedWeight):
        K = w.sign.shape[-2] * 8
        xk = x if k_local else k_slice(x, mesh, k_ax, K)
        return bitserial_matmul(xk, dataclasses.replace(w, k=K, kn_spec=None), active_planes)
    xk = x if k_local else k_slice(x, mesh, k_ax, w.w.shape[-2])
    return xk @ w.w.to(x.dtype)


def _warn_unsharded(pw: PackedWeight) -> None:
    import warnings

    warnings.warn(
        f"bitserial_matmul_sharded: falling back to the unsharded packed matmul "
        f"(kn_spec={pw.kn_spec}, sign shape {tuple(pw.sign.shape)}, scale shape "
        f"{tuple(pw.scale.shape)}, k={pw.k}): local shard blocks are ill-defined "
        "(indivisible K8/N/scale groups or padded K); packed bytes will be gathered at "
        "the kernel call", stacklevel=3)


def shardable(pw: PackedWeight, mesh) -> bool:
    """Whether this rank's block of ``pw`` is a well-defined packed weight:
    its K rows carry no padding that would straddle the K shards."""
    from ..dist.sharding import axis_size

    k_ax = pw.kn_spec[0] if pw.kn_spec is not None else None
    return pw.k == pw.sign.shape[-2] * axis_size(mesh, k_ax) * 8


def bitserial_matmul_sharded(x: torch.Tensor, pw: PackedWeight, mesh, active_planes=None,
                             k_local: bool = False) -> torch.Tensor:
    """x (..., K), whole on every rank, @ a packed weight of which this rank
    holds the block ``pw.kn_spec`` names: the bitserial kernel (the plain
    version on the CPU) runs on the LOCAL planes, sign and scale against
    the K slice of ``x`` that lines up with them, the partial products
    are summed over the K axis's ranks and the output gathered over the
    N axis's ranks (:func:`local_product`, :func:`stitch`), so every rank returns the whole
    (..., N).  ``active_planes`` is the same count on every rank; each
    masks the same planes of its local bytes.  ``k_local``: ``x`` is
    already this rank's K block (the N block of an earlier product).

    A block that is ill-defined (padded K, whose pad rows would straddle
    the K shards) warns, as JAX's GSPMD fallback does, and the bytes are
    gathered here before the unsharded kernel call.  ``pw.k`` is the
    whole weight's unpadded K; a scale row on a mesh always describes the
    local columns (``dist.elastic.reshard_tree``)."""
    k_ax, n_ax = pw.kn_spec if pw.kn_spec is not None else (None, None)
    if k_ax is None and n_ax is None:
        return bitserial_matmul(x, pw, active_planes)
    if not shardable(pw, mesh):
        if k_local:
            raise ValueError("a padded-K packed weight has no local block to run on")
        _warn_unsharded(pw)
        s = pw.scale
        whole = PackedWeight(
            planes=mesh.gather_block(pw.planes, (None, k_ax, n_ax)),
            sign=mesh.gather_block(pw.sign, (k_ax, n_ax)),
            scale=mesh.gather_block(s, (None, n_ax)) if s.ndim == 2 and s.shape[-1] > 1 else s,
            n_bits=pw.n_bits, k=pw.k, denom_bits=pw.denom_bits)
        return bitserial_matmul(x, whole, active_planes)
    return stitch(local_product(x, pw, mesh, active_planes, k_local), mesh, k_ax, n_ax)


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
