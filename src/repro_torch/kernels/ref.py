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
