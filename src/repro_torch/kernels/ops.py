"""Public kernel entry points: the CUDA kernel for a tensor on the card,
the plain PyTorch version for a tensor on the CPU.

The choice follows the device of ``x`` alone: no switch, and no
fallback when a kernel fails (it raises).  Ported from
``repro.kernels.ops``; the mesh-sharded entry comes with the mesh slice.
"""
from __future__ import annotations

import torch

from ..core.packing import PackedWeight
from . import ref


def _active_tensor(active_planes, device) -> torch.Tensor:
    if isinstance(active_planes, torch.Tensor):
        return active_planes.to(device=device, dtype=torch.int32).reshape(1)
    return torch.tensor([int(active_planes)], dtype=torch.int32, device=device)


def bitserial_matmul(x: torch.Tensor, pw: PackedWeight, active_planes=None) -> torch.Tensor:
    """x (..., K) @ packed weight (K, N) with on-the-fly dequantisation.

    ``active_planes`` (an int or an int32 tensor; None = every plane)
    keeps the ``a`` most significant planes, bitwise equal to the static
    path over ``core.packing.truncate_packed(pw, a)``.
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
