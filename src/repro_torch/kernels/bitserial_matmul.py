"""Wrapper around the Hopper bitserial-matmul kernel
(``csrc/bitserial_matmul.cu``), the port of the Pallas kernels
``bitserial_matmul_pallas`` and ``bitserial_matmul_pallas_dyn`` in
``repro/kernels/bitserial_matmul.py``.

:func:`bitserial_matmul_cuda` checks what it is given and raises on
anything the kernel does not take; it never copies an operand to make
it fit.  It allocates the output, launches on the current stream, raises
on a CUDA error from the launch, and adds one to :data:`launches` (and
to :data:`active_launches` when it reads a runtime plane count, the
path of ``bitserial_matmul_pallas_dyn``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BITS = 8

# kernel launches since the last reset (one per call that reaches the card)
launches = 0
active_launches = 0


def reset_launches() -> None:
    global launches, active_launches
    launches = 0
    active_launches = 0


def _lib():
    from . import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load("bitserial_matmul", {
        "bitserial_matmul_launch": [i, p, p, p, p, p, p, i, i, i, i, i, i, i, p],
    })


def bitserial_matmul_cuda(x: torch.Tensor, planes: torch.Tensor, sign: torch.Tensor,
                          scale: torch.Tensor, n_bits: int, k: int,
                          denom_bits: Optional[int] = None,
                          active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (M, K) @ packed (K, N) on the card.

    ``planes`` (n_bits, K8, N) uint8, ``sign`` (K8, N) uint8, ``scale``
    float32 with G elements (a scalar, ``(1, 1)`` or ``(1, G)``) where G
    divides N, ``active`` an int32 device tensor of one element (None =
    every plane; it is read on the device, never on the host).
    """
    global launches, active_launches
    if x.device.type != "cuda":
        raise ValueError(f"bitserial_matmul_cuda needs CUDA tensors, got x on {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    if not 1 <= n_bits <= MAX_BITS:
        raise ValueError(f"n_bits={n_bits} outside the kernel's range [1, {MAX_BITS}]")
    if x.ndim != 2 or planes.ndim != 3 or sign.ndim != 2:
        raise ValueError(f"want x (M, K), planes (n, K8, N), sign (K8, N); got "
                         f"{tuple(x.shape)}, {tuple(planes.shape)}, {tuple(sign.shape)}")
    M, K = x.shape
    n, K8, N = planes.shape
    if n != n_bits or tuple(sign.shape) != (K8, N) or K != k or not k <= K8 * 8 < k + 8:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, planes {tuple(planes.shape)}, "
                         f"sign {tuple(sign.shape)}, n_bits={n_bits}, k={k}")
    if planes.dtype != torch.uint8 or sign.dtype != torch.uint8:
        raise TypeError("planes and sign must be uint8")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    G = scale.numel()
    if scale.ndim > 2 or (scale.ndim == 2 and scale.shape[0] != 1) or N % G:
        raise ValueError(f"scale shape {tuple(scale.shape)} is not a row of G | N={N} groups")
    if N % 4:
        raise ValueError(f"N={N} must be a multiple of 4 (4-column words)")
    for name, t in (("x", x), ("planes", planes), ("sign", sign), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (a stacked weight's layer "
                             "slice is; the wrapper does not copy)")
    if planes.data_ptr() % 4 or sign.data_ptr() % 4:
        raise ValueError("planes and sign must be 4-byte aligned")
    if active is not None:
        if (active.device != x.device or active.dtype != torch.int32
                or active.numel() != 1):
            raise ValueError("active must be a one-element int32 tensor on x's device")
    denom_bits = n_bits if denom_bits is None else denom_bits
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bitserial_matmul_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), planes.data_ptr(), sign.data_ptr(),
            scale.data_ptr(), None if active is None else active.data_ptr(), out.data_ptr(),
            M, K, K8, N, n_bits, denom_bits, G, stream)
    if err:
        raise RuntimeError(f"bitserial_matmul kernel launch failed: CUDA error {err}")
    launches += 1
    if active is not None:
        active_launches += 1
    return out
