"""Wrapper around the Hopper per-row sum-of-squares kernel
(``csrc/bgl_sumsq.cu``), the port of the Pallas kernel
``bgl_sumsq_pallas`` in ``repro/kernels/bgl_norm.py``.

:func:`bgl_sumsq_cuda` checks what it is given and raises on anything
the kernel does not take; it never copies an operand to make it fit.  It
allocates the output and the per-chunk scratch, launches on the current
stream, raises on a CUDA error from the launch, and adds one to
:data:`launches`.
"""
from __future__ import annotations

import ctypes

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
CHUNK_BYTES = 256 * 1024  # of one row, per block
_MAX_BLOCKS = 2**31 - 1

# kernel launches since the last reset (one per call that reaches the card)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    from . import _build

    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return _build.load("bgl_sumsq", {"bgl_sumsq_launch": [i, p, p, p, ll, ll, ll, ll, p]})


def bgl_sumsq_cuda(x: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_c x[r, c]^2`` in f32 for a contiguous (R, C) float32
    or bfloat16 CUDA tensor."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"bgl_sumsq_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not supported (float32, bfloat16)")
    if x.ndim != 2:
        raise ValueError(f"want x (R, C), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (a plane tensor's (bits x groups, rest) view "
                         "is; the wrapper does not copy)")
    R, C = x.shape
    if R == 0 or C == 0:
        return torch.zeros((R,), dtype=torch.float32, device=x.device)
    chunk = CHUNK_BYTES // x.element_size()
    n_chunks = -(-C // chunk)
    if R * n_chunks > _MAX_BLOCKS or R > _MAX_BLOCKS:
        raise ValueError(f"x {tuple(x.shape)} needs {R * n_chunks} blocks, more than a 1-D grid")
    partial = torch.empty((R, n_chunks), dtype=torch.float32, device=x.device)
    out = torch.empty((R,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bgl_sumsq_launch(_DTYPE_CODE[x.dtype], x.data_ptr(), partial.data_ptr(),
                                   out.data_ptr(), R, C, chunk, n_chunks, stream)
    if err:
        raise RuntimeError(f"bgl_sumsq kernel launch failed: CUDA error {err}")
    launches += 1
    return out
