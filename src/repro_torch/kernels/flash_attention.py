"""Wrapper around the Hopper flash-attention kernel
(``csrc/flash_attention.cu``), the port of the Pallas kernel
``flash_attention_pallas`` in ``repro/kernels/flash_attention.py``.

:func:`flash_attention_cuda` checks what it is given and raises on
anything the kernel does not take; it never copies an operand to make
it fit.  It allocates the output, launches on the current stream,
raises on a CUDA error from the launch, and adds one to
:data:`launches` (and to :data:`windowed_launches` when a window is
given).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_ROWS = 65535  # rows of BH: the grid's second axis

# kernel launches since the last reset (one per call that reaches the card)
launches = 0
windowed_launches = 0


def reset_launches() -> None:
    global launches, windowed_launches
    launches = 0
    windowed_launches = 0


def _lib():
    from . import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load("flash_attention", {
        "flash_attention_launch": [i, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p],
    })


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention forward on the card.

    ``q`` (BH, S, d) float32 or bfloat16; ``k``/``v`` (BHkv, S, d) of q's
    dtype, BHkv dividing BH (query row r reads key/value row
    ``r // (BH // BHkv)``).  Returns (BH, S, d) in q's dtype.
    """
    global launches, windowed_launches
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got q on {q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype} not supported (q, k and v "
                        "all float32 or all bfloat16)")
    if q.ndim != 3 or k.ndim != 3 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"want q (BH, S, d) and k, v (BHkv, S, d); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, d = q.shape
    BHkv = k.shape[0]
    if k.shape[1:] != q.shape[1:] or BHkv < 1 or BH % BHkv:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}: need the same "
                         "(S, d) and a row count dividing q's")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 in [8, {MAX_HEAD_DIM}] "
                         "(16-byte row loads)")
    if BH > MAX_ROWS:
        raise ValueError(f"BH = {BH} > {MAX_ROWS} rows")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (the wrapper does not copy)")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: the kernel has no backward (training "
                             "runs the plain attention)")
    if window is not None and int(window) < 1:
        raise ValueError(f"window={window} must be >= 1 (or None)")
    win = 0 if window is None else int(window)  # 0: no window, in the C entry
    sm_scale = d**-0.5 if sm_scale is None else float(sm_scale)
    out = torch.empty_like(q)
    if BH == 0 or S == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            BH, BHkv, S, d, int(bool(causal)), win, sm_scale, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    if window is not None:
        windowed_launches += 1
    return out
