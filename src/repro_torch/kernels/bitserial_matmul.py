"""Wrapper around the Hopper bitserial-matmul kernels
(``csrc/bitserial_matmul.cu``), the port of the Pallas kernels
``bitserial_matmul_pallas`` and ``bitserial_matmul_pallas_dyn`` in
``repro/kernels/bitserial_matmul.py``.

:func:`bitserial_matmul_cuda` checks what it is given and raises on
anything the kernel does not take; it never copies an operand to make
it fit.  It allocates the output and any workspace, launches on the
current stream, raises on a CUDA error from the launch, and adds one to
:data:`launches` (and to :data:`active_launches` when it reads a runtime
plane count, the path of ``bitserial_matmul_pallas_dyn``, and to
:data:`prefill_launches` when M > 8, the prefill tiles).

Decode calls (M <= 8) split K over blocks: :func:`split_plan` of the
shape alone says how, so the static and the runtime-``active`` calls of
one shape sum in the same order.  The last block of each column tile
sums the splits in split order; it learns that it is last from a
per-device arrival counter that it resets, so two calls must not run at
once on different streams of one device.  Larger M runs a bf16 tile on
the tensor cores (``wgmma``), or the f32 SIMT tile (:func:`kernel_path`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BITS = 8
DECODE_MAX_M = 8  # rows of x that take the split-K decode kernel
SPLIT_TARGET_BLOCKS = 264  # one wave at two blocks per SM on the 132 of an H100
SPLIT_COLS = 128  # columns of a decode block (8 threads x 16 columns; 8 x 8 at M > 4)
MAX_SPLITS = 16  # the last block of a column tile reads every split
SPLIT_K_THREADS = 16  # threads of a decode block that share a split's byte-rows
COUNTER_COLS = 32  # columns per arrival counter (the narrowest column tile)
PATHS = ("splitk", "wgmma", "tiled")

# kernel launches since the last reset (one per call that reaches the card)
launches = 0
active_launches = 0
prefill_launches = 0
_counters: Dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    global launches, active_launches, prefill_launches
    launches = 0
    active_launches = 0
    prefill_launches = 0


def split_plan(M: int, K8: int, N: int) -> Tuple[int, int]:
    """``(n_split, rows_per_split)`` of a decode call (M <= 8 rows of x)
    with K8 packed byte-rows and N columns: split ``s`` covers the
    byte-rows ``[s * rows_per_split, (s + 1) * rows_per_split)``, and the
    splits tile ``[0, K8)``.  As many splits as keep the grid of column
    blocks (:data:`SPLIT_COLS` columns, half that at M > 4, where a
    thread keeps 8 columns) within :data:`SPLIT_TARGET_BLOCKS` (one wave:
    a block more would wait for the first to finish), at most
    :data:`MAX_SPLITS`; each split a whole number of byte-rows per thread
    (:data:`SPLIT_K_THREADS` share it) where K8 allows."""
    n_col = -(-N // (SPLIT_COLS if M <= 4 else SPLIT_COLS // 2))
    n_split = max(1, min(MAX_SPLITS, SPLIT_TARGET_BLOCKS // n_col))
    rows = -(-K8 // n_split)
    rows = min(-(-rows // SPLIT_K_THREADS) * SPLIT_K_THREADS, K8)
    return -(-K8 // rows), rows


def _lib():
    from . import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load("bitserial_matmul", {
        "bitserial_matmul_launch": [i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, p],
        "bitserial_matmul_path": [i, p, p, p, i, i, i],
    })


def kernel_path(x: torch.Tensor, planes: torch.Tensor, sign: torch.Tensor) -> str:
    """The kernel a call on these operands launches: "splitk" (M <= 8),
    "wgmma" (bf16 x, K % 8 == 0, N % 16 == 0, 16-byte aligned x, planes
    and sign) or "tiled"."""
    M, K = x.shape
    return PATHS[_lib().bitserial_matmul_path(_DTYPE_CODE[x.dtype], x.data_ptr(),
                                              planes.data_ptr(), sign.data_ptr(), M, K,
                                              planes.shape[-1])]


def _arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed arrival counters on ``device``; every call
    leaves them zero again."""
    c = _counters.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[device] = c
    return c


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
    global launches, active_launches, prefill_launches
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
    n_split, rows = split_plan(M, K8, N) if M <= DECODE_MAX_M else (1, 0)
    ws = (torch.empty((n_split, M, N), dtype=torch.float32, device=x.device)
          if n_split > 1 else None)
    counters = _arrival_counters(x.device, -(-N // COUNTER_COLS)) if n_split > 1 else None
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.bitserial_matmul_launch(
            _DTYPE_CODE[x.dtype], x.data_ptr(), planes.data_ptr(), sign.data_ptr(),
            scale.data_ptr(), None if active is None else active.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(),
            None if counters is None else counters.data_ptr(),
            M, K, K8, N, n_bits, denom_bits, G, n_split, rows, stream)
    if err:
        raise RuntimeError(f"bitserial_matmul kernel launch failed: CUDA error {err}")
    launches += 1
    if active is not None:
        active_launches += 1
    if M > DECODE_MAX_M:
        prefill_launches += 1
    return out
