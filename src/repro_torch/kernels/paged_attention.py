"""Wrapper around the Hopper paged-attention kernel
(``csrc/paged_attention.cu``), the port of the Pallas kernel
``paged_attention_pallas`` in ``repro/kernels/paged_attention.py``.

:func:`paged_attention_cuda` checks what it is given and raises on
anything the kernel does not take; it never copies an operand to make
it fit.  The block table and the positions are read on the device, so
a call never syncs the host.  It allocates the output, launches on the
current stream, raises on a CUDA error from the launch, and adds one to
:data:`launches`.

The kernel splits each lane's rows over several blocks (flash-decoding)
and merges the splits in a second kernel.  How many splits, and how many
rows each, is :func:`split_plan` of the table's shape alone, so the
grid and the scratch never depend on ``pos``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP_ELEMS = 4096  # G * d of one call (the kernel serves 8 heads a block)
SPLIT_ROWS = 128  # lane-logical rows per split (rounded to whole table blocks)

# kernel launches since the last reset (one per call that reaches the card)
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def split_plan(blocks_per_lane: int, block_size: int) -> Tuple[int, int]:
    """``(n_split, rows_per_split)`` for a table of ``blocks_per_lane``
    entries of ``block_size`` rows: split ``s`` covers the lane-logical
    rows ``[s * rows_per_split, (s + 1) * rows_per_split)``, whole table
    blocks, and the splits tile ``[0, blocks_per_lane * block_size)``."""
    per_split = max(1, SPLIT_ROWS // block_size)  # table blocks per split
    return -(-blocks_per_lane // per_split), per_split * block_size


def _lib():
    from . import _build

    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.load("paged_attention", {
        "paged_attention_launch": [i, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                   ctypes.c_float, i, i, p],
    })


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                         block_table: torch.Tensor, pos: torch.Tensor,
                         window: Optional[int] = None,
                         sm_scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention on the card.

    ``q`` (B, KV, G, d) float32 or bfloat16; ``k_pool``/``v_pool``
    (n_blocks, block_size, KV, d) of one dtype (float32 or bfloat16);
    ``block_table`` (B, blocks_per_lane) int32; ``pos`` (B,) int32, < 0
    for an inactive lane.  Returns (B, KV, G, d) in q's dtype.

    One call runs two kernels, the split walk and the merge, on f32
    scratch of :func:`split_plan`'s shape, and adds one to
    :data:`launches`.
    """
    global launches
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got q on {q.device}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not supported (float32, bfloat16)")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pool dtypes {k_pool.dtype}/{v_pool.dtype} not supported "
                        "(both float32 or both bfloat16)")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError(f"block_table and pos must be int32, got {block_table.dtype}, "
                        f"{pos.dtype}")
    if q.ndim != 4 or k_pool.ndim != 4 or block_table.ndim != 2 or pos.ndim != 1:
        raise ValueError(f"want q (B, KV, G, d), pools (n_blocks, bs, KV, d), table (B, nb), "
                         f"pos (B,); got {tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(block_table.shape)}, {tuple(pos.shape)}")
    B, KV, G, d = q.shape
    _, bs, kv_p, d_p = k_pool.shape
    if (tuple(v_pool.shape) != tuple(k_pool.shape) or (kv_p, d_p) != (KV, d)
            or block_table.shape[0] != B or pos.shape[0] != B):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k_pool {tuple(k_pool.shape)}, "
                         f"v_pool {tuple(v_pool.shape)}, table {tuple(block_table.shape)}, "
                         f"pos {tuple(pos.shape)}")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} must be a multiple of 8 in [8, {MAX_HEAD_DIM}] "
                         "(16-byte row loads)")
    if G * d > MAX_GROUP_ELEMS:
        raise ValueError(f"G * d = {G * d} > {MAX_GROUP_ELEMS} accumulators per block")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (a stacked cache's layer slice "
                             "is; the wrapper does not copy)")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if window is not None and int(window) < 1:
        raise ValueError(f"window={window} must be >= 1 (or None)")
    window = 0 if window is None else int(window)  # 0: no window, in the C entry
    sm_scale = d**-0.5 if sm_scale is None else float(sm_scale)
    out = torch.empty_like(q)
    nb_lane = block_table.shape[1]
    if B == 0 or KV == 0 or G == 0:
        return out
    n_split, rows_per_split = split_plan(nb_lane, bs)
    # per (lane, KV head, split, query head): acc (d), then (m, l)
    part_acc = torch.empty((B, KV, n_split, G, d), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, KV, n_split, G, 2), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.paged_attention_launch(
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], q.data_ptr(), k_pool.data_ptr(),
            v_pool.data_ptr(), block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), B, KV, G, d, bs, nb_lane, window,
            sm_scale, n_split, rows_per_split, stream)
    if err:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out
