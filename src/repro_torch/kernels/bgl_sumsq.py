"""Wrappers around the Hopper grouped sum-of-squares kernels
(``csrc/bgl_sumsq.cu``), the port of the Pallas kernel
``bgl_sumsq_pallas`` in ``repro/kernels/bgl_norm.py``.

:func:`bgl_sumsq_grouped_cuda` sums the rows of a whole group of (R, C)
views in one launch (more than :data:`MAX_SEGMENTS` views take one launch
per :data:`MAX_SEGMENTS`); :func:`bgl_sumsq_grouped_backward_cuda` writes
every view's gradient ``2 x g[row]`` in one launch.  Both check what
they are given and raise on anything the kernels do not take (never
copying an operand to make it fit), launch on the current stream, raise
on a CUDA error from the launch, and add one per launch to
:data:`launches` or :data:`backward_launches`.

How a row is cut into blocks (:func:`chunk_elems`) depends on that row's
length alone, so a view's sums are the same bits alone or in a group.
The per-row counters of the in-launch reduction and the partial sums
live in a workspace kept per device and stream, grown when a group needs
more; the kernel leaves the counters at 0.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# a row is cut into about PIECES chunks, a power of two of bytes between these
MIN_CHUNK_BYTES, MAX_CHUNK_BYTES, PIECES = 32 * 1024, 256 * 1024, 16
MAX_SEGMENTS = 96  # views per launch: the kernel's kMaxSegs, which refuses more
_MAX_BLOCKS = 2**31 - 1

# kernel launches since the last reset (one per launch that reaches the card)
launches = 0
backward_launches = 0

# (device index, stream) -> (per-row counters, all 0 between launches; partials)
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "bgl_sumsq_grouped_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P, _P],
    "bgl_sumsq_grad_launch": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P, _LL, _P],
}


def reset_launches() -> None:
    global launches, backward_launches
    launches = 0
    backward_launches = 0


def _lib():
    from . import _build

    return _build.load("bgl_sumsq", _ARGTYPES)


def chunk_elems(C: int, element_size: int) -> int:
    """Elements of one row that one block sums: about ``C / PIECES``,
    rounded up to a power of two of bytes in [MIN_CHUNK_BYTES,
    MAX_CHUNK_BYTES]."""
    want = -(-C * element_size // PIECES)
    if want <= MIN_CHUNK_BYTES:
        return MIN_CHUNK_BYTES // element_size
    return min(MAX_CHUNK_BYTES, 1 << (want - 1).bit_length()) // element_size


def _check(xs: Sequence[torch.Tensor], what: str) -> torch.dtype:
    if len(xs) == 0:
        raise ValueError(f"{what} needs at least one tensor")
    dev, dtype = xs[0].device, xs[0].dtype
    if (dtype in _DTYPE_CODE and dev.type == "cuda"
            and all(x.is_cuda and x.dtype == dtype and x.ndim == 2 and x.is_contiguous()
                    and x.get_device() == dev.index for x in xs)):
        return dtype
    for i, x in enumerate(xs):
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{what} needs CUDA tensors on one device: input {i} is on "
                             f"{x.device}, input 0 on {dev}")
        if x.dtype not in _DTYPE_CODE:
            raise TypeError(f"input {i} dtype {x.dtype} not supported (float32, bfloat16)")
        if x.dtype != dtype:
            raise TypeError(f"a group takes one dtype: input {i} is {x.dtype}, input 0 {dtype}")
        if x.ndim != 2:
            raise ValueError(f"want every input (R, C), input {i} is {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"input {i} must be contiguous (a plane tensor's (bits x groups, "
                             "rest) view is; the wrapper does not copy)")
    return dtype


def _launches(xs: Sequence[torch.Tensor], which: Sequence[int]):
    """The launches for views ``which`` of ``xs``: per launch, per segment
    (index, C, first block, first output row, chunks per row, chunk), and
    the launch's block count.  Views with no rows take no segment; a view
    with no columns takes one block per row (its sums are 0)."""
    shapes, es = [x.shape for x in xs], xs[0].element_size()
    row0, r = [], 0
    for R, _ in shapes:
        row0.append(r)
        r += R
    out, segs, blocks = [], [], 0
    for i in which:
        R, C = shapes[i]
        if R == 0:
            continue
        chunk = chunk_elems(C, es)
        n_chunks = max(1, -(-C // chunk))
        need = R * n_chunks
        if need > _MAX_BLOCKS:
            raise ValueError(f"input {i} {tuple(shapes[i])} needs {need} blocks, more than "
                             "one launch's grid")
        if len(segs) == MAX_SEGMENTS or blocks + need > _MAX_BLOCKS:
            out.append((segs, blocks))
            segs, blocks = [], 0
        segs.append((i, C, blocks, row0[i], n_chunks, chunk))
        blocks += need
    if segs:
        out.append((segs, blocks))
    return out


def _plan(xs: Sequence[torch.Tensor], which: Sequence[int]):
    """:func:`_launches` for the kernel: per launch, the views, the C,
    block0, row0, n_chunks and chunk arrays, and the block count."""
    plan = []
    for segs, blocks in _launches(xs, which):
        idx, C, *ints = zip(*segs)
        n = len(segs)
        arrays = [(ctypes.c_longlong * n)(*C)] + [(ctypes.c_int * n)(*a) for a in ints]
        plan.append((idx, arrays, blocks))
    return plan


def _pointers(ts, idx):
    return (ctypes.c_void_p * len(idx))(*[ts[i].data_ptr() for i in idx])


def _workspace(dev: torch.device, stream: int, rows: int, blocks: int):
    key = (dev.index, stream)
    counters, partial = _workspaces.get(key, (None, None))
    if counters is None or counters.numel() < rows:
        counters = torch.zeros((rows,), dtype=torch.int32, device=dev)
    if partial is None or partial.numel() < blocks:
        partial = torch.empty((blocks,), dtype=torch.float32, device=dev)
    _workspaces[key] = (counters, partial)
    return counters, partial


def bgl_sumsq_grouped_cuda(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``out[row0_i + r] = sum_c x_i[r, c]^2`` in f32 for contiguous (R_i,
    C_i) CUDA tensors of one dtype (float32 or bfloat16): the rows of
    ``xs[0]``, then those of ``xs[1]``, ... in one flat (sum R_i,) tensor."""
    global launches
    dtype = _check(xs, "bgl_sumsq_grouped_cuda")
    dev = xs[0].device
    rows = sum(x.shape[0] for x in xs)
    out = torch.empty((rows,), dtype=torch.float32, device=dev)
    plan = _plan(xs, range(len(xs)))
    if not plan:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        counters, partial = _workspace(dev, stream, rows, max(b for _, _, b in plan))
        for idx, a, blocks in plan:
            err = lib.bgl_sumsq_grouped_launch(
                _DTYPE_CODE[dtype], len(idx), _pointers(xs, idx), *a, blocks,
                partial.data_ptr(), counters.data_ptr(), out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"bgl_sumsq grouped kernel launch failed: CUDA error {err}")
            launches += 1
    return out


def bgl_sumsq_grouped_backward_cuda(xs: Sequence[torch.Tensor], g: torch.Tensor,
                                    needs: Optional[Sequence[bool]] = None
                                    ) -> List[Optional[torch.Tensor]]:
    """``grad_i = x_i * (2 g[row0_i + r])`` for each view that ``needs``
    it (None elsewhere): in f32, and for bf16 the f32 product rounded to
    bf16 once, the plain version's bits.  ``g`` is the f32 (sum R_i,)
    gradient of :func:`bgl_sumsq_grouped_cuda`'s output, any 1-D stride."""
    global backward_launches
    dtype = _check(xs, "bgl_sumsq_grouped_backward_cuda")
    dev = xs[0].device
    rows = sum(x.shape[0] for x in xs)
    if g.device != dev or g.dtype != torch.float32 or g.shape != (rows,):
        raise ValueError(f"want g float32 ({rows},) on {dev}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    which = [i for i in range(len(xs)) if needs is None or needs[i]]
    grads: List[Optional[torch.Tensor]] = [None] * len(xs)
    for i in which:
        grads[i] = torch.empty_like(xs[i], memory_format=torch.contiguous_format)
    plan = _plan(xs, which)
    if not plan:
        return grads
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for idx, a, blocks in plan:
            err = lib.bgl_sumsq_grad_launch(
                _DTYPE_CODE[dtype], len(idx), _pointers(xs, idx), _pointers(grads, idx), *a,
                blocks, g.data_ptr(), g.stride(0), stream)
            if err:
                raise RuntimeError(f"bgl_sumsq backward kernel launch failed: CUDA error {err}")
            backward_launches += 1
    return grads


def bgl_sumsq_cuda(x: torch.Tensor) -> torch.Tensor:
    """``out[r] = sum_c x[r, c]^2`` in f32 for one contiguous (R, C) float32
    or bfloat16 CUDA tensor: the one-view group."""
    return bgl_sumsq_grouped_cuda([x])
