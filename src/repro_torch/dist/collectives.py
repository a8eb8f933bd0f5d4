"""Compressed collectives: int8 + error-feedback gradient all-reduce.
PyTorch port of ``repro.dist.collectives``.

The compressed data-parallel step quantises each rank's gradient to int8
under a scale shared by the ranks (the maximum over them), sums the
integer codes over the ranks and dequantises once.  The per-rank
quantisation error is carried forward as an error-feedback residual, so
the bias of the compressed estimator averages out over steps
(Karimireddy et al. 2019).

What crosses the wire: the codes are summed as int32, as the JAX
package's ``psum(q.astype(int32))`` sums them (an int8 sum of n ranks
would overflow), so the payload is 4 bytes per element, the size of f32,
plus one f32 maximum per leaf.  The int8 range bounds the error, not the
bytes moved.  :func:`tree_compressed_psum_ef` sends every leaf's maximum
in one ``all_reduce`` and every leaf's codes in a second; integer sums
are exact, so batching changes no bit.

``shard_map_compat`` and ``dp_shard_map`` have no counterpart: in the
port each rank is a process (``launch.mesh.run_on_mesh``), so the
per-shard function is simply what every rank runs, with the mesh's
collectives (:class:`~repro_torch.launch.mesh.HostMesh`) in place of
``pmax``/``psum``.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..tree import flatten_with_path, tree_map, unflatten_like

PyTree = Any

_EPS = 1e-12


def quantize_int8(x: torch.Tensor, scale: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: returns (codes, scale) with
    ``x ~= codes * scale`` and ``|x - deq| <= scale / 2`` elementwise."""
    x = x.to(torch.float32)
    if scale is None:
        scale = torch.clamp(torch.amax(torch.abs(x)), min=_EPS) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_residuals(tree: PyTree, n_shards: Optional[int] = None) -> PyTree:
    """Zero error-feedback residuals matching a gradient tree (f32).

    With ``n_shards`` each leaf gains a leading shard axis of that size:
    on a mesh a rank holds its block of it, ``n_shards=1``."""
    lead = () if n_shards is None else (n_shards,)
    return tree_map(lambda x: torch.zeros(lead + tuple(x.shape), dtype=torch.float32,
                                          device=x.device), tree)


def _parts(c: torch.Tensor, scale: torch.Tensor):
    """(codes, new residual) of one leaf's ``c = g + residual`` under the
    shared ``scale``.  The residual ``c - q * scale`` is rounded once, as
    XLA's fused multiply-subtract rounds it: the product of a 7-bit code
    and an f32 scale and its difference from ``c`` are exact in f64."""
    q, _ = quantize_int8(c, scale)
    res = c.to(torch.float64) - q.to(torch.float64) * scale.to(torch.float64)
    return q, res.to(torch.float32)


def compressed_psum_ef(g: torch.Tensor, residual: torch.Tensor, mesh, axis: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf of the int8+EF all-reduce over ``axis`` of ``mesh``.

    The scale is the maximum over the ranks first, so the integer codes
    sum exactly: the summed codes times the scale equal the sum of the
    dequantised blocks.  Returns (mean gradient, the same on every rank;
    new local residual)."""
    c = g.to(torch.float32) + residual
    scale = mesh.all_reduce(torch.clamp(torch.amax(torch.abs(c)), min=_EPS), axis,
                            "max") / 127.0
    q, new_residual = _parts(c, scale)
    n = float(mesh.shape[axis])
    mean = mesh.all_reduce(q.to(torch.int32), axis).to(torch.float32) * scale / n
    return mean.to(g.dtype), new_residual


def tree_compressed_psum_ef(grads: PyTree, residuals: PyTree, mesh, axis: str
                            ) -> Tuple[PyTree, PyTree]:
    """Leaf-wise :func:`compressed_psum_ef` in two collectives: one
    ``all_reduce`` (max) of every leaf's maximum, one (int32 sum) of every
    leaf's codes.  Returns (grads, residuals)."""
    named = flatten_with_path(grads)
    res = dict(flatten_with_path(residuals))
    cs = [g.to(torch.float32) + res[n] for n, g in named]
    amax = torch.stack([torch.clamp(torch.amax(torch.abs(c)), min=_EPS) for c in cs])
    scales = mesh.all_reduce(amax, axis, "max") / 127.0
    codes, new_res = [], {}
    for (n, _), c, s in zip(named, cs, scales):
        q, new_res[n] = _parts(c, s)
        codes.append(q.reshape(-1).to(torch.int32))
    summed = mesh.all_reduce(torch.cat(codes), axis)
    n_ranks = float(mesh.shape[axis])
    means, off = {}, 0
    for (n, g), s in zip(named, scales):
        k = g.numel()
        means[n] = (summed[off:off + k].to(torch.float32) * s / n_ranks).reshape(g.shape).to(
            g.dtype)
        off += k
    return unflatten_like(grads, means), unflatten_like(grads, new_res)
