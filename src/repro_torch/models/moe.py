"""Mixture-of-Experts FFN with sort-based capacity dispatch: PyTorch port
of ``repro.models.moe``.

Tokens are split into G groups and each group dispatches on its own:
top-k gates -> stable sort by expert -> rank within the expert -> an
(E, C, d) buffer, assignments past the capacity C dropped.  The experts
run as one batched product per projection over the (G, E, C, d) buffer
against the stacked (E, d, f) weights; the combine weighs each token's
expert outputs by its router probabilities and sums them in ascending
expert order, in the output dtype.

Shared experts (Qwen-style) run densely as one fused MLP of width
``n_shared * d_ff`` and are added to the routed output.  No activation
here is quantised, as in the JAX package: ``moe_apply`` takes no
``act_bits``.

The semantics are JAX's exactly, including which assignments are
dropped: a prefill or chunk routes each lane as its own group, a decode
step routes all lanes (inactive ones included) as one group, in lane
order.  The combine never uses ``index_add_``: on the card its atomics
would change the order of the adds, and a bf16 sum with it, from run to
run.

On a ("data", "model") mesh (``common.packed_shard_mesh``) x is whole on
every rank and the router is a block whose gates are stitched whole, so
routing and dispatch run identically on every rank.  Each rank holds its
block of the stacked experts under the rules (experts over "model", the
hidden width f over "data"): it fills the dispatch rows of its own
experts only, runs them on its f columns, and weighs their outputs into
its partial y; one ``all_reduce`` over the mesh's weight axes (the whole
mesh but "pod", whose ranks hold copies of the experts) sums the partials
(over f and over the experts) into y.  Training differentiates through
it: x and the routing weights enter the rank's experts by
``HostMesh.enter`` (their gradients summed over the mesh, the sum's
conjugate).  The shared experts are a dense MLP under the Megatron rule.
In training each data rank's batch is its own: the router loss's token
and probability sums are summed over the data axes, "pod" and "data"
(``HostMesh.batch_sum``),
before the product, so every rank's loss is the whole batch's, JAX's.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .common import dense_apply, dense_init, mlp_apply, mlp_init, packed_mesh

Params = Dict[str, torch.Tensor]


def moe_capacity(tokens_per_group: int, top_k: int, n_experts: int, cf: float) -> int:
    """Slots per expert and group: the ceiling of ``T * k * cf / E`` (the
    JAX arithmetic, float floor division included), at least 8, rounded
    up to a multiple of 8."""
    c = int(-(-tokens_per_group * top_k * cf // n_experts))  # ceil
    return max(8, ((c + 7) // 8) * 8)


def moe_init(gen: torch.Generator, d: int, d_ff: int, n_experts: int, n_shared: int,
             mlp_kind: str, device) -> Params:
    """Router (d, E) at scale 0.02, stacked expert weights (E, d, f) and
    (E, f, d) at 1/sqrt(fan-in), and the fused shared MLP when
    ``n_shared``: the JAX package's distributions, drawn from ``gen``."""

    def stack(d_in, d_out):  # the E experts' (d_in, d_out) matrices in one draw
        return torch.randn((n_experts, d_in, d_out), generator=gen, device=device) \
            * (1.0 / math.sqrt(d_in))

    p = {
        "router": dense_init(gen, d, n_experts, device, scale=0.02),
        "w_gate": stack(d, d_ff),
        "w_up": stack(d, d_ff),
        "w_down": stack(d_ff, d),
    }
    if n_shared:
        p["shared"] = mlp_init(gen, d, n_shared * d_ff, mlp_kind, device)
    return p


def _route(gates: torch.Tensor, top_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-k gates of each token and their experts, descending:
    ``(top_w (G, T, k) f32, top_e (G, T, k) int64)``.  Its own function
    so that a caller can record the routing or impose another."""
    return torch.topk(gates, top_k, dim=-1)


def _ranks(top_e: torch.Tensor, n_experts: int):
    """Each assignment's rank among its group's picks of its expert.

    ``top_e`` (G, T, k) is flattened token-major and stably sorted by
    expert, so ranks follow token order.  Returns ``(order, counts, offs,
    rank)``: the sort's permutation (G, T*k), each expert's picks and the
    sorted position of its first (G, E), and the rank of every assignment
    in token-major order (G, T*k).  An assignment of rank >= C is
    dropped."""
    G, T, k = top_e.shape
    flat_e = top_e.reshape(G, T * k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    counts = F.one_hot(flat_e, n_experts).sum(dim=1)  # (G, E)
    offs = torch.cumsum(counts, dim=-1) - counts  # (G, E) exclusive
    rank_sorted = torch.arange(T * k, device=top_e.device) - offs.gather(1, se)
    rank = torch.empty_like(rank_sorted).scatter_(1, order, rank_sorted)
    return order, counts, offs, rank


def _dispatch(xg: torch.Tensor, top_e: torch.Tensor, n_experts: int, capacity: int,
              experts=None):
    """Scatter every group's tokens into its (E*C, d) expert buffer.

    ``xg`` (G, T, d); ``top_e`` (G, T, k).  The assignment at rank r of
    expert e (:func:`_ranks`) fills row ``e * C + r`` if r < C and is
    dropped otherwise.  Built as a gather (row ``e * C + r`` reads the
    token at sorted position ``offs[e] + r``), so every row is written
    once.  Returns ``(buf (G, E*C, d), slot (G, T*k), keep (G, T*k))``
    with ``slot`` and ``keep`` in the token-major order of the flattened
    assignments; a dropped assignment's slot is ``E * C``.  ``experts``
    ``(e0, e1)``: fill the rows of those experts only, ``buf`` (G,
    (e1-e0)*C, d) (a mesh rank's experts); ``slot`` stays global."""
    G, T, k = top_e.shape
    E, C = n_experts, capacity
    e0, e1 = experts or (0, E)
    order, counts, offs, rank = _ranks(top_e, E)
    keep = rank < C
    slot = torch.where(keep, top_e.reshape(G, T * k) * C + rank, torch.full_like(rank, E * C))
    # row e*C + r <- the token at sorted position offs[e] + r, if r < counts[e]
    r = torch.arange(C, device=xg.device)
    rows = (e1 - e0) * C
    src = (offs[:, e0:e1, None] + r).reshape(G, rows)
    filled = (r < counts[:, e0:e1, None]).reshape(G, rows)
    tok = order.gather(1, src.clamp(max=T * k - 1)) // k  # (G, rows)
    buf = xg.gather(1, tok[:, :, None].expand(G, rows, xg.shape[-1]))
    buf = torch.where(filled[:, :, None], buf, torch.zeros((), dtype=xg.dtype, device=xg.device))
    return buf, slot, keep


def _combine(out_flat: torch.Tensor, top_e: torch.Tensor, probs: torch.Tensor,
             slot: torch.Tensor, keep: torch.Tensor, experts=None,
             capacity: int = 0) -> torch.Tensor:
    """Each token's k expert outputs, weighted by ``probs * keep`` cast to
    the output dtype first, summed in ascending expert order from zeros in
    the output dtype (the order of JAX's sorted scatter-add).  ``out_flat``
    (G, E*C, d); the rest token-major (G, T, k) or (G, T*k).  ``experts``
    ``(e0, e1)`` (and ``capacity``): ``out_flat`` holds those experts' rows
    only, and the assignments to other experts weigh zero."""
    G, T, k = top_e.shape
    d = out_flat.shape[-1]
    keep = keep.reshape(G, T, k)
    if experts is not None:
        slot = slot.reshape(G, T, k) - experts[0] * capacity
        keep = keep & (top_e >= experts[0]) & (top_e < experts[1])
    slot_c = slot.clamp(0, out_flat.shape[1] - 1).reshape(G, T, k)
    w = (probs * keep.to(probs.dtype)).to(out_flat.dtype)
    asc = torch.argsort(top_e, dim=-1)  # the k experts of a token are distinct
    slot_c, w = slot_c.gather(-1, asc), w.gather(-1, asc)
    y = torch.zeros((G, T, d), dtype=out_flat.dtype, device=out_flat.device)
    for j in range(k):
        rows = out_flat.gather(1, slot_c[:, :, j, None].expand(G, T, d))
        y = y + rows * w[:, :, j, None]
    return y


def _experts(p: Params, ein: torch.Tensor, mlp_kind: str) -> torch.Tensor:
    """Every expert's FFN over its slots: (G, E, C, d) -> (G, E, C, d),
    one batched product per projection against the stacked (E, d, f)
    weights, in ``ein``'s dtype (JAX computes these einsums outside any
    Pallas kernel)."""
    dt = ein.dtype
    g = torch.einsum("gecd,edf->gecf", ein, p["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", ein, p["w_up"].to(dt))
    h = (F.silu(g) if mlp_kind == "swiglu" else F.gelu(g, approximate="tanh")) * u
    return torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))


def _expert_block(mesh, n_experts: int, d: int, d_ff: int):
    """On a mesh: this rank's experts ``(e0, e1)`` under the stacked
    experts' rule and whether its partial y counts in the sum over the
    mesh (1.0, or 0.0 on a rank whose block another rank of an axis the
    experts are whole on holds too)."""
    from ..dist.sharding import block_range, counted_once, param_spec

    spec = tuple(param_spec("moe/w_gate", (n_experts, d, d_ff), mesh)) + (None,) * 3
    return block_range(mesh, spec[0], n_experts), counted_once(spec[:3], mesh)


def _router_loss(gates: torch.Tensor, top_e: torch.Tensor, n_experts: int, top_k: int,
                 mesh) -> torch.Tensor:
    """The Switch load-balance loss ``E * sum_e f_e P_e / k``: f the share of
    picks and P the mean router probability of each expert over the
    batch's tokens.  On a training view, whose batch is this data rank's,
    the per-expert sums and the token count are summed over the data axes
    ("pod" and "data" on a pod mesh) first (one ``HostMesh.batch_sum``)."""
    probs_full = torch.softmax(gates, dim=-1)  # (G, T, E)
    onehot = F.one_hot(top_e, n_experts).to(torch.float32)  # (G, T, k, E)
    n = torch.full((1,), gates.shape[0] * gates.shape[1], dtype=torch.float32,
                   device=gates.device)
    sums = torch.cat([torch.sum(onehot, dim=(0, 1, 2)), torch.sum(probs_full, dim=(0, 1)), n])
    if mesh is not None:
        sums = mesh.batch_sum(sums)
    frac_tokens = sums[:n_experts] / sums[-1]  # (E,)
    frac_probs = sums[n_experts:2 * n_experts] / sums[-1]
    return n_experts * torch.sum(frac_tokens * frac_probs) / top_k


def moe_apply(p: Params, x: torch.Tensor, *, top_k: int, n_experts: int,
              capacity_factor: float, mlp_kind: str,
              n_shared: int = 0, d_ff: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (y (B, S, d), the Switch load-balance loss f32).  On a
    mesh ``d_ff`` (the experts' whole hidden width) places the experts'
    blocks (the module docstring)."""
    if packed_mesh() is not None and not d_ff:
        raise ValueError("moe_apply on a mesh needs d_ff, the experts' whole hidden width")
    B, S, d = x.shape
    G, T = (B, S) if S > 1 else (1, B)
    xg = x.reshape(G, T, d)
    gates = dense_apply(xg.to(torch.float32), p["router"])  # (G, T, E) f32
    C = moe_capacity(T, top_k, n_experts, capacity_factor)
    top_w, top_e = _route(gates, top_k)
    probs = torch.softmax(top_w, dim=-1)  # normalise over the chosen k

    mesh = packed_mesh()
    experts, counted = ((0, n_experts), 1.0) if mesh is None else \
        _expert_block(mesh, n_experts, d, d_ff)
    e0, e1 = experts
    xe, pe = xg, probs
    if mesh is not None:  # the rank's experts: their gradients summed over the mesh
        axes = mesh.weight_axes  # a pod holds a copy of the experts: never over "pod"
        xe, pe = mesh.enter(xg, axes), mesh.enter(probs, axes)
    buf, slot, keep = _dispatch(xe, top_e, n_experts, C, experts)
    out = _experts(p, buf.reshape(G, e1 - e0, C, d), mlp_kind)
    y = _combine(out.reshape(G, (e1 - e0) * C, d), top_e, pe, slot, keep, experts, C)
    if mesh is not None:
        if not counted:  # another rank adds this block's partial y
            y = torch.zeros_like(y)
        # the one reduction of the layer: over f's blocks and over the experts
        y = mesh.all_reduce(y, axes)
    y = y.reshape(B, S, d)
    aux = _router_loss(gates, top_e, n_experts, top_k, mesh)

    if n_shared:
        y = y + mlp_apply(p["shared"], x, mlp_kind)
    return y, aux
