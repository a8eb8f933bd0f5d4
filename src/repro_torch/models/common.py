"""Shared model components: norms, RoPE, MLPs, embeddings, initialisers.

PyTorch port of ``repro.models.common``.  Params are nested dicts of
tensors with the JAX key paths; every ``apply`` is a free function.
Weights use the (in, out) layout so a PackedWeight (K, N) maps 1:1.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core.packing import FloatBlock, PackedWeight, RowsBlock
from ..core.ste import relu6_act_quantize
from ..kernels import ops

Params = Dict[str, torch.Tensor]

# The mesh whose ranks hold the weights' blocks (None = unsharded), set
# for the duration of a model call by the serve engine and scheduler via
# packed_shard_mesh() and read by dense_apply, the embedding, the head and
# the attention paths.  A ContextVar, as in the JAX package, so a sharded
# engine and an unsharded one in one process never see each other's mesh.
_packed_mesh_var: contextvars.ContextVar = contextvars.ContextVar(
    "packed_shard_mesh", default=None)


@contextlib.contextmanager
def packed_shard_mesh(mesh, local_heads: bool = False):
    """Run the enclosed model calls on ``mesh``: every matmul weight is this
    rank's block (a PackedWeight with ``kn_spec``, or a FloatBlock), run
    on its local bytes and stitched by collectives
    (``kernels.ops.bitserial_matmul_sharded``); caches are this rank's
    blocks too.  ``mesh=None`` is a no-op (unsharded serving).
    ``local_heads``: the plain attention path keeps q, k, v on this rank's
    heads into ``wo``'s K block (training; ``models.attention``)."""
    token = _packed_mesh_var.set(None if mesh is None else (mesh, local_heads))
    try:
        yield
    finally:
        _packed_mesh_var.reset(token)


def packed_mesh():
    """The mesh set by :func:`packed_shard_mesh` (None off a mesh)."""
    placed = _packed_mesh_var.get()
    return None if placed is None else placed[0]


def packed_placement() -> tuple:
    """``(mesh, local_heads)`` as :func:`packed_shard_mesh` set them, or
    ``(None, False)``: what to set again to rerun a model call."""
    return _packed_mesh_var.get() or (None, False)


# The mesh over which paged decode runs shard-local (None = not): set by
# the scheduler when the block tables co-shard with the pool over the data
# axes (dist.sharding.table_shards > 1), read by models.attention.
_paged_mesh_var: contextvars.ContextVar = contextvars.ContextVar(
    "paged_shard_mesh", default=None)


@contextlib.contextmanager
def paged_shard_mesh(mesh):
    """Run the enclosed paged attention shard-local over ``mesh``: each data
    shard writes and reads only its own slice of the KV block pool (lanes
    and their blocks co-shard, see ``dist.sharding.block_table_spec``), so
    the pool is never gathered.  ``mesh=None`` is a no-op."""
    token = _paged_mesh_var.set(mesh)
    try:
        yield
    finally:
        _paged_mesh_var.reset(token)


def paged_mesh():
    """The mesh set by :func:`paged_shard_mesh` (None off it)."""
    return _paged_mesh_var.get()


def dense_apply(x: torch.Tensor, w, active_planes=None, k_local: bool = False) -> torch.Tensor:
    """x @ w for a plain tensor, or for a PackedWeight dequantised on the
    fly by the bitserial kernel (the plain version on the CPU).

    ``active_planes`` restricts packed weights to their most significant
    planes; it is a per-call argument here where the JAX package reads a
    ContextVar at trace time.  Plain weights ignore it.

    Under :func:`packed_shard_mesh`, ``x`` is whole on every rank and a
    weight with a ``kn_spec`` is this rank's block: a PackedWeight runs
    ``kernels.ops.bitserial_matmul_sharded``, a FloatBlock a local
    ``torch.matmul`` stitched the same way (JAX computes float weights
    outside any kernel); the result is whole on every rank, the same bits
    on each.  ``k_local``: ``x`` is already this rank's K block (a
    :func:`dense_group` output).  Training differentiates through it:
    ``x`` enters a FloatBlock's local product by ``HostMesh.enter`` (its
    gradient summed over the weight's axes) and the stitch's collectives
    carry their conjugates (``launch.mesh``)."""
    mesh = packed_mesh()
    if isinstance(w, PackedWeight):
        if mesh is not None and w.kn_spec is not None and any(a is not None for a in w.kn_spec):
            return ops.bitserial_matmul_sharded(x, w, mesh, active_planes, k_local)
        return ops.bitserial_matmul(x, w, active_planes=active_planes)
    if isinstance(w, FloatBlock):
        if mesh is None:
            raise ValueError("a FloatBlock is one rank's block of a weight: apply it under "
                             "packed_shard_mesh(mesh)")
        if not k_local:
            x = mesh.enter(x, tuple(a for a in w.kn_spec if a is not None))
        return ops.stitch(ops.local_product(x, w, mesh, k_local=k_local), mesh, *w.kn_spec)
    return x @ w.to(x.dtype)


def _kn(w):
    return w.kn_spec if isinstance(w, (PackedWeight, FloatBlock)) else None


def local_heads_ok(mesh, wide, narrow, heads: Optional[int] = None) -> bool:
    """Whether products by ``wide`` (col-parallel, sharing one ``kn_spec``
    (k, n)) can stay N-sharded into ``narrow`` (row-parallel, K over the
    same n): each rank's N block of the first is then the K block of the
    second, so the pair costs one K reduction and one stitch, the
    Megatron layout (``dense_group`` then ``dense_apply(k_local=True)``).
    ``heads``: the attention heads the N axis holds, which must split
    whole over the n axis (a single K/V head split over "model" would cut
    its head_dim; then K and V are stitched whole)."""
    if mesh is None:
        return False
    kn = _kn(wide[0])
    if kn is None or kn[1] is None or any(_kn(w) != kn for w in wide):
        return False
    if _kn(narrow) is None or _kn(narrow)[0] != kn[1]:
        return False
    if heads is not None:
        from ..dist.sharding import axis_size

        if heads % axis_size(mesh, kn[1]):
            return False
    return all(ops.shardable(w, mesh) for w in list(wide) + [narrow]
               if isinstance(w, PackedWeight))


def dense_group(x, ws, active_planes=None, biases=None):
    """``[x @ w for w in ws]`` on a mesh, for weights that share one
    ``kn_spec`` (k, n): each rank's N block of each product, the partial
    products of all of them summed over k in ONE ``all_reduce``.  ``x`` is
    whole on every rank, or a list of such inputs, one per weight (the
    cross-attention's q from the text, k and v from the cross tokens).
    ``biases``: a :class:`~repro_torch.core.packing.RowsBlock` of each
    weight or None, added into its partial product (:func:`_row_share`)."""
    mesh = packed_mesh()
    k_ax, n_ax = _kn(ws[0])
    xs = x if isinstance(x, (list, tuple)) else [x] * len(ws)
    axes = tuple(a for a in (k_ax, n_ax) if a is not None)
    # training: x is whole on every rank, its gradient the sum of theirs
    entered = {id(t): mesh.enter(t, axes) for t in xs}
    parts = [_row_share(ops.local_product(entered[id(t)], w, mesh, active_planes), b, mesh,
                        k_ax, n_ax)
             for t, w, b in zip(xs, ws, biases or [None] * len(ws))]
    if k_ax is None:
        return parts
    flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in parts]), k_ax)
    return [t.reshape(part.shape) for t, part in
            zip(torch.split(flat, [t.numel() for t in parts]), parts)]


def dense_whole(x: torch.Tensor, ws, active_planes=None, biases=None):
    """``[dense_apply(x, w) + b for w, b in zip(ws, biases)]`` (no bias
    where ``biases`` is None), each whole on every rank; on a mesh, where
    the weights are blocks sharing one ``kn_spec`` (k, n), the partial
    products of all of them cost one reduction over k (:func:`dense_group`)
    and one gather over n.  A :class:`~repro_torch.core.packing.RowsBlock`
    bias (this rank's block of a stacked vector, its layer axis split like
    k) is added into the partial product by the one rank of the reduction
    that holds it."""
    mesh = packed_mesh()
    biases = biases or [None] * len(ws)
    kn = _kn(ws[0])
    if mesh is None or kn is None or any(_kn(w) != kn for w in ws) or not all(
            ops.shardable(w, mesh) for w in ws if isinstance(w, PackedWeight)):
        if any(isinstance(b, RowsBlock) for b in biases):
            raise NotImplementedError("a bias whose layer axis the mesh splits needs its "
                                      "weight's K reduction over the same axis")
        return [_biased(dense_apply(x, w, active_planes), b) for w, b in zip(ws, biases)]
    parts = dense_group(x, ws, active_planes, biases)
    if kn[1] is not None:
        sizes = [t.shape[-1] for t in parts]
        # the gather lays the ranks' [w0 | w1 | ...] blocks side by side
        y = mesh.all_gather(torch.cat(parts, dim=-1), kn[1], dim=-1)
        y = y.reshape(*y.shape[:-1], -1, sum(sizes))
        parts = [t.reshape(*t.shape[:-2], -1) for t in torch.split(y, sizes, dim=-1)]
    return [_biased(t, b) for t, b in zip(parts, biases)]


def _biased(y: torch.Tensor, b) -> torch.Tensor:
    """``y + b`` for a whole bias tensor; ``y`` for None or a RowsBlock
    (added into the partial product already)."""
    return y if b is None or isinstance(b, RowsBlock) else y + b.to(y.dtype)


def _row_share(y: torch.Tensor, b, mesh, k_ax, n_ax) -> torch.Tensor:
    """A partial product plus this rank's share of a RowsBlock bias: its
    row of the layer where it holds it, counted once over ``k_ax`` (the
    layer axis's ranks along k hold distinct layers; ranks of a k the
    layer axis is whole on hold copies, and index 0 adds)."""
    if not isinstance(b, RowsBlock):
        return y
    from ..dist.sharding import axis_index

    l_ax, bn_ax = b.spec
    if bn_ax != n_ax or (l_ax is not None and l_ax != k_ax):
        raise NotImplementedError(f"a bias block {b.spec} against a weight block "
                                  f"{(k_ax, n_ax)}: its rows do not line up with the reduction")
    if b.w is None or (l_ax is None and k_ax is not None and axis_index(mesh, k_ax)):
        return y
    return y + b.w.to(y.dtype)


def lanes(lane_ax, B: int):
    """This rank's lanes ``[b0, b1)`` of a batch of ``B`` under the cache
    rule's batch entry ``lane_ax`` (a recurrent state's or a cache
    block's spec[0]): every lane where it is None (off a mesh, or a batch
    the data axes do not divide)."""
    if lane_ax is None:
        return 0, B
    from ..dist.sharding import block_range

    return block_range(packed_mesh(), lane_ax, B)


def gather_lanes(t: torch.Tensor, lane_ax) -> torch.Tensor:
    """The whole batch of a tensor this rank holds its :func:`lanes` of."""
    return t if lane_ax is None else packed_mesh().all_gather(t, lane_ax, dim=0)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, device,
               scale: float | None = None, dtype=torch.float32) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, device=device, dtype=dtype) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int, device,
               dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device, dtype=dtype) * 0.02


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Rotation pairs are INTERLEAVED (2j, 2j+1), not half-split, as in the
    JAX package: caches written by one convention are read by the same."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]  # (..., S, 1, hd/2)
    cos = torch.cos(ang)[..., None, :]
    xr = x.to(torch.float32).reshape(*x.shape[:-1], hd // 2, 2)
    a, b = xr[..., 0], xr[..., 1]
    out = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Checkpoint names (JAX's ``checkpoint_name``): a remat policy reads them
# ---------------------------------------------------------------------------

_CHECKPOINT_NAME: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "checkpoint_name", default=None)


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the products computed inside ``name``, as JAX's
    ``checkpoint_name`` tags a value: the "mlp_names" remat policy of
    ``models.transformer`` saves the products named "mlp_wide".  The
    arithmetic is unchanged."""
    token = _CHECKPOINT_NAME.set(name)
    try:
        yield
    finally:
        _CHECKPOINT_NAME.reset(token)


def current_checkpoint_name() -> Optional[str]:
    return _CHECKPOINT_NAME.get()


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, d_ff: int, kind: str, device) -> Params:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, d_ff, device),
            "w_up": dense_init(gen, d, d_ff, device),
            "w_down": dense_init(gen, d_ff, d, device),
        }
    return {"w_up": dense_init(gen, d, d_ff, device), "w_down": dense_init(gen, d_ff, d, device)}


def mlp_apply(p: Params, x: torch.Tensor, kind: str, act_bits: int = 32,
              active_planes=None) -> torch.Tensor:
    """``act_bits < 32`` quantises the hidden activation (ReLU6, then
    ``act_bits`` uniform levels) before ``w_down``, as JAX does.  The wide
    products (gate and up) are named "mlp_wide" for the remat policy.  On
    a mesh whose blocks allow it (``local_heads_ok``) the hidden
    activation stays this rank's N block: gate and up cost one reduction,
    ``w_down`` one stitch."""
    dt = x.dtype
    gated = kind in ("swiglu", "geglu")
    wide = [p["w_gate"], p["w_up"]] if gated else [p["w_up"]]
    # on a mesh: the hidden activation stays N-sharded into w_down
    local = local_heads_ok(packed_mesh(), wide, p["w_down"])
    with checkpoint_name("mlp_wide"):
        if local:
            outs = dense_group(x, wide, active_planes)
        else:
            outs = [dense_apply(x, w, active_planes) for w in wide]
    if gated:
        g, u = outs
        h = (F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")) * u
    else:
        u, = outs
        h = F.gelu(u, approximate="tanh") if kind == "gelu_mlp" else F.relu(u)
    if act_bits < 32:
        h = relu6_act_quantize(h, act_bits).to(dt)
    return dense_apply(h, p["w_down"], active_planes, k_local=local)


# ---------------------------------------------------------------------------
# Depthwise causal conv of the recurrent mixers (models.ssm, models.rglru)
# ---------------------------------------------------------------------------


def causal_conv_window(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       S: int) -> torch.Tensor:
    """The S outputs of a depthwise causal conv over ``window`` (B, W-1+S,
    C), the W-1 positions before them first: ``w`` (W, C) and ``b`` (C,)
    cast to the window's dtype, the taps summed in order as JAX's
    ``sum(...)`` does."""
    out = sum(window[:, i:i + S, :] * w[i][None, None].to(window.dtype)
              for i in range(w.shape[0]))
    return out + b.to(window.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S of ``x`` (B, S, C), zero-padded."""
    return causal_conv_window(F.pad(x, (0, 0, w.shape[0] - 1, 0)), w, b, x.shape[1])


def conv_tail(window: torch.Tensor, n_valid: torch.Tensor, rows: int) -> torch.Tensor:
    """Each lane's conv tail after a chunk: the ``rows`` entries of
    ``window`` (B, rows + C, C') ending at its last real token, so a lane
    with ``n_valid = 0`` keeps its old tail."""
    B = window.shape[0]
    idx = n_valid[:, None] + torch.arange(rows, device=window.device)[None, :]  # (B, rows)
    return window.gather(1, idx[..., None].expand(B, rows, window.shape[-1]))


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_apply(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return table.to(dtype)[tokens]


def embed_apply_sharded(table: torch.Tensor, tokens: torch.Tensor, dtype, spec,
                        mesh) -> torch.Tensor:
    """:func:`embed_apply` on this rank's block of the table under
    ``spec`` (vocab -> "model", d_model -> "data" where they divide):
    look up the tokens in the local vocabulary range (zero elsewhere), sum
    over the vocabulary's ranks (one rank holds each row, so the sum is
    exact) and gather d_model."""
    from ..dist.sharding import axis_index

    v_ax, d_ax = (tuple(spec) + (None, None))[:2]
    rows = table.shape[0]
    idx = tokens - axis_index(mesh, v_ax) * rows
    mine = (idx >= 0) & (idx < rows)
    x = table.to(dtype)[torch.where(mine, idx, torch.zeros_like(idx))]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=dtype, device=x.device))
    if v_ax is not None:
        x = mesh.all_reduce(x, v_ax)
    if d_ax is not None:
        x = mesh.all_gather(x, d_ax, dim=-1)
    return x


def logits_apply(head, x: torch.Tensor, softcap: float = 0.0,
                 active_planes=None) -> torch.Tensor:
    """f32 logits; on a mesh the same bits on every rank (one
    ``all_reduce`` over the head's K shards), so every rank's host takes
    the same token from them."""
    logits = dense_apply(x, head, active_planes).to(torch.float32)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor):
    """(sum of the token NLLs, number of tokens) over unmasked tokens
    (labels == -1 are masked): the two halves of :func:`cross_entropy`,
    which a mesh sums over its data ranks before dividing."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None].to(torch.int64))[..., 0]
    nll = lse - picked
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask), torch.sum(mask)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean CE over tokens; labels == -1 are masked."""
    total, count = cross_entropy_sums(logits, labels)
    return total / torch.clamp(count, min=1.0)
