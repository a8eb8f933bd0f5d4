"""Decoder-only LM assembled from a per-layer kind pattern: PyTorch port
of ``repro.models.transformer``.

The param tree keeps the JAX layout: ``embed``, ``blocks/p{i}/...``
stacked on a leading superblock axis, an optional ``tail`` list for
depths the pattern does not divide, ``final_norm`` and (untied)
``lm_head``.  Layers run one after another in a Python loop where the
JAX package scans.  Decode caches are updated in place.  The layer kinds
are "attn" (a full-length, or paged, KV cache), "local" (sliding-window
attention over a ring buffer of ``min(window, max_len)`` slots per
lane), "ssm" (the Mamba-2 SSD block of ``models.ssm``) and "rglru" (the
RG-LRU block of ``models.rglru``); a recurrent layer's cache is a
carried ``state`` (f32) and the ``conv`` tail of its causal conv (in the
cache dtype), fixed-size per lane, so it bypasses paging.

Serving prefill (:func:`prefill`) runs attention through the flash
kernel (``kernels.ops.flash_attention``); :func:`forward` and
:func:`loss_fn` (training) keep the plain path.  While autograd records,
:func:`forward` rematerialises each superblock under ``cfg.remat`` and
``cfg.remat_policy``, as JAX's ``jax.checkpoint`` does: the values are
the same, the backward recomputes what the policy does not save.

Where ``cfg.n_experts > 0`` every layer's FFN is the Mixture-of-Experts
of ``models.moe`` (``p["moe"]``), on every path: :func:`forward` sums
its router loss over the layers, the serving paths discard it as JAX's
do.

Any kind may carry "+cross" ("attn+cross"): the layer then holds
``norm_cross`` and ``cross`` (an attention block's four projections),
and a cross-attention sublayer over ``cross_embeds`` (B, T, D), the
vision frontend's precomputed patch embeddings, runs after the mixer's
residual and before the FFN, in every path, when ``cross_embeds`` is
given (the serving engines give none, as JAX's do, and skip it).  The
audio frontend's inputs are ``embeds`` (B, S, D) in place of tokens,
cast to the compute dtype with no sqrt(d_model) scale
(``models.frontends`` has their shapes).
"""
from __future__ import annotations

import collections
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from ..configs.base import ModelConfig
from ..core.packing import (
    FloatBlock,
    PackedWeight,
    pack_model_params,
    serving_cast,
    stack_packed,
    tree_map_with_path,
)
from ..device import resolve_device
from . import attention as attn_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .common import (
    cross_entropy,
    current_checkpoint_name,
    dense_apply,
    dense_init,
    embed_apply,
    embed_apply_sharded,
    embed_init,
    logits_apply,
    mlp_apply,
    mlp_init,
    packed_mesh,
    packed_placement,
    packed_shard_mesh,
    rmsnorm,
    rmsnorm_init,
)

Params = Dict[str, Any]


def _base_kind(kind: str) -> str:
    """The mixer of a layer kind: "attn+cross" -> "attn"."""
    return kind.split("+")[0]


def _has_cross(kind: str) -> bool:
    return "+cross" in kind


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str, device) -> Params:
    base = _base_kind(kind)
    p: Params = {"norm1": rmsnorm_init(cfg.d_model, device)}
    if base in ("attn", "local"):
        p["mixer"] = attn_mod.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, device)
    elif base == "ssm":
        p["mixer"] = ssm_mod.ssm_init(gen, cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                                      cfg.ssm_state, cfg.ssm_conv, device)
    elif base == "rglru":
        p["mixer"] = rglru_mod.rglru_init(gen, cfg.d_model, cfg.d_model, device)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if _has_cross(kind):
        p["norm_cross"] = rmsnorm_init(cfg.d_model, device)
        p["cross"] = attn_mod.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                        cfg.resolved_head_dim, device)
    if cfg.d_ff > 0:
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        if cfg.n_experts > 0:
            p["moe"] = moe_mod.moe_init(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                                        cfg.n_shared_experts, cfg.mlp_type, device)
        else:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, device)
    return p


def _stack(trees, n: int):
    """Stack ``n`` same-shaped trees (an iterable, drawn one at a time) on
    a new leading axis.  Tensor leaves fill a stacked tensor allocated
    from the first tree, so no list of them is held; PackedWeight leaves
    (small) are stacked at the end."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        if isinstance(t, PackedWeight):
            return []
        return torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)

    def fill(out, t, i):
        if isinstance(t, dict):
            for k, v in t.items():
                fill(out[k], v, i)
        elif isinstance(out, list):
            out.append(t)
        else:
            out[i].copy_(t)

    def finish(out):
        if isinstance(out, dict):
            return {k: finish(v) for k, v in out.items()}
        return stack_packed(out, (n,)) if isinstance(out, list) else out

    out = None
    for i, tree in enumerate(trees):
        out = alloc(tree) if out is None else out
        fill(out, tree, i)
    return finish(out)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                pack_bits: Optional[int] = None) -> Params:
    """Random params with the JAX package's distributions (normal /
    sqrt(d_in) matrices, 0.02-normal embeddings, unit norm scales), drawn
    on ``device`` (the card unless ``device="cpu"``) from ``generator``.

    With ``pack_bits`` every layer is packed right after it is drawn
    (``pack_model_params`` on that layer's tree, under its own key path)
    and stacked into preallocated tensors, so a full-width model never
    holds its whole float tree.  The packed bytes equal
    ``pack_model_params(init_params(...), bits)`` on the same draws.  The
    float matrices that stay unpacked (the MoE experts, which are never
    packed, the recurrent mixers' matrices, which are not packable, and
    any projection too small to pack) are cast to ``cfg.compute_dtype``
    as soon as they are drawn, by ``core.packing.serving_cast``, the rule
    ``serving_params`` applies; the router, the norm scales and the
    recurrent mixers' vectors and conv weights stay f32."""
    device = resolve_device(device)

    def layer(path, kind):
        p = _init_layer(generator, cfg, kind, device)
        if not pack_bits:
            return p

        # the layer's key path, so that packable() sees "/moe/" as it does
        # on the whole tree
        packed = pack_model_params({path: p}, pack_bits)[path]
        return tree_map_with_path(lambda name, leaf: serving_cast(name, leaf, cfg.compute_dtype),
                                  packed, path)

    params: Params = {"embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, device)}
    params["blocks"] = _stack(
        ({f"p{i}": layer(f"blocks/p{i}", kind) for i, kind in enumerate(cfg.layer_pattern)}
         for _ in range(cfg.n_superblocks)), cfg.n_superblocks)
    if cfg.n_tail_layers:
        params["tail"] = [layer(f"tail/{i}", cfg.layer_pattern[i])
                          for i in range(cfg.n_tail_layers)]
    params["final_norm"] = rmsnorm_init(cfg.d_model, device)
    if not cfg.tie_embeddings:
        head = dense_init(generator, cfg.d_model, cfg.padded_vocab, device, scale=0.02)
        params["lm_head"] = pack_model_params({"lm_head": head}, pack_bits)["lm_head"] \
            if pack_bits else head
    return params


def layer_slice(tree, b: int):
    """Layer ``b`` of a stacked tree (PackedWeight and FloatBlock fields
    sliced alike; each slice of a contiguous stacked tensor is
    contiguous)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, b) for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        return PackedWeight(planes=tree.planes[b], sign=tree.sign[b], scale=tree.scale[b],
                            n_bits=tree.n_bits, k=tree.k, denom_bits=tree.denom_bits,
                            kn_spec=tree.kn_spec)
    if isinstance(tree, FloatBlock):
        return FloatBlock(tree.w[b], tree.kn_spec)
    return tree[b]


def _layers(params: Params, cfg: ModelConfig):
    """(layer params, cache key path, kind) for every layer, in order."""
    for b in range(cfg.n_superblocks):
        blk = layer_slice(params["blocks"], b)
        for i, kind in enumerate(cfg.layer_pattern):
            yield blk[f"p{i}"], ("blocks", b, f"p{i}"), kind
    for i in range(cfg.n_tail_layers):
        yield params["tail"][i], ("tail", i), cfg.layer_pattern[i]


def _window(cfg: ModelConfig, kind: str) -> Optional[int]:
    """The attention window of a layer kind: "local" layers slide."""
    return cfg.window if _base_kind(kind) == "local" else None


def _embed_spec(cfg: ModelConfig, mesh):
    from ..dist.sharding import param_spec

    return param_spec("embed", (cfg.padded_vocab, cfg.d_model), mesh)


def _head(params: Params, cfg: ModelConfig):
    """The output projection: the tied embedding's transpose or
    ``lm_head``.  On a mesh the tied table's block (vocab over "model",
    d_model over "data") is a FloatBlock contracting over "data"."""
    if not cfg.tie_embeddings:
        return params["lm_head"]
    mesh = packed_mesh()
    if mesh is not None:
        spec = tuple(_embed_spec(cfg, mesh)) + (None, None)
        if spec[0] is not None or spec[1] is not None:
            return FloatBlock(params["embed"].T, (spec[1], spec[0]))
    return params["embed"].T


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Embedding times sqrt(d_model), the constant rounded to the compute
    dtype first as ``jnp.asarray(d_model**0.5, dt)`` is.  The constant is
    a 0-dim host tensor, which a device op reads as a scalar: a device
    tensor made from it would be a host-to-device copy, and a host sync,
    at every model call.  On a mesh the lookup runs on this rank's block
    of the table (``common.embed_apply_sharded``)."""
    mesh = packed_mesh()
    if mesh is None:
        x = embed_apply(params["embed"], tokens, cfg.compute_dtype)
    else:
        x = embed_apply_sharded(params["embed"], tokens, cfg.compute_dtype,
                                _embed_spec(cfg, mesh), mesh)
    return x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)


def check_mesh_kinds(cfg: ModelConfig) -> None:
    """Refuse, on a mesh, a model with layers other than "attn" (or with
    experts): the other kinds' mesh paths come with the next mesh slice."""
    bad = sorted({k for k in cfg.layer_pattern if k != "attn"})
    if bad or cfg.n_experts:
        what = bad + (["moe experts"] if cfg.n_experts else [])
        raise NotImplementedError(
            f"{cfg.name} on a mesh: {what} (local rings, MoE experts on 'model', recurrent "
            "state, '+cross') come with the next mesh slice; this one serves 'attn' layers")


def _inputs(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """``(x, cross_src)`` of a full-sequence batch: ``embeds`` (the audio
    frontend's, cast to the compute dtype, no scale) or embedded
    ``tokens``; ``cross_embeds`` in the compute dtype, or None."""
    if batch.get("embeds") is not None:
        x = batch["embeds"].to(cfg.compute_dtype)
    else:
        x = _embed(params, batch["tokens"], cfg)
    return x, _cross_src(batch.get("cross_embeds"), cfg)


def _cross_src(cross_embeds: Optional[torch.Tensor], cfg: ModelConfig):
    return None if cross_embeds is None else cross_embeds.to(cfg.compute_dtype)


def _cross_residual(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str, cross_src,
                    active_planes):
    """``x + cross_attention(norm_cross(x), cross_src)`` on a "+cross" layer
    given ``cross_src``; ``x`` unchanged otherwise."""
    if not _has_cross(kind) or cross_src is None:
        return x
    hc = rmsnorm(p["norm_cross"], x, cfg.norm_eps)
    return x + attn_mod.cross_attention(
        p["cross"], hc, cross_src, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, active_planes=active_planes)


def _mlp_residual(p: Params, x: torch.Tensor, cfg: ModelConfig, active_planes):
    """The FFN sublayer: ``(x + ffn(norm2(x)), aux)``.  ``aux`` is the MoE
    router loss where the config has experts (the serving paths discard
    it, as JAX's do), else None.  The experts' weights are float and their activations are not
    quantised (``moe_apply`` takes neither planes nor ``act_bits``)."""
    if cfg.d_ff <= 0:
        return x, None
    h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if cfg.n_experts > 0:
        y, aux = moe_mod.moe_apply(
            p["moe"], h2, top_k=cfg.top_k, n_experts=cfg.n_experts,
            capacity_factor=cfg.capacity_factor, mlp_kind=cfg.mlp_type,
            n_shared=cfg.n_shared_experts)
        return x + y, aux
    return x + mlp_apply(p["mlp"], h2, cfg.mlp_type, cfg.act_bits, active_planes), None


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _ssm_kw(cfg: ModelConfig):
    return dict(expand=cfg.ssm_expand, head_dim=cfg.ssm_head_dim, state=cfg.ssm_state)


def _apply_layer_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, kind: str,
                     cross_src=None, active_planes=None, flash: bool = False,
                     shard_spec=None):
    """Returns (x, cache seed, aux) for one layer.  The seed is what
    :func:`_seed_layer_cache` writes: ``{"k", "v"}`` of an attention
    layer, ``{"state", "conv_tail_src"}`` (the last W-1 normed inputs) of
    an "ssm" layer, ``{"state", "conv_tail"}`` of an "rglru" one.
    ``flash`` routes self-attention through the flash kernel (serving
    prefill), on a mesh over the lanes and heads of ``shard_spec`` (the
    cache blocks it seeds); ``aux`` as :func:`_mlp_residual` gives it."""
    base = _base_kind(kind)
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if base == "ssm":
        out, hT = ssm_mod.ssm_apply(p["mixer"], h, chunk=cfg.ssm_chunk, **_ssm_kw(cfg))
        # the conv tail is recomputed from these at the prefill->decode handoff
        seed = {"state": hT, "conv_tail_src": h[:, -(cfg.ssm_conv - 1):]}
    elif base == "rglru":
        out, (hT, conv_tail) = rglru_mod.rglru_apply(p["mixer"], h)
        seed = {"state": hT, "conv_tail": conv_tail}
    else:
        out, (k, v) = attn_mod.attention(
            p["mixer"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
            window=_window(cfg, kind), active_planes=active_planes, flash=flash,
            scores_dtype=cfg.attn_scores_dtype, shard_spec=shard_spec,
        )
        seed = {"k": k, "v": v}
    x = _cross_residual(p, x + out, cfg, kind, cross_src, active_planes)
    x, aux = _mlp_residual(p, x, cfg, active_planes)
    return x, seed, aux


def _add_aux(aux: torch.Tensor, aux_i) -> torch.Tensor:
    return aux if aux_i is None else aux + aux_i


def _superblock_fwd(x: torch.Tensor, aux: torch.Tensor, blk: Params, cfg: ModelConfig,
                    cross_src, active_planes, placement=(None, False)):
    """One pass of the layer pattern (JAX's ``_superblock_fwd``), the
    running router loss carried through, so remat leaves its sum's order.
    ``placement``: the forward's ``packed_placement()``, set again when
    remat recomputes the pass in the backward, outside the forward's
    context."""
    if placement[0] is not None and packed_placement() != placement:
        with packed_shard_mesh(*placement):
            return _superblock_fwd(x, aux, blk, cfg, cross_src, active_planes, placement)
    for i, kind in enumerate(cfg.layer_pattern):
        x, _, aux_i = _apply_layer_fwd(blk[f"p{i}"], x, cfg, kind, cross_src, active_planes)
        aux = _add_aux(aux, aux_i)
    return x, aux


# The products a "dots" policy saves: 2-D products (the projections), as
# JAX's ``dots_with_no_batch_dims_saveable``; batched ones (``bmm``, the
# attention scores, the experts) are recomputed.
_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_products(named: Optional[str] = None):
    """A selective-checkpoint policy that saves the 2-D products (those
    computed under ``checkpoint_name(named)`` only, when given)."""
    def policy(ctx, op, *args, **kwargs):
        if op in _PRODUCTS and (named is None or current_checkpoint_name() == named):
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


class _Offload(TorchDispatchMode):
    """The forward half of "dots_offload": each 2-D product's output is
    copied to pinned host memory as it is computed (kept as it is on the
    CPU), in call order."""

    def __init__(self, saved: collections.deque):
        super().__init__()
        self.saved = saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _PRODUCTS:
            if out.is_cuda:
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                self.saved.append(host.copy_(out, non_blocking=True))
            else:
                self.saved.append(out.detach())
        return out


class _Reload(TorchDispatchMode):
    """The recompute half of "dots_offload": each 2-D product is taken
    back from the host, in call order, in place of computing it."""

    def __init__(self, saved: collections.deque):
        super().__init__()
        self.saved = saved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _PRODUCTS:
            return self.saved.popleft().to(args[0].device, non_blocking=True).detach()
        return func(*args, **(kwargs or {}))


def _offload_contexts():
    saved = collections.deque()
    return _Offload(saved), _Reload(saved)


def _remat_context_fn(policy: str):
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a remat policy
    (JAX's ``jax.checkpoint`` policies); "nothing" saves only the
    superblock's inputs."""
    if policy == "nothing":
        return noop_context_fn
    if policy in ("dots", "mlp_names"):
        save = _save_products("mlp_wide" if policy == "mlp_names" else None)
        return lambda: create_selective_checkpoint_contexts(save)
    if policy == "dots_offload":
        return _offload_contexts
    raise ValueError(f"unknown remat_policy {policy!r}")


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            active_planes=None):
    """Full-sequence forward (training: the plain attention, which has a
    backward).  ``batch`` holds ``tokens`` (B, S) or ``embeds`` (B, S, D),
    and ``cross_embeds`` (B, T, D) for the "+cross" layers.  Returns
    (logits (B, S, V) f32, aux_loss): the MoE router loss summed over the
    layers in order, zero without experts.

    With ``cfg.remat`` and a ``cfg.remat_policy`` other than "none", and
    autograd recording, each superblock runs under a non-reentrant
    ``torch.utils.checkpoint``: "nothing" keeps only its inputs, "dots"
    its 2-D products too, "mlp_names" only the MLPs' gate and up products
    (named "mlp_wide"), "dots_offload" the "dots" set in pinned host
    memory; the tail layers are not wrapped, as in JAX."""
    x, cross_src = _inputs(params, batch, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and cfg.remat_policy != "none" and torch.is_grad_enabled()
    context_fn = _remat_context_fn(cfg.remat_policy) if remat else None
    for b in range(cfg.n_superblocks):
        blk = layer_slice(params["blocks"], b)
        if remat:
            x, aux = checkpoint(_superblock_fwd, x, aux, blk, cfg, cross_src, active_planes,
                                packed_placement(), use_reentrant=False,
                                context_fn=context_fn)
        else:
            x, aux = _superblock_fwd(x, aux, blk, cfg, cross_src, active_planes)
    for i in range(cfg.n_tail_layers):
        x, _, aux_i = _apply_layer_fwd(params["tail"][i], x, cfg, cfg.layer_pattern[i],
                                       cross_src, active_planes)
        aux = _add_aux(aux, aux_i)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_apply(_head(params, cfg), x, cfg.logit_softcap, active_planes)
    return logits, aux


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    logits, aux = forward(params, batch, cfg)
    ce = cross_entropy(logits, batch["labels"], cfg.padded_vocab)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# KV / recurrent caches + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None,
               paged_blocks: Optional[int] = None, block_size: Optional[int] = None,
               drop_row: bool = False, mesh=None):
    """Zero decode cache for ``batch`` lanes: per layer kind,
    ``blocks/p{i}/...`` with a leading superblock axis, plus the tail
    list.  Attention layers hold ``k``/``v`` of shape (batch, rows, n_kv,
    head_dim): "attn" layers ``max_len`` rows (``drop_row``: one more, the
    spare row of ``models.attention``), "local" layers a ring of ``Wc =
    min(window, max_len)`` slots, as JAX's ``_init_layer_cache`` does.
    "ssm" layers hold ``state`` (batch, heads, head_dim, state) f32 and
    ``conv`` (batch, ssm_conv - 1, conv_dim); "rglru" layers ``state``
    (batch, d_model) f32 and ``conv`` (batch, 3, d_model); ``conv`` in
    ``dtype``.

    With ``paged_blocks``/``block_size`` each "attn" K/V leaf is instead a
    pool of ``paged_blocks + 1`` blocks of ``block_size`` rows shared by
    every lane: (n_superblocks, paged_blocks + 1, block_size, n_kv,
    head_dim).  The last block is the drop sentinel of
    ``models.attention`` (JAX's pool has ``paged_blocks`` blocks; the
    first ``paged_blocks`` match it).  Rings stay per lane: they are
    bounded already.  A "+cross" layer's cache is its mixer's: the cross
    sublayer keeps none.

    With ``mesh`` each K/V leaf is this rank's block under the cache rules
    (``dist.sharding.cache_spec``, or ``paged_block_spec`` for the pool,
    whose local slice then carries its own sentinel block), and the one
    layer's spec rides on the tensor as ``mesh_spec``."""
    device = resolve_device(device)
    if mesh is not None:
        check_mesh_kinds(cfg)
    from ..dist import sharding as dist_sharding
    dtype = cfg.cache_dtype if dtype is None else dtype
    heads = (cfg.n_kv_heads, cfg.resolved_head_dim)

    def layer(kind, lead=()):
        kind = _base_kind(kind)
        if kind == "ssm":
            _, H, conv_dim = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_expand, cfg.ssm_head_dim,
                                              cfg.ssm_state)
            return {"state": torch.zeros(lead + (batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                                         dtype=torch.float32, device=device),
                    "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                                        dtype=dtype, device=device)}
        if kind == "rglru":
            return {"state": torch.zeros(lead + (batch, cfg.d_model), dtype=torch.float32,
                                         device=device),
                    "conv": torch.zeros(lead + (batch, 3, cfg.d_model), dtype=dtype,
                                        device=device)}
        if kind == "local":
            shape = (batch, min(cfg.window, max_len)) + heads
        elif paged_blocks is not None:
            shape = (paged_blocks + 1, block_size) + heads
        else:
            shape = (batch, max_len + int(drop_row)) + heads
        spec = None
        if mesh is not None:
            if paged_blocks is not None:
                spec = dist_sharding.paged_block_spec((paged_blocks,) + shape[1:], mesh)
                local = dist_sharding.local_shape((paged_blocks,) + shape[1:], spec, mesh)
                shape = (local[0] + 1,) + local[1:]  # the local sentinel block
            else:
                spec = dist_sharding.cache_spec("k", shape, mesh)
                shape = dist_sharding.local_shape(shape, spec, mesh)
        out = {"k": torch.zeros(lead + shape, dtype=dtype, device=device),
               "v": torch.zeros(lead + shape, dtype=dtype, device=device)}
        for t in out.values():
            t.mesh_spec = spec
        return out

    cache = {"blocks": {f"p{i}": layer(kind, (cfg.n_superblocks,))
                        for i, kind in enumerate(cfg.layer_pattern)}}
    if cfg.n_tail_layers:
        cache["tail"] = [layer(cfg.layer_pattern[i]) for i in range(cfg.n_tail_layers)]
    return cache


def _layer_cache(cache, key):
    """One layer's cache leaves, as views that in-place writes reach."""
    if key[0] == "blocks":
        return {name: t[key[1]] for name, t in cache["blocks"][key[2]].items()}
    return cache["tail"][key[1]]


def cache_leaf_spec(cache, key):
    """The spec of one layer's K/V blocks on a mesh (``init_cache``'s
    ``mesh_spec``), or None."""
    leaves = cache["blocks"][key[2]] if key[0] == "blocks" else cache["tail"][key[1]]
    return getattr(leaves.get("k"), "mesh_spec", None)


def _store_recurrent(c, state: torch.Tensor, conv: torch.Tensor, active=None) -> None:
    """Write a recurrent layer's new ``state`` and ``conv`` into its cache
    ``c`` IN PLACE.  ``active`` ((B,) bool) keeps the old values of the
    lanes that are not decoding, bitwise: idle lanes would integrate
    garbage without bound, and a lane mid-way through a chunked prefill
    would lose its carried state."""
    if active is not None:
        state = torch.where(active.reshape((-1,) + (1,) * (state.ndim - 1)), state, c["state"])
        conv = torch.where(active[:, None, None], conv.to(c["conv"].dtype), c["conv"])
    c["state"].copy_(state)
    c["conv"].copy_(conv)


def decode_step(params: Params, cache, tokens: torch.Tensor, pos, cfg: ModelConfig,
                active: Optional[torch.Tensor] = None, active_planes=None,
                block_table: Optional[torch.Tensor] = None, paged_kernel: bool = False,
                cross_embeds: Optional[torch.Tensor] = None):
    """One decode step for the whole model.  ``tokens`` (B, 1), or the
    audio frontend's embeds (B, 1, D); ``pos`` a scalar shared by every
    lane or a (B,) tensor of per-slot positions.  ``cross_embeds`` (B, T,
    D) feeds the "+cross" sublayers, which project its K and V anew at
    every step (they keep no cache, as in JAX).
    Writes each layer's new K/V row, or its new recurrent state and conv
    tail, into ``cache`` IN PLACE and returns (logits (B, V) f32, cache).

    ``active`` ((B,) bool, per-slot only) freezes the cache rows, or the
    recurrent state and conv tail, of lanes that are not decoding.
    ``block_table`` ((B, blocks_per_lane) int32) selects the paged pool
    layout of :func:`init_cache`; ``paged_kernel=True`` reads it through
    the paged-attention kernel.
    The step's tensor shapes depend only on B and the table's width, and
    nothing here syncs the host.  "local" layers write and read their
    ring buffer (slot ``pos % Wc``) and ignore the table; recurrent layers
    are position-free and ignore ``pos`` and the table."""
    if packed_mesh() is not None:
        check_mesh_kinds(cfg)
    x = tokens.to(cfg.compute_dtype) if tokens.ndim == 3 else _embed(params, tokens, cfg)
    cross_src = _cross_src(cross_embeds, cfg)
    for p, key, kind in _layers(params, cfg):
        base = _base_kind(kind)
        c = _layer_cache(cache, key)
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        if base == "ssm":
            out, state, conv = ssm_mod.ssm_decode(p["mixer"], h, c["state"], c["conv"],
                                                  **_ssm_kw(cfg))
            _store_recurrent(c, state, conv, active)
        elif base == "rglru":
            out, state, conv = rglru_mod.rglru_decode(p["mixer"], h, c["state"], c["conv"])
            _store_recurrent(c, state, conv, active)
        else:
            out = attn_mod.decode_attention(
                p["mixer"], h, c["k"], c["v"], pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                window=_window(cfg, kind), ring=base == "local", active=active,
                active_planes=active_planes, block_table=block_table,
                paged_kernel=paged_kernel, shard_spec=cache_leaf_spec(cache, key),
            )
        x = _cross_residual(p, x + out, cfg, kind, cross_src, active_planes)
        x, _ = _mlp_residual(p, x, cfg, active_planes)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_apply(_head(params, cfg), x, cfg.logit_softcap, active_planes)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Prefill: run forward and seed the decode cache
# ---------------------------------------------------------------------------


def _seed_layer_cache(p: Params, cfg: ModelConfig, kind: str, seed, c, spec=None) -> None:
    """Write a layer's prefill seed (:func:`_apply_layer_fwd`) into its
    fresh (zero) cache ``c``: the prompt's K/V into rows [0, S) of an
    "attn" cache, or its last ``min(Wc, S)`` positions into their slots
    ``pos % Wc`` of a "local" ring; a recurrent layer's final state, and
    its conv tail, left-padded with zeros when the prompt is shorter than
    the tail.  An "ssm" layer's tail is the xBC part of the last W-1
    normed inputs through ``in_proj``, recomputed here as JAX does.  On a
    mesh (``spec``, the K/V blocks' spec) only this rank's block is
    written."""
    kind = _base_kind(kind)
    if kind in ("ssm", "rglru"):
        if kind == "ssm":
            d_inner, _, conv_dim = ssm_mod.ssm_dims(cfg.d_model, cfg.ssm_expand,
                                                    cfg.ssm_head_dim, cfg.ssm_state)
            proj = dense_apply(seed["conv_tail_src"], p["mixer"]["in_proj"])
            tail = proj[..., d_inner:d_inner + conv_dim]
        else:
            tail = seed["conv_tail"]
        c["state"].copy_(seed["state"])
        c["conv"][:, c["conv"].shape[1] - tail.shape[1]:] = tail.to(c["conv"].dtype)
        return
    k, v = seed["k"], seed["v"]
    ck, cv = c["k"], c["v"]
    S = k.shape[1]
    if spec is not None:  # this rank's block: its lanes, heads and sequence rows
        from ..dist.sharding import axis_index, block_range

        mesh = packed_mesh()
        b0, b1 = block_range(mesh, spec[0], k.shape[0])
        h0, h1 = block_range(mesh, spec[2], k.shape[2])
        s0 = axis_index(mesh, spec[1]) * ck.shape[1]
        hi = min(S, s0 + ck.shape[1])
        if hi > s0:
            ck[:, :hi - s0] = k[b0:b1, s0:hi, h0:h1].to(ck.dtype)
            cv[:, :hi - s0] = v[b0:b1, s0:hi, h0:h1].to(cv.dtype)
        return
    if kind == "local":
        wc = ck.shape[1]
        take = min(wc, S)
        slots = torch.arange(S - take, S, device=ck.device) % wc
        ck[:, slots] = k[:, S - take:].to(ck.dtype)
        cv[:, slots] = v[:, S - take:].to(cv.dtype)
        return
    ck[:, :S] = k.to(ck.dtype)
    cv[:, :S] = v.to(cv.dtype)


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, max_len: int,
            cache_dtype=None, active_planes=None):
    """Full-sequence prefill that also fills a fresh decode cache, with
    every self-attention layer through the flash kernel (one launch per
    layer on the card).  ``batch`` as :func:`forward` takes it.  Returns
    (last-token logits (B, V) f32, cache).  An "ssm" layer runs
    ``ssm_apply`` at ``cfg.ssm_chunk``, which (as in JAX) refuses a prompt
    longer than the chunk that is not a multiple of it."""
    mesh = packed_mesh()
    x, cross_src = _inputs(params, batch, cfg)
    B, S = x.shape[:2]
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len={max_len}")
    cache = init_cache(cfg, B, max_len, cache_dtype, device=x.device, mesh=mesh)
    for p, key, kind in _layers(params, cfg):
        spec = cache_leaf_spec(cache, key)
        x, seed, _ = _apply_layer_fwd(p, x, cfg, kind, cross_src, active_planes, flash=True,
                                      shard_spec=spec)
        _seed_layer_cache(p, cfg, kind, seed, _layer_cache(cache, key), spec)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_apply(_head(params, cfg), x[:, -1:], cfg.logit_softcap, active_planes)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Chunked prefill: prompts stream through the pooled decode cache
# ---------------------------------------------------------------------------


def prefill_chunk(params: Params, cache, tokens: torch.Tensor, start: torch.Tensor,
                  n_valid: torch.Tensor, cfg: ModelConfig,
                  block_table: Optional[torch.Tensor] = None, active_planes=None,
                  return_all_logits: bool = False,
                  cross_embeds: Optional[torch.Tensor] = None):
    """One fixed-size prefill chunk over the whole slot pool.

    ``tokens`` (B, C), one chunk per lane; ``start`` (B,) the chunk's
    first position; ``n_valid`` (B,) its real tokens (the rest pad).  The
    chunk's K/V land in the lane's rows [start, start + n_valid) of the
    pooled ``cache``, IN PLACE, and recurrent layers advance their carried
    state and conv tail.  Lanes that are not prefilling ride along with
    ``n_valid = 0`` and ``start = max_len``: their compute is garbage and
    their cache rows, state and conv tail are untouched.  ``block_table``
    routes the writes through the paged pool (the caller grants the
    blocks first).

    Returns (last_logits (B, V) f32, cache): ``last_logits[b]`` is the
    logits at lane b's last real token of the chunk (garbage for lanes
    that did not finish their prompt).  "local" layers stream the chunk
    through their ring buffer and ignore the table.

    ``return_all_logits=True`` returns (logits (B, C, V) f32, cache)
    instead: the logits at EVERY chunk position (positions >= n_valid are
    garbage).  This is the speculative verify: one chunk scores every
    drafted position at once.  ``active_planes`` (an int32 device tensor
    on the card) runs every packed projection at that many planes.
    ``cross_embeds`` (B, T, D) feeds the "+cross" sublayers; the chunk's
    input stays tokens, as in JAX."""
    if packed_mesh() is not None:
        check_mesh_kinds(cfg)
    x = _embed(params, tokens, cfg)
    cross_src = _cross_src(cross_embeds, cfg)
    for p, key, kind in _layers(params, cfg):
        base = _base_kind(kind)
        c = _layer_cache(cache, key)
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        if base == "ssm":
            out, state, conv = ssm_mod.ssm_prefill_chunk(p["mixer"], h, c["state"], c["conv"],
                                                         n_valid, **_ssm_kw(cfg))
            _store_recurrent(c, state, conv)
        elif base == "rglru":
            out, state, conv = rglru_mod.rglru_prefill_chunk(p["mixer"], h, c["state"],
                                                             c["conv"], n_valid)
            _store_recurrent(c, state, conv)
        else:
            out = attn_mod.prefill_chunk_attention(
                p["mixer"], h, c["k"], c["v"], start, n_valid, n_heads=cfg.n_heads,
                n_kv=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                window=_window(cfg, kind), ring=base == "local",
                block_table=None if base == "local" else block_table,
                active_planes=active_planes, scores_dtype=cfg.attn_scores_dtype,
                shard_spec=cache_leaf_spec(cache, key),
            )
        x = _cross_residual(p, x + out, cfg, kind, cross_src, active_planes)
        x, _ = _mlp_residual(p, x, cfg, active_planes)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if return_all_logits:
        return logits_apply(_head(params, cfg), x, cfg.logit_softcap, active_planes), cache
    # logits only at each lane's last real token (the row math of
    # prefill's x[:, -1:], so greedy stays token-identical to the oracle)
    B, C, D = x.shape
    last = torch.clamp(n_valid.to(device=x.device, dtype=torch.int64) - 1, 0, C - 1)
    x_last = x.gather(1, last[:, None, None].expand(B, 1, D))
    logits = logits_apply(_head(params, cfg), x_last, cfg.logit_softcap, active_planes)
    return logits[:, 0], cache
