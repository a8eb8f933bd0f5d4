"""Decoder-only LM over the dense "attn" layer pattern: PyTorch port of
``repro.models.transformer``.

The param tree keeps the JAX layout: ``embed``, ``blocks/p{i}/...``
stacked on a leading superblock axis, an optional ``tail`` list for
depths the pattern does not divide, ``final_norm`` and (untied)
``lm_head``.  Layers run one after another in a Python loop where the
JAX package scans.  Decode caches are updated in place.

Other layer kinds ("local", "ssm", "rglru", "+cross"), MoE and modality
frontends come with later slices of the port and raise here.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..core.packing import PackedWeight, pack_model_params, stack_packed
from ..device import resolve_device
from . import attention as attn_mod
from .common import (
    cross_entropy,
    dense_init,
    embed_apply,
    embed_init,
    logits_apply,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
)

Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what this slice of the port does not run."""
    later = [k for k in cfg.layer_pattern if k != "attn"]
    if later:
        raise NotImplementedError(
            f"layer kinds {sorted(set(later))} of {cfg.name} come with a later "
            "slice of the port (ring buffers, SSM, RG-LRU, cross-attention); "
            "this slice runs the dense 'attn' pattern")
    if cfg.n_experts:
        raise NotImplementedError(f"MoE ({cfg.name}) comes with a later slice of the port")
    if cfg.frontend:
        raise NotImplementedError(
            f"the {cfg.frontend} frontend ({cfg.name}) comes with a later slice of the port")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_layer(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    hd = cfg.resolved_head_dim
    p: Params = {
        "norm1": rmsnorm_init(cfg.d_model, device),
        "mixer": attn_mod.attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, hd, device),
    }
    if cfg.d_ff > 0:
        p["norm2"] = rmsnorm_init(cfg.d_model, device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_type, device)
    return p


def _stack(trees: list):
    """Stack same-shaped layer trees on a new leading axis."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _stack([t[k] for t in trees]) for k in t0}
    if isinstance(t0, PackedWeight):
        return stack_packed(trees, (len(trees),))
    return torch.stack(trees)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                pack_bits: Optional[int] = None) -> Params:
    """Random params with the JAX package's distributions (normal /
    sqrt(d_in) matrices, 0.02-normal embeddings, unit norm scales), drawn
    on ``device`` (the card unless ``device="cpu"``) from ``generator``.

    With ``pack_bits`` every layer is packed right after it is drawn
    (``pack_model_params`` on that layer's tree) and the packed layers are
    stacked at the end, so a full-width model never holds its whole float
    tree.  The bytes equal ``pack_model_params(init_params(...), bits)``
    on the same draws."""
    check_supported(cfg)
    device = resolve_device(device)

    def layer():
        p = _init_layer(generator, cfg, device)
        return pack_model_params(p, pack_bits) if pack_bits else p

    params: Params = {"embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, device)}
    params["blocks"] = _stack([
        {f"p{i}": layer() for i in range(cfg.pattern_len)}
        for _ in range(cfg.n_superblocks)
    ])
    if cfg.n_tail_layers:
        params["tail"] = [layer() for _ in range(cfg.n_tail_layers)]
    params["final_norm"] = rmsnorm_init(cfg.d_model, device)
    if not cfg.tie_embeddings:
        head = dense_init(generator, cfg.d_model, cfg.padded_vocab, device, scale=0.02)
        params["lm_head"] = pack_model_params({"lm_head": head}, pack_bits)["lm_head"] \
            if pack_bits else head
    return params


def layer_slice(tree, b: int):
    """Layer ``b`` of a stacked tree (PackedWeight fields sliced alike;
    each slice of a contiguous stacked tensor is contiguous)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, b) for k, v in tree.items()}
    if isinstance(tree, PackedWeight):
        return PackedWeight(planes=tree.planes[b], sign=tree.sign[b], scale=tree.scale[b],
                            n_bits=tree.n_bits, k=tree.k, denom_bits=tree.denom_bits)
    return tree[b]


def _layers(params: Params, cfg: ModelConfig):
    """(layer params, cache key path) for every layer, in order."""
    for b in range(cfg.n_superblocks):
        blk = layer_slice(params["blocks"], b)
        for i in range(cfg.pattern_len):
            yield blk[f"p{i}"], ("blocks", b, f"p{i}")
    for i in range(cfg.n_tail_layers):
        yield params["tail"][i], ("tail", i)


def _head(params: Params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _embed(params: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Embedding times sqrt(d_model), the constant rounded to the compute
    dtype first as ``jnp.asarray(d_model**0.5, dt)`` is."""
    x = embed_apply(params["embed"], tokens, cfg.compute_dtype)
    return x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype, device=x.device)


def _mlp_residual(p: Params, x: torch.Tensor, cfg: ModelConfig, active_planes) -> torch.Tensor:
    if cfg.d_ff > 0:
        h2 = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h2, cfg.mlp_type, cfg.act_bits, active_planes)
    return x


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _apply_layer_fwd(p: Params, x: torch.Tensor, cfg: ModelConfig, active_planes=None):
    """Returns (x, (k, v)) for one "attn" layer."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    out, kv = attn_mod.attention(
        p["mixer"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        active_planes=active_planes,
    )
    return _mlp_residual(p, x + out, cfg, active_planes), kv


def forward(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            active_planes=None):
    """Full-sequence forward.  Returns (logits (B, S, V) f32, aux_loss)."""
    check_supported(cfg)
    x = _embed(params, batch["tokens"], cfg)
    for p, _ in _layers(params, cfg):
        x, _ = _apply_layer_fwd(p, x, cfg, active_planes)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_apply(_head(params, cfg), x, cfg.logit_softcap, active_planes)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    logits, aux = forward(params, batch, cfg)
    ce = cross_entropy(logits, batch["labels"], cfg.padded_vocab)
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# KV caches + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, device=None):
    """Zero decode cache for ``batch`` lanes: ``blocks/p{i}/{k,v}`` of shape
    (n_superblocks, batch, max_len, n_kv, head_dim), plus the tail list."""
    check_supported(cfg)
    device = resolve_device(device)
    dtype = cfg.cache_dtype if dtype is None else dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)

    def layer(lead=()):
        return {"k": torch.zeros(lead + shape, dtype=dtype, device=device),
                "v": torch.zeros(lead + shape, dtype=dtype, device=device)}

    cache = {"blocks": {f"p{i}": layer((cfg.n_superblocks,))
                        for i in range(cfg.pattern_len)}}
    if cfg.n_tail_layers:
        cache["tail"] = [layer() for _ in range(cfg.n_tail_layers)]
    return cache


def _layer_cache(cache, key):
    if key[0] == "blocks":
        c = cache["blocks"][key[2]]
        return c["k"][key[1]], c["v"][key[1]]
    c = cache["tail"][key[1]]
    return c["k"], c["v"]


def decode_step(params: Params, cache, tokens: torch.Tensor, pos, cfg: ModelConfig,
                active: Optional[torch.Tensor] = None, active_planes=None):
    """One decode step for the whole model.  ``tokens`` (B, 1); ``pos`` a
    scalar shared by every lane or a (B,) tensor of per-slot positions.
    Writes each layer's new K/V row into ``cache`` IN PLACE and returns
    (logits (B, V) f32, cache)."""
    x = _embed(params, tokens, cfg)
    for p, key in _layers(params, cfg):
        ck, cv = _layer_cache(cache, key)
        h = rmsnorm(p["norm1"], x, cfg.norm_eps)
        out = attn_mod.decode_attention(
            p["mixer"], h, ck, cv, pos, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta, active=active,
            active_planes=active_planes,
        )
        x = _mlp_residual(p, x + out, cfg, active_planes)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_apply(_head(params, cfg), x, cfg.logit_softcap, active_planes)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# Prefill: run forward and seed the decode cache
# ---------------------------------------------------------------------------


def _seed_layer_cache(ck: torch.Tensor, cv: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> None:
    """Write the prompt's K/V into rows [0, S) of an "attn" layer cache."""
    S = k.shape[1]
    ck[:, :S] = k.to(ck.dtype)
    cv[:, :S] = v.to(cv.dtype)


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig, max_len: int,
            cache_dtype=None, active_planes=None):
    """Full-sequence prefill that also fills a fresh decode cache.
    Returns (last-token logits (B, V) f32, cache)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt length {S} exceeds max_len={max_len}")
    cache = init_cache(cfg, B, max_len, cache_dtype, device=tokens.device)
    x = _embed(params, tokens, cfg)
    for p, key in _layers(params, cfg):
        x, (k, v) = _apply_layer_fwd(p, x, cfg, active_planes)
        _seed_layer_cache(*_layer_cache(cache, key), k, v)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = logits_apply(_head(params, cfg), x[:, -1:], cfg.logit_softcap, active_planes)
    return logits[:, 0], cache
