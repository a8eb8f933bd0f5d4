"""Architecture registry: ``get_config(arch)`` + reduced smoke variants
(a copy of ``repro.configs``; the config data files are verbatim)."""
from __future__ import annotations

import dataclasses

from .base import ModelConfig, torch_dtype  # noqa: F401
from .gemma3_12b import CONFIG as _gemma3_12b
from .gemma_2b import CONFIG as _gemma_2b
from .granite_20b import CONFIG as _granite_20b
from .granite_3_2b import CONFIG as _granite_3_2b
from .llama32_vision_11b import CONFIG as _llama32_vision
from .mamba2_130m import CONFIG as _mamba2_130m
from .musicgen_large import CONFIG as _musicgen_large
from .phi35_moe import CONFIG as _phi35_moe
from .qwen2_moe import CONFIG as _qwen2_moe
from .recurrentgemma_9b import CONFIG as _recurrentgemma_9b

REGISTRY = {
    c.name: c
    for c in [
        _granite_3_2b,
        _gemma_2b,
        _granite_20b,
        _gemma3_12b,
        _phi35_moe,
        _qwen2_moe,
        _recurrentgemma_9b,
        _mamba2_130m,
        _llama32_vision,
        _musicgen_large,
    ]
}

ARCH_IDS = list(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def reduced_config(arch: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests: few layers, small
    width/experts/vocab — the architecture *shape* (pattern, GQA ratio,
    MoE routing, SSD, RG-LRU, cross-attn) is preserved."""
    c = get_config(arch)
    plen = c.pattern_len
    n_layers = plen * 2 + (1 if c.n_tail_layers else 0)
    kv = max(1, min(c.n_kv_heads, 2))
    heads = max(kv * 2, 2) if c.n_heads else 0
    return dataclasses.replace(
        c,
        name=c.name + "-reduced",
        n_layers=n_layers,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16 if c.head_dim else 0,
        d_ff=0 if c.d_ff == 0 else 128,
        vocab_size=512,
        n_experts=min(c.n_experts, 4) if c.n_experts else 0,
        top_k=min(c.top_k, 2) if c.top_k else 0,
        n_shared_experts=min(c.n_shared_experts, 1),
        ssm_state=16 if c.ssm_state else 0,
        ssm_head_dim=16 if c.ssm_state else 64,
        window=16 if "local" in [k.split("+")[0] for k in c.layer_pattern] else c.window,
        frontend_tokens=8 if c.frontend_tokens else 0,
        remat=False,
        dtype="float32",
        # Match the compute dtype: with f32 compute a bf16 cache would make
        # chunked prefill (which re-reads earlier K/V through the cache)
        # numerically diverge from the batch-1 prefill oracle (which
        # attends full-precision K/V) — real configs are bf16/bf16, where
        # the cache round-trip is the identity anyway.
        kv_cache_dtype="float32",
        vocab_pad_multiple=8,
    )
