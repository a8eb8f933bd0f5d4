"""Model configuration schema shared by every architecture.

A copy of ``repro.configs.base`` in which the dtype strings map to
``torch.dtype`` instead of ``jax.numpy`` dtypes."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` a config dtype string names."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # Layer pattern, cycled over the depth. Kinds:
    #   "attn"  full causal self-attention
    #   "local" sliding-window self-attention
    #   "rglru" RG-LRU recurrent block (Griffin)
    #   "ssm"   Mamba-2 SSD block
    # Each entry may carry "+cross" (e.g. "attn+cross") to append a
    # cross-attention sublayer reading the frontend embeddings.
    layer_pattern: Tuple[str, ...] = ("attn",)
    window: int = 1024
    rope_theta: float = 10000.0
    logit_softcap: float = 0.0

    mlp_type: str = "swiglu"  # swiglu | geglu | mlp (attn-free kinds skip MLP if d_ff==0)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4

    # Modality frontend stub: inputs arrive as precomputed embeddings.
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_tokens: int = 0  # cross-attended tokens (vlm) per sequence

    # Quantisation hooks (BSQ weight quant is external; this is activations)
    act_bits: int = 32

    # Numerics / memory
    dtype: str = "bfloat16"
    remat: bool = True
    # §Perf knobs (hillclimb levers; defaults = paper-faithful baseline)
    remat_policy: str = "nothing"  # nothing | dots | mlp_names | none
    attn_scores_dtype: str = "float32"  # float32 | bfloat16 (softmax chain)
    ssm_chunk: int = 256  # Mamba-2 SSD chunk length
    kv_cache_dtype: str = "bfloat16"  # bfloat16 | float8_e4m3fn (decode HBM lever)
    vocab_pad_multiple: int = 256
    # scan_layers=False unrolls the layer stack (and attention q-chunk
    # loops): bigger HLO, but XLA cost_analysis counts while-loop bodies
    # only ONCE, so the roofline-accounting dry-run compiles unrolled.
    scan_layers: bool = True

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def cache_dtype(self) -> torch.dtype:
        return torch_dtype(self.kv_cache_dtype)

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_superblocks(self) -> int:
        """Full repetitions of the layer pattern (scanned)."""
        return self.n_layers // self.pattern_len

    @property
    def n_tail_layers(self) -> int:
        """Leftover layers that don't fill a pattern (unrolled)."""
        return self.n_layers % self.pattern_len

    @property
    def attention_free(self) -> bool:
        return all(k.split("+")[0] in ("ssm", "rglru") for k in self.layer_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no layer kind does full-sequence quadratic attention at
        *training* time AND decode cost per token is O(window/state), OR
        the full-attention fraction is bounded (gemma3 5:1 local:global —
        decode reads the global KV once per 6 layers)."""
        kinds = [k.split("+")[0] for k in self.layer_pattern]
        return all(k != "attn" for k in kinds) or (
            kinds.count("attn") / len(kinds) <= 0.2
        )

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)
