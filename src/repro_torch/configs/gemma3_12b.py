"""gemma3-12b [dense] — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144, mlp_type="geglu",
    layer_pattern=("local", "local", "local", "local", "local", "attn"),
    window=1024, rope_theta=1_000_000.0, tie_embeddings=True,
)
