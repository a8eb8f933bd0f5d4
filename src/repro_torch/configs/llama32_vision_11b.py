"""llama-3.2-vision-11b [vlm] — cross-attention image layers every 5th
layer (8 of 40); vision frontend is a stub providing precomputed patch
embeddings. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=128256, mlp_type="swiglu",
    layer_pattern=("attn", "attn", "attn", "attn", "attn+cross"),
    frontend="vision", frontend_tokens=1600, rope_theta=500_000.0,
)
