"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.
38 layers = 12 x (rglru, rglru, local) + 2 tail rglru. [arXiv:2402.19427; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000, mlp_type="geglu",
    layer_pattern=("rglru", "rglru", "local"), window=2048,
    tie_embeddings=True,
)
