"""gemma-2b [dense] — GeGLU, head_dim=256, MQA. [arXiv:2403.08295; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, mlp_type="geglu", layer_pattern=("attn",),
    tie_embeddings=True, logit_softcap=30.0,
)
