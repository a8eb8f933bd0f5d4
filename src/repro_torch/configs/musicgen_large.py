"""musicgen-large [audio] — decoder-only over EnCodec tokens; the EnCodec
frontend is a stub providing precomputed frame embeddings.  kv=32 == MHA.
[arXiv:2306.05284; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, mlp_type="gelu_mlp", layer_pattern=("attn",),
    frontend="audio",
)
