"""granite-20b [dense] — llama-arch, MQA, code model. [arXiv:2405.04324; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b", family="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152, mlp_type="swiglu", layer_pattern=("attn",),
)
