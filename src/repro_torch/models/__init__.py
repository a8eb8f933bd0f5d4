from .transformer import (  # noqa: F401
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)
