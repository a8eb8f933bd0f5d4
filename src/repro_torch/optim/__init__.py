from .optimizers import (  # noqa: F401
    SGDM,
    AdamW,
    clip_by_global_norm,
    cosine_warmup,
    global_norm,
    project_bitplanes,
    step_decay,
)
