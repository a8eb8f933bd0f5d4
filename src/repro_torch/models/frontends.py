"""Modality-frontend stubs: PyTorch port of ``repro.models.frontends``.

The audio and vision configs specify the transformer backbone only; their
frontend is a stub whose inputs arrive as precomputed embeddings.  An
"audio" config (musicgen-large) takes ``embeds`` (B, S, D) in place of
``tokens``; a "vision" config (llama-3.2-vision-11b) takes tokens plus
``cross_embeds`` (B, ``frontend_tokens``, D), which its "+cross"
sublayers attend to.

:func:`batch_specs` gives the inputs' shapes and dtypes as meta-device
tensors (JAX's gives ``ShapeDtypeStruct``); :func:`synthetic_batch`
draws concrete inputs of those keys and shapes from an explicit
``torch.Generator``.  The values are the port's own: the tests feed both
packages the same numpy inputs.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                global_batch: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins (shape and dtype, no storage) for every model
    input of a full-sequence step (train or prefill)."""
    B = global_batch if global_batch is not None else shape.global_batch
    S = shape.seq_len
    specs = {}
    if cfg.frontend == "audio":
        specs["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
    else:
        specs["tokens"] = _meta((B, S), torch.int32)
    if cfg.frontend == "vision":
        specs["cross_embeds"] = _meta((B, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    if shape.kind == "train":
        specs["labels"] = _meta((B, S), torch.int32)
    return specs


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, generator: torch.Generator,
                    device=None, with_labels: bool = True) -> Dict[str, torch.Tensor]:
    """Concrete inputs of :func:`batch_specs`' keys and shapes, drawn on
    ``device`` (the card unless ``device="cpu"``) from ``generator``:
    standard-normal embeddings in ``cfg.compute_dtype``, tokens and labels
    uniform over the vocabulary (int32)."""
    device = resolve_device(device)
    out = {}
    if cfg.frontend == "audio":
        out["embeds"] = torch.randn((batch, seq, cfg.d_model), generator=generator,
                                    device=device).to(cfg.compute_dtype)
    else:
        out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                                      device=device, dtype=torch.int32)
    if cfg.frontend == "vision":
        out["cross_embeds"] = torch.randn((batch, cfg.frontend_tokens, cfg.d_model),
                                          generator=generator, device=device
                                          ).to(cfg.compute_dtype)
    if with_labels:
        out["labels"] = torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                                      device=device, dtype=torch.int32)
    return out
