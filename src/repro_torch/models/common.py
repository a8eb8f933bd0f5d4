"""Shared model components: norms, RoPE, MLPs, embeddings, initialisers.

PyTorch port of ``repro.models.common``.  Params are nested dicts of
tensors with the JAX key paths; every ``apply`` is a free function.
Weights use the (in, out) layout so a PackedWeight (K, N) maps 1:1.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core.packing import PackedWeight
from ..core.ste import relu6_act_quantize
from ..kernels import ops

Params = Dict[str, torch.Tensor]


def dense_apply(x: torch.Tensor, w, active_planes=None) -> torch.Tensor:
    """x @ w for a plain tensor, or for a PackedWeight dequantised on the
    fly by the bitserial kernel (the plain version on the CPU).

    ``active_planes`` restricts packed weights to their most significant
    planes; it is a per-call argument here where the JAX package reads a
    ContextVar at trace time.  Plain weights ignore it."""
    if isinstance(w, PackedWeight):
        return ops.bitserial_matmul(x, w, active_planes=active_planes)
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int, device,
               scale: float | None = None, dtype=torch.float32) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return torch.randn((d_in, d_out), generator=gen, device=device, dtype=dtype) * scale


def embed_init(gen: torch.Generator, vocab: int, d: int, device,
               dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, d), generator=gen, device=device, dtype=dtype) * 0.02


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Rotation pairs are INTERLEAVED (2j, 2j+1), not half-split, as in the
    JAX package: caches written by one convention are read by the same."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]  # (..., S, 1, hd/2)
    cos = torch.cos(ang)[..., None, :]
    xr = x.to(torch.float32).reshape(*x.shape[:-1], hd // 2, 2)
    a, b = xr[..., 0], xr[..., 1]
    out = torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Checkpoint names (JAX's ``checkpoint_name``): a remat policy reads them
# ---------------------------------------------------------------------------

_CHECKPOINT_NAME: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "checkpoint_name", default=None)


@contextlib.contextmanager
def checkpoint_name(name: str):
    """Name the products computed inside ``name``, as JAX's
    ``checkpoint_name`` tags a value: the "mlp_names" remat policy of
    ``models.transformer`` saves the products named "mlp_wide".  The
    arithmetic is unchanged."""
    token = _CHECKPOINT_NAME.set(name)
    try:
        yield
    finally:
        _CHECKPOINT_NAME.reset(token)


def current_checkpoint_name() -> Optional[str]:
    return _CHECKPOINT_NAME.get()


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d: int, d_ff: int, kind: str, device) -> Params:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, d_ff, device),
            "w_up": dense_init(gen, d, d_ff, device),
            "w_down": dense_init(gen, d_ff, d, device),
        }
    return {"w_up": dense_init(gen, d, d_ff, device), "w_down": dense_init(gen, d_ff, d, device)}


def mlp_apply(p: Params, x: torch.Tensor, kind: str, act_bits: int = 32,
              active_planes=None) -> torch.Tensor:
    """``act_bits < 32`` quantises the hidden activation (ReLU6, then
    ``act_bits`` uniform levels) before ``w_down``, as JAX does.  The wide
    products (gate and up) are named "mlp_wide" for the remat policy."""
    dt = x.dtype
    if kind in ("swiglu", "geglu"):
        with checkpoint_name("mlp_wide"):
            g = dense_apply(x, p["w_gate"], active_planes)
            u = dense_apply(x, p["w_up"], active_planes)
        h = (F.silu(g) if kind == "swiglu" else F.gelu(g, approximate="tanh")) * u
    else:
        with checkpoint_name("mlp_wide"):
            u = dense_apply(x, p["w_up"], active_planes)
        h = F.gelu(u, approximate="tanh") if kind == "gelu_mlp" else F.relu(u)
    if act_bits < 32:
        h = relu6_act_quantize(h, act_bits).to(dt)
    return dense_apply(h, p["w_down"], active_planes)


# ---------------------------------------------------------------------------
# Depthwise causal conv of the recurrent mixers (models.ssm, models.rglru)
# ---------------------------------------------------------------------------


def causal_conv_window(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       S: int) -> torch.Tensor:
    """The S outputs of a depthwise causal conv over ``window`` (B, W-1+S,
    C), the W-1 positions before them first: ``w`` (W, C) and ``b`` (C,)
    cast to the window's dtype, the taps summed in order as JAX's
    ``sum(...)`` does."""
    out = sum(window[:, i:i + S, :] * w[i][None, None].to(window.dtype)
              for i in range(w.shape[0]))
    return out + b.to(window.dtype)


def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along S of ``x`` (B, S, C), zero-padded."""
    return causal_conv_window(F.pad(x, (0, 0, w.shape[0] - 1, 0)), w, b, x.shape[1])


def conv_tail(window: torch.Tensor, n_valid: torch.Tensor, rows: int) -> torch.Tensor:
    """Each lane's conv tail after a chunk: the ``rows`` entries of
    ``window`` (B, rows + C, C') ending at its last real token, so a lane
    with ``n_valid = 0`` keeps its old tail."""
    B = window.shape[0]
    idx = n_valid[:, None] + torch.arange(rows, device=window.device)[None, :]  # (B, rows)
    return window.gather(1, idx[..., None].expand(B, rows, window.shape[-1]))


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_apply(table: torch.Tensor, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return table.to(dtype)[tokens]


def logits_apply(head, x: torch.Tensor, softcap: float = 0.0,
                 active_planes=None) -> torch.Tensor:
    logits = dense_apply(x, head, active_planes).to(torch.float32)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int) -> torch.Tensor:
    """Mean CE over tokens; labels == -1 are masked."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels.clamp(min=0)[..., None].to(torch.int64))[..., 0]
    nll = lse - picked
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
