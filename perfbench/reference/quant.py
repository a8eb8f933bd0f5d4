"""Number formats the reference works out for itself."""
from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def sixbit(w: torch.Tensor, n_bits: int = 6) -> torch.Tensor:
    """The served weight of a packed projection, per slice of the leading
    (layer) axes: one per-tensor scale s = max|w|, codes round(w / s *
    (2^n - 1)) (ties to even), dequantised as codes * s / (2^n - 1), f32."""
    w = w.to(torch.float32)
    levels = 2**n_bits - 1
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    s = torch.amax(torch.abs(flat), dim=(1, 2), keepdim=True)
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.round(flat / s * levels)
    return (q * (s / levels)).reshape(w.shape)


FP8_FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to a float8 format (e4m3 by default) under one
    per-tensor scale that maps max|x| to the format's largest value, back
    in f32."""
    x = x.to(torch.float32)
    amax = torch.amax(torch.abs(x))
    s = torch.where(amax > 0, FP8_FORMATS[fmt] / amax, torch.ones_like(amax))
    return (x * s).to(fmt).to(torch.float32) / s


class _Fp8Matmul(torch.autograd.Function):
    """a @ b as float8 training runs it: the operands in e4m3, the
    gradient flowing back in e5m2, every product summed in f32."""

    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = fp8(a), fp8(b)
        ctx.save_for_backward(a8, b8)
        return a8 @ b8

    @staticmethod
    def backward(ctx, g):
        a8, b8 = ctx.saved_tensors
        g8 = fp8(g, torch.float8_e5m2)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g8 @ b8.transpose(-1, -2)).sum_to_size(a8.shape)
        if ctx.needs_input_grad[1]:
            gb = (a8.transpose(-1, -2) @ g8).sum_to_size(b8.shape)
        return ga, gb


class Precision:
    """The reference's arithmetic: "f32" (the reference), or "fp8" (the
    control: every matmul's operands rounded to e4m3, its gradient to
    e5m2, f32 sums)."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "fp8"):
            raise ValueError(f"precision {mode!r}: want 'f32' or 'fp8'")
        self.mode = mode

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.to(torch.float32), b.to(torch.float32)
        return a @ b if self.mode == "f32" else _Fp8Matmul.apply(a, b)
