"""A decoder LM's full forward pass over whole sequences, in float32,
from the float weights in the benchmark's layout (``harness.weights``).

The architecture, as the configurations run it: token embedding times
sqrt(d_model); per layer, x += attention(rmsnorm(x)) and x += ffn(rmsnorm(x));
RMSNorm scales by (1 + scale); rotary embeddings rotate interleaved pairs
(2j, 2j+1) of each head; causal grouped-query attention, softmax of
q.k / sqrt(head_dim); a SwiGLU FFN, or a mixture of experts: router logits
in f32, the top-k experts' logits softmaxed among themselves, each token's
k SwiGLU experts weighed by them, every token routed (no capacity), plus
the shared experts as one SwiGLU of their summed width; a final RMSNorm
and the head (the embedding's transpose where tied).  The leaves a
configuration serves packed are used as their 6-bit values
(``quant.sixbit``), worked out here from the float weights.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from ..counts.model import LM
from .quant import Precision, sixbit

NEG_INF = float("-inf")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd), pos (S,): rotate the pairs (2j, 2j+1) by pos * theta^(-2j/hd)."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.to(torch.float32)[:, None] * freqs  # (S, hd/2)
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).reshape(x.shape)


class Model:
    """The reference over one configuration's float weights."""

    def __init__(self, program: dict, weights: Dict[str, torch.Tensor], packed: Sequence[str],
                 precision: str = "f32", n_bits: int = 6):
        self.lm = LM.from_program(program)
        self.eps = float(program.get("norm_eps", 1e-6))
        self.theta = float(program.get("rope_theta", 10000.0))
        self.w = weights
        self.packed = set(packed)
        self.p = Precision(precision)
        self.n_bits = n_bits

    def leaf(self, path: str, layer: int = None) -> torch.Tensor:
        """A weight in f32 as the configuration serves it (6-bit where
        packed), one layer's slice where ``layer`` is given."""
        w = self.w[path] if layer is None else self.w[path][layer]
        if path.rsplit("/", 1)[-1] in self.packed and "/moe/" not in path:
            return sixbit(w, self.n_bits)
        return w.to(torch.float32)

    def attention(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        lm, mm = self.lm, self.p.mm
        S = h.shape[0]
        H, KV, hd = lm.n_heads, lm.n_kv_heads, lm.head_dim
        G = H // KV
        pre = "blocks/p0/mixer/"
        q = mm(h, self.leaf(pre + "wq", layer)).reshape(S, H, hd)
        k = mm(h, self.leaf(pre + "wk", layer)).reshape(S, KV, hd)
        v = mm(h, self.leaf(pre + "wv", layer)).reshape(S, KV, hd)
        pos = torch.arange(S, device=h.device)
        q, k = rope(q, pos, self.theta), rope(k, pos, self.theta)
        causal = pos[:, None] >= pos[None, :]
        outs = []
        for g in range(KV):  # one K/V head and its G query heads at a time
            qg = q[:, g * G:(g + 1) * G, :].transpose(0, 1)  # (G, S, hd)
            s = self.p.mm(qg, k[:, g, :].T) / math.sqrt(hd)  # (G, S, S)
            s = torch.where(causal, s, torch.full((), NEG_INF, device=h.device))
            w = torch.softmax(s, dim=-1)
            outs.append(self.p.mm(w, v[:, g, :]).transpose(0, 1))
        out = torch.cat(outs, dim=1)  # (S, H, hd), head kv*G + g
        return mm(out.reshape(S, H * hd), self.leaf(pre + "wo", layer))

    def swiglu(self, h: torch.Tensor, wg, wu, wd) -> torch.Tensor:
        mm = self.p.mm
        return mm(F.silu(mm(h, wg)) * mm(h, wu), wd)

    def ffn(self, h: torch.Tensor, layer: int) -> torch.Tensor:
        lm = self.lm
        if not lm.n_experts:
            pre = "blocks/p0/mlp/"
            return self.swiglu(h, self.leaf(pre + "w_gate", layer), self.leaf(pre + "w_up", layer),
                               self.leaf(pre + "w_down", layer))
        pre = "blocks/p0/moe/"
        gates = h @ self.w[pre + "router"][layer].to(torch.float32)  # f32, as configured
        top_w, top_e = torch.topk(gates, lm.top_k, dim=-1)
        probs = torch.softmax(top_w, dim=-1)
        y = torch.zeros_like(h)
        for e in torch.unique(top_e).tolist():
            tok, slot = torch.nonzero(top_e == e, as_tuple=True)
            ye = self.swiglu(h[tok], self.w[pre + "w_gate"][layer, e].to(torch.float32),
                             self.w[pre + "w_up"][layer, e].to(torch.float32),
                             self.w[pre + "w_down"][layer, e].to(torch.float32))
            y.index_add_(0, tok, ye * probs[tok, slot][:, None])
        if lm.n_shared_experts:
            sp = pre + "shared/"
            y = y + self.swiglu(h, *(self.w[sp + n][layer].to(torch.float32)
                                     for n in ("w_gate", "w_up", "w_down")))
        return y

    def head(self) -> torch.Tensor:
        if self.lm.tie_embeddings:
            return self.w["embed"].to(torch.float32).T
        return self.leaf("lm_head")

    def hidden(self, sequences: List[torch.Tensor]) -> List[torch.Tensor]:
        """The final-normed hidden states (S_i, d) of each token sequence."""
        lm = self.lm
        xs = [self.w["embed"][t].to(torch.float32) * math.sqrt(lm.d_model) for t in sequences]
        for layer in range(lm.n_layers):
            n1 = self.w["blocks/p0/norm1/scale"][layer]
            n2 = self.w["blocks/p0/norm2/scale"][layer]
            xs = [x + self.attention(rmsnorm(x, n1, self.eps), layer) for x in xs]
            # the FFN is position-free: every sequence's rows in one batch
            sizes = [x.shape[0] for x in xs]
            flat = torch.cat(xs)
            flat = flat + self.ffn(rmsnorm(flat, n2, self.eps), layer)
            xs = list(torch.split(flat, sizes))
        fin = self.w["final_norm/scale"]
        return [rmsnorm(x, fin, self.eps) for x in xs]

    def padded_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (S, padded vocab) of one sequence, every position (the
        training loss's cross-entropy runs over the padded vocabulary)."""
        return self.p.mm(self.hidden([tokens])[0], self.head())

    @torch.no_grad()
    def logits(self, sequences: List[torch.Tensor], rows: List[torch.Tensor]) -> List[torch.Tensor]:
        """For each token sequence (S_i,), the logits (len(rows_i), vocab)
        at the positions ``rows_i``, over the true vocabulary."""
        head = self.head()
        return [self.p.mm(x[r], head)[:, :self.lm.vocab]
                for x, r in zip(self.hidden(sequences), rows)]
