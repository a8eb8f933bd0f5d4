"""Whole-step counts of a decoder LM from its configuration's widths:
model FLOPs per token (the 2*N per token of serving, 6*N of training,
plus causal attention), the projections a serving call runs through the
bitserial kernel, and the bytes BSQ's state must move once a step."""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from . import HBM_BW, peak_flops


@dataclasses.dataclass(frozen=True)
class LM:
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    padded_vocab: int
    tie_embeddings: bool
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0

    @classmethod
    def from_program(cls, p: dict) -> "LM":
        """From a configuration file's ``program`` section."""
        hd = p.get("head_dim") or p["d_model"] // p["n_heads"]
        m = p.get("vocab_pad_multiple", 256)
        return cls(n_layers=p["n_layers"], d_model=p["d_model"], n_heads=p["n_heads"],
                   n_kv_heads=p["n_kv_heads"], head_dim=hd, d_ff=p["d_ff"],
                   vocab=p["vocab_size"], padded_vocab=-(-p["vocab_size"] // m) * m,
                   tie_embeddings=p.get("tie_embeddings", False),
                   n_experts=p.get("n_experts", 0), top_k=p.get("top_k", 0),
                   n_shared_experts=p.get("n_shared_experts", 0))

    # -- parameters -----------------------------------------------------
    def attn_shapes(self) -> List[Tuple[str, int, int]]:
        d, q, kv = self.d_model, self.n_heads * self.head_dim, self.n_kv_heads * self.head_dim
        return [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d)]

    def mlp_shapes(self) -> List[Tuple[str, int, int]]:
        d, f = self.d_model, self.d_ff
        return [("w_gate", d, f), ("w_up", d, f), ("w_down", f, d)]

    def layer_active_params(self) -> int:
        """Matmul weights one token meets in one layer (the router and the
        top-k routed experts and the shared ones, for a MoE)."""
        n = sum(k * n for _, k, n in self.attn_shapes())
        mlp = sum(k * n for _, k, n in self.mlp_shapes())
        if self.n_experts:
            n += self.d_model * self.n_experts + self.top_k * mlp + self.n_shared_experts * mlp
        else:
            n += mlp
        return n

    def active_params(self) -> int:
        """Matmul weights per token: every layer's and the output head's
        (the true vocabulary; the embedding lookup has no operations)."""
        return self.n_layers * self.layer_active_params() + self.d_model * self.vocab

    def kv_bytes_per_token(self, itemsize: int = 2) -> int:
        """The K and V rows one position holds in every layer's cache."""
        return self.n_layers * 2 * self.n_kv_heads * self.head_dim * itemsize

    def attention_flops(self, rows: float) -> float:
        """q.k and p.v of one query over ``rows`` keys, every layer."""
        return 4.0 * self.n_layers * self.n_heads * self.head_dim * rows

    def token_flops(self, position: int) -> float:
        """Serving FLOPs of one token at ``position`` (0-based): 2*N plus
        causal attention over the position + 1 keys."""
        return 2.0 * self.active_params() + self.attention_flops(position + 1)

    def tokens_flops(self, start: int, count: int) -> float:
        """:meth:`token_flops` summed over positions start .. start+count-1."""
        rows = count * (start + 1) + count * (count - 1) / 2.0
        return 2.0 * self.active_params() * count + self.attention_flops(rows)

    def train_flops(self, seq_len: int, sequences: int) -> float:
        """6*N*D plus causal attention forward and backward (3x forward)."""
        tokens = seq_len * sequences
        rows = sequences * seq_len * (seq_len + 1) / 2.0
        return 6.0 * self.active_params() * tokens + 3.0 * self.attention_flops(rows)

    # -- serving calls through the bitserial kernel ------------------------
    def packed_launches(self, packed: List[str], M: int, M_head: int):
        """[(M, K, N)] of one model call's bitserial launches: each packed
        per-layer projection at ``M`` rows, every layer, and a packed head
        at ``M_head`` rows (a prefill chunk takes logits at one row a lane)."""
        out = []
        shapes = self.attn_shapes() + ([] if self.n_experts else self.mlp_shapes())
        per_layer = [(M, k, n) for name, k, n in shapes if name in packed]
        out += per_layer * self.n_layers
        if "lm_head" in packed and not self.tie_embeddings:
            out.append((M_head, self.d_model, self.padded_vocab))
        return out

    # -- BSQ training ---------------------------------------------------
    def quantised_params(self) -> int:
        """Parameters BSQ holds as planes: the padded embedding, every
        layer's matmul weights, an untied head."""
        mlp = sum(k * n for _, k, n in self.mlp_shapes())
        per_layer = sum(k * n for _, k, n in self.attn_shapes()) + mlp * max(
            1, self.n_experts + self.n_shared_experts)
        n = self.padded_vocab * self.d_model + self.n_layers * per_layer
        if not self.tie_embeddings:
            n += self.d_model * self.padded_vocab
        return n

    def bsq_state_bytes(self, planes: int) -> float:
        """Bytes a BSQ step must read and write once: wp and wn (``planes``
        f32 planes each) and their SGD momentum, each read and written."""
        return 2.0 * 2 * (planes * 2 * 4) * self.quantised_params()

    def bsq_step_least(self, planes: int, seq_len: int, sequences: int) -> float:
        """The least time of one BSQ step: the state's bytes at the HBM
        rate or the step's FLOPs at the bf16 rate, whichever is larger."""
        return max(self.bsq_state_bytes(planes) / HBM_BW,
                   self.train_flops(seq_len, sequences) / peak_flops("bfloat16"))
