"""Random weights of a decoder LM, made on the device from the seed in a
few large draws, in the program's parameter layout (``embed``,
``blocks/p0/...`` stacked over the layers, ``final_norm``, an untied
``lm_head``).  The benchmark hands the same tensors to the program and to
the plain reference; neither side draws its own.

Matrices are N(0, 1/fan_in), the embedding N(0, s^2) (s = 0.02 unless
the configuration's ``init`` says otherwise) and an untied head N(0, 0.02^2),
the router N(0, 0.02^2) in f32, norm scales N(0, 0.1^2) in f32 (the
models scale by 1 + scale)."""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..counts.model import LM


def layout(lm: LM, embed_std: float = 0.02) -> List[Tuple[str, Tuple[int, ...], float, bool]]:
    """(key path, shape, std, matrix?) of every leaf.  Matrices are drawn
    in the model's dtype, the rest (norm scales, the router) in f32."""
    L, d, f = lm.n_layers, lm.d_model, lm.d_ff
    leaves = [("embed", (lm.padded_vocab, d), embed_std, True)]
    p = "blocks/p0/"
    leaves.append((p + "norm1/scale", (L, d), 0.1, False))
    for name, k, n in lm.attn_shapes():
        leaves.append((p + "mixer/" + name, (L, k, n), 1.0 / math.sqrt(k), True))
    leaves.append((p + "norm2/scale", (L, d), 0.1, False))
    if lm.n_experts:
        E = lm.n_experts
        leaves.append((p + "moe/router", (L, d, E), 0.02, False))
        for name, k, n in lm.mlp_shapes():
            leaves.append((p + "moe/" + name, (L, E, k, n), 1.0 / math.sqrt(k), True))
        if lm.n_shared_experts:
            fs = lm.n_shared_experts * f
            for name, k, n in [("w_gate", d, fs), ("w_up", d, fs), ("w_down", fs, d)]:
                leaves.append((p + "moe/shared/" + name, (L, k, n), 1.0 / math.sqrt(k), True))
    else:
        for name, k, n in lm.mlp_shapes():
            leaves.append((p + "mlp/" + name, (L, k, n), 1.0 / math.sqrt(k), True))
    leaves.append(("final_norm/scale", (d,), 0.1, False))
    if not lm.tie_embeddings:
        leaves.append(("lm_head", (d, lm.padded_vocab), 0.02, True))
    return leaves


def make_flat(lm: LM, seed: int, device, dtype: torch.dtype,
              embed_std: float = 0.02) -> Dict[str, torch.Tensor]:
    """Every leaf by key path: two draws (the matrices in ``dtype``, the
    rest in f32) from one generator seeded with ``seed``, each leaf a view
    of its draw scaled in place."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2**63))
    leaves = layout(lm, embed_std)
    out = {}
    for is_matrix, dt in ((True, dtype), (False, torch.float32)):
        group = [leaf for leaf in leaves if leaf[3] == is_matrix]
        total = sum(math.prod(s) for _, s, _, _ in group)
        buf = torch.randn((total,), generator=gen, device=device, dtype=dt)
        off = 0
        for name, shape, std, _ in group:
            n = math.prod(shape)
            out[name] = buf[off:off + n].view(shape).mul_(std)
            off += n
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """The nested dict of key paths (``a/b/c`` -> tree["a"]["b"]["c"])."""
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaf
    return tree
