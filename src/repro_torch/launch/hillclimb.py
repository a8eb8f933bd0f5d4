"""Hillclimb: run named variants of three dry-run cells and log
hypothesis -> change -> before -> after, on the dry run's 16x16 mesh as
JAX's cells run (``launch.dryrun``; rank 0 on meta tensors, terms
computed from H100 data-sheet figures, nothing measured), A6 on the
2x16x16 mesh it names.  PyTorch port of ``repro.launch.hillclimb``: the
same cells, labels and overrides.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell A --out results/hillclimb.json
"""
import argparse
import dataclasses
import json
import os

from ..configs import get_config
from .dryrun import MESHES, run_cell

# (cell, label, hypothesis, run_cell overrides, cfg overrides)
VARIANTS = {
    # A: granite-3-2b x train_4k — paper-representative BSQ train step.
    "A": [
        ("baseline", "paper-faithful baseline (remat 'nothing')", {}, {}),
        ("remat_dots",
         "H-A1: 'nothing' recomputes every superblock op in the backward; saving "
         "the 2-D products ('dots') skips recomputing them and the chains that "
         "feed them -> predict fewer bytes and FLOPs, a larger temp peak",
         {}, {"remat_policy": "dots"}),
        ("bf16_scores",
         "H-A2: the attention score/softmax chain is f32 (4 B per element) and "
         "moves the most bytes of the attention; bf16 scores halve that chain "
         "-> predict a memory-term drop in proportion to the chain's share",
         {}, {"attn_scores_dtype": "bfloat16"}),
        ("dots+bf16",
         "H-A3: A1 and A2 compose (different op sets)",
         {}, {"remat_policy": "dots", "attn_scores_dtype": "bfloat16"}),
        ("mlp_names",
         "H-A4: the saved products of every microbatch stay resident under "
         "'dots'. Save ONLY the wide MLP products (the largest recompute per "
         "saved byte) -> predict most of A1's saving at a smaller temp peak",
         {}, {"remat_policy": "mlp_names"}),
        ("dots_bf16_offload",
         "H-A5: keep the 'dots' set but hold it in pinned host memory -> the "
         "saved set leaves device memory, the same FLOPs and device bytes as A3",
         {}, {"remat_policy": "dots_offload", "attn_scores_dtype": "bfloat16"}),
        ("spmd_ce",
         "H-A7: the op profile's largest op is the f32 logits chain of the "
         "cross entropy (batch x seq x vocab); the port has no sharded cross "
         "entropy to vary, so this label is an alias: it copies the baseline's "
         "record (ALIASES) to read that chain's share beside the products'",
         {}, {}),
        ("spmd_ce_dots_bf16",
         "H-A8: compose A7's reading with A3; an alias of 'dots+bf16' (ALIASES)",
         {}, {"remat_policy": "dots", "attn_scores_dtype": "bfloat16"}),
        ("dots_bf16_multipod",
         "H-A6: the 2x16x16 mesh halves each device's batch rows, so A3's saved "
         "set halves -> predict about half A3's temp peak on 16x16, the parameter "
         "bytes unchanged (no rule splits a weight over 'pod')",
         {"multi_pod": True}, {"remat_policy": "dots", "attn_scores_dtype": "bfloat16"}),
    ],
    # B: qwen2-moe x train_4k — the MoE train step.
    "B": [
        ("baseline_fixed_sharding",
         "H-B0: the baseline MoE train step on 16x16: 60 experts do not divide "
         "the 16-way model axis, so the rule keeps E whole and every rank's (E, C) "
         "dispatch runs all 60 experts' products on its 'data' slice of each -> "
         "predict the expert products lead the FLOPs and the dispatch buffers the bytes",
         {}, {}),
        ("remat_dots_bf16",
         "H-B1: carry A's winners onto the MoE cell",
         {}, {"remat_policy": "dots", "attn_scores_dtype": "bfloat16"}),
        ("cf1",
         "H-B2: capacity_factor 1.25->1.0 cuts the (G,E,C,d) dispatch buffers "
         "and expert einsum work 20% at the cost of more dropped tokens "
         "(quality tradeoff, flagged)",
         {}, {"capacity_factor": 1.0}),
        ("mlp_names",
         "H-B3: carry A4's named-saveable policy",
         {}, {"remat_policy": "mlp_names"}),
    ],
    # C: granite-3-2b x decode_32k — dense decode; the paper's own payoff:
    # packed bit-plane weights cut the weights' bytes.
    "C": [
        ("baseline", "bf16 weights", {}, {}),
        ("packed_4b",
         "H-C1: decode reads every weight once per step; BSQ-packed 4-bit(+sign) "
         "weights are 5/16 of bf16 bytes -> predict the weights' share of the "
         "memory term toward 5/16 of the baseline's",
         {"packed_bits": 4}, {}),
        ("packed_2b",
         "H-C2: 2-bit(+sign) -> 3/16 of bf16 weight bytes; floor set by KV-cache "
         "reads + activations",
         {"packed_bits": 2}, {}),
        ("kv_f8",
         "H-C3: with 128 lanes of 32k positions the KV cache, not the weights, "
         "dominates a decode step's bytes. Store KV in float8_e4m3 -> predict "
         "the cache's bytes halve",
         {}, {"kv_cache_dtype": "float8_e4m3fn"}),
        ("kv_f8_packed4",
         "H-C4: compose f8 cache + 4-bit packed weights (weights minor here but "
         "free); also the deployment configuration BSQ implies",
         {"packed_bits": 4}, {"kv_cache_dtype": "float8_e4m3fn"}),
    ],
}

# Labels whose run would repeat another label's cell exactly: the port has
# no sharded cross entropy, so they copy that label's record.
ALIASES = {("A", "spmd_ce"): "baseline", ("A", "spmd_ce_dots_bf16"): "dots+bf16"}

CELLS = {
    "A": ("granite-3-2b", "train_4k"),
    "B": ("qwen2-moe-a2.7b", "train_4k"),
    "C": ("granite-3-2b", "decode_32k"),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, choices=list(CELLS) + ["all"])
    ap.add_argument("--out", default="results/hillclimb.json")
    ap.add_argument("--only", default=None, help="comma-separated variant labels")
    args = ap.parse_args(argv)

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["cell"], r["label"]) for r in results if r.get("status") == "ok"}

    cells = list(CELLS) if args.cell == "all" else [args.cell]
    for cell in cells:
        arch, shape = CELLS[cell]
        for label, hypothesis, rkw, ckw in VARIANTS[cell]:
            if args.only and label not in args.only.split(","):
                continue
            if (cell, label) in done:
                continue
            print(f"=== {cell}/{label}: {hypothesis[:90]}")
            source = ALIASES.get((cell, label))
            prior = [r for r in results if source and r.get("status") == "ok"
                     and (r["cell"], r["label"]) == (cell, source)]
            if prior:
                rec = {k: v for k, v in prior[-1].items() if k not in ("label", "hypothesis")}
                rec["alias_of"] = source
            else:
                cfg = get_config(arch)
                if ckw:
                    cfg = dataclasses.replace(cfg, **ckw)
                rec = run_cell(arch, shape, cfg_override=cfg, mesh_shape=MESHES["16x16"], **rkw)
            rec.update(cell=cell, label=label, hypothesis=hypothesis)
            results.append(rec)
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
