"""Serve a BSQ-compressed model with batched requests.  PyTorch port of
``examples/serve_quantized.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--steps 120]

Trains briefly with BSQ, freezes + packs the scheme (sign-magnitude
bit-planes), reports the footprint against bf16, then serves a batch of
prompts through the bucketed engine and prints throughput.

Where the JAX example serves the reconstructed float weights, this one
serves the packed export itself: every projection stays a PackedWeight
(dequantised inside the bitserial kernel on the card), and only the
embedding, a lookup table, is dequantised from its packed form.  The
float route (``serve.engine.dequantize_packed_params``) is built for its
footprint, and is what the CPU tests serve beside it.
"""
import argparse

import numpy as np
import torch

from ..configs import reduced_config
from ..core import BSQConfig, export_packed, extract_scheme
from ..core.bsq import merge_params
from ..core.packing import PackedWeight, tree_leaves, unpack_to_float
from ..data import MarkovLM
from ..device import resolve_device
from ..optim import SGDM, step_decay
from ..serve import Request, ServeEngine, dequantize_packed_params
from ..train.step import init_bsq_state, make_bsq_train_step, make_requant_step, state_reps
from .quickstart import lm_batch


def tree_bytes(tree) -> int:
    """Device bytes of a param tree: PackedWeights at their packed size."""
    return sum(x.hbm_bytes() if isinstance(x, PackedWeight) else x.numel() * x.element_size()
               for x in tree_leaves(tree))


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--requant-interval", type=int, default=40)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    args = ap.parse_args(argv)
    device = resolve_device(device)

    cfg = reduced_config("granite-3-2b")
    bsq_cfg = BSQConfig(n_init=8, alpha=0.3, mode="static", compute_dtype=torch.float32)
    opt = SGDM()
    state, ctx = init_bsq_state(torch.Generator(device=device).manual_seed(0), cfg, bsq_cfg,
                                opt, device)
    step = make_bsq_train_step(ctx, opt, step_decay(0.5, [100]))
    requant = make_requant_step(ctx)
    task = MarkovLM(vocab=cfg.vocab_size, seed=7)
    rng = np.random.default_rng(0)
    for i in range(args.steps):
        state, m = step(state, lm_batch(task, rng, 8, 32, device))
        if (i + 1) % args.requant_interval == 0:
            state = requant(state)
    state = requant(state)
    reps = state_reps(state, ctx)
    scheme = extract_scheme(reps)
    print(f"BSQ scheme: bits/para={scheme.bits_per_param:.2f} comp={scheme.compression:.2f}x")

    packed = export_packed(reps)
    packed_bytes = sum(pw.hbm_bytes() for pw in packed.values())
    bf16_bytes = scheme.quantized_params * 2
    print(f"packed weights: {packed_bytes/1e6:.2f} MB vs bf16 {bf16_bytes/1e6:.2f} MB "
          f"({bf16_bytes/max(packed_bytes,1):.2f}x smaller)")

    floats = state["trainable"]["float"]
    served = {k: v for k, v in packed.items() if k != "embed"}
    served["embed"] = unpack_to_float(packed["embed"])
    params = merge_params(ctx.template, served, floats)
    float_params = dequantize_packed_params(ctx.template, packed, floats)
    print(f"served trees: packed route {tree_bytes(params)/1e6:.3f} MB (projections packed), "
          f"float route {tree_bytes(float_params)/1e6:.3f} MB (dequantize_packed_params); "
          "serving the packed route")

    engine = ServeEngine(params, cfg, max_len=128, device=device)
    prompts = [task.sample(np.random.default_rng(i), 1, 16)[0, :16].astype(np.int32)
               for i in range(args.requests)]
    reqs = [Request(uid=i, tokens=p, max_new=args.max_new) for i, p in enumerate(prompts)]
    results = engine.generate(reqs)
    for r in results[:3]:
        print(f"req {r.uid}: prefill {r.prefill_ms:.1f} ms, "
              f"{r.decode_ms_per_tok:.1f} ms/token -> {r.tokens[:10]}...")
    toks = sum(len(r.tokens) for r in results)
    print(f"generated {toks} tokens across {len(results)} requests")
    return {"scheme": scheme, "packed": packed, "params": params, "float_params": float_params,
            "prompts": prompts, "results": results, "cfg": cfg}


if __name__ == "__main__":
    main()
