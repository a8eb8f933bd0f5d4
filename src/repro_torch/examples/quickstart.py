"""Quickstart: BSQ on a tiny LM.  PyTorch port of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--steps 200]

Converts a model to the bit representation, trains with the bit-level
group Lasso, re-quantises periodically, and prints the mixed-precision
scheme BSQ discovered.  Runs on the CUDA card unless ``main`` is given
``device="cpu"``.
"""
import argparse

import numpy as np
import torch

from ..configs import reduced_config
from ..core import BSQConfig, extract_scheme
from ..data import MarkovLM
from ..device import resolve_device
from ..optim import SGDM, step_decay
from ..train.step import init_bsq_state, make_bsq_train_step, make_requant_step, state_reps


def lm_batch(task: MarkovLM, rng: np.random.Generator, batch: int, seq: int, device):
    """One ``task`` batch as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v).long().to(device)
            for k, v in task.batch(rng, batch, seq).items()}


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--requant-interval", type=int, default=50)
    args = ap.parse_args(argv)
    device = resolve_device(device)

    cfg = reduced_config("granite-3-2b")  # tiny same-shape variant
    bsq_cfg = BSQConfig(n_init=8, alpha=0.3, mode="static", compute_dtype=torch.float32)
    opt = SGDM(momentum=0.9, weight_decay=1e-4)  # the paper's optimizer

    state, ctx = init_bsq_state(torch.Generator(device=device).manual_seed(0), cfg, bsq_cfg,
                                opt, device)
    train_step = make_bsq_train_step(ctx, opt, step_decay(0.5, [150]))
    requant = make_requant_step(ctx)

    task = MarkovLM(vocab=cfg.vocab_size, seed=7)
    rng = np.random.default_rng(0)
    print(f"task entropy floor: {task.entropy_floor():.3f} nats")

    history = []
    for i in range(args.steps):
        state, m = train_step(state, lm_batch(task, rng, 8, 32, device))
        if (i + 1) % args.requant_interval == 0:
            state = requant(state)  # paper §3.3: periodic precision adjustment
            scheme = extract_scheme(state_reps(state, ctx))
            history.append({"step": i + 1, "ce": float(m["ce"]), "reg": float(m["reg"]),
                            "bits_per_param": scheme.bits_per_param})
            print(f"step {i+1}: ce={history[-1]['ce']:.3f} reg={history[-1]['reg']:.1f} "
                  f"bits/para={scheme.bits_per_param:.2f} comp={scheme.compression:.2f}x")

    state = requant(state)
    scheme = extract_scheme(state_reps(state, ctx))
    print("\nfinal mixed-precision scheme (mean bits per tensor):")
    for name, bits in sorted(scheme.layer_bits().items()):
        print(f"  {name:45s} {bits:.1f} bits")
    print(f"\nbits/para={scheme.bits_per_param:.2f}  compression={scheme.compression:.2f}x "
          f"vs fp32")
    return {"scheme": scheme, "history": history, "state": state, "ctx": ctx}


if __name__ == "__main__":
    main()
