"""End-to-end run: train a ~100M-param LM with BSQ for a few hundred
steps on the synthetic Markov corpus, with requant events, checkpointing,
straggler monitoring and auto-resume (kill it and rerun: it resumes).
PyTorch port of ``examples/train_lm_bsq.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_bsq [--steps 300] [--alpha 5e-3]

~100M params: 12 layers x d_model 512 x ffn 2048, vocab 32768.  A BSQ
state holds 216 bytes per quantised parameter (planes, their gradients,
SGD momentum): about 17 GB for this model's 81M quantised parameters,
and a checkpoint under ``--workdir`` (an empty value trains without one)
about 12 GB.
"""
import argparse
import os
import tempfile

import torch

from ..configs.base import ModelConfig
from ..core import BSQConfig
from ..data import MarkovLM, sharded_lm_iterator
from ..device import resolve_device
from ..optim import SGDM, step_decay
from ..train.step import init_bsq_state, make_bsq_train_step, make_requant_step
from ..train.trainer import TrainerConfig, train_bsq
from ..tree import leaves

LM_100M = ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=512, n_heads=8,
    n_kv_heads=4, d_ff=2048, vocab_size=32768, layer_pattern=("attn",),
    dtype="float32", remat=False,
)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--alpha", type=float, default=5e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--requant-interval", type=int, default=100)
    ap.add_argument("--workdir", default=os.path.join(tempfile.gettempdir(), "bsq_lm_100m"),
                    help="checkpoints, scheme and history ('' trains without them)")
    return ap


def run(cfg: ModelConfig, args, device=None):
    """Train ``cfg`` as ``args`` (parsed by :func:`build_parser`) say; the
    trainer's dict (``state``, ``history``, ``scheme``, ``stragglers``)."""
    device = resolve_device(device)
    bsq_cfg = BSQConfig(n_init=8, alpha=args.alpha, mode="static", compute_dtype=torch.float32)
    opt = SGDM()
    state, ctx = init_bsq_state(torch.Generator(device=device).manual_seed(0), cfg, bsq_cfg,
                                opt, device)
    n = sum(x.numel() for x in leaves(ctx.template))
    print(f"model params: ~{n:,}")

    train_step = make_bsq_train_step(ctx, opt, step_decay(0.2, [200, 280]))
    requant = make_requant_step(ctx)
    task = MarkovLM(vocab=cfg.vocab_size, branching=8, seed=13)
    data = sharded_lm_iterator(task, args.batch, args.seq, seed=0, device=device)

    out = train_bsq(
        state, ctx, train_step, requant, data,
        TrainerConfig(total_steps=args.steps, requant_interval=args.requant_interval,
                      ckpt_interval=100, log_interval=20, workdir=args.workdir or None),
    )
    print(f"entropy floor {task.entropy_floor():.3f}; history tail:")
    for rec in out["history"][-3:]:
        print(" ", rec)
    s = out["scheme"]
    print(f"scheme: bits/para={s.bits_per_param:.2f} comp={s.compression:.2f}x")
    return out


def main(argv=None, device=None):
    return run(LM_100M, build_parser().parse_args(argv), device)


if __name__ == "__main__":
    main()
