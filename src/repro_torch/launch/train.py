"""Training launcher: BSQ (or plain) training of a decoder LM on
synthetic Markov data, with periodic requant, checkpoints and resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --steps 200 --alpha 5e-3 --workdir /tmp/run1 [--device cpu] \\
        [--technique bsq|plain] [--optimizer sgdm|adamw] [--full]

The flags of ``repro.launch.train``, plus ``--device``: it runs on the
CUDA card unless ``--device cpu`` is given.  ``--reduced`` (the default)
trains the smoke-size config in f32; ``--full`` trains the published
config with bf16 reconstructed weights.  A BSQ state holds 216 bytes
per quantised parameter (planes, their gradients, SGD momentum), so
``--full`` granite-3-2b (about 2.5e9 quantised parameters) needs some
550 GB and does not fit one 80 GB card: it fails as PyTorch fails when
the card is out of memory.  ``--data-parallel``/``--model-parallel``
(a device mesh) come with the training mesh slice of the port.

:func:`run` is the body: it takes the ModelConfig to train, so a caller
can train a depth-cut config of the same width.
"""
import argparse

import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--technique", default="bsq", choices=["bsq", "plain"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--alpha", type=float, default=5e-3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--requant-interval", type=int, default=50)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--data-parallel", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=0)
    ap.add_argument("--optimizer", default="sgdm", choices=["sgdm", "adamw"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch path)")
    return ap


def run(cfg, args, log_interval: int = 10):
    """Train ``cfg`` as ``args`` (parsed by :func:`build_parser`) say.

    Returns the trainer's dict (``state``, ``history``, ``scheme``,
    ``stragglers``) plus ``ctx`` for BSQ; ``state`` and ``history`` for
    plain training.  ``log_interval`` is the trainer's history stride."""
    from ..core import BSQConfig
    from ..data import MarkovLM, sharded_lm_iterator
    from ..device import resolve_device
    from ..optim import SGDM, AdamW, step_decay
    from ..train.step import (
        init_bsq_state,
        init_plain_state,
        make_bsq_train_step,
        make_plain_train_step,
        make_requant_step,
    )
    from ..train.trainer import TrainerConfig, simple_train_loop, train_bsq

    if args.data_parallel or args.model_parallel:
        raise NotImplementedError("--data-parallel/--model-parallel (training on a device "
                                  "mesh) come with the training mesh slice of the port "
                                  "(ROADMAP item 9b); serving runs on a mesh already")
    device = resolve_device(args.device)
    opt = SGDM() if args.optimizer == "sgdm" else AdamW()
    lr_fn = step_decay(args.lr, [int(args.steps * 0.7), int(args.steps * 0.9)])
    task = MarkovLM(vocab=cfg.vocab_size, seed=13)
    data = sharded_lm_iterator(task, args.batch, args.seq, seed=0, device=device)
    tcfg = TrainerConfig(
        total_steps=args.steps, requant_interval=args.requant_interval,
        ckpt_interval=args.ckpt_interval, log_interval=log_interval, workdir=args.workdir,
    )
    gen = torch.Generator(device=device).manual_seed(0)

    if args.technique == "bsq":
        bsq_cfg = BSQConfig(n_init=8, alpha=args.alpha, mode="static",
                            compute_dtype=torch.float32 if args.reduced else torch.bfloat16)
        state, ctx = init_bsq_state(gen, cfg, bsq_cfg, opt, device)
        step = make_bsq_train_step(ctx, opt, lr_fn)
        out = train_bsq(state, ctx, step, make_requant_step(ctx), data, tcfg)
        s = out["scheme"]
        print(f"done: bits/para={s.bits_per_param:.2f} comp={s.compression:.2f}x")
        return dict(out, ctx=ctx)
    state = init_plain_state(gen, cfg, opt, device)
    state, history = simple_train_loop(state, make_plain_train_step(cfg, opt, lr_fn), data,
                                       args.steps)
    print(f"done: final={history[-1]}")
    return {"state": state, "history": history}


def main(argv=None):
    from ..configs import get_config, reduced_config

    args = build_parser().parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    return run(cfg, args)


if __name__ == "__main__":
    main()
