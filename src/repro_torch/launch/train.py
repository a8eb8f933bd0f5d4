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
the card is out of memory.

``--data-parallel D --model-parallel M`` (both non-zero, as in JAX) train
on a D x M ("data", "model") mesh: one process per rank
(``launch.mesh.run_on_mesh``), each holding its block of the state and
of every batch (``train.step``), checkpoints gathered and written by
rank 0 and resumed on whatever mesh the next run has.  Rank 0 prints.
``--dist-backend`` picks the ``torch.distributed`` backend: ``nccl`` (one
card per rank, the default on the card) or ``gloo`` (the CPU's default;
on the card, several ranks sharing one card).  A ``--batch`` the data
axis does not divide exits with JAX's message.

:func:`run` is the body: it takes the ModelConfig to train, so a caller
can train a depth-cut config of the same width.
"""
import argparse
import contextlib
import io

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
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend of the mesh ranks (default: gloo with "
                         "--device cpu, else nccl, which needs one card per rank)")
    return ap


def run(cfg, args, log_interval: int = 10):
    """Train ``cfg`` as ``args`` (parsed by :func:`build_parser`) say.

    Returns the trainer's dict (``state``, ``history``, ``scheme``,
    ``stragglers``) plus ``ctx`` for BSQ; ``state`` and ``history`` for
    plain training.  ``log_interval`` is the trainer's history stride.
    On a mesh: rank 0's ``history`` and ``scheme`` (BSQ) or ``history``
    (plain); the states stay with the ranks."""
    from ..device import resolve_device

    device = resolve_device(args.device)
    if not (args.data_parallel and args.model_parallel):
        return _run(cfg, args, log_interval, device, None)
    from ..dist.elastic import validate_batch_divisibility
    from .mesh import AbstractMesh, run_on_mesh

    shape = {"data": args.data_parallel, "model": args.model_parallel}
    if not validate_batch_divisibility(args.batch, AbstractMesh(shape)):
        raise SystemExit(f"--batch {args.batch} does not divide over the mesh's data axes "
                         f"({shape}); pick a batch the DP axes divide")
    backend = args.dist_backend or ("gloo" if device.type == "cpu" else "nccl")
    print(f"[mesh] data={args.data_parallel} model={args.model_parallel}: "
          f"{args.data_parallel * args.model_parallel} ranks on {device}, backend {backend}")
    ranks = run_on_mesh(_train_rank, args.data_parallel, args.model_parallel, backend=backend,
                        device=device, args=(cfg, args, log_interval))
    return ranks[0]


def _train_rank(mesh, cfg, args, log_interval):
    """One mesh rank of :func:`run`: rank 0 prints, the others train
    quietly; returns what pickles cheaply (no state)."""
    quiet = contextlib.redirect_stdout(io.StringIO()) if mesh.rank else contextlib.nullcontext()
    with quiet:
        out = _run(cfg, args, log_interval, mesh.device, mesh)
    return {k: v for k, v in out.items() if k in ("history", "scheme")}


def _run(cfg, args, log_interval, device, mesh):
    from ..core import BSQConfig
    from ..data import MarkovLM, sharded_lm_iterator
    from ..optim import SGDM, AdamW, step_decay
    from ..train.step import (
        init_bsq_state,
        init_plain_state,
        make_bsq_train_step,
        make_plain_train_step,
        make_requant_step,
    )
    from ..train.trainer import TrainerConfig, simple_train_loop, train_bsq

    opt = SGDM() if args.optimizer == "sgdm" else AdamW()
    lr_fn = step_decay(args.lr, [int(args.steps * 0.7), int(args.steps * 0.9)])
    task = MarkovLM(vocab=cfg.vocab_size, seed=13)
    data = sharded_lm_iterator(task, args.batch, args.seq, seed=0, device=device, sharding=mesh)
    tcfg = TrainerConfig(
        total_steps=args.steps, requant_interval=args.requant_interval,
        ckpt_interval=args.ckpt_interval, log_interval=log_interval, workdir=args.workdir,
    )
    gen = torch.Generator(device=device).manual_seed(0)

    if args.technique == "bsq":
        bsq_cfg = BSQConfig(n_init=8, alpha=args.alpha, mode="static",
                            compute_dtype=torch.float32 if args.reduced else torch.bfloat16)
        state, ctx = init_bsq_state(gen, cfg, bsq_cfg, opt, device, mesh=mesh)
        step = make_bsq_train_step(ctx, opt, lr_fn, mesh=mesh)
        out = train_bsq(state, ctx, step, make_requant_step(ctx, mesh), data, tcfg, mesh=mesh)
        s = out["scheme"]
        print(f"done: bits/para={s.bits_per_param:.2f} comp={s.compression:.2f}x")
        return dict(out, ctx=ctx)
    state = init_plain_state(gen, cfg, opt, device, mesh=mesh)
    state, history = simple_train_loop(state, make_plain_train_step(cfg, opt, lr_fn, mesh=mesh),
                                       data, args.steps)
    print(f"done: final={history[-1]}")
    return {"state": state, "history": history}


def main(argv=None):
    from ..configs import get_config, reduced_config

    args = build_parser().parse_args(argv)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    return run(cfg, args)


if __name__ == "__main__":
    main()
