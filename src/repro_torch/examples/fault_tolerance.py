"""Fault-tolerance demo: heartbeats, failure detection, restart from the
newest checkpoint.  PyTorch port of ``examples/fault_tolerance.py``.

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerance [--steps 20]

Simulates: 4 'hosts' heartbeat while a BSQ run checkpoints; host 2 dies;
the detector excludes it; training resumes from the newest complete
checkpoint (on the smaller 'fleet'), losing at most ckpt_interval steps.
Phase 1 trains ``--steps`` steps (requant every half of them, a
checkpoint every quarter), phase 2 resumes to one and a half times that.
The work directory is a fresh temporary one, removed at the end.
"""
import argparse
import shutil
import tempfile
import time

import torch

from ..ckpt import checkpoint as ckpt
from ..configs import reduced_config
from ..core import BSQConfig
from ..data import MarkovLM, sharded_lm_iterator
from ..device import resolve_device
from ..optim import SGDM, step_decay
from ..train.ft import FailureDetector, Heartbeat
from ..train.step import init_bsq_state, make_bsq_train_step, make_requant_step
from ..train.trainer import TrainerConfig, train_bsq


def main(argv=None, device=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(device)
    if args.steps < 4 or args.steps % 4:
        raise ValueError(f"--steps {args.steps}: want a positive multiple of 4")
    phase1, phase2 = args.steps, args.steps * 3 // 2
    requant_interval, ckpt_interval = args.steps // 2, args.steps // 4

    workdir = tempfile.mkdtemp(prefix="bsq_ft_")
    hosts = [Heartbeat(workdir, h, interval=0.2) for h in range(4)]
    try:
        for h in hosts:
            h.start()

        cfg = reduced_config("granite-3-2b")
        bsq_cfg = BSQConfig(n_init=8, alpha=5e-3, mode="static", compute_dtype=torch.float32)
        opt = SGDM()
        task = MarkovLM(vocab=cfg.vocab_size, seed=1)

        def train(total_steps):
            # a fresh state each time: the second call stands for a restarted process
            state, ctx = init_bsq_state(torch.Generator(device=device).manual_seed(0), cfg,
                                        bsq_cfg, opt, device)
            step = make_bsq_train_step(ctx, opt, step_decay(0.2, [1000]))
            tcfg = TrainerConfig(total_steps=total_steps, requant_interval=requant_interval,
                                 ckpt_interval=ckpt_interval, log_interval=ckpt_interval,
                                 workdir=workdir)
            return train_bsq(state, ctx, step, make_requant_step(ctx),
                             sharded_lm_iterator(task, 4, 16, seed=0, device=device), tcfg)

        out = train(phase1)
        step1 = int(out["state"]["step"])
        print(f"phase 1 done at step {step1}")

        # host 2 dies
        hosts[2].stop()
        time.sleep(0.8)
        det = FailureDetector(workdir, suspect_after=0.5, dead_after=0.7)
        status = det.check([0, 1, 2, 3])
        print("fleet status:", status)
        survivors = det.surviving([0, 1, 2, 3])
        if 2 in survivors:
            raise RuntimeError(f"the detector kept the dead host 2: {status}")
        print(f"excluding host 2; resuming on {len(survivors)} hosts "
              f"(global batch unchanged — per-host batch grows)")

        # restart: fresh process state, same workdir -> auto-resume
        resumed_from = max(ckpt.available_steps(workdir))
        out2 = train(phase2)
        step2 = int(out2["state"]["step"])
        print(f"phase 2 resumed from step {resumed_from} and finished at step {step2}")
        print("OK")
        return {"phase1_step": step1, "resumed_from": resumed_from, "phase2_step": step2,
                "status": status, "survivors": survivors, "history": out2["history"]}
    finally:
        for h in hosts:
            h.stop()
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
