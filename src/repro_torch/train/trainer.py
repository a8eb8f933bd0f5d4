"""Training loop: BSQ schedule (train -> periodic requant -> finalize),
checkpoint/restart, preemption handling, straggler monitoring.  PyTorch
port of ``repro.train.trainer``.

Fault-tolerance model:
  * checkpoints every ``ckpt_interval`` steps (async, integrity manifest,
    atomic rename): a restart resumes from the newest *complete* one;
  * a ``STOP`` file in the workdir triggers checkpoint-and-exit (the
    preemption signal cluster schedulers use);
  * per-step wall times feed an EMA straggler detector.

A step's time is taken on the host clock after ``torch.cuda.synchronize``
when the state lives on the card.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from ..ckpt import checkpoint as ckpt
from ..core import extract_scheme
from .step import BSQTrainContext, state_reps


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    requant_interval: int = 50  # paper: every 100 epochs (CIFAR) / 10 (ImageNet)
    ckpt_interval: int = 50
    keep_ckpts: int = 3
    log_interval: int = 10
    workdir: Optional[str] = None
    straggler_ema: float = 0.9
    straggler_factor: float = 2.0  # step slower than factor*EMA is flagged


class StragglerMonitor:
    def __init__(self, ema_decay: float, factor: float):
        self.ema: Optional[float] = None
        self.decay = ema_decay
        self.factor = factor
        self.flagged = []

    def observe(self, step: int, dt: float) -> bool:
        slow = self.ema is not None and dt > self.factor * self.ema
        if slow:
            self.flagged.append((step, dt, self.ema))
        self.ema = dt if self.ema is None else self.decay * self.ema + (1 - self.decay) * dt
        return slow


def _should_stop(workdir: Optional[str]) -> bool:
    return workdir is not None and os.path.exists(os.path.join(workdir, "STOP"))


def _sync(metrics) -> None:
    """Wait for the step's device work (the JAX loop's block_until_ready)."""
    t = metrics["total"]
    if isinstance(t, torch.Tensor) and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _record(metrics) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def train_bsq(
    state: Dict,
    ctx: BSQTrainContext,
    train_step: Callable,
    requant_step: Callable,
    data_iter: Iterator,
    tcfg: TrainerConfig,
    eval_fn: Optional[Callable] = None,
) -> Dict:
    """Run the BSQ phase.  Returns dict(state=, history=, scheme=, stragglers=).

    With a workdir holding checkpoints the run resumes from the newest
    complete one (its leaves land where ``state``'s are)."""
    history = []
    monitor = StragglerMonitor(tcfg.straggler_ema, tcfg.straggler_factor)
    start_step = int(state["step"])
    if tcfg.workdir:
        os.makedirs(tcfg.workdir, exist_ok=True)
        restored, step_found = ckpt.restore_latest(state, tcfg.workdir)
        if restored is not None:
            state = restored
            start_step = step_found
            print(f"[trainer] resumed from step {step_found}")

    pending_save = None
    for i in range(start_step, tcfg.total_steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        _sync(metrics)
        dt = time.perf_counter() - t0
        if monitor.observe(i, dt):
            print(f"[straggler] step {i} took {dt:.3f}s (ema {monitor.ema:.3f}s)")

        if (i + 1) % tcfg.requant_interval == 0:
            state = requant_step(state)
            scheme = extract_scheme(state_reps(state, ctx))
            print(f"[requant] step {i+1}: bits/para={scheme.bits_per_param:.2f} "
                  f"comp={scheme.compression:.2f}x")

        if (i + 1) % tcfg.log_interval == 0 or i == tcfg.total_steps - 1:
            rec = _record(metrics)
            rec["step"] = i + 1
            rec["dt"] = dt
            history.append(rec)

        if tcfg.workdir and (i + 1) % tcfg.ckpt_interval == 0:
            if pending_save is not None:
                pending_save.join()
            pending_save = ckpt.save(state, tcfg.workdir, i + 1, blocking=False)
            ckpt.prune_old(tcfg.workdir, tcfg.keep_ckpts)

        if _should_stop(tcfg.workdir):
            print(f"[trainer] STOP file detected at step {i+1}; checkpointing and exiting")
            if pending_save is not None:
                pending_save.join()
            ckpt.save(state, tcfg.workdir, i + 1, blocking=True)
            break

    if pending_save is not None:
        pending_save.join()

    # final re-quantisation fixes the scheme (paper §3.3 "post-training")
    state = requant_step(state)
    scheme = extract_scheme(state_reps(state, ctx))
    if eval_fn is not None:
        history.append({"step": "final_eval", **eval_fn(state)})
    if tcfg.workdir:
        with open(os.path.join(tcfg.workdir, "scheme.json"), "w") as f:
            f.write(scheme.to_json())
        with open(os.path.join(tcfg.workdir, "history.json"), "w") as f:
            json.dump(history, f)
        if monitor.flagged:
            with open(os.path.join(tcfg.workdir, "stragglers.json"), "w") as f:
                json.dump(monitor.flagged, f)
    return {"state": state, "history": history, "scheme": scheme,
            "stragglers": monitor.flagged}


def simple_train_loop(state, train_step, data_iter, steps: int, log_every: int = 10):
    """Minimal loop for baselines (no BSQ machinery)."""
    history = []
    for i in range(steps):
        state, metrics = train_step(state, next(data_iter))
        if (i + 1) % log_every == 0 or i == steps - 1:
            history.append({"step": i + 1, **_record(metrics)})
    return state, history
