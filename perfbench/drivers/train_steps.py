"""The ``train_steps`` driver: BSQ training of one configuration, a fixed
batch per step, the same step object from set-up through the window.

Set-up builds the program's BSQ state from the benchmark's float weights
(``harness.weights``) and its train step, and drives the step through
the first ``checked_steps`` steps on distinct rows of the feed; after the
first it reads each leaf's gradient off the optimiser state (SGD momentum
after one step is the clipped gradient plus weight decay times the
initial leaf), after the last each leaf's change.  Further warm-up steps
follow, then the window: steps until ``--seconds`` have passed, each
ending at a synchronise.  After the window (with ``--trace 1``) a few
more steps run under the profiler.  Last, with the program's state
freed, the reference follows the checked steps from the same weights and
rows and the readings are compared."""
from __future__ import annotations

import math
import sys
import time
from typing import Callable, Dict, Optional
from unittest import mock

import torch

from perfbench.counts.model import LM
from perfbench.harness import device as dev_mod
from perfbench.harness import profile as prof_mod
from perfbench.harness import program, traffic, weights
from perfbench.reference import bsq as ref_bsq


def _state_leaves(part: dict) -> Dict[str, torch.Tensor]:
    """``reps/<w>/wp|wn|scale`` and ``float/<w>`` of a trainable-shaped tree."""
    out = {f"reps/{n}/{k}": t for n, r in part["reps"].items() for k, t in r.items()}
    out.update({f"float/{n}": t for n, t in part["float"].items()})
    return out


def _gap(prog: Dict[str, float], ref: Dict[str, float], counted) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or the median leaf's, whichever
    is larger."""
    vals = sorted(ref[k] for k in counted)
    med = vals[len(vals) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in counted)


def readings(got: dict, ref: dict, tiny: float) -> dict:
    """The compared numbers of ``got`` (losses, grad_norms, change_norms)
    against the reference's: leaves whose reference gradient is under
    ``tiny`` of the median leaf's are left out (they move by rounding)."""
    vals = sorted(ref["grad_norms"].values())
    med = vals[len(vals) // 2]
    counted = [k for k, v in ref["grad_norms"].items() if v >= tiny * med]
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
        "grad_norm_gap": _gap(got["grad_norms"], ref["grad_norms"], counted),
        "change_norm_gap": _gap(got["change_norms"], ref["change_norms"], counted),
    }, sorted(set(ref["grad_norms"]) - set(counted))


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        patches: Optional[Callable] = None, control: bool = False) -> dict:
    """One run of the cell; ``control`` also reads the control (the
    reference in float8 in the program's place) against the reference."""
    from repro_torch.core.bsq import BSQConfig
    from repro_torch.models import transformer
    from repro_torch.optim import SGDM, step_decay
    from repro_torch.train.step import init_bsq_state, make_bsq_train_step

    conf, tr = cell.config, cell.traffic
    prog, bsq = conf["program"], conf["bsq"]
    lm = LM.from_program(prog)
    cfg = program.model_config(prog)
    sync = lambda: dev_mod.sync(device)  # noqa: E731
    B, S = int(tr["batch"]), int(tr["seq_len"])

    w0 = weights.make_flat(lm, seed, device, torch.float32,
                           float(conf.get("init", {}).get("embed_std", 0.02)))  # kept for the reference
    given = weights.nest({k: v.clone() for k, v in w0.items()})  # the program trains these
    bsq_cfg = BSQConfig(n_init=int(bsq["n_init"]), n_max=int(bsq["n_max"]),
                        alpha=float(bsq["alpha"]), reweigh=True, mode="static",
                        compute_dtype=torch.bfloat16)
    opt = SGDM(momentum=float(bsq["momentum"]), weight_decay=float(bsq["weight_decay"]))
    with mock.patch.object(transformer, "init_params", lambda *a, **k: given):
        state, ctx = init_bsq_state(torch.Generator(device=device), cfg, bsq_cfg, opt, device)
    del given
    t_built = time.perf_counter()
    quantised = sorted(ctx.meta)
    step = make_bsq_train_step(ctx, opt, step_decay(float(bsq["lr"]), []),
                               grad_clip=float(bsq["grad_clip"]))

    rows = torch.from_numpy(traffic.markov_rows(tr["markov"], seed, lm.vocab,
                                                int(tr["distinct_rows"]) * B, S + 1)).to(device)

    n_batches = rows.shape[0] // B

    def batch(i: int) -> dict:
        r = rows.view(n_batches, B, S + 1)[i % n_batches]
        return {"tokens": r[:, :-1], "labels": r[:, 1:]}

    ctxm = patches() if patches is not None else mock.patch.dict({})
    with ctxm:
        # -- set-up: the checked steps, read as they go ----------------------
        t_readings = 0.0
        losses, grad_norms, change_norms = [], {}, {}
        wd = float(bsq["weight_decay"])
        n_checked = int(tr["checked_steps"])
        for i in range(n_checked):
            state, m = step(state, batch(i))
            losses.append(float(m["total"]))
            if i == 0:
                t = time.perf_counter()
                mom = _state_leaves(state["opt"])
                for name, p0 in ref_bsq.initial_leaves(w0, quantised, bsq):
                    grad_norms[name] = float(torch.linalg.vector_norm(mom[name] - wd * p0))
                del mom
                t_readings += time.perf_counter() - t
        t = time.perf_counter()
        now = _state_leaves(state["trainable"])
        for name, p0 in ref_bsq.initial_leaves(w0, quantised, bsq):
            change_norms[name] = float(torch.linalg.vector_norm(now[name] - p0))
        del now
        t_readings += time.perf_counter() - t
        i = n_checked
        for _ in range(int(tr["warmup_steps"])):
            state, _ = step(state, batch(i))
            i += 1
        sync()

        # -- the window -----------------------------------------------------
        t0 = time.perf_counter()
        setup_s = t0 - t_start - t_readings
        print(f"perfbench: set-up {setup_s:.1f} s (the state built {t_built - t_start:.1f} s; "
              f"the readings, left out, {t_readings:.1f} s)", file=sys.stderr, flush=True)
        steps, nonfinite, t_last = 0, 0, t0
        while True:
            state, m = step(state, batch(i))
            sync()
            i += 1
            steps += 1
            nonfinite += not math.isfinite(float(m["total"]))
            t_last = time.perf_counter()
            if t_last - t0 >= seconds:
                break
        window_s = t_last - t0

        # -- the traced slice, after the window ------------------------------
        slc, prof_steps = None, int(tr["profile_steps"])
        if trace:
            for _ in range(3):  # a trace with no device activity is taken again
                with prof_mod.profiled(sync) as got:
                    for _ in range(prof_steps):
                        state, _ = step(state, batch(i))
                        i += 1
                slc = got["slice"]
                if slc.kernels or torch.device(device).type != "cuda":
                    break
    peak = dev_mod.peak_bytes(device)
    del state, step, ctx, m
    dev_mod.free(device)

    # -- the reference follows the checked steps -------------------------------
    checked = [(batch(k)["tokens"], batch(k)["labels"]) for k in range(n_checked)]
    ref = ref_bsq.follow(prog, w0, quantised, bsq, checked)
    tiny = float(conf["check"]["unmoved_leaf_share"])
    got = {"losses": losses, "grad_norms": grad_norms, "change_norms": change_norms}
    read, left_out = readings(got, ref, tiny)
    controls = None
    if control:
        controls, _ = readings(ref_bsq.follow(prog, w0, quantised, bsq, checked,
                                              precision="fp8"), ref, tiny)
    limits = conf["check"]["limits"]
    checks = {k: {"value": read[k], "limit": v} for k, v in limits.items()}
    print(f"perfbench: readings {read}; leaves left out (reference gradient under "
          f"{tiny} of the median leaf's): {left_out}", file=sys.stderr, flush=True)
    correct = all(v["value"] <= v["limit"] for v in checks.values()) and nonfinite == 0
    tokens = steps * B * S
    return {
        "correct": correct, "attempted": steps, "failed": nonfinite,
        "end_to_end": {"train_tokens_per_s": tokens / window_s, "setup_s": setup_s},
        "memory_peak_bytes": peak, "checks": checks, "slice": slc, "control": controls,
        "ctx": {"kind": "train", "lm": lm, "bsq": bsq, "steps": steps, "window_s": window_s,
                "seq_len": S, "batch": B, "slice": slc, "profile_steps": prof_steps,
                "bgl_elements": 2 * int(bsq["n_max"]) * sum(w0[n].numel() for n in quantised),
                "bgl_rows": 2 * int(bsq["n_max"]) * sum(w0[n].shape[0] if w0[n].ndim > 2 else 1
                                                        for n in quantised),
                "left_out": left_out,
                "losses": losses, "ref_losses": ref["losses"]},
    }
