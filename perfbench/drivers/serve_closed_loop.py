"""The ``serve_closed_loop`` driver: a closed loop of ``clients`` =
``n_slots`` clients in front of the continuous scheduler.

The benchmark makes the weights (``harness.weights``), the program packs
its leaves and serves them through ``ContinuousScheduler.stream`` over a
FIFO backlog: the first wave (one request a client) is sent when the
stream starts, and each later request when the request it follows
finishes (the moment its ``Result`` is yielded), as a gateway that keeps
every lane busy does.  Each request's span events are taken as its
``Result`` arrives (the recorder's ring of completed traces is bounded),
and those still open when the loop stops are taken then.

The window opens at the first result after every request of the first
wave has its first token: the burst of the first wave's prompts is
through, every shape the traffic uses has run, and each lane serves its
residual; it closes ``--seconds`` later; tokens count by their events' host times.  With
``--trace 1`` the loop then runs a further slice under the profiler.
Last, with the program freed, a sample of the requests finished in the
window is run through the plain reference and each served token's logit
is held against the reference's best."""
from __future__ import annotations

import sys
import time
from typing import Callable, Optional
from unittest import mock

import numpy as np
import torch

from perfbench.counts.model import LM
from perfbench.harness import device as dev_mod
from perfbench.harness import profile as prof_mod
from perfbench.harness import program, traffic, weights, window
from perfbench.reference.lm import Model

TOKEN_EVENTS = ("first_token", "decode_step")


def _snapshot(sched, occ, reg) -> dict:
    rows, blocks = reg.histogram("serve_live_rows"), reg.histogram("serve_blocks_used")
    return {"t": time.perf_counter(), "decode_ms_total": sched.decode_ms_total,
            "decode_steps": sched.decode_steps, "prefill_chunks": sched.prefill_chunks,
            "occ_sum": occ.sum, "occ_count": occ.count, "rows_sum": rows.sum,
            "blocks_sum": blocks.sum, "pool_count": blocks.count,
            "preemptions": sched.preemptions_total()}


def pool_policy(serve: dict) -> dict:
    """The paged pool of ``pool_blocks`` blocks, admitted against every
    lane at its longest: a pool smaller than that preempts only when the
    live rows outgrow it."""
    bs = int(serve["block_size"])
    worst = int(serve["n_slots"]) * -(-int(serve["max_len"]) // bs)
    pool = int(serve["pool_blocks"])
    return {"block_size": bs, "n_blocks": pool,
            "overcommit": 1.0 if pool >= worst else (worst + 0.5) / pool}


def pool_in_window(edges: dict, kv_bytes_per_row: int) -> dict:
    """Mean live K/V rows and pool blocks over the window's decode steps,
    and the preemptions in it."""
    a, b = edges["open"], edges["close"]
    n = max(b["pool_count"] - a["pool_count"], 1)
    rows = (b["rows_sum"] - a["rows_sum"]) / n
    return {"live_rows": rows, "live_kv_bytes": rows * kv_bytes_per_row,
            "blocks_used": (b["blocks_sum"] - a["blocks_sum"]) / n,
            "preemptions": b["preemptions"] - a["preemptions"]}


def sample_for_check(finished, rng, want_tokens: int, min_requests: int):
    """The longest finished request and others drawn from ``rng`` until
    the sample holds ``want_tokens`` served tokens and ``min_requests``
    requests."""
    order = sorted(finished, key=lambda r: -(len(r["prompt"]) + len(r["tokens"])))
    picked = [order[0]] if order else []
    rest = [order[i] for i in rng.permutation(len(order) - 1) + 1] if len(order) > 1 else []
    for r in rest:
        if sum(len(p["tokens"]) for p in picked) >= want_tokens and len(picked) >= min_requests:
            break
        picked.append(r)
    return picked


def served_logits(model: Model, sample, device):
    """Per sampled request, the model's logits at each position that served
    a token: the prompt and the served tokens but the last go in."""
    seqs, rows = [], []
    for r in sample:
        P, toks = len(r["prompt"]), np.asarray(r["tokens"], np.int64)
        seqs.append(torch.from_numpy(np.concatenate([r["prompt"], toks[:-1]]).astype(np.int64)
                                     ).to(device))
        rows.append(torch.arange(P - 1, P - 1 + len(toks), device=device))
    return model.logits(seqs, rows)


def gaps(ref_logits, tokens):
    """Per request: the reference's best logit minus its logit of each token."""
    out = []
    for lg, t in zip(ref_logits, tokens):
        t = torch.as_tensor(np.asarray(t, np.int64), device=lg.device)
        out.append((lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0]).cpu().numpy())
    return out


def readings(g) -> dict:
    """The compared numbers: the widest and the mean gap over every sampled
    served token (infinite where nothing was sampled)."""
    if not g:
        return {"max_logit_gap": float("inf"), "mean_logit_gap": float("inf")}
    g = np.concatenate(g)
    return {"max_logit_gap": float(g.max()), "mean_logit_gap": float(g.mean())}


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        patches: Optional[Callable] = None, control: bool = False) -> dict:
    """One run of the cell; ``control`` also reads the control (the
    reference in float8 in the program's place) on the same sample."""
    from repro_torch.core.packing import pack_model_params
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.scheduler import SchedulerPolicy

    conf, tr = cell.config, cell.traffic
    prog, serve = conf["program"], conf["serve"]
    lm = LM.from_program(prog)
    cfg = program.model_config(prog)
    sync = lambda: dev_mod.sync(device)  # noqa: E731
    n_slots, max_len = int(serve["n_slots"]), int(serve["max_len"])
    C = int(serve["chunk_sizes"][-1])

    w = weights.make_flat(lm, seed, device, cfg.compute_dtype,
                          float(conf.get("init", {}).get("embed_std", 0.02)))  # kept for the reference
    params = pack_model_params(weights.nest(w), int(serve["packed_bits"]))
    policy = SchedulerPolicy(
        n_slots=n_slots, chunked_prefill=True, chunk_sizes=tuple(serve["chunk_sizes"]),
        paged=True, paged_kernel=True, **pool_policy(serve))
    engine = ServeEngine(params, cfg, max_len=max_len, device=device, continuous=True,
                         policy=policy)
    del params
    t_built = time.perf_counter()
    sched, rec = engine.scheduler, engine.obs.recorder
    reg = engine.obs.registry
    occ = reg.histogram("serve_occupancy")

    made = traffic.chat_requests(tr, n_slots, seed, lm.vocab)
    reqs = [Request(uid=i, tokens=t, max_new=n, temperature=0.0)
            for i, (t, n) in enumerate(made)]
    sent, traces, finished_at, answers = {}, {}, {}, {}
    waiting = set(range(min(n_slots, len(reqs))))  # the first wave, before its first token
    profile_s = float(tr["profile_seconds"])
    edges, slc, slice_edges = {}, None, None

    ctxm = patches() if patches is not None else mock.patch.dict({})
    with ctxm:
        t_stream = time.perf_counter()
        for i in range(min(n_slots, len(reqs))):
            sent[i] = t_stream
        stream = sched.stream(reqs)
        k, phase, attempts = 0, "warmup", 0
        prof_cm = got = None
        for res in stream:
            t = time.perf_counter()
            trc = rec.completed[-1]
            if trc.uid != res.uid:
                raise RuntimeError(f"result {res.uid} arrived without its trace")
            traces[res.uid], finished_at[res.uid], answers[res.uid] = trc, t, res.tokens
            if n_slots + k < len(reqs):
                sent[n_slots + k] = t
            k += 1
            if phase == "warmup":
                waiting = {u for u in waiting if u not in traces
                           and rec.active[u].find("first_token") is None}
                if not waiting:
                    edges["open"] = _snapshot(sched, occ, reg)
                    phase = "window"
                    print(f"perfbench: set-up {edges['open']['t'] - t_start:.1f} s (weights "
                          f"and packing {t_built - t_start:.1f} s, warm-up "
                          f"{edges['open']['t'] - t_stream:.1f} s, {k} results)",
                          file=sys.stderr, flush=True)
            elif phase == "window" and t >= edges["open"]["t"] + seconds:
                edges["close"] = _snapshot(sched, occ, reg)
                if n_slots + k >= len(reqs):
                    raise RuntimeError("the backlog ran dry inside the window: raise "
                                       "the traffic's backlog")
                if not trace:
                    break
                phase = "profile"
            if phase == "profile" and prof_cm is None:
                prof_cm = prof_mod.profiled(sync)
                got = prof_cm.__enter__()
                slice_edges = [_snapshot(sched, occ, reg)]
            elif phase == "profile" and t >= slice_edges[0]["t"] + profile_s:
                slice_edges.append(_snapshot(sched, occ, reg))
                prof_cm.__exit__(None, None, None)
                slc, prof_cm = got["slice"], None
                attempts += 1
                if slc.kernels or torch.device(device).type != "cuda" or attempts >= 3:
                    break
        if prof_cm is not None:
            prof_cm.__exit__(None, None, None)
        for trc in list(rec.active.values()):  # requests still in flight
            traces.setdefault(trc.uid, trc)
        stream.close()
    if "close" not in edges:
        raise RuntimeError("the stream ended before the window closed")
    peak = dev_mod.peak_bytes(device)
    del engine, sched, stream
    dev_mod.free(device)

    t0 = edges["open"]["t"]
    t1 = t0 + seconds
    times = {u: [e.ts for e in trc.events if e.kind in TOKEN_EVENTS] for u, trc in traces.items()}
    summary = window.window_summary(times, sent, t0, t1)
    pool = pool_in_window(edges, lm.kv_bytes_per_token(cfg.cache_dtype.itemsize))
    print(f"perfbench: K/V in the window: {pool['live_rows']:.0f} live rows "
          f"({pool['live_kv_bytes'] / 1e9:.2f} GB) in {pool['blocks_used']:.0f} of "
          f"{policy.n_blocks} pool blocks on average, {pool['preemptions']:.0f} preemptions; "
          f"{summary['first_tokens']} first tokens, {summary['tokens']} tokens",
          file=sys.stderr, flush=True)

    # -- correctness: every answer due in the window, and a sample of them
    # held against the reference
    due = sorted(u for u, t in finished_at.items() if t0 <= t <= t1)
    bad = {u for u in due if len(answers[u]) != reqs[u].max_new
           or int(np.min(answers[u])) < 0 or int(np.max(answers[u])) >= lm.vocab}
    rng = np.random.default_rng(int(seed))
    sample = sample_for_check(
        [{"uid": u, "prompt": reqs[u].tokens, "tokens": answers[u]} for u in due if u not in bad],
        rng, int(tr["check_tokens"]), int(tr["check_min_requests"]))
    model = Model(prog, w, serve["packed_leaves"], n_bits=int(serve["packed_bits"]))
    ref = served_logits(model, sample, device) if sample else []
    got = gaps(ref, [r["tokens"] for r in sample])
    read = readings(got)
    limits = conf["check"]["limits"]
    bad |= {r["uid"] for r, g in zip(sample, got)
            if "max_logit_gap" in limits and float(g.max()) > float(limits["max_logit_gap"])}
    controls = None
    if control and sample:
        low = Model(prog, w, serve["packed_leaves"], precision="fp8",
                    n_bits=int(serve["packed_bits"]))
        picks = [lg.argmax(dim=-1).cpu().numpy() for lg in served_logits(low, sample, device)]
        controls = readings(gaps(ref, picks))
    want = min(int(tr["check_tokens"]), sum(len(answers[u]) for u in due))
    checks = {k: {"value": read[k], "limit": float(v)} for k, v in limits.items()}
    checks["checked_tokens"] = {"value": int(sum(len(g) for g in got)), "limit": want}
    checks["wrong_answers"] = {"value": len(bad), "limit": 0}
    correct = (not bad and bool(due) and checks["checked_tokens"]["value"] >= want
               and all(read[k] <= float(v) for k, v in limits.items()))
    return {
        "correct": correct, "attempted": len(due), "failed": len(bad),
        "end_to_end": {"serve_tokens_per_s": summary["serve_tokens_per_s"],
                       "ttft_p90_ms": summary["ttft_p90_ms"],
                       "itl_p95_ms": summary["itl_p95_ms"],
                       "setup_s": t0 - t_start},
        "memory_peak_bytes": peak, "checks": checks, "slice": slc, "control": controls,
        "ctx": {"kind": "serve", "lm": lm, "serve": serve, "C": C, "n_slots": n_slots,
                "edges": edges, "slice_edges": slice_edges, "slice": slc, "seconds": seconds,
                "traces": traces, "prompt_len": {r.uid: len(r.tokens) for r in reqs},
                "summary": summary, "pool": pool},
    }
