"""Serving launcher: draw a model, optionally pack it, serve requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 8 --max-new 32 --packed-bits 6 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --paged \
        --paged-kernel --slots 4 --block-size 16 --arrival-rate 0.5 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --prompt-len 12 --max-new 20 --packed-bits 6 [--device cpu]

The bucketed, continuous, chunked and paged paths of
``repro.launch.serve``, with the same flags and print lines (the
``[continuous]`` line has no compiled-program counts: eager PyTorch
compiles nothing).  It serves the reduced config, as the JAX launcher
does, and runs on the card unless ``--device cpu`` is given.

The JAX launcher's speculative, overcommit, SLO-tier, precision-tier,
degrade and mesh flags are accepted and exit with a one-line "not yet
ported" message.
"""
import argparse

import numpy as np

_UNPORTED_SWITCHES = ("--spec-decode", "--degrade")
_UNPORTED_VALUES = ("--data-parallel", "--model-parallel", "--overcommit", "--draft-planes",
                    "--gamma", "--tier", "--precision-tier", "--economy-planes",
                    "--degrade-queue-depth", "--degrade-hysteresis")


def poisson_arrivals(n: int, rate: float, seed: int = 0):
    """Arrival steps of a simulated Poisson stream: exponential gaps with
    mean 1/rate decode steps, cumulated and floored onto the scheduler's
    integer step clock (``repro.launch.serve.poisson_arrivals``)."""
    if rate <= 0:
        return [0] * n
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(scale=1.0 / rate, size=n)
    return np.floor(np.cumsum(gaps)).astype(int).tolist()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--mixed-lens", action="store_true",
                    help="cycle prompt lengths around --prompt-len")
    ap.add_argument("--packed-bits", type=int, default=0,
                    help="serve bit-plane-packed weights at this precision (0 = float)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve Prometheus text at /metrics on this port "
                         "(0 = ephemeral, printed at startup; omit to disable)")
    ap.add_argument("--trace-out", default=None,
                    help="dump the flight recorder's request traces as JSONL")
    ap.add_argument("--chrome-trace-out", default=None,
                    help="write a chrome://tracing document of the request spans")
    ap.add_argument("--flight-recorder", type=int, default=256,
                    help="keep the last N completed request traces")
    ap.add_argument("--smoke", action="store_true",
                    help="after serving, validate the metrics exposition and the "
                         "trace schema, and print OBS_SMOKE_OK")
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the slot-pool continuous-batching scheduler")
    ap.add_argument("--slots", type=int, default=8, help="slot-pool lanes (continuous mode)")
    ap.add_argument("--chunked-prefill", action="store_true",
                    help="stream prompts through the pooled step in fixed-size chunks "
                         "(continuous mode)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV: a global pool of fixed-size blocks + per-lane block "
                         "tables (continuous mode; implies --chunked-prefill)")
    ap.add_argument("--block-size", type=int, default=32, help="rows per KV block (--paged)")
    ap.add_argument("--blocks", type=int, default=0,
                    help="KV blocks in the pool (--paged); 0 sizes it to the unpaged "
                         "capacity slots * ceil(max-len / block-size)")
    ap.add_argument("--paged-kernel", action="store_true",
                    help="decode attention walks the block table through the paged-"
                         "attention kernel instead of gathering each lane's whole view "
                         "(--paged)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="simulate Poisson arrivals at this mean rate per decode step "
                         "(continuous mode; 0 = all requests at step 0)")
    for flag in _UNPORTED_SWITCHES:
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    for flag in _UNPORTED_VALUES:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag in _UNPORTED_SWITCHES + _UNPORTED_VALUES:
        if getattr(args, flag[2:].replace("-", "_")) not in (False, None):
            raise SystemExit(f"{flag} is not yet ported to repro_torch")
    if args.chunked_prefill and not args.continuous:
        raise SystemExit("--chunked-prefill requires --continuous")
    if args.paged and not args.continuous:
        raise SystemExit("--paged requires --continuous")
    if args.paged_kernel and not args.paged:
        raise SystemExit("--paged-kernel requires --paged")

    import torch

    from ..configs import reduced_config
    from ..core.packing import packed_leaves
    from ..data import MarkovLM
    from ..device import resolve_device
    from ..models import init_params
    from ..obs import Observability, get_registry
    from ..serve import Request, ServeEngine

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device, pack_bits=args.packed_bits or None)
    if args.packed_bits:
        packed_bytes = sum(pw.hbm_bytes() for pw in packed_leaves(params))
        print(f"[serve] packed weights at {args.packed_bits}b: "
              f"{packed_bytes / 1e6:.2f} MB global")
    obs = Observability(registry=get_registry(), flight_capacity=args.flight_recorder)
    server = None
    if args.metrics_port is not None:
        from ..obs.export import start_metrics_server

        server = start_metrics_server(obs.registry, port=args.metrics_port)
        print(f"[obs] metrics at {server.url}")
    engine = ServeEngine(params, cfg, max_len=args.max_len, device=device,
                         continuous=args.continuous, n_slots=args.slots,
                         chunked_prefill=args.chunked_prefill, paged=args.paged,
                         block_size=args.block_size, n_blocks=args.blocks or None,
                         paged_kernel=args.paged_kernel, obs=obs)
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    if args.mixed_lens:
        lens = [max(2, args.prompt_len * m // 2) for m in (1, 2, 3, 4)]
    else:
        lens = [args.prompt_len]
    reqs = [
        Request(
            uid=i,
            tokens=task.sample(np.random.default_rng(i), 1, max(lens))[0,
                   : lens[i % len(lens)]].astype(np.int32),
            max_new=args.max_new,
            temperature=args.temperature,
        )
        for i in range(args.requests)
    ]
    if args.continuous:
        results = engine.generate(reqs, arrival_steps=poisson_arrivals(args.requests,
                                                                       args.arrival_rate))
    else:
        results = engine.generate(reqs)
    for r in sorted(results, key=lambda r: r.uid):
        print(f"req {r.uid}: prefill {r.prefill_ms:.1f} ms, "
              f"{r.decode_ms_per_tok:.2f} ms/tok, tokens={r.tokens[:8]}...")
    total = sum(len(r.tokens) for r in results)
    print(f"{total} tokens generated")
    if args.continuous:
        sched = engine.scheduler
        print(f"[continuous] slots={args.slots} occupancy={sched.mean_occupancy():.2f} "
              f"decode_steps={sched.decode_steps}")
        if args.chunked_prefill or args.paged:
            print(f"[chunked] chunk_dispatches={sched.prefill_chunks} "
                  f"admit_bursts={len(sched.admit_bursts)}")
        if args.paged:
            pool = sched.pool
            print(f"[paged] block_size={pool.block_size} n_blocks={pool.n_blocks} "
                  f"kernel={args.paged_kernel} table_shards={pool.table_shards} "
                  f"block_occupancy={sched.mean_block_occupancy():.2f} "
                  f"fragmentation={sched.mean_fragmentation():.2f} "
                  f"leaked_blocks={pool.n_blocks - pool.allocator.free_count}")
    if args.trace_out:
        n = obs.recorder.dump_jsonl(args.trace_out)
        print(f"[obs] {n} request traces -> {args.trace_out}")
    if args.chrome_trace_out:
        obs.recorder.dump_chrome_trace(args.chrome_trace_out)
        print(f"[obs] chrome trace -> {args.chrome_trace_out}")
    if args.smoke:
        _obs_smoke(args, obs, server)
    if server is not None:
        server.close()
    return results


def _obs_smoke(args, obs, server):
    """Scrape once (over HTTP when an endpoint was requested), check the
    exposition parses, the families of the path served are populated, no
    span leaked and the JSONL trace passes the schema check.  Prints
    OBS_SMOKE_OK."""
    from urllib.request import urlopen

    from ..obs import trace as obs_trace
    from ..obs.export import parse_prometheus, to_prometheus

    if server is not None:
        text = urlopen(server.url, timeout=10).read().decode()
    else:
        text = to_prometheus(obs.registry)
    families = parse_prometheus(text)
    required = ["serve_ttft_ms", "serve_requests_total"]
    if args.continuous:
        required += ["serve_occupancy", "serve_decode_step_ms"]
    if args.paged:
        required += ["serve_blocks_alloc_total", "serve_block_pool_free"]
    missing = [f for f in required if f not in families or not families[f]["samples"]]
    if missing:
        raise SystemExit(f"[obs] smoke FAILED: empty/missing families {missing}")
    if obs.recorder.leaked:
        raise SystemExit(f"[obs] smoke FAILED: leaked spans {obs.recorder.leaked}")
    if args.trace_out:
        n = obs_trace.validate_jsonl(args.trace_out)
        if n < args.requests:
            raise SystemExit(f"[obs] smoke FAILED: {n} traces in {args.trace_out} for "
                             f"{args.requests} requests")
    print(f"OBS_SMOKE_OK families={len(families)}")


if __name__ == "__main__":
    main()
