"""Serving launcher: draw a model, optionally pack it, serve requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 8 --max-new 32 --packed-bits 6 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --paged \
        --paged-kernel --slots 4 --block-size 16 --arrival-rate 0.5 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b \
        --prompt-len 12 --max-new 20 --packed-bits 6 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --paged \
        --paged-kernel --slots 4 --block-size 16 --blocks 6 --overcommit 2 \
        --packed-bits 6 --spec-decode --draft-planes 3 --gamma 4 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --continuous --paged \
        --packed-bits 6 --precision-tier mixed --economy-planes 3 --degrade \
        --requests 12 --slots 4 --smoke [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --data-parallel 2 \
        --model-parallel 2 --packed-bits 6 --dist-backend gloo [--device cpu]

The bucketed, continuous, chunked and paged paths of
``repro.launch.serve``, with the same flags and print lines (the
``[continuous]`` and ``[spec]`` lines have no compiled-program counts:
eager PyTorch compiles nothing): ``--overcommit`` (recompute-swap
preemption), ``--tier`` (SLO classes), ``--spec-decode`` /
``--draft-planes`` / ``--gamma`` (bit-plane speculative decoding),
``--precision-tier`` / ``--economy-planes`` (precision classes) and
``--degrade`` / ``--degrade-queue-depth`` / ``--degrade-hysteresis``
(load-triggered plane shedding).  It serves the reduced config, as the
JAX launcher does (``--arch qwen2-moe-a2.7b`` and
``--arch phi3.5-moe-42b-a6.6b`` serve their MoE layers; with
``--spec-decode`` they are refused, as in JAX), and runs on the card
unless ``--device cpu`` is given.

``--data-parallel N --model-parallel M`` (given together, as in JAX)
serve any ``--arch`` on an N x M ("data", "model") mesh: the launcher
starts the N*M ranks itself (``launch.mesh.run_on_mesh``), each holding
its block of every weight, of the KV pool and rings and of the lanes'
recurrent state, and rank 0 prints.  ``--dist-backend``
picks the ``torch.distributed`` backend: ``nccl`` (one card per rank, the
default on the card), ``gloo`` (the CPU, the default with ``--device
cpu``; on the card, several ranks sharing one card).
"""
import argparse
import contextlib
import io

import numpy as np


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
    ap.add_argument("--overcommit", type=float, default=1.0,
                    help="admit against this multiple of the pool's physical blocks "
                         "(--paged); > 1.0 enables preemption: a victim lane's blocks are "
                         "reclaimed and its request re-prefills prompt + generated tokens")
    ap.add_argument("--spec-decode", action="store_true",
                    help="bit-plane speculative decoding (--paged, --packed-bits): decode "
                         "lanes self-draft --gamma steps from the --draft-planes most "
                         "significant planes of the same packed weights, then one verify "
                         "chunk scores every drafted position; greedy output equals "
                         "non-speculative decode")
    ap.add_argument("--draft-planes", type=int, default=2,
                    help="active bit planes during draft steps (--spec-decode); must be "
                         "< --packed-bits")
    ap.add_argument("--gamma", type=int, default=4,
                    help="max draft steps per speculative round (--spec-decode)")
    ap.add_argument("--tier", choices=("throughput", "latency", "mixed"),
                    default="throughput",
                    help="SLO class stamped on requests: latency-tier is admitted first "
                         "and preempted last; 'mixed' marks every 4th request latency-tier")
    ap.add_argument("--precision-tier", choices=("full", "economy", "mixed"),
                    default="full",
                    help="precision class stamped on requests (--packed-bits and a "
                         "chunked continuous engine): economy lanes decode at "
                         "--economy-planes active planes; 'mixed' marks every other "
                         "request economy")
    ap.add_argument("--economy-planes", type=int, default=0,
                    help="active bit planes of the economy class (0 = max(1, "
                         "--packed-bits // 2)); in [1, --packed-bits], and above "
                         "--draft-planes under --spec-decode")
    ap.add_argument("--degrade", action="store_true",
                    help="load-triggered plane shedding: under queue, occupancy or "
                         "preemption pressure shed one active plane per step "
                         "(floor-clamped per class) instead of shedding requests, and "
                         "restore with hysteresis")
    ap.add_argument("--degrade-queue-depth", type=int, default=2,
                    help="queue depth (after admission) at which the degrade loop sheds "
                         "a plane (--degrade)")
    ap.add_argument("--degrade-hysteresis", type=int, default=4,
                    help="calm steps before the degrade loop restores a plane (--degrade)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="simulate Poisson arrivals at this mean rate per decode step "
                         "(continuous mode; 0 = all requests at step 0)")
    ap.add_argument("--data-parallel", type=int, default=0,
                    help="mesh 'data' axis size (with --model-parallel)")
    ap.add_argument("--model-parallel", type=int, default=0,
                    help="mesh 'model' axis size (with --data-parallel)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend of the mesh ranks (default: gloo with "
                         "--device cpu, else nccl, which needs one card per rank)")
    args = ap.parse_args(argv)
    if bool(args.data_parallel) != bool(args.model_parallel):
        raise SystemExit("--data-parallel and --model-parallel must be given together "
                         "(use 1 for an unsharded axis)")
    if args.chunked_prefill and not args.continuous:
        raise SystemExit("--chunked-prefill requires --continuous")
    if args.paged and not args.continuous:
        raise SystemExit("--paged requires --continuous")
    if args.paged_kernel and not args.paged:
        raise SystemExit("--paged-kernel requires --paged")
    if args.overcommit != 1.0 and not args.paged:
        raise SystemExit("--overcommit requires --paged (only the block pool has "
                         "commitment accounting)")
    if args.spec_decode and not args.paged:
        raise SystemExit("--spec-decode requires --paged (draft rollback rewinds lane "
                         "positions through the block tables)")
    if args.spec_decode and not args.packed_bits:
        raise SystemExit("--spec-decode requires --packed-bits (drafting truncates the "
                         "packed weight's bit planes)")
    if args.spec_decode and args.temperature > 0:
        raise SystemExit("--spec-decode requires --temperature 0 (greedy verify is what "
                         "makes spec output token-identical)")
    if args.spec_decode and not 1 <= args.draft_planes < args.packed_bits:
        raise SystemExit(f"--draft-planes {args.draft_planes} must be in "
                         f"[1, --packed-bits {args.packed_bits})")
    tiered = args.precision_tier != "full" or args.degrade
    if tiered and not args.packed_bits:
        raise SystemExit("--precision-tier/--degrade require --packed-bits (float weights "
                         "have no bit planes to shed)")
    if tiered and not (args.chunked_prefill or args.paged):
        raise SystemExit("--precision-tier/--degrade require a chunked continuous engine "
                         "(--continuous with --chunked-prefill or --paged)")
    econ_planes = args.economy_planes or max(1, args.packed_bits // 2)
    if args.precision_tier != "full":
        if not 1 <= econ_planes <= args.packed_bits:
            raise SystemExit(f"--economy-planes {econ_planes} must be in "
                             f"[1, --packed-bits {args.packed_bits}]")
        if args.spec_decode and econ_planes <= args.draft_planes:
            raise SystemExit(f"--economy-planes {econ_planes} must exceed --draft-planes "
                             f"{args.draft_planes} (the verify must add information over "
                             "the draft)")

    from ..device import resolve_device

    device = resolve_device(args.device)
    if not args.data_parallel:
        return _serve(args, device, None, econ_planes, tiered)
    from ..dist.elastic import validate_batch_divisibility
    from .mesh import AbstractMesh, run_on_mesh

    shape = {"data": args.data_parallel, "model": args.model_parallel}
    backend = args.dist_backend or ("gloo" if device.type == "cpu" else "nccl")
    print(f"[mesh] data={args.data_parallel} model={args.model_parallel}: "
          f"{args.data_parallel * args.model_parallel} ranks on {device}, backend {backend}")
    # advisory only: a bucket the data axis does not divide runs with its
    # batch axis replicated
    if not validate_batch_divisibility(args.requests, AbstractMesh(shape)):
        print(f"[serve] note: --requests {args.requests} does not divide over the data axis "
              f"({shape}); buckets will run with a replicated batch axis")
    results = run_on_mesh(_serve_rank, args.data_parallel, args.model_parallel,
                          backend=backend, device=device, args=(args, econ_planes, tiered))
    return results[0]


def _serve_rank(mesh, args, econ_planes, tiered):
    """One mesh rank of :func:`main`: rank 0 prints, the others serve
    quietly."""
    quiet = contextlib.redirect_stdout(io.StringIO()) if mesh.rank else contextlib.nullcontext()
    with quiet:
        return _serve(args, mesh.device, mesh, econ_planes, tiered)


def _serve(args, device, mesh, econ_planes, tiered):
    import torch

    from ..configs import reduced_config
    from ..core.packing import packed_leaves
    from ..data import MarkovLM
    from ..models import init_params
    from ..obs import Observability, get_registry
    from ..serve import Request, ServeEngine

    cfg = reduced_config(args.arch)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device, pack_bits=args.packed_bits or None)
    if args.packed_bits:
        packed_bytes = sum(pw.hbm_bytes() for pw in packed_leaves(params))
        print(f"[serve] packed weights at {args.packed_bits}b: "
              f"{packed_bytes / 1e6:.2f} MB global")
    lead = mesh is None or mesh.rank == 0  # the rank that serves metrics and writes traces
    obs = Observability(registry=get_registry(), flight_capacity=args.flight_recorder)
    server = None
    if args.metrics_port is not None and lead:
        from ..obs.export import start_metrics_server

        server = start_metrics_server(obs.registry, port=args.metrics_port)
        print(f"[obs] metrics at {server.url}")
    engine = ServeEngine(params, cfg, max_len=args.max_len, device=device,
                         continuous=args.continuous, n_slots=args.slots,
                         chunked_prefill=args.chunked_prefill, paged=args.paged,
                         block_size=args.block_size, n_blocks=args.blocks or None,
                         paged_kernel=args.paged_kernel, overcommit=args.overcommit,
                         spec_decode=args.spec_decode, draft_planes=args.draft_planes,
                         gamma=args.gamma,
                         precision_tiers=({"economy": econ_planes}
                                          if args.precision_tier != "full" else None),
                         degrade=args.degrade, degrade_queue_depth=args.degrade_queue_depth,
                         degrade_hysteresis=args.degrade_hysteresis, obs=obs, mesh=mesh)
    del params
    if mesh is not None and args.packed_bits:
        print(f"[mesh] rank {mesh.rank}: packed weights {engine.packed_bytes_local / 1e6:.2f} "
              f"MB of {engine.packed_bytes_global / 1e6:.2f} MB global "
              f"({engine.packed_bytes_local / engine.packed_bytes_global:.3f})")
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    if args.mixed_lens:
        lens = [max(2, args.prompt_len * m // 2) for m in (1, 2, 3, 4)]
    else:
        lens = [args.prompt_len]

    def req_tier(i: int) -> str:
        if args.tier == "mixed":
            return "latency" if i % 4 == 0 else "throughput"
        return args.tier

    def req_precision(i: int) -> str:
        if args.precision_tier == "mixed":
            return "economy" if i % 2 else "full"
        return args.precision_tier

    reqs = [
        Request(
            uid=i,
            tokens=task.sample(np.random.default_rng(i), 1, max(lens))[0,
                   : lens[i % len(lens)]].astype(np.int32),
            max_new=args.max_new,
            temperature=args.temperature,
            tier=req_tier(i),
            precision=req_precision(i),
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
        if tiered:
            econ = (f"economy={sched.active_planes('economy')}/{econ_planes}"
                    if args.precision_tier != "full" else "economy=-")
            print(f"[tiers] precision_tier={args.precision_tier} "
                  f"full={sched.active_planes('full')}/{args.packed_bits} {econ} "
                  f"tier_dispatches={sched.tier_dispatches}")
        if args.degrade:
            print(f"[degrade] sheds={sched.degrade_sheds} restores={sched.degrade_restores} "
                  f"events={sched.degrade_events_total()} "
                  f"queue_depth_trigger={args.degrade_queue_depth} "
                  f"hysteresis={args.degrade_hysteresis}")
        if args.paged:
            pool = sched.pool
            print(f"[paged] block_size={pool.block_size} n_blocks={pool.n_blocks} "
                  f"kernel={args.paged_kernel} table_shards={pool.table_shards} "
                  f"block_occupancy={sched.mean_block_occupancy():.2f} "
                  f"fragmentation={sched.mean_fragmentation():.2f} "
                  f"leaked_blocks={pool.n_blocks - pool.allocator.free_count}")
            if args.overcommit != 1.0:
                print(f"[overcommit] factor={args.overcommit} "
                      f"commit_capacity={pool.allocator.commit_capacity}"
                      f"x{pool.allocator.n_shards} preemptions={sched.preemptions_total()}")
            if args.spec_decode:
                print(f"[spec] draft_planes={args.draft_planes} gamma={args.gamma} "
                      f"rounds={sched.spec_rounds} draft_steps={sched.draft_steps} "
                      f"drafted={sched.spec_drafted} accepted={sched.spec_accepted} "
                      f"committed={sched.spec_committed} "
                      f"accept_rate={sched.spec_accept_rate():.2f}")
    if not lead:
        return results
    if args.trace_out:
        n = obs.recorder.dump_jsonl(args.trace_out)
        print(f"[obs] {n} request traces -> {args.trace_out}")
    if args.chrome_trace_out:
        obs.recorder.dump_chrome_trace(args.chrome_trace_out)
        print(f"[obs] chrome trace -> {args.chrome_trace_out}")
    if args.smoke:
        _obs_smoke(args, obs, server, engine)
    if server is not None:
        server.close()
    return results


def _obs_smoke(args, obs, server, engine):
    """Scrape once (over HTTP when an endpoint was requested), check the
    exposition parses, the families of the path served are populated, no
    span leaked and the JSONL trace passes the schema check.  With
    ``--degrade`` the shed-and-restore cycle must have fired (overload
    the pool: more requests than slots, arrivals at step 0) with no
    leaked block.  Prints OBS_SMOKE_OK."""
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
    if args.spec_decode:
        required += ["serve_spec_rounds_total", "serve_spec_accept_total"]
    if args.precision_tier != "full" or args.degrade:
        required += ["serve_active_planes"]
    if args.degrade:
        required += ["serve_degrade_events_total"]
    missing = [f for f in required if f not in families or not families[f]["samples"]]
    if missing:
        raise SystemExit(f"[obs] smoke FAILED: empty/missing families {missing}")
    if obs.recorder.leaked:
        raise SystemExit(f"[obs] smoke FAILED: leaked spans {obs.recorder.leaked}")
    if args.degrade:
        sched = engine.scheduler
        if sched.degrade_sheds < 1 or sched.degrade_restores < 1:
            raise SystemExit(
                f"[obs] smoke FAILED: --degrade ran without a full shed-and-restore cycle "
                f"(sheds={sched.degrade_sheds}, restores={sched.degrade_restores}): "
                "overload the pool (more requests than slots, arrivals at step 0)")
        pool = sched.pool
        if args.paged and pool.n_blocks - pool.allocator.free_count:
            raise SystemExit(f"[obs] smoke FAILED: {pool.n_blocks - pool.allocator.free_count}"
                             " leaked KV blocks after the degrade run")
    if args.trace_out:
        n = obs_trace.validate_jsonl(args.trace_out)
        if n < args.requests:
            raise SystemExit(f"[obs] smoke FAILED: {n} traces in {args.trace_out} for "
                             f"{args.requests} requests")
    print(f"OBS_SMOKE_OK families={len(families)}")


if __name__ == "__main__":
    main()
