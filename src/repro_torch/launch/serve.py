"""Serving launcher: draw a model, optionally pack it, serve requests.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 8 --max-new 32 --packed-bits 6 [--device cpu]

The bucketed path of ``repro.launch.serve``, with the same flags and
print lines: requests are grouped by prompt length and served by the
bucketed :class:`~repro_torch.serve.ServeEngine`.  It serves the
reduced config, as the JAX launcher does.  It runs on the card unless
``--device cpu`` is given.

The JAX launcher's continuous, chunked, paged, speculative,
precision-tier and mesh flags are accepted and exit with a one-line
"not yet ported" message.
"""
import argparse

import numpy as np

_UNPORTED_SWITCHES = ("--continuous", "--chunked-prefill", "--paged", "--paged-kernel",
                      "--spec-decode", "--degrade")
_UNPORTED_VALUES = ("--data-parallel", "--model-parallel", "--slots", "--block-size",
                    "--blocks", "--overcommit", "--draft-planes", "--gamma", "--tier",
                    "--precision-tier", "--economy-planes", "--degrade-queue-depth",
                    "--degrade-hysteresis", "--arrival-rate")


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
    for flag in _UNPORTED_SWITCHES:
        ap.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    for flag in _UNPORTED_VALUES:
        ap.add_argument(flag, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    for flag in _UNPORTED_SWITCHES + _UNPORTED_VALUES:
        if getattr(args, flag[2:].replace("-", "_")) not in (False, None):
            raise SystemExit(f"{flag} is not yet ported to repro_torch (bucketed serving only)")

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
    engine = ServeEngine(params, cfg, max_len=args.max_len, device=device, obs=obs)
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
    results = engine.generate(reqs)
    for r in sorted(results, key=lambda r: r.uid):
        print(f"req {r.uid}: prefill {r.prefill_ms:.1f} ms, "
              f"{r.decode_ms_per_tok:.2f} ms/tok, tokens={r.tokens[:8]}...")
    total = sum(len(r.tokens) for r in results)
    print(f"{total} tokens generated")
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
    exposition parses, the bucketed families are populated, no span
    leaked and the JSONL trace passes the schema check.  Prints
    OBS_SMOKE_OK."""
    from urllib.request import urlopen

    from ..obs import trace as obs_trace
    from ..obs.export import parse_prometheus, to_prometheus

    if server is not None:
        text = urlopen(server.url, timeout=10).read().decode()
    else:
        text = to_prometheus(obs.registry)
    families = parse_prometheus(text)
    missing = [f for f in ("serve_ttft_ms", "serve_requests_total")
               if f not in families or not families[f]["samples"]]
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
