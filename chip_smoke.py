#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``repro_torch`` only (never JAX, never ``repro``), in phases; any
failure exits non-zero and none is caught:

1. build the CUDA kernel library from ``src/repro_torch/kernels/csrc``;
2. hold the bitserial kernel against its plain PyTorch version at the
   main path's shapes (f32 and bf16, per-tensor and per-group scales),
   check ``active=a`` bitwise against ``truncate_packed`` for every a,
   and time the kernel, the plain version and ``torch.matmul`` against
   the dequantised weight (a yardstick only; the port never calls it);
3. full-width granite-3-2b cut to 2 layers, f32, 6-bit packed: the card
   (kernel) against the CPU (plain path) on the same params;
4. the slice: full-width 40-layer granite-3-2b, bf16, 6-bit packed,
   served by the bucketed ServeEngine (8 requests, two buckets, 32
   tokens each), with the kernel's launch count checked exactly;
5. ``torch.profiler`` over a few decode steps of one bucket: device
   busy time, idle share and the device ops by time;
6. a ``{"kernels": [...]}`` line, the card's name and power limit, and
   the final ``{"ok": true, ...}`` line.

Exits non-zero without a CUDA device, and when the repo's ``src`` is not
beside it.  The per-shape table goes to ``chiprun_out/chip_smoke.json``.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 outside tensor cores; bf16 dense
N_BITS = 6
MATMUL_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
# the 7 projections of one granite-3-2b layer, as (K, N)
LAYER_PROJ = [(2048, 2048), (2048, 512), (2048, 512), (2048, 2048),
              (2048, 8192), (2048, 8192), (8192, 2048)]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of max |plain|, see phase 2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def check(ok, what) -> None:
    """Fail the run (an assert would vanish under ``python -O``)."""
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def bound_ms(M, K, N, dtype_name, n_bits=N_BITS, groups=1):
    elt = 4 if dtype_name == "float32" else 2
    nbytes = M * K * elt + (n_bits + 1) * (K // 8) * N + 4 * groups + M * N * elt
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2.0 * M * K * N / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def profile_decode(engine, reqs, cfg, card, steps=4):
    """Where a decode step's time goes: torch.profiler over ``steps``
    decode steps of one bucket, after the counted run.  Device busy time
    is the sum of the device events (one stream, so they do not
    overlap); the idle share is 1 - busy / wall under the profiler."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer

    dev = engine.device
    plen = len(reqs[0].tokens)
    with torch.inference_mode():
        prompts = torch.from_numpy(np.stack([r.tokens for r in reqs]).astype(np.int64)).to(dev)
        logits, cache = transformer.prefill(engine.params, {"tokens": prompts}, cfg,
                                            engine.max_len)
        tok = logits.argmax(-1, keepdim=True)
        logits, cache = transformer.decode_step(engine.params, cache, tok, plen, cfg)
        tok = logits.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for t in range(steps):
                logits, cache = transformer.decode_step(engine.params, cache, tok,
                                                        plen + 1 + t, cfg)
                tok = logits.argmax(-1, keepdim=True)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    if not by_name:
        print(f"[profile] decode step: wall {wall_ms:.2f} ms under the profiler; device "
              f"time not measured (the profiler saw no device events) [{card}]")
        return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": None}
    busy = sum(t for t, _ in by_name.values()) / steps
    ops = sum(n for _, n in by_name.values()) / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[profile] decode step, bucket of {len(reqs)}, {cfg.n_layers} layers: wall "
          f"{wall_ms:.2f} ms under the profiler, device busy {busy:.2f} ms "
          f"(idle {1 - busy / wall_ms:.1%}), {ops:.0f} device ops per step [{card}]")
    for name, (t, n) in top:
        print(f"[profile]   {t / steps:8.3f} ms/step {n / steps:6.0f}x  {name[:90]}")
    return {"wall_ms_per_step": wall_ms, "device_busy_ms_per_step": busy,
            "device_ops_per_step": ops,
            "top": [{"name": k, "ms_per_step": t / steps, "count_per_step": n / steps}
                    for k, (t, n) in top]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.packing import (pack_from_float, packed_leaves, tree_to,
                                          truncate_packed, unpack_to_float)
    from repro_torch.data import MarkovLM
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitserial_matmul as bsm
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer
    from repro_torch.serve import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    report = {"card": card, "matmul": []}

    # ---------------------------------------------------------------- 1
    t0 = time.perf_counter()
    lib_path = _build.build("bitserial_matmul")
    bsm._lib()
    print(f"[build] bitserial_matmul.cu -> {lib_path.name} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for line in _build.build_log["bitserial_matmul"]["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # ---------------------------------------------------------------- 2
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)  # > the 50 MB L2

    def time_ms(fn, iters=10):
        """Median device time of fn with the L2 flushed before each call."""
        fn()
        fn()
        times = []
        for _ in range(iters):
            flush.zero_()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    gen = torch.Generator(device=dev).manual_seed(0)
    max_err = 0.0
    for M in (4, 512):
        for K, N in MATMUL_SHAPES:
            w = torch.randn((K, N), generator=gen, device=dev) / K**0.5
            for groups in (None, 16):
                pw = pack_from_float(w, N_BITS, group_cols=groups)
                w_deq = unpack_to_float(pw)
                for dt in (torch.float32, torch.bfloat16):
                    dname = str(dt).split(".")[-1]
                    x = torch.randn((M, K), generator=gen, device=dev).to(dt)
                    got = ops.bitserial_matmul(x, pw)
                    want = ref.bitserial_matmul_ref(x, pw.planes, pw.sign, pw.scale, N_BITS)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    scale_ = want.float().abs().max().item()
                    # f32: the two differ only by the order of the sums and the
                    # epilogue's rounding; bf16: the plain version rounds x @ w
                    # to bf16 before the scale, the kernel scales the f32 sum
                    check(bool(torch.isfinite(got).all()) and err <= TOL[dname] * scale_,
                          f"kernel vs plain at M={M} K={K} N={N} groups={groups} {dname}: "
                          f"max err {err} > {TOL[dname]} x {scale_}")
                    max_err = max(max_err, err)
                    for a in range(1, N_BITS + 1):
                        dyn = ops.bitserial_matmul(x, pw, active_planes=a)
                        static = ops.bitserial_matmul(x, truncate_packed(pw, a))
                        iview = torch.int32 if dt == torch.float32 else torch.int16
                        check(torch.equal(dyn.view(iview), static.view(iview)),
                              f"active={a} != truncate_packed at M={M} K={K} N={N} "
                              f"groups={groups} {dname}")
                    wl = w_deq.to(dt)
                    a_dev = torch.tensor([N_BITS - 2], dtype=torch.int32, device=dev)
                    row = {
                        "M": M, "K": K, "N": N, "dtype": dname,
                        "scale": "per-tensor" if groups is None else f"{groups} groups",
                        "max_abs_err": err, "max_abs_plain": scale_,
                        "ms": time_ms(lambda: ops.bitserial_matmul(x, pw)),
                        # the same kernel reading its active-plane count from
                        # the device (the dyn Pallas kernel's path)
                        "active_ms": time_ms(lambda: ops.bitserial_matmul(
                            x, pw, active_planes=a_dev)),
                        "plain_ms": time_ms(lambda: ref.bitserial_matmul_ref(
                            x, pw.planes, pw.sign, pw.scale, N_BITS), iters=3),
                        "library_ms": time_ms(lambda: torch.matmul(x, wl)),
                    }
                    row["bound_ms"], row["bound_by"] = bound_ms(M, K, N, dname,
                                                                groups=groups or 1)
                    report["matmul"].append(row)
                    print(f"[kernel] M={M} K={K} N={N} {dname} {row['scale']}: "
                          f"max_err={err:.3e} (max|plain|={scale_:.3e}) "
                          f"kernel {row['ms']:.4f} ms (active={N_BITS - 2} from the "
                          f"device {row['active_ms']:.4f} ms), bound {row['bound_ms']:.4f} ms "
                          f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, "
                          f"torch.matmul(dequantised) {row['library_ms']:.4f} ms "
                          f"[{card}]", flush=True)
    print(f"[kernel] all {len(report['matmul'])} shapes agree; active=a bitwise equal "
          f"to truncate_packed for a in 1..{N_BITS}", flush=True)
    del flush

    # ---------------------------------------------------------------- 3
    cfg2 = get_config("granite-3-2b").scaled(n_layers=2, dtype="float32",
                                             kv_cache_dtype="float32")
    p_gpu = transformer.init_params(cfg2, torch.Generator(device=dev).manual_seed(1), dev,
                                    pack_bits=N_BITS)
    p_cpu = tree_to(p_gpu, "cpu")
    prompt = MarkovLM(vocab=cfg2.vocab_size, seed=3).sample(
        np.random.default_rng(0), 1, 16)[0, :16].astype(np.int32)
    first = {}
    toks = {}
    for name, params, d in (("cuda", p_gpu, dev), ("cpu", p_cpu, torch.device("cpu"))):
        with torch.inference_mode():
            first[name], _ = transformer.prefill(
                params, {"tokens": torch.from_numpy(prompt[None]).long().to(d)}, cfg2, 64)
        eng = ServeEngine(params, cfg2, max_len=64, device=d)
        toks[name] = eng.generate([Request(uid=0, tokens=prompt, max_new=8)])[0].tokens
    dlog = (first["cuda"].cpu() - first["cpu"]).abs().max().item()
    lmax = first["cpu"].abs().max().item()
    print(f"[parity] 2-layer full-width f32: greedy cuda {toks['cuda'].tolist()} "
          f"cpu {toks['cpu'].tolist()}; first-step max|dlogit|={dlog:.3e} "
          f"(max|logit|={lmax:.3e})", flush=True)
    check(np.array_equal(toks["cuda"], toks["cpu"]), "greedy tokens differ cuda vs cpu")
    # f32 end to end: sums in another order (kernel, cuBLAS vs the CPU)
    check(dlog <= 1e-4 * max(1.0, lmax), f"first-step logits differ by {dlog}")
    report["parity"] = {"tokens": toks["cuda"].tolist(), "max_abs_dlogit": dlog,
                        "max_abs_logit": lmax}
    del p_gpu, p_cpu

    # ---------------------------------------------------------------- 4
    cfg = get_config("granite-3-2b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev,
                                     pack_bits=N_BITS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    packed_bytes = sum(pw.hbm_bytes() for pw in packed_leaves(params))
    init_peak = torch.cuda.max_memory_allocated()
    print(f"[slice] granite-3-2b {cfg.n_layers} layers d_model={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size}->"
          f"{cfg.padded_vocab} {cfg.dtype}: init+pack {init_s:.1f} s, packed weights "
          f"{packed_bytes / 1e9:.4f} GB, init peak {init_peak / 1e9:.3f} GB [{card}]",
          flush=True)

    class CheckedEngine(ServeEngine):
        """Counts non-finite logits without a host sync per step."""
        bad = None

        def _sample(self, logits, temperatures, any_hot):
            nonfinite = (~torch.isfinite(logits)).sum()
            self.bad = nonfinite if self.bad is None else self.bad + nonfinite
            return super()._sample(logits, temperatures, any_hot)

    engine = CheckedEngine(params, cfg, max_len=512, device=dev)
    task = MarkovLM(vocab=cfg.vocab_size, seed=3)
    lens = [64] * 4 + [128] * 4
    reqs = [Request(uid=i, tokens=task.sample(np.random.default_rng(i), 1, 128)[0, :n]
                    .astype(np.int32), max_new=32) for i, n in enumerate(lens)]
    engine.generate([Request(uid=100, tokens=reqs[0].tokens[:16], max_new=2)])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine.bad = None
    bsm.reset_launches()
    t0 = time.perf_counter()
    results = engine.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = bsm.launches
    expected = 2 * 32 * cfg.n_layers * 7
    peak = torch.cuda.max_memory_allocated()
    gen_toks = np.stack([r.tokens for r in sorted(results, key=lambda r: r.uid)])
    check(gen_toks.shape == (8, 32), f"generated tokens of shape {gen_toks.shape}")
    check(((gen_toks >= 0) & (gen_toks < cfg.vocab_size)).all(), "token outside the vocab")
    check(int(engine.bad.item()) == 0, f"{int(engine.bad.item())} non-finite logits")
    check(launches == expected, f"{launches} bitserial launches, expected {expected}")
    buckets = {}
    for r in results:
        buckets.setdefault(len(reqs[r.uid].tokens), []).append(r)
    slice_rep = {"packed_weight_bytes": packed_bytes, "serve_peak_bytes": peak,
                 "wall_s": wall, "tokens": int(gen_toks.size),
                 "tokens_per_s": gen_toks.size / wall, "launches": launches, "buckets": {}}
    for plen, rs in sorted(buckets.items()):
        ttft = float(np.mean([r.prefill_ms for r in rs]))
        dms = float(np.mean([r.decode_ms_per_tok for r in rs]))
        slice_rep["buckets"][plen] = {"ttft_ms": ttft, "decode_ms_per_step": dms}
        print(f"[slice] bucket prompt={plen} x{len(rs)}: TTFT {ttft:.2f} ms, "
              f"decode {dms:.3f} ms per step (= per token per request) [{card}]")
    print(f"[slice] 8 requests, {gen_toks.size} tokens in {wall:.3f} s = "
          f"{gen_toks.size / wall:.1f} tok/s; serve peak memory {peak / 1e9:.3f} GB; "
          f"bitserial launches {launches} == 2 x 32 x {cfg.n_layers} x 7 [{card}]",
          flush=True)
    report["slice"] = slice_rep
    report["profile"] = profile_decode(engine, reqs[:4], cfg, card)

    # one decode layer's 7 projections at the decode shape (M = 4 lanes, bf16)
    rows = {(r["M"], r["K"], r["N"], r["dtype"], r["scale"]): r for r in report["matmul"]}
    layer = [rows[(4, K, N, "bfloat16", "per-tensor")] for K, N in LAYER_PROJ]
    lb = sum(r["bound_ms"] for r in layer)
    entry = {
        "name": "bitserial_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitserial_matmul.cu",
        "replaces": "src/repro/kernels/bitserial_matmul.py:139",
        "also_replaces": "src/repro/kernels/bitserial_matmul.py:183",
        "launches": launches, "max_abs_err": max_err,
        "ms": sum(r["ms"] for r in layer), "plain_ms": sum(r["plain_ms"] for r in layer),
        "active_ms": sum(r["active_ms"] for r in layer),
        "bound_ms": lb, "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in layer)
        else "operations",
        "library_ms": sum(r["library_ms"] for r in layer),
        "work": "one decode layer of granite-3-2b: its 7 projections at M=4, bf16, 6 bits",
    }
    report["kernels"] = [entry]
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # ---------------------------------------------------------------- 6
    print(json.dumps({"kernels": [entry]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
