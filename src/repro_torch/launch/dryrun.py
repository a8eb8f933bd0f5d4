"""One-card dry run: every (arch x shape) cell on the meta device.

For each cell this builds the real step function (the BSQ or plain train
step for train shapes, ``transformer.decode_step`` for decode shapes, the
prefill ``forward`` for prefill shapes), runs it on meta tensors (shapes
and dtypes, no storage, no card), and records the memory and the
roofline terms of ``roofline.analysis`` against one H100's data-sheet
figures (``roofline.hw``).  PyTorch port of ``repro.launch.dryrun``,
whose records it keeps, on a mesh of one card (label ``"1"``); the
``16x16`` and ``2x16x16`` meshes come with the training mesh slice of the port.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun.json

A record's ``compile_s`` holds the seconds of the meta run that measured
the memory (nothing is compiled); ``memory.temp_bytes`` is the peak of
the bytes the run allocated and still held (``Counter.peak_live``, an
estimate of eager liveness), ``peak_bytes`` that plus the arguments.
Nothing here is measured on a card.
"""
import argparse
import json
import math
import os
import time
import traceback

import torch

from ..configs import ARCH_IDS, SHAPES, get_config, shape_applicable
from ..core.bsq import BSQConfig
from ..core.packing import PackedWeight, pack_model_params, serving_cast, tree_map_with_path
from ..models import transformer
from ..models.frontends import batch_specs
from ..optim import SGDM, AdamW, step_decay
from ..roofline import analysis, hw
from ..train.step import (
    abstract_bsq_state,
    abstract_plain_state,
    make_bsq_train_step,
    make_plain_train_step,
)
from ..tree import flatten_with_path

MESH = "1"  # one card


def _active_params(cfg, params) -> float:
    """Active non-embedding params (MoE: top_k/E of routed experts).  A
    PackedWeight counts the weight it stands for (lead..., K, N); JAX's
    flattening counts its packed fields' elements instead."""
    total = 0.0
    for name, leaf in flatten_with_path(params):
        name = name.lower()
        shape = (tuple(leaf.sign.shape[:-2]) + (leaf.k, leaf.sign.shape[-1])
                 if isinstance(leaf, PackedWeight) else leaf.shape)
        n = float(math.prod(shape))
        if "embed" in name or name.endswith("lm_head"):
            continue
        if "/moe/" in name and any(name.endswith(s) for s in ("w_gate", "w_up", "w_down")):
            n *= cfg.top_k / max(cfg.n_experts, 1)
        total += n
    return total


def _serving_tree(cfg, packed_bits: int = 0):
    """The meta param tree the port serves: packed projections (with
    ``packed_bits``) and float matrices in the compute dtype, as
    ``serve.engine.serving_params`` holds them."""
    params = transformer.init_params(cfg, torch.Generator(), "meta")
    if packed_bits:
        params = pack_model_params(params, packed_bits, abstract=True)
    return tree_map_with_path(lambda name, leaf: serving_cast(name, leaf, cfg.compute_dtype),
                              params)


# ---------------------------------------------------------------------------
# Cell builders: return (fn, example_args, model_flops_per_device)
# ---------------------------------------------------------------------------


def build_train_cell(cfg, shape, technique="bsq", optimizer="sgdm", microbatches=1):
    opt = SGDM() if optimizer == "sgdm" else AdamW()
    lr_fn = step_decay(0.1, [10_000, 20_000])
    if technique == "bsq":
        bsq_cfg = BSQConfig(n_init=8, alpha=5e-3, mode="static")
        state, ctx = abstract_bsq_state(cfg, bsq_cfg, opt)
        fn = make_bsq_train_step(ctx, opt, lr_fn, microbatches=microbatches)
        params = ctx.template
    else:
        state = abstract_plain_state(cfg, opt)
        fn = make_plain_train_step(cfg, opt, lr_fn)
        params = state["params"]
    n_active = _active_params(cfg, params)
    mf = 6.0 * n_active * shape.seq_len * shape.global_batch
    return fn, (state, batch_specs(cfg, shape)), mf


def build_decode_cell(cfg, shape, packed_bits: int = 0):
    """One ``decode_step`` of ``global_batch`` lanes over a ``seq_len``
    cache, at its last position (``pos`` is an int: the port's attention
    reads it on the host)."""
    B, S = shape.global_batch, shape.seq_len
    params = _serving_tree(cfg, packed_bits)
    cache = transformer.init_cache(cfg, B, S, device="meta")
    if cfg.frontend == "audio":
        tok = torch.empty((B, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")
    else:
        tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    cross = None
    if cfg.frontend == "vision":
        cross = torch.empty((B, cfg.frontend_tokens, cfg.d_model), dtype=torch.bfloat16,
                            device="meta")

    def fn(params, cache, tok, pos, cross):
        return transformer.decode_step(params, cache, tok, pos, cfg, cross_embeds=cross)

    mf = 2.0 * _active_params(cfg, params) * B
    return fn, (params, cache, tok, S - 1, cross), mf


def build_prefill_cell(cfg, shape):
    """Prefill = full forward (logits over the prompt; the last row kept);
    cache seeding is exercised by the serve engine, the dry run counts the
    FLOPs-dominant forward."""
    params = _serving_tree(cfg)

    def fn(params, batch):
        with torch.no_grad():
            logits, aux = transformer.forward(params, batch, cfg)
        return logits[:, -1], aux

    mf = 2.0 * _active_params(cfg, params) * shape.seq_len * shape.global_batch
    return fn, (params, batch_specs(cfg, shape)), mf


def _build(cfg, shape, technique, microbatches, packed_bits=0):
    if shape.kind == "train":
        return build_train_cell(cfg, shape, technique, microbatches=microbatches)
    if shape.kind == "decode":
        return build_decode_cell(cfg, shape, packed_bits=packed_bits)
    return build_prefill_cell(cfg, shape)


def _run(cfg, shape, technique, microbatches, packed_bits=0):
    """One meta run of the cell: (Counter, argument bytes, output bytes,
    model FLOPs)."""
    fn, args, mf = _build(cfg, shape, technique, microbatches, packed_bits)
    arg_bytes = analysis._shape_bytes(args)
    with analysis.Counter() as counter:
        out = fn(*args)
    return counter, arg_bytes, analysis._shape_bytes(out), mf


def run_cell(arch: str, shape_name: str, multi_pod: bool = False, technique: str = "bsq",
             microbatches: int | None = None, verbose: bool = True,
             cfg_override=None, packed_bits: int = 0):
    """One cell's record.  The memory comes from one meta run at the
    cell's microbatches (JAX's default with one batch shard: up to 16 for
    train), the roofline terms from one run at microbatches 1, as JAX's
    accounting takes them.  Eager meta runs every layer, so no superblock
    differencing (JAX's ``accounting_terms``) is needed: XLA's cost
    analysis counts a scanned loop body once, the counter sees every op.
    ``multi_pod`` records a failed cell: the training mesh slice is not ported."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name]
    if microbatches is None:
        microbatches = max(min(16, shape.global_batch), 1) if shape.kind == "train" else 1
    rec = {
        "arch": arch, "shape": shape_name, "mesh": "2x16x16" if multi_pod else MESH,
        "kind": shape.kind, "technique": technique if shape.kind == "train" else "serve",
        "microbatches": microbatches,
    }
    t0 = time.time()
    try:
        if multi_pod:
            raise NotImplementedError("the 2x16x16 mesh comes with the training mesh slice of "
                                      "the port (ROADMAP item 9b); this dry run covers one card")
        # 1) the cell as it runs (microbatched): memory
        counter, arg_bytes, out_bytes, mf = _run(cfg, shape, technique, microbatches,
                                                 packed_bits)
        t_run = time.time() - t0
        # 2) microbatches 1: the roofline terms
        if microbatches == 1:
            terms = counter.terms(1)
        else:
            terms = _run(cfg, shape, technique, 1, packed_bits)[0].terms(1)
        temp = counter.peak_live
        rec.update(
            status="ok",
            compile_s=round(t_run, 1),
            total_s=round(time.time() - t0, 1),
            memory={
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": temp,
                "peak_bytes": arg_bytes + temp,
            },
            roofline=terms.to_dict(),
            model_flops_per_device=mf,
            useful_ratio=mf / terms.flops_per_device if terms.flops_per_device else None,
            roofline_fraction=terms.roofline_fraction(mf),
        )
        if verbose:
            fits = arg_bytes + temp <= hw.HBM_BYTES
            print(
                f"[ok] {arch} x {shape_name} x {rec['mesh']}: "
                f"{rec['total_s']:.0f}s | "
                f"args {arg_bytes / 1e9:.2f} + temp {temp / 1e9:.2f} GB "
                f"({'fits' if fits else 'OVER'} {hw.HBM_BYTES / 1e9:.0f} GB) | "
                f"compute {terms.compute_s * 1e3:.2f} ms, mem {terms.memory_s * 1e3:.2f} ms, "
                f"coll {terms.collective_s * 1e3:.2f} ms -> {terms.bottleneck} | "
                f"MFU-bound {rec['roofline_fraction'] * 100:.1f}% (computed from H100 "
                f"data-sheet figures, not measured)", flush=True,
            )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} x {shape_name} x {rec['mesh']}: {rec['error']}", flush=True)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod", action="store_true",
                    help="the 16x16 mesh: not ported (the training mesh slice)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2x16x16 mesh: not ported (the training mesh slice)")
    ap.add_argument("--technique", default="bsq", choices=["bsq", "plain"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.single_pod or args.multi_pod:
        raise SystemExit("--single-pod/--multi-pod: the 16x16 and 2x16x16 meshes come with the "
                         "training mesh slice of the port (ROADMAP item 9b); without them the "
                         f"dry run covers one card (mesh {MESH!r})")
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("technique"))
            for r in results if r.get("status") == "ok"}

    t0 = time.time()
    for arch in archs:
        for shape_name in shapes:
            if not shape_applicable(arch, shape_name):
                print(f"[skip] {arch} x {shape_name}: long_500k needs sub-quadratic "
                      f"attention (DESIGN.md §5)")
                continue
            tech = args.technique if SHAPES[shape_name].kind == "train" else "serve"
            if (arch, shape_name, MESH, tech) in done:
                continue
            rec = run_cell(arch, shape_name, technique=args.technique,
                           microbatches=args.microbatches)
            results.append(rec)
            if args.out:
                os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
    n_ok = sum(1 for r in results if r["status"] == "ok")
    print(f"\n{n_ok}/{len(results)} cells ok ({time.time() - t0:.1f} s on the host)")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
