"""Dry run: every (arch x shape x mesh) cell on the meta device.

For each cell this builds the real step function (the BSQ or plain train
step for train shapes, ``transformer.decode_step`` for decode shapes, the
prefill ``forward`` for prefill shapes), runs it on meta tensors (shapes
and dtypes, no storage, no card), and records the memory and the
roofline terms of ``roofline.analysis`` against one H100's data-sheet
figures (``roofline.hw``).  PyTorch port of ``repro.launch.dryrun``,
whose records and mesh labels it keeps.  The default mesh is one card
(label ``"1"``).  ``--single-pod`` and ``--multi-pod`` run the
production meshes, ("data", "model") 16x16 and ("pod", "data", "model")
2x16x16, as rank 0 sees them: ``launch.mesh.meta_mesh`` builds rank 0's
live mesh in this process on torch's fake process group, so the cell is
the live mesh's code path, its c10d collectives included, on rank 0's
blocks of the params, the state, the cache and the batch (the batch in
microbatch order, lanes over ("pod", "data")); the counter records each
collective's output bytes by kind.  The per-device figures are rank
0's.

The collective term is computed, not measured: the bytes over
``hw.LINK_BW``, one NVLink direction of an H100 (450 GB/s).  An NVLink
domain of H100s holds 8 cards, so a 16-wide axis of these meshes would
cross the network at a lower rate: the term is a floor.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k \
        --multi-pod
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
from ..models.common import packed_shard_mesh
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
# the production meshes, as JAX's launch.mesh.make_production_mesh shapes them
MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def mesh_label(mesh_shape) -> str:
    """A record's mesh label: "1" for one card, else the sizes joined by
    "x" ("16x16", "2x16x16")."""
    return MESH if not mesh_shape else "x".join(str(n) for n in mesh_shape.values())


def default_microbatches(shape, mesh_shape=None) -> int:
    """JAX's default: for a train shape, one batch row per batch shard and
    microbatch, at most 16 microbatches (16 on 16x16, 8 on 2x16x16; 16 on
    one card); 1 otherwise."""
    if shape.kind != "train":
        return 1
    shards = math.prod(n for ax, n in (mesh_shape or {}).items() if ax in ("pod", "data"))
    return max(min(16, shape.global_batch // shards), 1)


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


def _n_devices(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def _served(params, mesh):
    """Rank 0's blocks of a serving tree on ``mesh`` (the tree itself off
    one), as the serve engine places them."""
    if mesh is None:
        return params
    from ..dist import elastic, sharding

    return elastic.reshard_tree(sharding.annotate_packed_specs(params, mesh), mesh)


def build_train_cell(cfg, shape, technique="bsq", optimizer="sgdm", microbatches=1, mesh=None):
    """The train step on rank 0's blocks of the state and of the batch
    (``mesh`` None: one card)."""
    opt = SGDM() if optimizer == "sgdm" else AdamW()
    lr_fn = step_decay(0.1, [10_000, 20_000])
    if technique == "bsq":
        bsq_cfg = BSQConfig(n_init=8, alpha=5e-3, mode="static")
        state, ctx = abstract_bsq_state(cfg, bsq_cfg, opt, mesh=mesh)
        fn = make_bsq_train_step(ctx, opt, lr_fn, microbatches=microbatches, mesh=mesh)
        params = ctx.template
    else:
        state = abstract_plain_state(cfg, opt, mesh=mesh)
        fn = make_plain_train_step(cfg, opt, lr_fn, mesh=mesh)
        params = transformer.init_params(cfg, torch.Generator(), "meta")
    batch = batch_specs(cfg, shape)
    if mesh is not None:
        from ..dist.sharding import batch_block

        batch = {k: batch_block(v, mesh, microbatches) for k, v in batch.items()}
    n_active = _active_params(cfg, params)
    mf = 6.0 * n_active * shape.seq_len * shape.global_batch / _n_devices(mesh)
    return fn, (state, batch), mf


def build_decode_cell(cfg, shape, packed_bits: int = 0, mesh=None):
    """One ``decode_step`` of ``global_batch`` lanes over a ``seq_len``
    cache, at its last position (``pos`` is an int: the port's attention
    reads it on the host).  On ``mesh``: rank 0's blocks of the params and
    of the cache (``cache_tree_specs``: lanes over the data axes), the
    tokens whole, as the serve engine runs a mesh."""
    B, S = shape.global_batch, shape.seq_len
    whole = _serving_tree(cfg, packed_bits)
    params = _served(whole, mesh)
    cache = transformer.init_cache(cfg, B, S, device="meta", mesh=mesh)
    if cfg.frontend == "audio":
        tok = torch.empty((B, 1, cfg.d_model), dtype=torch.bfloat16, device="meta")
    else:
        tok = torch.empty((B, 1), dtype=torch.int32, device="meta")
    cross = None
    if cfg.frontend == "vision":
        cross = torch.empty((B, cfg.frontend_tokens, cfg.d_model), dtype=torch.bfloat16,
                            device="meta")

    def fn(params, cache, tok, pos, cross):
        with packed_shard_mesh(mesh):
            return transformer.decode_step(params, cache, tok, pos, cfg, cross_embeds=cross)

    mf = 2.0 * _active_params(cfg, whole) * B / _n_devices(mesh)
    return fn, (params, cache, tok, S - 1, cross), mf


def build_prefill_cell(cfg, shape, mesh=None):
    """Prefill = full forward (logits over the prompt; the last row kept);
    cache seeding is exercised by the serve engine, the dry run counts the
    FLOPs-dominant forward.  On ``mesh``: rank 0's forward as the serve
    engine runs it, on its blocks of the weights (the prompt batch whole
    on every rank)."""
    whole = _serving_tree(cfg)

    def fn(params, batch):
        with torch.no_grad(), packed_shard_mesh(mesh):
            logits, aux = transformer.forward(params, batch, cfg)
        return logits[:, -1], aux

    mf = 2.0 * _active_params(cfg, whole) * shape.seq_len * shape.global_batch \
        / _n_devices(mesh)
    return fn, (_served(whole, mesh), batch_specs(cfg, shape)), mf


def _build(cfg, shape, technique, microbatches, packed_bits=0, mesh=None):
    if shape.kind == "train":
        return build_train_cell(cfg, shape, technique, microbatches=microbatches, mesh=mesh)
    if shape.kind == "decode":
        return build_decode_cell(cfg, shape, packed_bits=packed_bits, mesh=mesh)
    return build_prefill_cell(cfg, shape, mesh=mesh)


def run_meta(cfg, shape, technique, microbatches, packed_bits=0, mesh_shape=None):
    """One meta run of the cell on one card, or as rank 0 of a mesh of
    ``mesh_shape`` (``launch.mesh.meta_mesh``): (Counter, argument bytes,
    output bytes, model FLOPs per device)."""
    if mesh_shape:
        from .mesh import meta_mesh

        with meta_mesh(mesh_shape) as mesh:
            return _run_on(cfg, shape, technique, microbatches, packed_bits, mesh)
    return _run_on(cfg, shape, technique, microbatches, packed_bits, None)


def _run_on(cfg, shape, technique, microbatches, packed_bits, mesh):
    fn, args, mf = _build(cfg, shape, technique, microbatches, packed_bits, mesh)
    arg_bytes = analysis._shape_bytes(args)
    with analysis.Counter() as counter:
        out = fn(*args)
    return counter, arg_bytes, analysis._shape_bytes(out), mf


def run_cell(arch: str, shape_name, multi_pod: bool = False, technique: str = "bsq",
             microbatches: int | None = None, verbose: bool = True,
             cfg_override=None, packed_bits: int = 0, mesh_shape=None):
    """One cell's record on one card, on any ``mesh_shape`` (``MESHES``'
    "16x16", say), or on the 2x16x16 mesh (``multi_pod``, JAX's flag,
    which wins); ``shape_name`` names a shape of ``SHAPES`` or is a
    ``ShapeConfig``.  The memory comes from one meta run at the cell's
    microbatches (:func:`default_microbatches`, JAX's), the roofline terms
    from one run at microbatches 1, as JAX's accounting takes them.
    Eager meta runs every layer, so no superblock differencing (JAX's
    ``accounting_terms``) is needed: XLA's cost analysis counts a scanned
    loop body once, the counter sees every op."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if multi_pod:
        mesh_shape = MESHES["2x16x16"]
    n_dev = math.prod(mesh_shape.values()) if mesh_shape else 1
    if microbatches is None:
        microbatches = default_microbatches(shape, mesh_shape)
    rec = {
        "arch": arch, "shape": shape.name, "mesh": mesh_label(mesh_shape),
        "kind": shape.kind, "technique": technique if shape.kind == "train" else "serve",
        "microbatches": microbatches,
    }
    t0 = time.time()
    try:
        # 1) the cell as it runs (microbatched): memory
        counter, arg_bytes, out_bytes, mf = run_meta(cfg, shape, technique, microbatches,
                                                     packed_bits, mesh_shape)
        t_run = time.time() - t0
        # 2) microbatches 1: the roofline terms
        if microbatches == 1:
            terms = counter.terms(n_dev)
        else:
            terms = run_meta(cfg, shape, technique, 1, packed_bits,
                             mesh_shape)[0].terms(n_dev)
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
            coll = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in terms.collectives.items() if v)
            print(
                f"[ok] {arch} x {shape.name} x {rec['mesh']}: "
                f"{rec['total_s']:.0f}s | "
                f"args {arg_bytes / 1e9:.2f} + temp {temp / 1e9:.2f} GB "
                f"({'fits' if fits else 'OVER'} {hw.HBM_BYTES / 1e9:.0f} GB) | "
                f"compute {terms.compute_s * 1e3:.2f} ms, mem {terms.memory_s * 1e3:.2f} ms, "
                f"coll {terms.collective_s * 1e3:.2f} ms -> {terms.bottleneck} | "
                f"MFU-bound {rec['roofline_fraction'] * 100:.1f}% (computed from H100 "
                f"data-sheet figures, not measured)"
                + (f" | collective GB per device: {coll or 'none'} (the term at one NVLink "
                   "direction, a floor: a 16-wide axis crosses the network)"
                   if mesh_shape else ""), flush=True,
            )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[FAIL] {arch} x {shape.name} x {rec['mesh']}: {rec['error']}", flush=True)
    return rec


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="Dry run on meta tensors. With neither --single-pod nor --multi-pod the "
                    "mesh is one card (label '1'); with either, that mesh as rank 0 sees it; "
                    "with both, both meshes.")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--single-pod", action="store_true",
                    help="the (data, model) 16x16 mesh, rank 0's view")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (pod, data, model) 2x16x16 mesh, rank 0's view")
    ap.add_argument("--technique", default="bsq", choices=["bsq", "plain"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--out", default=None)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    meshes = [m for m, on in (("16x16", args.single_pod), ("2x16x16", args.multi_pod)) if on]
    meshes = meshes or [MESH]
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
            for mesh in meshes:
                if (arch, shape_name, mesh, tech) in done:
                    continue
                rec = run_cell(arch, shape_name, technique=args.technique,
                               microbatches=args.microbatches, mesh_shape=MESHES.get(mesh))
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
