"""Serving every layer kind on a ("data", "model") mesh, against the JAX
package's single-device engine, on the CPU.

One module-scope 2x2 gloo group of CPU ranks (``launch.mesh.run_on_mesh``,
spawned once) serves six reduced configurations, f32, each drawn once
with the port's ``init_params`` and carried to both packages as numpy:

* gemma3-12b: five "local" layers per superblock, its 2 K/V heads split
  over "model" (each rank holds its heads of every ring);
* recurrentgemma-9b: one K/V head, so the rule moves "model" to the
  rings' slot axis (reads combine each slot shard's partial softmax), and
  the RG-LRU layers' state over the lanes, whole on every "model" rank;
* mamba2-130m: the SSD layers' state over the lanes;
* llama-3.2-vision-11b: the "+cross" sublayer on each rank's heads (the
  model API with ``cross_embeds``; the engines take none, as JAX's do);
* qwen2-moe-a2.7b: 2 of its 4 experts on each "model" rank, their hidden
  width over "data", one reduction over the mesh per MoE layer;
* musicgen-large: "attn" layers fed ``embeds`` through the model API.

Each gets 4 prompts of 20 tokens, past every reduced ring's 16 slots, and
8 new tokens, through the bucketed, legacy (batch-1 prefill), chunked and
paged (kernel path) engines.  Their greedy tokens must equal JAX's: for
the five dense models every JAX mode gives the bucketed engine's tokens
(``tests/test_torch_local.py``, ``test_torch_rglru.py``,
``test_torch_ssm.py`` and ``test_torch_frontends.py`` hold the port's
modes to that oracle), so JAX's bucketed engine is the oracle of all
four; for qwen2-moe, whose capacity drops depend on each mode's routing
groups, it is JAX's engine in the same mode.  The model API's logits
(prefill and 4 decode steps) must be within 1e-4 of max(1, max |logit|)
of the port in one process and bitwise alike on every rank; every rank's
scheduler digest equal after every step; every rank's leaves the block
the rules give it.  Routing near-ties (a top-k margin under 100 f32
ulps of the largest gate) are counted on the ranks and reported.  Last,
JAX's 6-bit export of reduced qwen2-moe, bridged, serves JAX's tokens on
the mesh (each rank resharding it), and each rank holds about a quarter
of the packed bytes.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.packing import FloatBlock, PackedWeight, RowsBlock, pack_model_params
from repro_torch.dist import elastic
from repro_torch.dist import sharding as ts
from repro_torch.launch.mesh import run_on_mesh
from repro_torch.models import transformer as ttf
from repro_torch.models.common import packed_shard_mesh
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.scheduler import SchedulerPolicy
from repro_torch.tree import flatten_with_path, tree_map
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["gemma3-12b", "recurrentgemma-9b", "mamba2-130m", "llama-3.2-vision-11b",
         "qwen2-moe-a2.7b", "musicgen-large"]
MOE = "qwen2-moe-a2.7b"
MODES = ["bucketed", "legacy", "chunked", "paged"]
MAX_LEN = 32
PLEN, NEW = 20, 8
ARRIVALS = [0, 0, 1, 3]
TOL = 1e-4  # of max(1, max |logit|)
STEPS = 4


def _policy(mode, kernel=True):
    """The scheduler policy of a continuous mode (JAX's oracle reads its
    paged pool by the gather: ``kernel=False``)."""
    if mode == "legacy":
        return dict(n_slots=4)
    kw = dict(n_slots=4, chunked_prefill=True, chunk_sizes=(8, 4))
    if mode == "paged":
        kw.update(paged=True, block_size=4, n_blocks=32, paged_kernel=kernel)
    return kw


def _requests(cls, vocab):
    rng = np.random.default_rng(5)
    return [cls(uid=i, tokens=rng.integers(0, vocab, PLEN).astype(np.int32), max_new=NEW)
            for i in range(4)]


def _tokens(results):
    return {r.uid: [int(t) for t in r.tokens] for r in results}


def _inputs(cfg):
    """The model API's inputs: tokens, or the audio frontend's embeds, and
    the vision layers' cross embeds."""
    rng = np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 12)).astype(np.int64))
    batch = {"tokens": toks}
    if cfg.frontend == "audio":
        batch = {"embeds": torch.from_numpy(rng.standard_normal((4, 12, cfg.d_model))
                                            .astype(np.float32))}
    if cfg.frontend == "vision":
        batch["cross_embeds"] = torch.from_numpy(
            rng.standard_normal((4, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return batch


def _model_logits(params, cfg):
    """Prefill and STEPS greedy decode steps through the model API: the
    stacked f32 logits."""
    batch = _inputs(cfg)
    cross = batch.get("cross_embeds")
    logits, cache = ttf.prefill(params, batch, cfg, MAX_LEN)
    out = [logits]
    for t in range(STEPS):
        nxt = logits.argmax(-1)[:, None]
        if cfg.frontend == "audio":  # the next frame's embeds
            nxt = batch["embeds"][:, t:t + 1]
        logits, cache = ttf.decode_step(params, cache, nxt, 12 + t, cfg, cross_embeds=cross)
        out.append(logits)
    return torch.stack(out)


def _engine(params, cfg, mode, **kw):
    if mode == "bucketed":
        return ServeEngine(params, cfg, max_len=MAX_LEN, **kw)
    return ServeEngine(params, cfg, max_len=MAX_LEN, continuous=True,
                       policy=SchedulerPolicy(**_policy(mode)), **kw)


def _serve(eng, cfg):
    reqs = _requests(Request, cfg.vocab_size)
    if eng.scheduler is None:
        return _tokens(eng.generate(reqs)), None
    eng.scheduler.digests = []
    return _tokens(eng.generate(reqs, arrival_steps=ARRIVALS)), eng.scheduler.digests


def _block_mismatches(local, whole, mesh):
    """Leaves of ``local`` (a rank's engine params) whose shape is not the
    block the rules give this rank of the ``whole`` leaf, and the number
    of leaves the rules shard."""
    bad, sharded = [], 0

    def walk(lt, wt, path):
        nonlocal sharded
        if isinstance(lt, dict):
            for k in lt:
                walk(lt[k], wt[k], f"{path}/{k}" if path else k)
            return
        if isinstance(lt, (list, tuple)):
            for i, (a, b) in enumerate(zip(lt, wt)):
                walk(a, b, f"{path}/{i}")
            return
        if isinstance(lt, PackedWeight):
            pairs = [(f"{path}/{f}", getattr(lt, f), getattr(wt, f)) for f in ("planes", "sign")]
        else:
            w = lt.w if isinstance(lt, (FloatBlock, RowsBlock)) else lt
            pairs = [(path, w, wt)]
        for name, t, wl in pairs:
            spec = ts.param_spec(name, tuple(wl.shape), mesh)
            sharded += any(a is not None for a in spec)
            if tuple(t.shape) != ts.local_shape(tuple(wl.shape), spec, mesh):
                bad.append((name, tuple(t.shape), tuple(wl.shape), tuple(spec)))

    walk(local, whole, "")
    return bad, sharded


def _route_margins():
    """Wrap ``moe._route`` to count near-ties: top-k picks whose margin to
    the next gate is under 100 f32 ulps of the largest gate, where another
    order of the stitched router sum could pick another expert."""
    from repro_torch.models import moe

    seen = {"near": 0, "picks": 0}
    orig = moe._route

    def route(gates, top_k):
        srt = gates.sort(-1, descending=True).values
        margin = srt[..., top_k - 1] - srt[..., top_k]
        ulp = torch.finfo(torch.float32).eps * gates.abs().amax()
        seen["near"] += int((margin < 100 * ulp).sum())
        seen["picks"] += margin.numel()
        return orig(gates, top_k)

    moe._route = route
    return seen, lambda: setattr(moe, "_route", orig)


def _rank(mesh, models, export):
    """Every check of the 2x2 mesh on one rank."""
    out = {"rank": mesh.rank}
    for arch, m in models.items():
        cfg, params = m["cfg"], m["float"]
        r = {}
        seen, undo = _route_margins()
        try:
            for mode in MODES:
                eng = _engine(params, cfg, mode, mesh=mesh)
                r[mode], r[mode + "_digests"] = _serve(eng, cfg)
                if mode == "bucketed":
                    r["blocks"] = _block_mismatches(eng.params, serving_whole(params, cfg),
                                                    mesh)
                    moe = eng.params["blocks"]["p0"].get("moe")
                    r["experts"] = None if moe is None else tuple(moe["w_gate"].shape)
                del eng
            local = elastic.reshard_tree(ts.annotate_packed_specs(params, mesh), mesh)
            mesh.collectives = 0
            with torch.no_grad(), packed_shard_mesh(mesh):
                r["logits"] = _model_logits(local, cfg)
            r["collectives"] = mesh.collectives
        finally:
            undo()
        r["route"] = seen
        out[arch] = r
    # a JAX export, bridged: each rank keeps its blocks of it
    eng = _engine(export, models[MOE]["cfg"], "bucketed", mesh=mesh)
    out["export"] = {"tokens": _serve(eng, models[MOE]["cfg"])[0],
                     "bytes": (eng.packed_bytes_local, eng.packed_bytes_global)}
    return out


def serving_whole(params, cfg):
    """The whole params as an engine holds them on one process (the shapes
    the rules cut)."""
    from repro_torch.serve.engine import serving_params

    return serving_params(params, cfg, torch.device("cpu"))


@pytest.fixture(scope="module")
def runs():
    """The draws, then the 2x2 ranks (spawned from a thread) while this
    process computes JAX's single-device oracle and the port's logits in
    one process for each arch."""
    import threading

    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config as j_reduced
    from repro.core.packing import pack_model_params as j_pack
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine
    from repro.serve.scheduler import SchedulerPolicy as JPolicy

    draws, models = {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = reduced_config(arch)
        draws[arch] = tree_map(lambda t: t.numpy(), ttf.init_params(
            cfg, torch.Generator().manual_seed(20 + i), "cpu"))
        models[arch] = {"cfg": cfg, "float": bridge.from_numpy_tree(draws[arch])}
    jp_moe = jax.tree.map(jnp.asarray, draws[MOE])
    jpacked = jax.jit(functools.partial(j_pack, n_bits=6))(jp_moe)
    export = bridge.from_numpy_tree(jpacked)
    out = {}

    def spawn():
        try:
            out["ranks"] = run_on_mesh(_rank, 2, 2, backend="gloo", device="cpu", threads=1,
                                       args=(models, export))
        except BaseException as e:  # noqa: BLE001 - raised in the test's thread below
            out["error"] = e

    ranks_thread = threading.Thread(target=spawn)
    ranks_thread.start()
    ref = {}
    for arch in ARCHS:
        cfg, jcfg = models[arch]["cfg"], j_reduced(arch)
        jp = jp_moe if arch == MOE else jax.tree.map(jnp.asarray, draws[arch])
        jreqs = _requests(JRequest, cfg.vocab_size)
        oracle = _tokens(JServeEngine(jp, jcfg, max_len=MAX_LEN).generate(jreqs))
        ref[arch] = {mode: oracle for mode in MODES}
        if arch == MOE:
            for mode in MODES[1:]:
                eng = JServeEngine(jp, jcfg, max_len=MAX_LEN, continuous=True,
                                   policy=JPolicy(**_policy(mode, kernel=False)))
                ref[arch][mode] = _tokens(eng.generate(jreqs, arrival_steps=ARRIVALS))
            ref["export"] = _tokens(JServeEngine(jpacked, jcfg, max_len=MAX_LEN).generate(
                jreqs))
            ref["export_repacked"] = pack_model_params(models[arch]["float"], 6)
            ref["export_tree"] = export
        with torch.no_grad():
            ref[arch]["logits"] = _model_logits(models[arch]["float"], cfg)
    ranks_thread.join()
    if "error" in out:
        raise out["error"]
    return models, ref, out["ranks"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_equal_jax_single_device(runs, arch, mode):
    _, ref, ranks = runs
    for r in ranks:
        assert r[arch][mode] == ref[arch][mode], (arch, mode, r["rank"], r[arch]["route"])


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_one_process_and_are_bitwise_alike_on_every_rank(runs, arch):
    _, ref, ranks = runs
    want = ref[arch]["logits"]
    scale = max(1.0, float(want.abs().max()))
    for r in ranks:
        got = r[arch]["logits"]
        assert bool(torch.isfinite(got).all())
        assert float((got - want).abs().max()) <= TOL * scale, (arch, r["rank"])
        assert torch.equal(got, ranks[0][arch]["logits"]), (arch, r["rank"])
        assert r[arch]["collectives"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_scheduler_state_is_the_same_on_every_rank_after_every_step(runs, arch):
    _, _, ranks = runs
    for mode in MODES[1:]:
        digests = ranks[0][arch][mode + "_digests"]
        assert len(digests) >= NEW, (arch, mode)
        for r in ranks[1:]:
            assert r[arch][mode + "_digests"] == digests, (arch, mode, r["rank"])


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_block_of_every_sharded_leaf(runs, arch):
    models, _, ranks = runs
    cfg = models[arch]["cfg"]
    for r in ranks:
        bad, sharded = r[arch]["blocks"]
        assert not bad and sharded > 0, (arch, r["rank"], bad[:3])
    if cfg.n_experts:
        # (superblocks, experts, d_model, f): 2 of 4 experts, half of f
        assert ranks[0][arch]["experts"] == (cfg.n_superblocks, cfg.n_experts // 2,
                                             cfg.d_model, cfg.d_ff // 2)


def test_moe_route_near_ties_are_counted():
    """The count itself: a pick whose margin is under 100 ulps of the
    largest gate is a near-tie."""
    from repro_torch.models import moe

    seen, undo = _route_margins()
    try:
        gates = torch.tensor([[[1.0, 1.0 + 1e-7, 0.5, 0.1], [1.0, 0.5, 0.2, 0.1]]])
        moe._route(gates, 2)
    finally:
        undo()
    assert seen == {"near": 0, "picks": 2}
    seen, undo = _route_margins()
    try:
        moe._route(torch.tensor([[[1.0, 0.9, 0.9 + 1e-7, 0.1]]]), 2)
    finally:
        undo()
    assert seen == {"near": 1, "picks": 1}


def test_route_near_ties_on_the_mesh_are_reported(runs):
    _, _, ranks = runs
    for r in ranks:
        seen = r[MOE]["route"]
        assert seen["picks"] > 0
        # reported: the tokens above equal JAX's whatever this count is
        print(f"rank {r['rank']}: {seen['near']} near-ties of {seen['picks']} routing picks")


def test_a_jax_export_bridged_and_resharded_serves_jax_tokens(runs):
    _, ref, ranks = runs
    # the port's packing of the same draw is JAX's export, byte for byte
    ours = flatten_with_path(ref["export_repacked"])
    theirs = dict(flatten_with_path(ref["export_tree"]))
    fields = ("planes", "sign", "scale")
    assert any(isinstance(x, PackedWeight) for _, x in ours)
    for n, x in ours:
        pairs = [(getattr(x, f), getattr(theirs[n], f)) for f in fields] \
            if isinstance(x, PackedWeight) else [(x, theirs[n])]
        assert all(torch.equal(a, b) for a, b in pairs), n
    for r in ranks:
        assert r["export"]["tokens"] == ref["export"], r["rank"]
        local, whole = r["export"]["bytes"]
        # the packed projections split both ways; the small scales replicate
        assert 0.25 <= local / whole < 0.27, (local, whole)
