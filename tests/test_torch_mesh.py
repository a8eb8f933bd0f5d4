"""The port's mesh layer against the JAX package, on the CPU.

* The partition rules in process: ``repro_torch.dist.sharding`` against
  ``repro.dist.sharding`` on ``jax.sharding.AbstractMesh`` (no devices),
  every leaf of the ten reduced configurations' params, packed params and
  BSQ train states and of the published configurations' params, the
  cache, pool and table rules and the packed weights' ``kn_spec``.
* Serving on gloo meshes (``launch.mesh.run_on_mesh``, one spawned
  process per rank, reduced granite-3-2b, f32): a 2x2 mesh (bucketed,
  6-bit packed and float; tokens against JAX's single-device engine,
  logits against the port in one process) and a 2x4 mesh (JAX's mesh
  tests' traffic through the continuous, chunked and paged engines, the
  gather and kernel paths; overcommit preemption and spec decode against
  the port's single-process twin; each rank's exported packed bytes
  against the block of JAX's ``export_packed``; the runtime plane count
  on each rank's block; every rank's scheduler state after every step).

Each group of ranks is spawned once (module fixtures) and runs every
check of its mesh; the tests read the results.  JAX is imported inside
the fixtures only, so the spawned ranks import torch and the port alone.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, reduced_config
from repro_torch.core.packing import PackedWeight, truncate_packed
from repro_torch.dist import elastic
from repro_torch.dist import sharding as ts
from repro_torch.kernels import ops
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh, run_on_mesh
from repro_torch.models import transformer as ttf
from repro_torch.models.common import packed_shard_mesh
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.scheduler import SchedulerPolicy
from repro_torch.serve.slots import BlockAllocator

ARCH = "granite-3-2b"
MAX_LEN = 32
TOL = 1e-4  # of max |logit|, phase 3's f32 tolerance
MESH_SHAPES = [(2, 4), (4, 2), (1, 8), (16, 16), (2, 16, 16)]
ARRIVALS = [0, 0, 1, 3, 5]


def _axes(shape):
    return ("pod", "data", "model") if len(shape) == 3 else ("data", "model")


def _meshes(shape):
    from jax.sharding import AbstractMesh as JAbstractMesh

    return JAbstractMesh(shape, _axes(shape)), AbstractMesh(dict(zip(_axes(shape), shape)))


def _spec(s):
    return tuple(s)


# ---------------------------------------------------------------------------
# The rules, in process
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_leaves():
    """(tree, path, shape) of every leaf of the reduced configs' params,
    packed params and BSQ train states, and of the published params."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.configs import reduced_config as j_reduced
    from repro.core.bsq import BSQConfig
    from repro.core.packing import pack_model_params
    from repro.dist import sharding as js
    from repro.models import init_params
    from repro.optim import SGDM
    from repro.train.step import init_bsq_state

    key = jax.random.PRNGKey(0)
    out = []
    for arch in ARCH_IDS:
        cfg = j_reduced(arch)
        trees = {
            "params": jax.eval_shape(lambda k: init_params(k, cfg), key),
            "packed": jax.eval_shape(lambda k: pack_model_params(init_params(k, cfg), 6), key),
            "bsq_state": jax.eval_shape(lambda k: init_bsq_state(
                k, cfg, BSQConfig(n_init=8, compute_dtype=jnp.float32), SGDM())[0], key),
            "published": jax.eval_shape(lambda k: init_params(k, get_config(arch)), key),
        }
        for tag, tree in trees.items():
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
                out.append((f"{arch}:{tag}", js._path_name(path), tuple(leaf.shape)))
    return out


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_param_rules_match_jax_on_every_leaf(jax_leaves, shape):
    from repro.dist import sharding as js

    jm, tm = _meshes(shape)
    bad = [(tree, name, leaf_shape, _spec(js.param_spec(name, leaf_shape, jm)),
            _spec(ts.param_spec(name, leaf_shape, tm)))
           for tree, name, leaf_shape in jax_leaves
           if _spec(js.param_spec(name, leaf_shape, jm)) != _spec(ts.param_spec(name, leaf_shape,
                                                                              tm))]
    assert len(jax_leaves) > 2000 and not bad, bad[:5]
    sharded = sum(any(a is not None for a in ts.param_spec(n, s, tm)) for _, n, s in jax_leaves)
    assert sharded > 100  # the check is not over replicated leaves alone


@pytest.fixture(scope="module")
def granite():
    """Reduced granite-3-2b's JAX params, float and 6-bit packed, and the
    same bytes in the port."""
    import jax

    from repro.configs import reduced_config as j_reduced
    from repro.core.packing import pack_model_params
    from repro.models import transformer as jtf

    jcfg = j_reduced(ARCH)
    jparams = jax.jit(functools.partial(jtf.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    jpacked = jax.jit(functools.partial(pack_model_params, n_bits=6))(jparams)
    return {"jcfg": jcfg, "cfg": reduced_config(ARCH), "jfloat": jparams, "jpacked": jpacked,
            "float": bridge.from_numpy_tree(jparams), "packed": bridge.from_numpy_tree(jpacked)}


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tree_specs_and_kn_spec_match_jax(granite, shape):
    """``tree_param_specs`` over the port's trees and
    ``annotate_packed_specs``' ``kn_spec`` equal JAX's by path."""
    import jax

    from repro.core.packing import PackedWeight as JPackedWeight
    from repro.dist import sharding as js

    jm, tm = _meshes(shape)
    for kind in ("float", "packed"):
        want = {js._path_name(p): _spec(s) for p, s in jax.tree_util.tree_flatten_with_path(
            js.tree_param_specs(granite["j" + kind], jm),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
        got = {}

        def walk(t, path=""):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{path}/{k}" if path else k)
            elif isinstance(t, PackedWeight):
                for f in ("planes", "sign", "scale"):
                    got[f"{path}/{f}"] = _spec(getattr(t, f))
            else:
                got[path] = _spec(t)

        walk(ts.tree_param_specs(granite[kind], tm))
        assert got == want, kind
    jann = js.annotate_packed_specs(granite["jpacked"], jm)
    tann = ts.annotate_packed_specs(granite["packed"], tm)
    jk = [(js._path_name(p), leaf.kn_spec) for p, leaf in jax.tree_util.tree_flatten_with_path(
        jann, is_leaf=lambda x: isinstance(x, JPackedWeight))[0]
        if isinstance(leaf, JPackedWeight)]
    tk = {}

    def walk_pw(t, path=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk_pw(v, f"{path}/{k}" if path else k)
        elif isinstance(t, PackedWeight):
            tk[path] = t.kn_spec

    walk_pw(tann)
    assert jk and dict(jk) == tk


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cache_pool_and_table_rules_match_jax(shape):
    import jax
    import jax.numpy as jnp

    from repro.configs import reduced_config as j_reduced
    from repro.dist import sharding as js
    from repro.models import transformer as jtf

    jm, tm = _meshes(shape)
    # every fallback: batch 1, indivisible batch, MQA, indivisible K/V heads
    for B in (1, 2, 3, 4, 8, 16, 32, 64):
        for S in (1, 7, 16, 32, 33, 256, 4096):
            for KV in (1, 2, 4, 8, 16):
                for name in ("k", "v", "state", "conv"):
                    shp = (B, S, KV, 64) if name in ("k", "v") else (B, S, KV)
                    assert _spec(js.cache_spec(name, shp, jm)) == _spec(ts.cache_spec(name, shp,
                                                                                       tm))
                assert _spec(js.paged_block_spec((S, 16, KV, 64), jm)) == _spec(
                    ts.paged_block_spec((S, 16, KV, 64), tm))
            for nb in (1, 2, 8, 14, 32, 64, 96):
                assert _spec(js.block_table_spec(B, nb, jm)) == _spec(
                    ts.block_table_spec(B, nb, tm))
                lanes = js.block_table_spec(B, nb, jm)
                if len(lanes) and isinstance(lanes[0], tuple):
                    # ("pod", "data"): JAX's _axis_size looks the tuple up as one
                    # axis name and counts 0 shards; the port multiplies the sizes
                    assert ts.table_shards(tm, B, nb) == ts.axis_size(tm, lanes[0]) > 1
                else:
                    assert js.table_shards(jm, B, nb) == ts.table_shards(tm, B, nb)
            assert js.dp_axes(jm, B) == ts.dp_axes(tm, B)
            assert _spec(js.data_batch_spec(jm, B, 3)) == _spec(ts.data_batch_spec(tm, B, 3))
    for n_slots in (1, 2, 3, 4, 8, 12):
        for n_shards in (1, 2, 4):
            if n_slots < n_shards:
                continue
            lanes = [js.lane_shard(s, n_slots, n_shards) for s in range(n_slots)]
            assert lanes == [ts.lane_shard(s, n_slots, n_shards) for s in range(n_slots)]
            assert [list(js.shard_lanes(h, n_slots, n_shards)) for h in range(n_shards)] == \
                [list(ts.shard_lanes(h, n_slots, n_shards)) for h in range(n_shards)]
    # whole cache and pool trees of three layer layouts
    flat = functools.partial(jax.tree_util.tree_flatten_with_path,
                             is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    for arch in (ARCH, "gemma3-12b", "recurrentgemma-9b"):
        cfg = j_reduced(arch)
        for B in (1, 3, 4):
            cache = jax.eval_shape(lambda: jtf.init_cache(cfg, B, MAX_LEN, jnp.float32))
            want = [_spec(s) for _, s in flat(js.cache_tree_specs(cache, jm))[0]]
            got = [_spec(s) for _, s in flat(ts.cache_tree_specs(cache, tm))[0]]
            assert want == got, (arch, B)
        for nb, paged in ((14, True), (None, False)):
            cache = jax.eval_shape(lambda: jtf.init_cache(cfg, 4, MAX_LEN, jnp.float32,
                                                          paged_blocks=nb, block_size=4))
            ctrl = jax.ShapeDtypeStruct((4,), jnp.int32)
            state = {"cache": cache, "pos": ctrl, "temps": ctrl}
            if paged:
                state["block_table"] = jax.ShapeDtypeStruct((4, 8), jnp.int32)
                want, got = (js.block_pool_specs(state, jm, nb, 4),
                             ts.block_pool_specs(state, tm, nb, 4))
            else:
                want, got = js.slot_pool_specs(state, jm), ts.slot_pool_specs(state, tm)
            assert [_spec(s) for _, s in flat(want)[0]] == [_spec(s) for _, s in flat(got)[0]]


def test_mesh_shapes_and_local_blocks():
    """The production meshes are shape-only; ``local_block`` cuts the
    blocks in ``jax.make_mesh``'s row-major device order."""
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {"pod": 2, "data": 16, "model": 16}
    assert ts.mesh_labels(None) == {"mesh": "none", "process": "0"}
    full = torch.arange(4 * 6).reshape(4, 6)
    blocks = {}
    for d in range(2):
        for m in range(3):
            mesh = AbstractMesh({"data": 2, "model": 3})
            mesh.coords = {"data": d, "model": m}
            blocks[d, m] = ts.local_block(full, ts.P("data", "model"), mesh)
    assert torch.equal(torch.cat([torch.cat([blocks[d, m] for m in range(3)], 1)
                                  for d in range(2)], 0), full)
    mesh = AbstractMesh({"data": 2, "model": 2})
    mesh.coords = {"data": 1, "model": 0}
    seq = torch.arange(8)
    assert ts.local_block(seq, ts.P(("data", "model")), mesh).tolist() == [4, 5]
    assert elastic.validate_batch_divisibility(4, mesh)
    assert not elastic.validate_batch_divisibility(3, mesh)


# ---------------------------------------------------------------------------
# Serving on gloo meshes
# ---------------------------------------------------------------------------


def _reqs4(vocab):
    return [Request(uid=i, tokens=(np.arange(8, dtype=np.int32) + i) % vocab, max_new=4)
            for i in range(4)]


def _reqs5(vocab, tier=False):
    return [Request(uid=i, tokens=(np.arange(4 + 2 * i, dtype=np.int32) + i) % vocab,
                    max_new=5, tier="latency" if tier and i % 4 == 0 else "throughput")
            for i in range(5)]


def _tokens(results):
    return {r.uid: r.tokens.tolist() for r in results}


def _model_logits(params, cfg, steps=4):
    """Prefill of 4 rows and ``steps`` decode steps through the model API:
    the stacked f32 logits."""
    toks = torch.from_numpy((np.arange(32).reshape(4, 8) * 7 % cfg.vocab_size).astype(np.int64))
    logits, cache = ttf.prefill(params, {"tokens": toks}, cfg, MAX_LEN)
    out = [logits]
    for t in range(steps):
        logits, cache = ttf.decode_step(params, cache, logits.argmax(-1)[:, None], 8 + t, cfg)
        out.append(logits)
    return torch.stack(out)


def _rank_2x2(mesh, params, cfg):
    """Every check of the 2x2 mesh on one rank."""
    out = {"rank": mesh.rank}
    for kind in ("packed", "float"):
        eng = ServeEngine(params[kind], cfg, max_len=MAX_LEN, mesh=mesh)
        out[kind] = {"tokens4": _tokens(eng.generate(_reqs4(cfg.vocab_size))),
                     "tokens3": _tokens(eng.generate(_reqs4(cfg.vocab_size)[:3]))}
        p = elastic.reshard_tree(ts.annotate_packed_specs(params[kind], mesh), mesh)
        with packed_shard_mesh(mesh):
            out[kind]["logits"] = _model_logits(p, cfg)
        if kind == "packed":
            out["bytes"] = (eng.packed_bytes_local, eng.packed_bytes_global)
            wq, wo = eng.params["blocks"]["p0"]["mixer"]["wq"], eng.params["blocks"]["p0"]["mlp"][
                "w_down"]
            out["wq"] = (wq.kn_spec, tuple(wq.planes.shape), tuple(wq.sign.shape))
            out["w_down"] = (wo.kn_spec, tuple(wo.planes.shape))
        else:
            w = eng.params["blocks"]["p0"]["mixer"]["wq"]
            out["float_wq"] = (type(w).__name__, w.kn_spec, tuple(w.w.shape))
    # K/V heads split over model here: the continuous engines run each
    # rank's heads end to end (one reduction for q, k, v)
    for name, kw in (("chunked", dict(chunked_prefill=True)),
                     ("paged_kernel", dict(paged=True, block_size=4, n_blocks=16,
                                           paged_kernel=True))):
        eng = ServeEngine(params["packed"], cfg, max_len=MAX_LEN, mesh=mesh, continuous=True,
                          n_slots=4, **kw)
        out[name] = _tokens(eng.generate(_reqs4(cfg.vocab_size), arrival_steps=[0, 1, 1, 4]))
    return out


@pytest.fixture(scope="module")
def mesh_2x2(granite):
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    cfg = granite["cfg"]
    ref = {}
    for kind in ("packed", "float"):
        jreqs = [JRequest(uid=r.uid, tokens=r.tokens, max_new=r.max_new)
                 for r in _reqs4(cfg.vocab_size)]
        ref[kind] = {"jax_tokens": _tokens(JServeEngine(granite["j" + kind], granite["jcfg"],
                                                        max_len=MAX_LEN).generate(jreqs)),
                     "logits": _model_logits(granite[kind], cfg)}
    ranks = run_on_mesh(_rank_2x2, 2, 2, backend="gloo", device="cpu", threads=1,
                        args=({"packed": granite["packed"], "float": granite["float"]}, cfg))
    return ref, ranks


@pytest.mark.parametrize("kind", ["packed", "float"])
def test_bucketed_2x2_tokens_equal_jax_single_device(mesh_2x2, kind):
    ref, ranks = mesh_2x2
    want = ref[kind]["jax_tokens"]
    for r in ranks:
        assert r[kind]["tokens4"] == want
        # 3 rows on data=2: the bucket runs with its batch axis replicated
        assert r[kind]["tokens3"] == {u: t for u, t in want.items() if u < 3}


@pytest.mark.parametrize("mode", ["chunked", "paged_kernel"])
def test_2x2_continuous_on_local_heads_equals_jax_single_device(mesh_2x2, mode):
    ref, ranks = mesh_2x2
    for r in ranks:
        assert r[mode] == ref["packed"]["jax_tokens"], (mode, r["rank"])


@pytest.mark.parametrize("kind", ["packed", "float"])
def test_2x2_logits_match_single_process_and_every_rank(mesh_2x2, kind):
    ref, ranks = mesh_2x2
    want = ref[kind]["logits"]
    scale = float(want.abs().max())
    for r in ranks:
        assert float((r[kind]["logits"] - want).abs().max()) <= TOL * scale
        # every rank's logits bitwise the same (the tokens every host takes)
        assert torch.equal(r[kind]["logits"], ranks[0][kind]["logits"])


def test_2x2_ranks_hold_a_quarter_of_each_weight(mesh_2x2, granite):
    _, ranks = mesh_2x2
    cfg = granite["cfg"]
    K8, N = cfg.d_model // 8, cfg.n_heads * cfg.resolved_head_dim
    for r in ranks:
        assert r["wq"] == (("data", "model"), (2, 6, K8 // 2, N // 2), (2, K8 // 2, N // 2))
        assert r["w_down"] == (("model", "data"), (2, 6, cfg.d_ff // 16, cfg.d_model // 2))
        assert r["float_wq"] == ("FloatBlock", ("data", "model"), (2, cfg.d_model // 2, N // 2))
        local, whole = r["bytes"]
        # every packed projection is doubly sharded here; the scales replicate
        assert 0.25 <= local / whole < 0.26, (local, whole)


CONTINUOUS = {
    "legacy": dict(continuous=True, n_slots=4),
    "chunked": dict(continuous=True, policy=SchedulerPolicy(n_slots=4, chunked_prefill=True,
                                                            chunk_sizes=(8, 1))),
    "paged_gather": dict(continuous=True, n_slots=4, paged=True, block_size=4, n_blocks=14),
    "paged_kernel": dict(continuous=True, n_slots=4, paged=True, block_size=4, n_blocks=14,
                         paged_kernel=True),
    # 3 lanes do not split over data=2 while 14 blocks do: the pool is
    # gathered for the read (table_shards 1)
    "paged_gathered": dict(continuous=True, n_slots=3, paged=True, block_size=4, n_blocks=14),
}
# the twins: a single process whose allocator is split into the mesh's two
# table shards (_serve_continuous) schedules, grants and preempts as the
# 2x4 mesh does
TWINS = {
    "overcommit": (dict(continuous=True, paged=True, block_size=4, n_blocks=8, overcommit=2.0,
                        paged_kernel=True), True),
    "spec": (dict(continuous=True, paged=True, block_size=4, n_blocks=14, spec_decode=True,
                  draft_planes=2, gamma=3), False),
}


def _twin_policy(kw):
    kw = dict(kw)
    pol = SchedulerPolicy(n_slots=4, chunked_prefill=True, paged=True,
                          block_size=kw.pop("block_size"), n_blocks=kw.pop("n_blocks"),
                          overcommit=kw.pop("overcommit", 1.0),
                          paged_kernel=kw.pop("paged_kernel", False),
                          spec_decode=kw.pop("spec_decode", False),
                          draft_planes=kw.pop("draft_planes", 2), gamma=kw.pop("gamma", 4))
    return pol


def _serve_continuous(params, cfg, mesh, kw, tier=False):
    eng = ServeEngine(params, cfg, max_len=MAX_LEN, mesh=mesh, device=None if mesh else "cpu",
                      **kw)
    sched = eng.scheduler
    if mesh is None and sched.pool.paged:  # the twin of a mesh with two table shards
        pool = sched.pool
        pool.table_shards = 2
        pool.allocator = BlockAllocator(pool.n_blocks, pool.block_size, n_shards=2,
                                        overcommit=pool.overcommit)
    sched.digests = []
    toks = _tokens(eng.generate(_reqs5(cfg.vocab_size, tier), arrival_steps=ARRIVALS))
    pool = sched.pool
    out = {"tokens": toks, "digests": sched.digests, "preemptions": sched.preemptions_total(),
           "leaked": sorted(eng.obs.recorder.leaked)}
    if pool.paged:
        out.update(table_shards=pool.table_shards, free=pool.allocator.free_count,
                   n_blocks=pool.n_blocks, committed=pool.allocator.committed,
                   pool_shape=tuple(pool.cache["blocks"]["p0"]["k"].shape))
    if kw.get("spec_decode") or (kw.get("policy") and kw["policy"].spec_decode):
        out.update(spec_rounds=sched.spec_rounds, spec_committed=sched.spec_committed,
                   spec_accepted=sched.spec_accepted)
    return out


def _rank_2x4(mesh, params, cfg, reps):
    from repro_torch.core.bsq import export_packed_sharded

    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    for name, kw in CONTINUOUS.items():
        out[name] = _serve_continuous(params["packed"], cfg, mesh, kw)
    for name, (kw, tier) in TWINS.items():
        out[name] = _serve_continuous(params["packed"], cfg, mesh,
                                      dict(continuous=True, policy=_twin_policy(kw)), tier)
    eng = ServeEngine(params["packed"], cfg, max_len=MAX_LEN, mesh=mesh)
    out["bucketed"] = _tokens(eng.generate(_reqs5(cfg.vocab_size)))
    # each rank's export: only its slice of the codes is packed
    out["export"] = {name: (pw.planes, pw.sign, pw.scale, pw.k, pw.kn_spec)
                     for name, pw in export_packed_sharded(reps, mesh).items()}
    # the runtime plane count on this rank's block: bitwise the static
    # kernel over truncate_packed, locally and stitched
    pw = eng.params["blocks"]["p0"]["mlp"]["w_up"]
    pw = PackedWeight(planes=pw.planes[0], sign=pw.sign[0], scale=pw.scale[0], n_bits=pw.n_bits,
                      k=pw.k, kn_spec=pw.kn_spec)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((3, cfg.d_model))
                         .astype(np.float32))
    local = PackedWeight(planes=pw.planes, sign=pw.sign, scale=pw.scale, n_bits=pw.n_bits,
                         k=pw.sign.shape[0] * 8)
    xk = ops.k_slice(x, mesh, pw.kn_spec[0], local.k)
    out["active"] = [
        (torch.equal(ops.bitserial_matmul(xk, local, active_planes=a),
                     ops.bitserial_matmul(xk, truncate_packed(local, a))),
         torch.equal(ops.bitserial_matmul_sharded(x, pw, mesh, active_planes=a),
                     ops.bitserial_matmul_sharded(x, truncate_packed(pw, a), mesh)))
        for a in range(1, pw.n_bits + 1)]
    out["w_up_block"] = (pw.kn_spec, tuple(pw.planes.shape))
    # K = 60 pads to 64: no local block is well defined, so the bytes are
    # gathered before the unsharded call (with JAX's warning)
    from repro_torch.core.packing import pack_from_float

    w = torch.from_numpy(np.random.default_rng(6).standard_normal((60, 64)).astype(np.float32))
    whole = pack_from_float(w, 6)
    placed = elastic.reshard_tree({"mlp/w_up": ts.annotate_packed_specs(
        {"mlp/w_up": whole}, mesh)["mlp/w_up"]}, mesh)["mlp/w_up"]
    x = x[:, :60]
    with pytest.warns(UserWarning, match="falling back to the unsharded"):
        padded = ops.bitserial_matmul_sharded(x, placed, mesh)
    out["padded"] = (placed.kn_spec, torch.equal(padded, ops.bitserial_matmul(x, whole)))
    return out


@pytest.fixture(scope="module")
def mesh_2x4(granite):
    import jax
    import jax.numpy as jnp

    from repro.core import export_packed
    from repro.core.bitrep import decompose as j_decompose
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    from repro_torch.core.bitrep import decompose

    cfg = granite["cfg"]
    jreqs = [JRequest(uid=r.uid, tokens=r.tokens, max_new=r.max_new)
             for r in _reqs5(cfg.vocab_size)]
    ref = {"jax_tokens": _tokens(JServeEngine(granite["jpacked"], granite["jcfg"],
                                              max_len=MAX_LEN).generate(jreqs))}
    for name, (kw, tier) in TWINS.items():
        ref[name] = _serve_continuous(granite["packed"], cfg, None,
                                      dict(continuous=True, policy=_twin_policy(kw)), tier)
    # reps: JAX's mesh test's stacked (2, 64, 64) weight with one slice x50
    # (group scales that disagree) as a col-parallel wq, and another draw
    # of its shape as a row-parallel wo (one shape: JAX compiles once)
    w = np.array(jax.random.normal(jax.random.PRNGKey(2), (2, 64, 64), jnp.float32))
    w[1] *= 50.0
    ws = {"blocks/p0/mixer/wq": w,
          "blocks/p0/mixer/wo": np.array(granite["jfloat"]["blocks"]["p0"]["mixer"]["wo"])}
    jreps = {k: j_decompose(jnp.asarray(v), 4, group_axes=(0,)) for k, v in ws.items()}
    reps = {k: decompose(torch.from_numpy(v), 4, group_axes=(0,)) for k, v in ws.items()}
    ref["export"] = export_packed(jreps)
    ranks = run_on_mesh(_rank_2x4, 2, 4, backend="gloo", device="cpu", threads=1,
                        args=({"packed": granite["packed"]}, cfg, reps))
    return ref, ranks


@pytest.mark.parametrize("mode", list(CONTINUOUS))
def test_2x4_continuous_tokens_equal_jax_single_device(mesh_2x4, mode):
    ref, ranks = mesh_2x4
    for r in ranks:
        assert r[mode]["tokens"] == ref["jax_tokens"], (mode, r["rank"])
        assert not r[mode]["leaked"]
    assert all(r["bucketed"] == ref["jax_tokens"] for r in ranks)


@pytest.mark.parametrize("mode", ["paged_gather", "paged_kernel", "paged_gathered"])
def test_2x4_paged_pool_is_sharded_and_drains(mesh_2x4, granite, mode):
    _, ranks = mesh_2x4
    cfg = granite["cfg"]
    for r in ranks:
        got = r[mode]
        assert got["table_shards"] == (1 if mode == "paged_gathered" else 2)
        assert got["free"] == got["n_blocks"] == 14 and got["committed"] == 0
        # each rank holds 7 of the 14 blocks (plus its sentinel); 2 K/V heads
        # do not split over model=4, so they stay whole
        assert got["pool_shape"] == (cfg.n_superblocks, 7 + 1, 4, 2, cfg.resolved_head_dim)
    for r in ranks:
        assert r["w_up_block"] == (("data", "model"), (6, cfg.d_model // 16, cfg.d_ff // 4))


@pytest.mark.parametrize("mode", list(TWINS))
def test_2x4_overcommit_and_spec_equal_the_single_process_twin(mesh_2x4, mode):
    ref, ranks = mesh_2x4
    want = ref[mode]
    assert want["tokens"] == ref["jax_tokens"]
    for r in ranks:
        got = r[mode]
        assert got["tokens"] == want["tokens"]
        assert got["preemptions"] == want["preemptions"]
        assert got["free"] == got["n_blocks"] and got["committed"] == 0
        assert not got["leaked"]
        if mode == "spec":
            assert got["spec_rounds"] == want["spec_rounds"] > 0
            assert got["spec_committed"] == want["spec_committed"] > 0
            assert got["spec_accepted"] == want["spec_accepted"]
    if mode == "overcommit":
        assert want["preemptions"] > 0, "never preempted"


@pytest.mark.parametrize("mode", list(CONTINUOUS) + list(TWINS))
def test_2x4_every_rank_holds_the_same_scheduler_state_after_every_step(mesh_2x4, mode):
    _, ranks = mesh_2x4
    digests = ranks[0][mode]["digests"]
    assert len(digests) > 5
    for r in ranks[1:]:
        assert r[mode]["digests"] == digests, r["rank"]


def test_2x4_export_bytes_equal_the_block_of_jax_export(mesh_2x4):
    from repro.dist import sharding as js

    ref, ranks = mesh_2x4
    jm, _ = _meshes((2, 4))
    checked = 0
    for r in ranks:
        for name, (planes, sign, scale, k, kn) in r["export"].items():
            g = ref["export"][name]
            blocks = []
            for field, got in (("planes", planes), ("sign", sign), ("scale", scale)):
                whole = np.asarray(getattr(g, field))
                spec = tuple(js.param_spec(f"{name}/{field}", whole.shape, jm))
                idx = []
                for dim, ax in enumerate(spec + (None,) * (whole.ndim - len(spec))):
                    n = 1 if ax is None else np.prod([jm.shape[a] for a in
                                                      (ax if isinstance(ax, tuple) else (ax,))])
                    size = whole.shape[dim] // n
                    i = 0 if ax is None else r["coords"][ax]
                    idx.append(slice(i * size, (i + 1) * size))
                blocks.append((whole[tuple(idx)], got.numpy()))
            for want, got in blocks:
                assert want.dtype == got.dtype and want.shape == got.shape
                np.testing.assert_array_equal(want, got)
            assert k == g.k
            sign_spec = tuple(js.param_spec(f"{name}/sign", tuple(g.sign.shape), jm))
            assert kn == (sign_spec[-2], sign_spec[-1])
            checked += 1
    assert checked == 8 * 2 and any(kn != (None, None) for *_, kn in ranks[0]["export"].values())


def test_2x4_padded_k_gathers_the_bytes_and_warns(mesh_2x4):
    _, ranks = mesh_2x4
    for r in ranks:
        assert r["padded"] == (("data", "model"), True)


def test_scale_rows_the_n_shards_do_not_divide_go_per_column():
    """A (1, G) scale row whose G does not split over the N shards is held
    per column for this rank's columns: its block's product equals the
    whole weight's columns, bitwise."""
    from repro_torch.core.packing import pack_from_float

    w = torch.from_numpy(np.random.default_rng(3).standard_normal((64, 96)).astype(np.float32))
    whole = pack_from_float(w, 6, group_cols=3)  # 3 groups of 32 columns
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((5, 64)).astype(np.float32))
    want = ops.bitserial_matmul(x, whole)
    for m in range(2):
        mesh = AbstractMesh({"data": 1, "model": 2})
        mesh.coords = {"data": 0, "model": m}
        pw = elastic.reshard_tree(ts.annotate_packed_specs({"wq": whole}, mesh), mesh)["wq"]
        assert pw.kn_spec == ("data", "model") and tuple(pw.scale.shape) == (1, 48)
        local = PackedWeight(planes=pw.planes, sign=pw.sign, scale=pw.scale, n_bits=6, k=64)
        assert torch.equal(ops.bitserial_matmul(x, local), want[:, 48 * m:48 * (m + 1)])


def test_2x4_runtime_plane_count_is_bitwise_truncation_on_each_block(mesh_2x4):
    _, ranks = mesh_2x4
    for r in ranks:
        assert len(r["active"]) == 6 and all(a and b for a, b in r["active"]), r["active"]
