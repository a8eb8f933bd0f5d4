"""The port's Mixture-of-Experts against the JAX package on the CPU:
``moe_apply`` and ``moe_capacity``; reduced qwen2-moe (also made MHA)
and phi3.5-moe ``forward``, ``prefill`` + ``decode_step``, a 16-lane
decode step that drops; the bucketed, legacy, chunked and paged engines
against JAX's engines in the same mode; packing, ``serving_params`` and
the packed init; BSQ per-(layer, expert) groups and a train step; the
spec-decode refusal; the launchers.

Tolerances: ``moe_apply`` f32 within 1e-5 of max|y| and the aux loss
within 1e-6, bf16 within 2e-2 of max|y| (both frameworks sum the expert
products in other orders; bf16 rounds each product and each add of the
combine); model logits within 2e-4 absolute (f32 at width 64, as
tests/test_torch_model.py); train-step metrics within 1e-5 relative;
tokens exact.

Routing is a step function: where a token's k-th and (k+1)-th gates lie
within the two frameworks' gate difference, they may pick different
experts.  ``moe_apply`` is held with the port's own routing wherever
JAX's top-k margin exceeds 100x the largest gate difference, and is fed
JAX's routing (through ``moe._route``) otherwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core import BSQConfig as JBSQConfig
from repro.core.packing import PackedWeight as JPackedWeight
from repro.core.packing import pack_model_params as j_pack_model_params
from repro.models import moe as jmoe
from repro.models.common import cross_entropy as j_cross_entropy
from repro.models import transformer as jtf
from repro.optim import SGDM as JSGDM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import SchedulerPolicy as JPolicy
from repro.train import step as jstep
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core import BSQConfig
from repro_torch.core.packing import PackedWeight, pack_model_params, tree_map_with_path
from repro_torch.data import MarkovLM
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import moe
from repro_torch.models import transformer as ttf
from repro_torch.optim import SGDM, step_decay
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.engine import serving_params
from repro_torch.serve.scheduler import SchedulerPolicy
from repro_torch.train import init_bsq_state, make_bsq_train_step
from repro_torch.tree import flatten_with_path

QWEN, PHI = "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"
TOL = 2e-4
MAX_LEN = 32


def _j_cfg(arch, **kw):
    return dataclasses.replace(j_reduced_config(arch), **kw)


def _cfg(arch, **kw):
    return dataclasses.replace(reduced_config(arch), **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(arch, n_kv=None):
    kw = {} if n_kv is None else {"n_kv_heads": n_kv}
    return jax.jit(functools.partial(jtf.init_params, cfg=_j_cfg(arch, **kw)))(
        jax.random.PRNGKey(0))


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.array(want, np.float32), atol=tol,
                               rtol=tol)


def _drops(top_e: np.ndarray, n_experts: int, capacity: int) -> int:
    """Assignments past capacity: per group, each expert's picks beyond C."""
    counts = np.stack([np.bincount(g.reshape(-1), minlength=n_experts) for g in top_e])
    return int(np.maximum(counts - capacity, 0).sum())


class RecordRoutes:
    """Wraps ``moe._route``: records every call's chosen experts."""

    def __init__(self, monkeypatch):
        self.top_e = []
        orig = moe._route

        def route(gates, top_k):
            w, e = orig(gates, top_k)
            self.top_e.append(e.numpy().copy())
            return w, e

        monkeypatch.setattr(moe, "_route", route)


# ---------------------------------------------------------------------------
# moe_capacity, moe_apply
# ---------------------------------------------------------------------------


def test_moe_capacity_matches_jax():
    for T in (1, 3, 8, 16, 64, 200, 1024):
        for k in (1, 2, 4):
            for E in (4, 16, 60):
                for cf in (0.25, 1.0, 1.25, 8.0):
                    assert moe.moe_capacity(T, k, E, cf) == jmoe.moe_capacity(T, k, E, cf)


MOE_D, MOE_F, MOE_E, MOE_K = 32, 48, 4, 2


@pytest.mark.parametrize("shared,kind", [(0, "swiglu"), (2, "geglu")])
@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("B,S", [(24, 1), (3, 20)])
def test_moe_apply_matches_jax(monkeypatch, B, S, cf, shared, kind):
    jp = jmoe.moe_init(jax.random.PRNGKey(1), MOE_D, MOE_F, MOE_E, shared, kind)
    tp = bridge.from_numpy_tree(jp)
    x = np.random.default_rng(B * S).standard_normal((B, S, MOE_D)).astype(np.float32)
    kw = dict(top_k=MOE_K, n_experts=MOE_E, capacity_factor=cf, mlp_kind=kind,
              n_shared=shared)
    G, T = (B, S) if S > 1 else (1, B)

    # routing: JAX's gates and top-k against the port's
    jg = np.array(jnp.asarray(x).reshape(G, T, MOE_D) @ jp["router"])
    tg = torch.from_numpy(x).reshape(G, T, MOE_D) @ tp["router"]
    j_e = np.array(jax.jit(jax.lax.top_k, static_argnums=1)(jnp.asarray(jg), MOE_K)[1])
    t_e = moe._route(tg, MOE_K)[1].numpy()
    srt = -np.sort(-jg, axis=-1)
    margin = srt[..., MOE_K - 1] - srt[..., MOE_K]
    safe = margin > 100 * np.abs(tg.numpy() - jg).max()
    np.testing.assert_array_equal(np.sort(t_e, -1)[safe], np.sort(j_e, -1)[safe])
    if not safe.all():  # a near-tie: the port takes JAX's routing
        def route(gates, top_k):
            e = torch.from_numpy(j_e.astype(np.int64))
            return gates.gather(-1, e), e

        monkeypatch.setattr(moe, "_route", route)
    C = moe.moe_capacity(T, MOE_K, MOE_E, cf)
    if cf == 0.25:
        assert _drops(j_e, MOE_E, C) > 0
    if cf == 8.0:
        assert _drops(j_e, MOE_E, C) == 0

    j_apply = jax.jit(functools.partial(jmoe.moe_apply, **kw))
    jy, jaux = j_apply(jp, jnp.asarray(x))
    with torch.no_grad():
        ty, taux = moe.moe_apply(tp, torch.from_numpy(x), **kw)
    jy = np.array(jy)
    assert np.abs(ty.numpy() - jy).max() <= 1e-5 * np.abs(jy).max()
    assert abs(float(taux) - float(jaux)) <= 1e-6
    # bf16: x and the compute in bf16 (router and gates stay f32)
    jyb, _ = j_apply(jp, jnp.asarray(x).astype(jnp.bfloat16))
    with torch.no_grad():
        tyb, _ = moe.moe_apply(tp, torch.from_numpy(x).bfloat16(), **kw)
    assert tyb.dtype == torch.bfloat16
    jyb = np.array(jyb.astype(jnp.float32))
    assert np.abs(tyb.float().numpy() - jyb).max() <= 2e-2 * np.abs(jyb).max()


def test_moe_apply_is_deterministic():
    jp = jmoe.moe_init(jax.random.PRNGKey(2), MOE_D, MOE_F, MOE_E, 1, "swiglu")
    tp = bridge.from_numpy_tree(jp)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 9, MOE_D))
                         .astype(np.float32)).bfloat16()
    kw = dict(top_k=MOE_K, n_experts=MOE_E, capacity_factor=0.25, mlp_kind="swiglu",
              n_shared=1)
    y1, aux1 = moe.moe_apply(tp, x, **kw)
    y2, aux2 = moe.moe_apply(tp, x, **kw)
    assert torch.equal(y1, y2) and torch.equal(aux1, aux2)


# ---------------------------------------------------------------------------
# The model: forward, prefill + decode, a decode step with drops
# ---------------------------------------------------------------------------

# (arch, n_kv): reduced qwen2-moe has G 2; n_kv 4 makes it MHA as the real one
MODELS = [(QWEN, None), (QWEN, 4), (PHI, None)]


def _pair(arch, n_kv, kind="float"):
    kw = {} if n_kv is None else {"n_kv_heads": n_kv}
    jp = _jax_params(arch, n_kv)
    if kind == "packed":
        jp = jax.jit(functools.partial(j_pack_model_params, n_bits=6))(jp)
    return jp, bridge.from_numpy_tree(jp), _j_cfg(arch, **kw), _cfg(arch, **kw)


@pytest.mark.parametrize("arch,n_kv,kind", [(QWEN, None, "float"), (PHI, None, "float"),
                                             (QWEN, 4, "packed")])
def test_forward_logits_and_aux_match_jax(arch, n_kv, kind):
    """Logits, and the router loss summed over the layers; ``loss_fn``
    weighs it by ``router_aux_weight``."""
    jp, tp, jcfg, cfg = _pair(arch, n_kv, kind)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    want, jaux = jax.jit(functools.partial(jtf.forward, cfg=jcfg))(
        jp, {"tokens": jnp.asarray(toks)})
    jce = float(j_cross_entropy(want, jnp.asarray(labels), jcfg.padded_vocab))
    with torch.no_grad():
        batch = {"tokens": torch.from_numpy(toks).long(),
                 "labels": torch.from_numpy(labels).long()}
        logits, aux = ttf.forward(tp, batch, cfg)
        loss, metrics = ttf.loss_fn(tp, batch, cfg)
    _close(logits, want)
    assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= 1e-6 * cfg.n_layers
    assert float(metrics["aux"]) == float(aux)
    assert abs(float(metrics["ce"]) - jce) <= 1e-5 * jce
    want_loss = jce + cfg.router_aux_weight * float(jaux)
    assert abs(float(loss) - want_loss) <= 1e-5 * want_loss


@pytest.mark.parametrize("arch,n_kv", MODELS)
def test_prefill_and_decode_match_jax(arch, n_kv):
    jp, tp, jcfg, cfg = _pair(arch, n_kv, "packed")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jl, jcache = jax.jit(functools.partial(jtf.prefill, cfg=jcfg, max_len=MAX_LEN,
                                           cache_dtype=jnp.float32))(
        jp, {"tokens": jnp.asarray(toks)})
    j_decode = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    with torch.no_grad():
        tl, tcache = ttf.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cfg, MAX_LEN)
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, axis=-1)).astype(np.int32)
        for t in range(6):
            jl, jcache = j_decode(jp, jcache, jnp.asarray(nxt[:, None]), jnp.int32(8 + t))
            tl, tcache = ttf.decode_step(tp, tcache, torch.from_numpy(nxt[:, None]).long(),
                                         8 + t, cfg)
            _close(tl, jl)
            nxt = np.array(jnp.argmax(jl, axis=-1)).astype(np.int32)
    _close(tcache["blocks"]["p0"]["k"], jcache["blocks"]["p0"]["k"])


def test_sixteen_lane_decode_with_drops_matches_jax(monkeypatch):
    """A decode step routes its 16 lanes as one group: at capacity factor
    0.5 (C 8 for 32 assignments over 4 experts) lane order decides who is
    dropped."""
    cf = 0.5
    jcfg, cfg = _j_cfg(QWEN, capacity_factor=cf), _cfg(QWEN, capacity_factor=cf)
    jp = _jax_params(QWEN)
    tp = bridge.from_numpy_tree(jp)
    B = 16
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 4)).astype(np.int32)
    jl, jcache = jax.jit(functools.partial(jtf.prefill, cfg=jcfg, max_len=MAX_LEN,
                                           cache_dtype=jnp.float32))(
        jp, {"tokens": jnp.asarray(toks)})
    j_decode = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    rec = RecordRoutes(monkeypatch)
    with torch.no_grad():
        tl, tcache = ttf.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cfg, MAX_LEN)
        _close(tl, jl)
        rec.top_e.clear()
        nxt = np.array(jnp.argmax(jl, axis=-1)).astype(np.int32)
        for t in range(2):
            jl, jcache = j_decode(jp, jcache, jnp.asarray(nxt[:, None]), jnp.int32(4 + t))
            tl, tcache = ttf.decode_step(tp, tcache, torch.from_numpy(nxt[:, None]).long(),
                                         4 + t, cfg)
            _close(tl, jl)
            nxt = np.array(jnp.argmax(jl, axis=-1)).astype(np.int32)
    C = moe.moe_capacity(B, cfg.top_k, cfg.n_experts, cf)
    assert [e.shape for e in rec.top_e] == [(1, B, cfg.top_k)] * (2 * cfg.n_layers)
    assert sum(_drops(e, cfg.n_experts, C) for e in rec.top_e) > 0


# ---------------------------------------------------------------------------
# Serving: each engine mode against JAX's engine in that mode
# ---------------------------------------------------------------------------


def _schedule(cls, vocab, seed=0):
    """Prompts of 11 and 5 tokens (two lengths: one JAX prefill compile
    each), staggered arrivals, as tests/test_torch_scheduler.py."""
    rng = np.random.default_rng(seed)
    reqs = [cls(uid=i, tokens=rng.integers(0, vocab, size=(11, 5)[i % 2]).astype(np.int32),
                max_new=int(rng.integers(2, 7))) for i in range(5)]
    return reqs, np.cumsum(rng.integers(0, 3, size=5)).tolist()


MODES = {
    "bucketed": {},
    "legacy": dict(continuous=True, n_slots=3),
    "chunked": dict(continuous=True, policy=dict(n_slots=3, chunked_prefill=True,
                                                 chunk_sizes=(8, 1))),
    "paged": dict(continuous=True, policy=dict(n_slots=3, chunked_prefill=True,
                                               chunk_sizes=(8, 1), paged=True, block_size=4,
                                               n_blocks=12)),
}


def _serve(side, mode, params, cfg, paged_kernel=False):
    kw = dict(MODES[mode])
    if "policy" in kw:
        Policy = JPolicy if side == "jax" else SchedulerPolicy
        kw["policy"] = Policy(**kw["policy"], paged_kernel=paged_kernel)
    if side == "jax":
        eng = JServeEngine(params, cfg, max_len=MAX_LEN, **kw)
        reqs, arrivals = _schedule(JRequest, cfg.vocab_size)
    else:
        eng = ServeEngine(params, cfg, max_len=MAX_LEN, device="cpu", **kw)
        reqs, arrivals = _schedule(Request, cfg.vocab_size)
    out = eng.generate(reqs, arrival_steps=arrivals)
    if side == "port" and eng.scheduler is not None:
        pool = eng.scheduler.pool
        assert pool.n_active == 0 and eng.obs.recorder.leaked == []
        if pool.paged:
            assert pool.allocator.free_count == pool.n_blocks
    return {r.uid: np.asarray(r.tokens).tolist() for r in out}


@pytest.mark.parametrize("mode", list(MODES))
def test_serving_modes_match_jax(mode):
    """Reduced qwen2-moe at its capacity factor 1.25, 6-bit packed: each
    mode routes its own groups (a lane's prompt, a chunk, all lanes of a
    decode step), so each is held against JAX in the same mode."""
    jp, tp, jcfg, cfg = _pair(QWEN, None, "packed")
    want = _serve("jax", mode, jp, jcfg)
    assert _serve("port", mode, tp, cfg) == want
    if mode == "paged":
        assert _serve("port", mode, tp, cfg, paged_kernel=True) == want


def test_modes_agree_with_each_other_at_capacity_factor_8():
    """With no drops (capacity factor 8) the routing groups no longer
    matter: every mode gives the bucketed tokens."""
    jp = _jax_params(QWEN)
    cfg = _cfg(QWEN, capacity_factor=8.0)
    tp = bridge.from_numpy_tree(jax.jit(functools.partial(j_pack_model_params, n_bits=6))(jp))
    toks = {mode: _serve("port", mode, tp, cfg) for mode in MODES}
    toks["paged_kernel"] = _serve("port", "paged", tp, cfg, paged_kernel=True)
    assert all(t == toks["bucketed"] for t in toks.values()), toks


# ---------------------------------------------------------------------------
# Packing, serving params, the packed init
# ---------------------------------------------------------------------------


def test_packing_leaves_moe_float_as_jax_does():
    jp = _jax_params(QWEN)
    jpacked = jax.jit(functools.partial(j_pack_model_params, n_bits=6))(jp)
    ours = pack_model_params(bridge.from_numpy_tree(jp), 6)
    theirs = bridge.from_numpy_tree(jpacked)
    kinds = {}
    tree_map_with_path(lambda n, x: kinds.__setitem__(n, isinstance(x, PackedWeight)), ours)
    j_kinds = {}
    tree_map_with_path(lambda n, x: j_kinds.__setitem__(n, isinstance(x, PackedWeight)), theirs)
    assert kinds == j_kinds
    # wk and wv (2 KV heads of 16, 32 columns) are too narrow to pack
    packed = sorted(n for n, k in kinds.items() if k)
    assert packed == ["blocks/p0/mixer/wo", "blocks/p0/mixer/wq", "lm_head"]
    assert all(not isinstance(x, JPackedWeight)
               for x in jax.tree_util.tree_leaves(jpacked["blocks"]["p0"]["moe"]))
    for f in ("planes", "sign", "scale"):
        assert torch.equal(getattr(ours["lm_head"], f), getattr(theirs["lm_head"], f))
    moe_p = ours["blocks"]["p0"]["moe"]
    assert tuple(moe_p["w_gate"].shape) == (2, 4, 64, 128)  # (layers, E, d, f)
    assert tuple(moe_p["shared"]["w_down"].shape) == (2, 128, 64)


def test_serving_params_keep_the_router_f32():
    cfg = _cfg(QWEN, dtype="bfloat16")
    params = serving_params(bridge.from_numpy_tree(_jax_params(QWEN)), cfg, torch.device("cpu"))
    m = params["blocks"]["p0"]["moe"]
    assert m["router"].dtype == torch.float32
    for leaf in (m["w_gate"], m["w_up"], m["w_down"], m["shared"]["w_gate"]):
        assert leaf.dtype == torch.bfloat16


def test_packed_init_casts_experts_as_serving_does():
    """init_params(pack_bits=) draws as init_params and packs, and its
    float expert stacks already hold the values serving_params gives."""
    cfg = _cfg(QWEN, dtype="bfloat16")
    ref = serving_params(pack_model_params(
        ttf.init_params(cfg, torch.Generator().manual_seed(3), "cpu"), 6), cfg,
        torch.device("cpu"))
    got = ttf.init_params(cfg, torch.Generator().manual_seed(3), "cpu", pack_bits=6)
    ref_l, got_l = flatten_with_path(ref), flatten_with_path(got)
    assert [n for n, _ in ref_l] == [n for n, _ in got_l]
    for (name, a), (_, b) in zip(ref_l, got_l):
        if isinstance(a, PackedWeight):
            assert all(torch.equal(getattr(a, f), getattr(b, f))
                       for f in ("planes", "sign", "scale")), name
        elif name != "embed":  # the engine casts the embedding when it is built
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got["blocks"]["p0"]["moe"]["router"].dtype == torch.float32


# ---------------------------------------------------------------------------
# BSQ, spec decode, launchers
# ---------------------------------------------------------------------------


def test_bsq_groups_per_layer_and_expert_and_a_finite_step():
    """tests/test_bsq_end2end.py::test_moe_arch_bsq_trains: per-(layer,
    expert) groups for the routed experts (the same meta as JAX's
    context), per-layer for the shared ones, the router float; a step is
    finite and its ``aux`` metric carries the router loss."""
    jbsq = JBSQConfig(n_init=8, alpha=5e-3, compute_dtype=jnp.float32)
    _, jctx = jstep.abstract_bsq_state(j_reduced_config(QWEN), jbsq, JSGDM())
    state, ctx = init_bsq_state(torch.Generator().manual_seed(0), reduced_config(QWEN),
                                BSQConfig(n_init=8, alpha=5e-3, compute_dtype=torch.float32),
                                SGDM(), "cpu")
    assert ctx.meta == jctx.meta
    experts = [g for n, (_, g) in ctx.meta.items() if "/moe/" in n and "/shared/" not in n]
    shared = [g for n, (_, g) in ctx.meta.items() if "/shared/" in n]
    assert len(experts) == 3 and all(g == (0, 1) for g in experts)
    assert len(shared) == 3 and all(g == (0,) for g in shared)
    assert not any("router" in n for n in ctx.meta)
    batch = MarkovLM(vocab=512, seed=13).batch(np.random.default_rng(0), 4, 16)
    step = make_bsq_train_step(ctx, SGDM(), step_decay(0.2, [100]))
    for _ in range(2):
        state, m = step(state, {k: torch.from_numpy(v.astype(np.int64))
                                for k, v in batch.items()})
        assert all(np.isfinite(float(m[k])) for k in ("ce", "aux", "reg", "total"))
        assert float(m["aux"]) > 0
        want = float(m["ce"]) + 0.01 * float(m["aux"]) + 5e-3 * float(m["reg"])
        assert abs(float(m["total"]) - want) <= 1e-5 * want


def test_spec_decode_is_refused_for_moe():
    cfg = reduced_config(QWEN)
    params = pack_model_params(bridge.from_numpy_tree(_jax_params(QWEN)), 6)
    with pytest.raises(ValueError, match="MoE"):
        ServeEngine(params, cfg, max_len=MAX_LEN, device="cpu", continuous=True, paged=True,
                    spec_decode=True, draft_planes=3)
    with pytest.raises(ValueError, match="MoE"):
        serve_launcher.main(["--device", "cpu", "--arch", QWEN, "--continuous", "--paged",
                             "--packed-bits", "6", "--spec-decode", "--draft-planes", "3",
                             "--requests", "2", "--prompt-len", "4", "--max-new", "2"])


def test_launchers_run_the_moe_archs(capsys):
    serve_launcher.main(["--device", "cpu", "--arch", QWEN, "--continuous", "--paged",
                         "--paged-kernel", "--slots", "2", "--block-size", "8", "--requests",
                         "3", "--prompt-len", "6", "--mixed-lens", "--max-new", "3",
                         "--packed-bits", "6", "--smoke"])
    assert "OBS_SMOKE_OK" in capsys.readouterr().out
    out = train_launcher.main(["--device", "cpu", "--arch", PHI, "--steps", "2", "--batch",
                               "2", "--seq", "8", "--requant-interval", "2"])
    assert out["scheme"].bits_per_param > 0
