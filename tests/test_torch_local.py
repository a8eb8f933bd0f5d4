"""The port's sliding-window ("local") layers against the JAX package, on
the CPU, at reduced gemma3-12b f32 (window 16; 12 layers in two
superblocks of 5 local + 1 global; params bridged from JAX
``init_params``, float and 6-bit packed):

* ring decode (``decode_attention(ring=True)`` against JAX
  ``decode_attention_cache``), scalar and per-slot positions, across the
  ring's wrap, with an inactive lane;
* prefill and decode logits (after ``tests/test_decode.py``), and the
  whole caches, rings ``[:Wc]`` included, after prefill, a chunk and a
  decode step (after ``tests/test_chunked_prefill.py``);
* greedy tokens of the bucketed, legacy, chunked, paged and paged-kernel
  engines identical to the JAX bucketed oracle with ``max_new = window +
  4`` (after ``tests/test_paged_serve.py``), zero leaked blocks;
* the bridge carries a JAX gemma3 tree, float and packed, with its six
  pattern positions ``blocks/p0..p5``.

Tolerances: logits 1e-5 absolute plus 1e-4 relative (f32 at width 64
through 12 layers; the two frameworks sum in other orders, and the worst
element seen differs by 1.4e-5 at a logit of 0.4); cache rows 1e-4
absolute and relative (K/V of up to ~4 in magnitude, eleven layers into
the residual stream); tokens exact."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core.packing import pack_model_params as j_pack_model_params
from repro.models import transformer as jtf
from repro.models.attention import decode_attention_cache as j_decode_attention_cache
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.core.packing import PackedWeight, pack_model_params
from repro_torch.models import transformer as ttf
from repro_torch.models.attention import decode_attention
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.scheduler import SchedulerPolicy
from repro_torch.serve.slots import SlotPool
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "gemma3-12b"
TOL = (1e-5, 1e-4)  # (absolute, relative)
CACHE_TOL = (1e-4, 1e-4)
MAX_LEN = 48
N_SLOTS = 3
BLOCK_SIZE = 4
N_BLOCKS = 12


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduced_config(ARCH)
    jparams = jax.jit(functools.partial(jtf.init_params, cfg=jcfg))(jax.random.PRNGKey(1))
    jpacked = jax.jit(functools.partial(j_pack_model_params, n_bits=6))(jparams)
    return {"jcfg": jcfg, "cfg": reduced_config(ARCH),
            "float": (jparams, bridge.from_numpy_tree(jparams)),
            "packed": (jpacked, bridge.from_numpy_tree(jpacked))}


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.numpy(), np.array(want), atol=tol[0], rtol=tol[1])


def _jax_part(t, shape):
    """The port's leaf cut to JAX's shape (without the sentinel block or
    the spare row of "attn" leaves; rings have JAX's shape)."""
    return t[tuple(slice(0, n) for n in shape)]


def _check_caches(tcache, jcache):
    for name, jc in jcache["blocks"].items():
        for leaf in ("k", "v"):
            want = np.array(jc[leaf])
            _close(_jax_part(tcache["blocks"][name][leaf], want.shape), want, CACHE_TOL)


# ---------------------------------------------------------------------------
# Ring decode against JAX decode_attention_cache
# ---------------------------------------------------------------------------


def _attn_params(d_model, n_heads, n_kv, hd, rng):
    def w(i, o):
        return (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)

    return {"wq": w(d_model, n_heads * hd), "wk": w(d_model, n_kv * hd),
            "wv": w(d_model, n_kv * hd), "wo": w(n_heads * hd, d_model)}


@pytest.mark.parametrize("pos,window", [(3, 8), (8, 8), (13, 8), (21, 6),
                                        ((3, 9, 17), 8), ((20, 9, 5), 6)])
def test_ring_decode_matches_jax(pos, window):
    """A ring of Wc = 8 slots: positions before, at and past its first
    wrap; per-slot positions with lane 1 inactive (its slot must keep its
    content); a window narrower than the ring."""
    B, H, KV, hd, Wc = 3, 4, 2, 16, 8
    rng = np.random.default_rng(sum(np.atleast_1d(pos)) + window)
    p = _attn_params(H * hd, H, KV, hd, rng)
    x = (rng.standard_normal((B, 1, H * hd)) * 0.5).astype(np.float32)
    ck, cv = (rng.standard_normal((B, Wc, KV, hd)).astype(np.float32) for _ in range(2))
    per_slot = isinstance(pos, tuple)
    active = np.array([True, False, True]) if per_slot else None
    kw = dict(n_heads=H, n_kv=KV, head_dim=hd, rope_theta=1e4, window=window, ring=True)
    jpos = jnp.asarray(np.array(pos, np.int32))
    want, jk, jv = j_decode_attention_cache(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x), jnp.asarray(ck),
        jnp.asarray(cv), jpos, active=None if active is None else jnp.asarray(active), **kw)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tpos = torch.from_numpy(np.array(pos, np.int32)) if per_slot else pos
    got = decode_attention({n: torch.from_numpy(a) for n, a in p.items()}, torch.from_numpy(x),
                           tk, tv, tpos, active=None if active is None
                           else torch.from_numpy(active), **kw)
    _close(got, want)
    _close(tk, jk, CACHE_TOL)
    _close(tv, jv, CACHE_TOL)
    if per_slot:
        assert torch.equal(tk[1], torch.from_numpy(ck[1]))


# ---------------------------------------------------------------------------
# The model: prefill, decode, chunk and caches against JAX
# ---------------------------------------------------------------------------


def test_init_cache_rings_are_window_sized(models):
    """tests/test_decode.py::test_ring_buffer_cache_is_window_sized, and
    the slot pool: rings keep min(window, max_len) slots (never the spare
    row of "attn" leaves), the global layer max_len (+1 unpaged)."""
    cfg = models["cfg"]
    cache = ttf.init_cache(cfg, 2, 64, device="cpu")
    assert cache["blocks"]["p0"]["k"].shape[2] == cfg.window
    assert cache["blocks"]["p5"]["k"].shape[2] == 64
    assert ttf.init_cache(cfg, 2, 10, device="cpu")["blocks"]["p4"]["v"].shape[2] == 10
    for max_len in (10, 64):
        pool = SlotPool(cfg, 2, max_len, device="cpu")
        assert pool.cache["blocks"]["p0"]["k"].shape[2] == min(cfg.window, max_len)
        assert pool.cache["blocks"]["p5"]["k"].shape[2] == max_len + 1
    paged = SlotPool(cfg, 2, 64, paged=True, block_size=8, device="cpu")
    assert paged.cache["blocks"]["p1"]["k"].shape[1:3] == (2, cfg.window)
    assert paged.cache["blocks"]["p5"]["k"].shape[1:3] == (paged.n_blocks + 1, 8)
    ring = 2 * 5 * 2 * (2 * cfg.window * cfg.n_kv_heads * cfg.resolved_head_dim * 4)
    assert paged.ring_bytes() == ring < paged.cache_bytes()


@pytest.mark.parametrize("kind", ["float", "packed"])
def test_prefill_and_decode_match_jax_across_the_wrap(models, kind):
    """A 24-token prompt wraps every ring during prefill; decode steps at
    24..27 overwrite live slots.  Logits and whole caches after prefill
    and after the decode steps (float; the packed tree's decode is held
    per slot in ``test_decode_step_with_an_inactive_lane_matches_jax``)."""
    jp, tp = models[kind]
    jcfg, cfg = models["jcfg"], models["cfg"]
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, jcache = jax.jit(functools.partial(jtf.prefill, cfg=jcfg, max_len=MAX_LEN,
                                           cache_dtype=jnp.float32))(jp, {"tokens": toks})
    with torch.no_grad():
        tl, tcache = ttf.prefill(tp, {"tokens": torch.from_numpy(toks).long()}, cfg, MAX_LEN,
                                 torch.float32)
    _close(tl, jl)
    _check_caches(tcache, jcache)
    if kind == "packed":
        return
    step = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg))
    nxt = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 4)).astype(np.int32)
    for t in range(4):
        jl, jcache = step(jp, jcache, jnp.asarray(nxt[:, t:t + 1]), jnp.int32(24 + t))
        with torch.no_grad():
            tl, _ = ttf.decode_step(tp, tcache, torch.from_numpy(nxt[:, t:t + 1]).long(),
                                    24 + t, cfg)
        _close(tl, jl)
    _check_caches(tcache, jcache)


def test_forward_matches_jax(models):
    """The training path's plain windowed attention, and the bridge of a
    JAX gemma3 tree: six pattern positions, each of JAX's kind."""
    jp, tp = models["float"]
    jcfg, cfg = models["jcfg"], models["cfg"]
    assert sorted(tp["blocks"]) == [f"p{i}" for i in range(6)] == sorted(jp["blocks"])
    assert cfg.layer_pattern == jcfg.layer_pattern == ("local",) * 5 + ("attn",)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jl, _ = jax.jit(functools.partial(jtf.forward, cfg=jcfg))(jp, {"tokens": toks})
    with torch.no_grad():
        tl, _ = ttf.forward(tp, {"tokens": torch.from_numpy(toks).long()}, cfg)
    _close(tl, jl)


def test_bridge_carries_packed_gemma3_trees(models):
    """Packing the bridged float tree in the port gives the JAX packer's
    tree, at every pattern position: the same leaves packed (the 64 x 32
    wk/wv stay float, as ``packable`` says), with the same bytes."""
    ours = pack_model_params(models["float"][1], 6)
    theirs = models["packed"][1]
    n_packed = 0
    for i in range(6):
        for sub in ("mixer", "mlp"):
            for name, b in theirs["blocks"][f"p{i}"][sub].items():
                a = ours["blocks"][f"p{i}"][sub][name]
                assert type(a) is type(b), (i, name)
                if isinstance(b, PackedWeight):
                    n_packed += 1
                    assert a.n_bits == b.n_bits == 6
                    for f in ("planes", "sign", "scale"):
                        assert torch.equal(getattr(a, f), getattr(b, f)), (i, name, f)
                else:
                    assert torch.equal(a, b), (i, name)
    assert n_packed == 6 * 5  # wq, wo and the three GeGLU matrices


def _random_caches(jcfg, cfg, seed, paged):
    """The same random contents in every leaf for JAX and the port (the
    port's "attn" leaves have one sentinel block, or spare row, more)."""
    rng = np.random.default_rng(seed)
    if paged:
        jcache = jtf.init_cache(jcfg, N_SLOTS, MAX_LEN, jnp.float32, paged_blocks=N_BLOCKS,
                                block_size=BLOCK_SIZE)
        tcache = ttf.init_cache(cfg, N_SLOTS, MAX_LEN, torch.float32, "cpu",
                                paged_blocks=N_BLOCKS, block_size=BLOCK_SIZE)
    else:
        jcache = jtf.init_cache(jcfg, N_SLOTS, MAX_LEN, jnp.float32)
        tcache = ttf.init_cache(cfg, N_SLOTS, MAX_LEN, torch.float32, "cpu", drop_row=True)
    for name in tcache["blocks"]:
        for leaf in ("k", "v"):
            t = tcache["blocks"][name][leaf]
            t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
            # a copy: JAX may alias a numpy buffer, and the port then
            # updates the tensor under it in place
            jcache["blocks"][name][leaf] = jnp.asarray(
                _jax_part(t, jcache["blocks"][name][leaf].shape).numpy().copy())
    return jcache, tcache


# lane 0 owns pool blocks 0..11 in order, lane 1 the reverse, lane 2 (idle
# or inactive) a shuffle: the live ranges of lanes 0 and 1 never share a block
TABLE = np.array([list(range(12)), list(range(11, -1, -1)),
                  [3, 7, 1, 9, 0, 5, 11, 2, 8, 4, 10, 6]], np.int32)


@pytest.mark.parametrize("kind,C,paged", [("float", 24, False), ("packed", 24, True),
                                          ("float", 8, True)])
def test_prefill_chunk_through_the_rings_matches_jax(models, kind, C, paged):
    """Lane 0's chunk starts at 16 (its ring full of earlier keys); C = 24
    is longer than the ring, the concat-attend and gather-rebuild path;
    lane 1 has 3 real tokens behind pads; lane 2 is idle."""
    jp, tp = models[kind]
    jcfg, cfg = models["jcfg"], models["cfg"]
    jcache, tcache = _random_caches(jcfg, cfg, seed=C, paged=paged)
    toks = np.random.default_rng(C + 1).integers(0, cfg.vocab_size, (N_SLOTS, C)).astype(
        np.int32)
    start = np.array([16, 4, MAX_LEN], np.int32)
    nvalid = np.array([C, 3, 0], np.int32)
    table = TABLE if paged else None
    jl, jcache = jax.jit(functools.partial(jtf.prefill_chunk, cfg=jcfg,
                                           cache_dtype=jnp.float32))(
        jp, jcache, jnp.asarray(toks), jnp.asarray(start), jnp.asarray(nvalid),
        block_table=None if table is None else jnp.asarray(table))
    with torch.no_grad():
        tl, _ = ttf.prefill_chunk(tp, tcache, torch.from_numpy(toks).long(),
                                  torch.from_numpy(start), torch.from_numpy(nvalid), cfg,
                                  block_table=None if table is None else torch.from_numpy(table))
    _close(tl[:2], np.array(jl)[:2])  # lane 2 is idle: its logits are garbage in both
    _check_caches(tcache, jcache)


@pytest.mark.parametrize("kind,paged", [("float", False), ("packed", True)])
def test_decode_step_with_an_inactive_lane_matches_jax(models, kind, paged):
    """Per-slot positions: lane 0 past its ring's wrap, lane 1 before it,
    lane 2 inactive (its ring slot and its rows frozen)."""
    jp, tp = models[kind]
    jcfg, cfg = models["jcfg"], models["cfg"]
    jcache, tcache = _random_caches(jcfg, cfg, seed=3, paged=paged)
    tok = np.array([[7], [300], [11]], np.int32)
    pos = np.array([20, 9, 5], np.int32)
    active = np.array([True, True, False])
    table = TABLE if paged else None
    jl, jcache = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg, paged_kernel=paged))(
        jp, jcache, jnp.asarray(tok), jnp.asarray(pos), active=jnp.asarray(active),
        block_table=None if table is None else jnp.asarray(table))
    with torch.no_grad():
        tl, _ = ttf.decode_step(tp, tcache, torch.from_numpy(tok).long(), torch.from_numpy(pos),
                                cfg, active=torch.from_numpy(active),
                                block_table=None if table is None else torch.from_numpy(table),
                                paged_kernel=paged)
    _close(tl[:2], np.array(jl)[:2])
    _check_caches(tcache, jcache)


# ---------------------------------------------------------------------------
# Engines against the JAX bucketed oracle
# ---------------------------------------------------------------------------


def _requests(cfg, cls):
    """Prompts of 9 and 22 tokens (two buckets; 22 is past the window),
    max_new = window + 4 so every lane's ring wraps while it decodes."""
    rng = np.random.default_rng(7)
    return [cls(uid=i, tokens=rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                max_new=cfg.window + 4)
            for i, n in enumerate((9, 22, 22, 9))]


@pytest.fixture(scope="module")
def oracle(models):
    reqs = _requests(models["cfg"], JRequest)
    return {r.uid: r.tokens for r in
            JServeEngine(models["float"][0], models["jcfg"], max_len=MAX_LEN).generate(reqs)}


@pytest.mark.parametrize("mode", ["bucketed", "legacy", "chunked", "chunked_long",
                                  "paged", "paged_kernel"])
def test_engines_match_the_jax_bucketed_oracle(models, oracle, mode):
    """``chunked_long`` streams 32-token chunks through 16-slot rings."""
    cfg, tp = models["cfg"], models["float"][1]
    paged = dict(chunked_prefill=True, chunk_sizes=(8, 1), paged=True, block_size=8)
    policy = {"legacy": {}, "chunked": dict(chunked_prefill=True, chunk_sizes=(8, 4, 1)),
              "chunked_long": dict(chunked_prefill=True, chunk_sizes=(32, 1)),
              "paged": paged, "paged_kernel": dict(paged, paged_kernel=True)}
    if mode == "bucketed":
        eng = ServeEngine(tp, cfg, max_len=MAX_LEN, device="cpu")
    else:
        eng = ServeEngine(tp, cfg, max_len=MAX_LEN, device="cpu", continuous=True,
                          policy=SchedulerPolicy(n_slots=2, **policy[mode]))
    out = eng.generate(_requests(cfg, Request), arrival_steps=[0, 1, 2, 3])
    assert sorted(r.uid for r in out) == [0, 1, 2, 3]
    for r in out:
        np.testing.assert_array_equal(r.tokens, oracle[r.uid], err_msg=f"{mode} uid {r.uid}")
    if eng.scheduler is not None:
        pool = eng.scheduler.pool
        assert pool.n_active == 0 and eng.obs.recorder.leaked == []
        if pool.paged:
            assert pool.allocator.free_count == pool.n_blocks
            assert pool.allocator.committed == 0
