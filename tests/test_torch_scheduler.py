"""The port's continuous, chunked and paged serving against the JAX
package, at reduced granite-3-2b f32 (params bridged from JAX
``init_params``; float, and 6-bit packed where stated).

* the block allocator's seeded interleavings (after
  tests/test_paged_serve.py);
* ``prefill_chunk`` with idle lanes and pads, and a paged
  ``decode_step`` with an inactive lane, against JAX on the same inputs:
  the logits of the live lanes and the WHOLE cache, which pins where the
  writes JAX drops (``mode="drop"``) go in the port (its sentinel block
  and spare row, never a live row);
* the occupancy-aware chunk picker against JAX's;
* seeded schedules through the port's legacy, chunked, paged and
  paged-kernel engines: greedy tokens identical to the JAX bucketed
  oracle, zero leaked blocks, every span closed.

Tolerance of the logit and cache comparisons: 2e-4 absolute and
relative (f32 at width 64; the two frameworks sum matmuls and softmaxes
in other orders); tokens exact."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as j_reduced_config
from repro.core.packing import pack_model_params as j_pack_model_params
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import ContinuousScheduler as JScheduler
from repro.serve.scheduler import SchedulerPolicy as JPolicy
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as ttf
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.scheduler import ContinuousScheduler, SchedulerPolicy
from repro_torch.serve.slots import BlockAllocator, SlotPool
from test_torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "granite-3-2b"
TOL = 2e-4
MAX_LEN = 48
N_SLOTS = 3
BLOCK_SIZE = 4
N_BLOCKS = 12  # 3 lanes x worst case 5 blocks > 12: admission must hold on blocks
CHUNKS = (8, 1)


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduced_config(ARCH)
    jparams = jax.jit(functools.partial(jtf.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    jpacked = jax.jit(functools.partial(j_pack_model_params, n_bits=6))(jparams)
    return {"jcfg": jcfg, "cfg": reduced_config(ARCH),
            "float": (jparams, bridge.from_numpy_tree(jparams)),
            "packed": (jpacked, bridge.from_numpy_tree(jpacked))}


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.array(want), atol=TOL, rtol=TOL)


def test_block_allocator_randomized_interleavings():
    """Seeded alloc/free interleavings never double-assign a block, and an
    allocation fails only when the pool lacks that many free blocks."""
    rng = np.random.default_rng(0)
    for _ in range(50):
        n_blocks = int(rng.integers(1, 32))
        a = BlockAllocator(n_blocks, int(rng.integers(1, 16)))
        live = []
        for _ in range(40):
            if rng.random() < 0.55:
                k = int(rng.integers(0, n_blocks + 2))
                got = a.alloc(k)
                if k <= n_blocks - len(live):
                    assert got is not None and len(got) == k
                    assert len(set(got)) == k and not set(got) & set(live)
                    assert all(0 <= b < n_blocks for b in got)
                    live.extend(got)
                else:
                    assert got is None
            elif live:
                j = int(rng.integers(1, len(live) + 1))
                out, live = live[:j], live[j:]
                a.free(out)
        assert a.free_count == n_blocks - len(live)
        if live:
            a.free([live[0]])
            with pytest.raises(ValueError, match="double free"):
                a.free([live[0]])


# ---------------------------------------------------------------------------
# prefill_chunk / paged decode_step against JAX, whole caches
# ---------------------------------------------------------------------------

# lane 0 prefills rows [0, 8), lane 1 rows [4, 7) behind 5 pads, lane 2 is
# idle; every lane's table row past its granted blocks names blocks other
# lanes own (stale ids) — writes through them would corrupt those lanes
TABLE = np.array([[5, 0, 9, 3, 7, 1, 2, 4, 6, 8, 10, 11],
                  [2, 8, 5, 0, 9, 3, 7, 1, 4, 6, 10, 11],
                  [0, 5, 2, 8, 9, 3, 7, 1, 4, 6, 10, 11]], np.int32)
C = 8
START = np.array([0, 4, MAX_LEN], np.int32)
NVALID = np.array([8, 3, 0], np.int32)


def _random_caches(jcfg, cfg, seed, paged):
    """The same random cache contents for JAX and the port (the port's
    pool has one sentinel block more, its contiguous cache one row)."""
    rng = np.random.default_rng(seed)
    if paged:
        jcache = jtf.init_cache(jcfg, N_SLOTS, MAX_LEN, jnp.float32, paged_blocks=N_BLOCKS,
                                block_size=BLOCK_SIZE)
        tcache = ttf.init_cache(cfg, N_SLOTS, MAX_LEN, torch.float32, "cpu",
                                paged_blocks=N_BLOCKS, block_size=BLOCK_SIZE)
    else:
        jcache = jtf.init_cache(jcfg, N_SLOTS, MAX_LEN, jnp.float32)
        tcache = ttf.init_cache(cfg, N_SLOTS, MAX_LEN + 1, torch.float32, "cpu")
    for leaf in ("k", "v"):
        t = tcache["blocks"]["p0"][leaf]
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
        jcache["blocks"]["p0"][leaf] = jnp.asarray(
            _jax_part(t, jcache["blocks"]["p0"][leaf].shape).numpy())
    return jcache, tcache


def _jax_part(t, shape):
    """The port's leaf cut to JAX's shape: without the sentinel block or
    the spare row."""
    return t[tuple(slice(0, n) for n in shape)]


def _check_caches(tcache, jcache):
    for leaf in ("k", "v"):
        want = np.array(jcache["blocks"]["p0"][leaf])
        _close(_jax_part(tcache["blocks"]["p0"][leaf], want.shape), want)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("kind", ["float", "packed"])
def test_prefill_chunk_with_idle_lanes_and_pads_matches_jax(models, kind, paged):
    jp, tp = models[kind]
    jcfg, cfg = models["jcfg"], models["cfg"]
    jcache, tcache = _random_caches(jcfg, cfg, seed=1, paged=paged)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (N_SLOTS, C)).astype(np.int32)
    table = TABLE if paged else None
    jl, jcache = jax.jit(functools.partial(jtf.prefill_chunk, cfg=jcfg, cache_dtype=jnp.float32))(
        jp, jcache, jnp.asarray(toks), jnp.asarray(START), jnp.asarray(NVALID),
        block_table=None if table is None else jnp.asarray(table))
    with torch.no_grad():
        tl, _ = ttf.prefill_chunk(tp, tcache, torch.from_numpy(toks).long(),
                                  torch.from_numpy(START), torch.from_numpy(NVALID), cfg,
                                  block_table=None if table is None else torch.from_numpy(table))
    _close(tl[:2], np.array(jl)[:2])  # lane 2 is idle: its logits are garbage in both
    _check_caches(tcache, jcache)


@pytest.mark.parametrize("paged_kernel", [False, True])
@pytest.mark.parametrize("kind", ["float", "packed"])
def test_paged_decode_step_with_an_inactive_lane_matches_jax(models, kind, paged_kernel):
    """Lane 2 is inactive and its table names lane 0's blocks: JAX drops
    its write, the port sends it to the sentinel; lane 0 and lane 1 sit
    mid-block and at a block's first row."""
    jp, tp = models[kind]
    jcfg, cfg = models["jcfg"], models["cfg"]
    jcache, tcache = _random_caches(jcfg, cfg, seed=3, paged=True)
    tok = np.array([[7], [300], [11]], np.int32)
    pos = np.array([9, 8, 5], np.int32)
    active = np.array([True, True, False])
    jl, jcache = jax.jit(functools.partial(jtf.decode_step, cfg=jcfg, paged_kernel=paged_kernel))(
        jp, jcache, jnp.asarray(tok), jnp.asarray(pos), active=jnp.asarray(active),
        block_table=jnp.asarray(TABLE))
    with torch.no_grad():
        tl, _ = ttf.decode_step(tp, tcache, torch.from_numpy(tok).long(), torch.from_numpy(pos),
                                cfg, active=torch.from_numpy(active),
                                block_table=torch.from_numpy(TABLE), paged_kernel=paged_kernel)
    _close(tl[:2], np.array(jl)[:2])
    _check_caches(tcache, jcache)


def test_pick_chunk_matches_jax():
    """The occupancy-aware chunk picker, over a grid of (remaining,
    n_decoding), chunk tables, pool sizes and both picker modes."""
    for sizes in ((128, 32, 1), (8, 1), (64, 16, 4, 1)):
        for n_slots in (3, 8):
            for occ in (True, False):
                kw = dict(n_slots=n_slots, chunked_prefill=True, chunk_sizes=sizes,
                          occupancy_chunking=occ)
                pool = types.SimpleNamespace(n_slots=n_slots)
                ours = types.SimpleNamespace(policy=SchedulerPolicy(**kw), pool=pool)
                theirs = types.SimpleNamespace(policy=JPolicy(**kw), pool=pool)
                for rem in (1, 2, 7, 8, 9, 31, 32, 33, 100, 128, 300):
                    for n_dec in range(n_slots + 1):
                        assert (ContinuousScheduler._pick_chunk(ours, rem, n_dec)
                                == JScheduler._pick_chunk(theirs, rem, n_dec)), (
                            sizes, n_slots, occ, rem, n_dec)


def test_policy_validation_and_paged_pool_bytes(models):
    cfg, tp = models["cfg"], models["float"][1]
    with pytest.raises(ValueError, match="chunked_prefill"):
        SchedulerPolicy(n_slots=2, paged=True)
    with pytest.raises(ValueError, match="paged=True"):
        SchedulerPolicy(n_slots=2, chunked_prefill=True, paged_kernel=True)
    with pytest.raises(ValueError, match="continuous"):
        ServeEngine(tp, cfg, max_len=32, device="cpu", paged=True)
    # the pool holds n_blocks + 1 blocks (the sentinel), the dense cache
    # max_len + 1 rows (the spare row): 4 x 65 rows against 9 x 8
    dense = SlotPool(cfg, 4, 64, device="cpu")
    small = SlotPool(cfg, 4, 64, paged=True, block_size=8, n_blocks=8, device="cpu")
    assert dense.cache_bytes() * 9 * 8 == small.cache_bytes() * 4 * 65


# ---------------------------------------------------------------------------
# Seeded schedules: port engines == JAX bucketed oracle
# ---------------------------------------------------------------------------


def _engine(models, **policy):
    return ServeEngine(models["float"][1], models["cfg"], max_len=MAX_LEN, device="cpu",
                       continuous=True, policy=SchedulerPolicy(n_slots=N_SLOTS, **policy))


@pytest.fixture(scope="module")
def engines(models):
    paged = dict(chunked_prefill=True, chunk_sizes=CHUNKS, paged=True, block_size=BLOCK_SIZE,
                 n_blocks=N_BLOCKS)
    return {"legacy": _engine(models),
            "chunked": _engine(models, chunked_prefill=True, chunk_sizes=CHUNKS),
            "paged": _engine(models, **paged),
            "paged_kernel": _engine(models, paged_kernel=True, **paged)}


def _schedule(seed, vocab, cls):
    """tests/test_paged_serve.py::_random_schedule: mixed prompt lengths,
    staggered arrivals."""
    rng = np.random.default_rng(seed)
    reqs = [cls(uid=i,
                tokens=rng.integers(0, vocab, size=int(rng.integers(1, 13))).astype(np.int32),
                max_new=int(rng.integers(1, 7)))
            for i in range(6)]
    return reqs, np.cumsum(rng.integers(0, 3, size=6)).tolist()


def _assert_drained(engine):
    pool = engine.scheduler.pool
    assert pool.n_active == 0
    if pool.paged:
        assert pool.allocator.free_count == pool.n_blocks
        assert pool.allocator.committed == 0
    rec = engine.obs.recorder
    assert rec.leaked == []
    for tr in rec.traces():
        assert tr.terminal_count() == 1, (tr.uid, [e.kind for e in tr.events])
        if tr.terminal.kind == obs_trace.FINISHED:
            assert tr.find(obs_trace.ADMITTED) and tr.find(obs_trace.FIRST_TOKEN)


@pytest.mark.parametrize("seed", range(4))
def test_seeded_schedules_match_the_jax_bucketed_oracle(models, engines, seed):
    jreqs, _ = _schedule(seed, models["cfg"].vocab_size, JRequest)
    ref = {r.uid: r.tokens for r in
           JServeEngine(models["float"][0], models["jcfg"], max_len=MAX_LEN).generate(jreqs)}
    reqs, arrivals = _schedule(seed, models["cfg"].vocab_size, Request)
    for name, eng in engines.items():
        out = eng.generate(reqs, arrival_steps=arrivals)
        assert sorted(r.uid for r in out) == list(range(len(reqs))), name
        for r in out:
            np.testing.assert_array_equal(r.tokens, ref[r.uid], err_msg=f"{name} uid {r.uid}")
        _assert_drained(eng)
    if seed == 0:
        # a client disconnects mid-stream, lanes possibly mid-prefill: the
        # pool comes back clean, and the next seed's run on the same
        # engines proves it stayed serviceable
        for name in ("paged", "paged_kernel"):
            it = engines[name].stream(reqs, arrival_steps=arrivals)
            for _ in range(len(reqs) // 2):
                next(it)
            it.close()
            _assert_drained(engines[name])
            kinds = {t.terminal.kind for t in engines[name].obs.recorder.traces()}
            assert obs_trace.EVICTED in kinds or obs_trace.ABANDONED in kinds
