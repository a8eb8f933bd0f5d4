"""The port's scheduler policies against the JAX package, at reduced
granite-3-2b f32 with params bridged from JAX ``init_params`` (float,
and 6-bit packed where stated): overcommit with recompute-swap
preemption, bit-plane speculative decoding, precision tiers and the
degrade loop (after tests/test_precision_tiers.py and
tests/test_paged_serve.py, with 3 seeds where those use 25).

* every ``SchedulerPolicy`` / ``ServeEngine`` / ``Request`` refusal of
  JAX, refused by the port with the same exception and message;
* ``preemption_order`` equal to JAX's on random candidate lists;
* the same requests through JAX's scheduler and the port's: identical
  tokens, ``plane_log``s, preemption counts per tier, degrade
  transitions and spec draft/accept counts, a drained pool, and the
  port's ``replay_plane_log`` equal to its served tokens;
* a grouped decode step writes each lane's row once, in its own
  group's dispatch, and leaves the other rows alone;
* the launcher's policy flags on ``--device cpu``.

Tokens and counts are compared exactly; no tolerance is involved."""
import functools
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import reduced_config as j_reduced_config
from repro.core.packing import pack_model_params as j_pack_model_params
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.scheduler import SchedulerPolicy as JPolicy
from repro.serve.scheduler import preemption_order as j_preemption_order
from repro.serve.slots import SlotState as JSlotState
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as ttf
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.quality import replay_plane_log
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.scheduler import SchedulerPolicy, preemption_order
from repro_torch.serve.slots import SlotPool, SlotState

ARCH = "granite-3-2b"
N_BITS = 6
MAX_LEN = 48
POLICY = dict(n_slots=3, chunked_prefill=True, chunk_sizes=(8, 1), paged=True, block_size=4,
              n_blocks=14)


@pytest.fixture(scope="module")
def models():
    jcfg = j_reduced_config(ARCH)
    jparams = jax.jit(functools.partial(jtf.init_params, cfg=jcfg))(jax.random.PRNGKey(0))
    jpacked = jax.jit(functools.partial(j_pack_model_params, n_bits=N_BITS))(jparams)
    return {"jcfg": jcfg, "cfg": reduced_config(ARCH),
            "float": (jparams, bridge.from_numpy_tree(jparams)),
            "packed": (jpacked, bridge.from_numpy_tree(jpacked))}


def _side(models, which):
    """The JAX package or the port, behind one namespace, so a case is
    written once and built on both."""
    if which == "jax":
        cfg, i = models["jcfg"], 0

        def engine(params, cfg=cfg, **kw):
            return JServeEngine(params, cfg, max_len=MAX_LEN, **kw)

        ns = dict(Policy=JPolicy, Request=JRequest)
    else:
        cfg, i = models["cfg"], 1

        def engine(params, cfg=cfg, **kw):
            return ServeEngine(params, cfg, max_len=MAX_LEN, device="cpu", **kw)

        ns = dict(Policy=SchedulerPolicy, Request=Request)
    return types.SimpleNamespace(Engine=engine, float=models["float"][i],
                                 packed=models["packed"][i], which=which, **ns)


def _pol(m, **kw):
    return m.Policy(**{**POLICY, **kw})


def _tiered(m, **kw):
    return m.Engine(m.packed, continuous=True, policy=_pol(m, **kw))


def _one(m, **kw):
    return [m.Request(uid=0, tokens=np.arange(4, dtype=np.int32), max_new=2, **kw)]


def _gemma3_spec(m, models):
    if m.which == "jax":
        cfg = j_reduced_config("gemma3-12b")
        params = jax.jit(functools.partial(jtf.init_params, cfg=cfg))(jax.random.PRNGKey(0))
    else:
        cfg = reduced_config("gemma3-12b")
        params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return m.Engine(params, cfg=cfg, continuous=True, policy=_pol(m, spec_decode=True))


# name -> (build on one side, the message both must match)
REFUSALS = {
    "tiers_need_chunked_prefill": (
        lambda m: m.Policy(n_slots=2, precision_tiers={"economy": 3}), "chunked_prefill"),
    "degrade_needs_chunked_prefill": (
        lambda m: m.Policy(n_slots=2, degrade=True), "chunked_prefill"),
    "full_is_not_remapped": (lambda m: _pol(m, precision_tiers={"full": 6}), "remap"),
    "tier_of_zero_planes": (lambda m: _pol(m, precision_tiers={"economy": 0}), "int >= 1"),
    "tier_of_fractional_planes": (
        lambda m: _pol(m, precision_tiers={"economy": 2.5}), "int >= 1"),
    "floors_alone_are_inert": (
        lambda m: _pol(m, precision_floors={"economy": 2}), "silently inert"),
    "floor_of_zero": (lambda m: _pol(m, degrade=True, precision_floors={"economy": 0}),
                      ">= 1"),
    "degrade_queue_depth_zero": (
        lambda m: _pol(m, degrade=True, degrade_queue_depth=0), "degrade_queue_depth"),
    "degrade_occupancy_past_one": (
        lambda m: _pol(m, degrade=True, degrade_occupancy=1.5), "degrade_occupancy"),
    "degrade_preempt_rate_negative": (
        lambda m: _pol(m, degrade=True, degrade_preempt_rate=-0.5), "degrade_preempt_rate"),
    "degrade_window_zero": (
        lambda m: _pol(m, degrade=True, degrade_window=0), "degrade_window"),
    "degrade_hysteresis_zero": (
        lambda m: _pol(m, degrade=True, degrade_hysteresis=0), "degrade_hysteresis"),
    "spec_tier_at_the_draft": (
        lambda m: _pol(m, spec_decode=True, draft_planes=3, precision_tiers={"economy": 3}),
        "draft"),
    "spec_tier_below_the_draft": (
        lambda m: _pol(m, spec_decode=True, draft_planes=3, precision_tiers={"economy": 2}),
        "draft"),
    "spec_needs_paged": (lambda m: m.Policy(n_slots=2, spec_decode=True), "paged"),
    "draft_planes_zero": (lambda m: _pol(m, spec_decode=True, draft_planes=0),
                          "draft_planes"),
    "gamma_zero": (lambda m: _pol(m, spec_decode=True, gamma=0), "gamma"),
    "overcommit_below_one": (lambda m: _pol(m, overcommit=0.5), "overcommit"),
    "overcommit_needs_paged": (lambda m: m.Policy(n_slots=2, overcommit=2.0), "paged"),
    "tiers_need_a_packed_model": (
        lambda m: m.Engine(m.float, continuous=True,
                           policy=_pol(m, precision_tiers={"economy": 3})), "bit planes"),
    "tier_above_n_bits": (lambda m: _tiered(m, precision_tiers={"economy": N_BITS + 1}),
                          "n_bits"),
    "draft_at_n_bits_with_tiers": (
        lambda m: _tiered(m, spec_decode=True, draft_planes=N_BITS, degrade=True), "draft"),
    "spec_needs_continuous": (lambda m: m.Engine(m.packed, spec_decode=True), "continuous"),
    "unknown_precision_class": (
        lambda m: _tiered(m, precision_tiers={"economy": 3}).generate(
            _one(m, precision="gold")), "unknown precision class"),
    "explicit_zero_planes": (
        lambda m: _tiered(m, precision_tiers={"economy": 3}).generate(_one(m, precision=0)),
        "must be in"),
    "explicit_planes_above_n_bits": (
        lambda m: _tiered(m, precision_tiers={"economy": 3}).generate(
            _one(m, precision=N_BITS + 1)), "must be in"),
    "untiered_refuses_economy": (
        lambda m: _tiered(m).generate(_one(m, precision="economy")), "no precision tiers"),
    "explicit_planes_at_the_draft": (
        lambda m: _tiered(m, spec_decode=True, draft_planes=2,
                          precision_tiers={"economy": 4}).generate(_one(m, precision=2)),
        "draft"),
    "spec_refuses_sampling": (
        lambda m: _tiered(m, spec_decode=True).generate(_one(m, temperature=0.7)), "greedy"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS) + ["spec_refuses_local_layers"])
def test_refusals_match_jax(models, case):
    """What JAX refuses, the port refuses: the same exception type, and a
    message with the same key phrase.  No such refusal is a "later
    slice" one any more."""
    if case == "spec_refuses_local_layers":  # gemma3-12b's "local" rings
        build, match = (lambda m: _gemma3_spec(m, models)), "attention-only"
    else:
        build, match = REFUSALS[case]
    errors = {}
    for which in ("jax", "torch"):
        with pytest.raises(Exception) as err:
            build(_side(models, which))
        errors[which] = err
    assert errors["jax"].type is ValueError and errors["torch"].type is ValueError
    assert errors["jax"].match(match) and errors["torch"].match(match)


def test_policies_jax_accepts_are_accepted(models):
    m = _side(models, "torch")
    pol = _pol(m, overcommit=2.0, spec_decode=True, draft_planes=3,
               precision_tiers={"economy": 4}, degrade=True, precision_floors={"economy": 4})
    eng = m.Engine(m.packed, continuous=True, policy=pol)
    assert eng.scheduler._tiered and eng.scheduler._shed_ceiling == N_BITS - 4
    # each plane count is one int32 tensor on the engine's device, made once
    assert sorted(eng.scheduler._plane_t) == list(range(1, N_BITS + 1))
    assert all(t.dtype == torch.int32 and t.numel() == 1
               for t in eng.scheduler._plane_t.values())


@settings(max_examples=60, deadline=None)
@given(cands=st.lists(st.tuples(st.integers(0, 31), st.booleans(), st.integers(0, 100)),
                      min_size=1, max_size=16))
def test_preemption_order_matches_jax(cands):
    lanes = [(slot, "latency" if lat else "throughput", seq) for slot, lat, seq in cands]
    ours = preemption_order([(s, SlotState(tier=t, admit_seq=q)) for s, t, q in lanes])
    theirs = j_preemption_order([(s, JSlotState(tier=t, admit_seq=q)) for s, t, q in lanes])
    assert ([(s, st_.tier, st_.admit_seq) for s, st_ in ours]
            == [(s, st_.tier, st_.admit_seq) for s, st_ in theirs])


# ---------------------------------------------------------------------------
# served through both schedulers
# ---------------------------------------------------------------------------


def _rand_reqs(cls, vocab, n, max_new, seed, precision=lambda i: "full"):
    """tests/test_precision_tiers.py::_reqs, with a precision per uid."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, tokens=rng.integers(0, vocab, size=int(rng.integers(3, 11)))
                .astype(np.int32), max_new=max_new, precision=precision(i))
            for i in range(n)]


def _preempt_reqs(cls, vocab, seed, **kw):
    """Three 10-token prompts, 11 new tokens each, uid 0 latency-tier: on
    an 8-block pool at overcommit 2.0 the scheduler must preempt."""
    rng = np.random.default_rng(seed)
    return [cls(uid=i, tokens=rng.integers(0, vocab, size=10).astype(np.int32), max_new=11,
                tier="latency" if i == 0 else "throughput", **kw) for i in range(3)]


def _spec_schedule(cls, vocab, seed):
    """Mixed prompt lengths, staggered arrivals, up to 12 new tokens."""
    rng = np.random.default_rng(seed)
    reqs = [cls(uid=i, tokens=rng.integers(0, vocab, size=int(rng.integers(1, 13)))
                .astype(np.int32), max_new=int(rng.integers(4, 13))) for i in range(6)]
    return reqs, np.cumsum(rng.integers(0, 3, size=6)).tolist()


def _econ_odd(i):
    return "economy" if i % 2 else "full"


# name -> (params kind, policy, requests(cls, vocab), arrivals, force_shed)
SCENARIOS = {
    "fixed_tiers": ("packed", dict(precision_tiers={"economy": 3}),
                    lambda c, v: _rand_reqs(c, v, 4, 6, 1, _econ_odd), [0, 0, 1, 2], None),
    "forced_degrade_schedule": (
        "packed", dict(precision_tiers={"economy": 4}, degrade=True),
        lambda c, v: _rand_reqs(c, v, 4, 8, 2, lambda i: "economy" if i == 3 else "full"),
        [0, 0, 1, 2], lambda step: (step // 2) % 4),
    "plane_grouping_off": (
        "packed", dict(precision_tiers={"economy": 3}, plane_grouping=False),
        lambda c, v: _rand_reqs(c, v, 2, 6, 4, lambda i: "economy" if i else "full"),
        [0, 0], None),
    "degrade_under_queue_pressure": (
        "packed", dict(n_slots=2, n_blocks=20, degrade=True, degrade_queue_depth=1,
                       degrade_hysteresis=2),
        lambda c, v: _rand_reqs(c, v, 6, 8, 5), None, None),
    "degrade_floor_clamps": (
        "packed", dict(n_slots=2, n_blocks=20, degrade=True, degrade_queue_depth=1,
                       precision_floors={"full": 4}),
        lambda c, v: _rand_reqs(c, v, 4, 6, 6), None, lambda step: 99),
    "spec_with_tiers_verifies_at_effective_planes": (
        "packed", dict(spec_decode=True, draft_planes=2, gamma=3,
                       precision_tiers={"economy": 4}),
        lambda c, v: _rand_reqs(c, v, 4, 8, 7), [0, 0, 1, 2], None),
    "spec_tiers_economy_and_degrade": (
        "packed", dict(spec_decode=True, draft_planes=2, gamma=3,
                       precision_tiers={"economy": 4}, degrade=True),
        lambda c, v: _rand_reqs(c, v, 4, 8, 11, _econ_odd), [0, 0, 1, 2],
        lambda step: (step // 2) % 3),
    "degrade_across_preemption": (
        "packed", dict(n_blocks=8, overcommit=2.0, degrade=True),
        lambda c, v: _preempt_reqs(c, v, 8), None, lambda step: (step // 3) % 2),
    "forced_preemption_float": (
        "float", dict(n_blocks=8, overcommit=2.0), lambda c, v: _preempt_reqs(c, v, 3),
        None, None),
    "forced_preemption_packed": (
        "packed", dict(n_blocks=8, overcommit=2.0), lambda c, v: _preempt_reqs(c, v, 3),
        None, None),
    "spec_under_overcommit_preemption": (
        "packed", dict(n_blocks=8, overcommit=2.0, spec_decode=True, draft_planes=2, gamma=4),
        lambda c, v: _preempt_reqs(c, v, 3), None, None),
}


def _by_tier(sched):
    return {lbls["tier"]: int(c.value) for lbls, c in sched._c_preempt.children()}


def _assert_drained(engine):
    pool = engine.scheduler.pool
    assert pool.n_active == 0
    assert pool.allocator.free_count == pool.n_blocks and pool.allocator.committed == 0
    rec = engine.obs.recorder
    assert rec.leaked == []
    for tr in rec.traces():
        assert tr.terminal_count() == 1, (tr.uid, [e.kind for e in tr.events])


def _serve_both(models, kind, policy, make_reqs, arrivals, force_shed):
    out = {}
    for which in ("jax", "torch"):
        m = _side(models, which)
        eng = m.Engine(getattr(m, kind), continuous=True, policy=_pol(m, **policy))
        eng.scheduler.force_shed = force_shed
        reqs = make_reqs(m.Request, models["cfg"].vocab_size)
        out[which] = (eng, reqs, {r.uid: r for r in eng.generate(reqs, arrival_steps=arrivals)})
    return out


def _counts(sched):
    return {"preempted": _by_tier(sched), "sheds": sched.degrade_sheds,
            "restores": sched.degrade_restores, "rounds": sched.spec_rounds,
            "drafted": sched.spec_drafted, "accepted": sched.spec_accepted,
            "committed": sched.spec_committed, "decode_steps": sched.decode_steps,
            "prefill_chunks": sched.prefill_chunks}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_matches_jax(models, name):
    """One workload through JAX's scheduler and the port's: identical
    tokens, plane logs, preemptions per tier, degrade transitions, spec
    counts, decode steps and prefill chunks; the port drains its pool and
    closes every span; on a tiered engine the port's replay of each plane
    log by static truncation gives its served tokens."""
    kind, policy, make_reqs, arrivals, force_shed = SCENARIOS[name]
    runs = _serve_both(models, kind, policy, make_reqs, arrivals, force_shed)
    (jeng, _, jout), (eng, reqs, out) = runs["jax"], runs["torch"]
    assert sorted(out) == sorted(jout) == [r.uid for r in reqs]
    for uid, r in out.items():
        np.testing.assert_array_equal(r.tokens, jout[uid].tokens, err_msg=f"uid {uid}")
        if jout[uid].plane_log is None:
            assert r.plane_log is None
        else:
            np.testing.assert_array_equal(r.plane_log, jout[uid].plane_log)
            assert len(r.plane_log) == len(r.tokens) and r.plane_log[0] == N_BITS
    sched = eng.scheduler
    assert _counts(sched) == _counts(jeng.scheduler)
    _assert_drained(eng)
    if policy.get("overcommit", 1.0) > 1.0:
        assert sched.preemptions_total() > 0 and _by_tier(sched).get("latency", 0) == 0
        kinds = [e.kind for tr in eng.obs.recorder.traces() for e in tr.events]
        assert obs_trace.PREEMPTED in kinds and obs_trace.RE_PREFILL in kinds
    if policy.get("degrade") and force_shed is not None and name != "degrade_floor_clamps":
        assert sched.degrade_sheds > 0 and sched.degrade_restores > 0
    if name == "degrade_floor_clamps":
        assert min(np.concatenate([r.plane_log for r in out.values()])) >= 4
    if name == "spec_with_tiers_verifies_at_effective_planes":
        assert all((r.plane_log == N_BITS).all() for r in out.values())
    if sched._tiered:
        assert sched.tier_dispatches + sched.tier_verifies > 0
        prompts = {r.uid: r.tokens for r in reqs}
        params = _side(models, "torch").packed
        for uid, r in out.items():
            np.testing.assert_array_equal(
                replay_plane_log(params, models["cfg"], prompts[uid], r.plane_log, MAX_LEN),
                r.tokens, err_msg=f"replay of uid {uid}")


@pytest.fixture(scope="module")
def spec_engines(models):
    pol = dict(n_blocks=12, spec_decode=True, draft_planes=4, gamma=4)
    j, t = _side(models, "jax"), _side(models, "torch")
    return {"jax": j.Engine(j.packed, continuous=True, policy=_pol(j, **pol)),
            "spec": t.Engine(t.packed, continuous=True, policy=_pol(t, **pol)),
            "plain": t.Engine(t.packed, continuous=True, policy=_pol(t, n_blocks=12))}


@pytest.mark.parametrize("seed", range(3))
def test_spec_decode_matches_jax_and_non_spec(models, spec_engines, seed):
    """Seeded schedules through module-scoped engines (lanes and blocks
    reused from seed to seed): the port's spec tokens equal JAX's spec
    tokens and the port's non-speculative tokens, with JAX's draft,
    accept and round counts; rejected drafts rewind, some freeing a
    tail block, and the pool drains."""
    vocab = models["cfg"].vocab_size
    jreqs, arrivals = _spec_schedule(JRequest, vocab, seed)
    reqs, _ = _spec_schedule(Request, vocab, seed)
    for eng in spec_engines.values():
        eng.scheduler.reset_telemetry()
    jout = {r.uid: r.tokens for r in spec_engines["jax"].generate(jreqs, arrival_steps=arrivals)}
    out = {r.uid: r.tokens for r in spec_engines["spec"].generate(reqs, arrival_steps=arrivals)}
    plain = {r.uid: r.tokens
             for r in spec_engines["plain"].generate(reqs, arrival_steps=arrivals)}
    assert sorted(out) == sorted(jout) == sorted(plain) == list(range(len(reqs)))
    for uid in out:
        np.testing.assert_array_equal(out[uid], jout[uid])
        np.testing.assert_array_equal(out[uid], plain[uid])
    sched, jsched = spec_engines["spec"].scheduler, spec_engines["jax"].scheduler
    assert _counts(sched) == _counts(jsched)
    assert 0 < sched.spec_accepted < sched.spec_drafted
    # every draft dispatch passed the draft plane count as a tensor
    assert sched.draft_steps >= sched.spec_rounds > 0 and sched.tier_dispatches == 0
    _assert_drained(spec_engines["spec"])
    rollbacks = [e.attrs for tr in spec_engines["spec"].obs.recorder.traces()
                 for e in tr.events if e.kind == obs_trace.ROLLBACK]
    assert rollbacks and any(a["freed_blocks"] > 0 for a in rollbacks)


def test_spec_commit_rewind_never_leaks_blocks(models):
    """tests/test_paged_serve.py's pool-level property on the port's
    SlotPool: after every commit the lane holds exactly the blocks of its
    verified rows, and admit/round/evict interleavings drain the pool."""
    cfg = models["cfg"]
    rng = np.random.default_rng(0)
    freed_any = 0
    for trial in range(10):
        n_blocks = int(rng.integers(8, 17))
        pool = SlotPool(cfg, 3, MAX_LEN, cache_dtype=torch.float32, paged=True,
                        block_size=4, n_blocks=n_blocks, device="cpu")
        alloc, uid = pool.allocator, 0
        for _ in range(40):
            kind, free = int(rng.integers(0, 3)), pool.free_slots()
            if kind == 0 and free:
                plen, max_new = int(rng.integers(1, 9)), int(rng.integers(1, 9))
                if alloc.committed + alloc.blocks_for_rows(plen + max_new - 1) \
                        > alloc.commit_capacity:
                    continue
                slot = free[0]
                pool.admit(slot, uid, np.arange(plen, dtype=np.int32), max_new, 0.0, now=0,
                           wall=0.0)
                uid += 1
                pool.grow_rows(slot, plen)
                s = pool.slots[slot]
                s.phase, s.tokens, s.remaining = "decode", [0], max_new - 1
            elif kind == 1:
                lanes = [i for i in range(pool.n_slots) if pool.slots[i].uid is not None
                         and pool.slots[i].remaining > 0]
                if not lanes:
                    continue
                slot = lanes[int(rng.integers(0, len(lanes)))]
                s = pool.slots[slot]
                plen, g = len(s.prompt), len(s.tokens)
                gam = int(rng.integers(1, min(4, s.remaining) + 1))
                pool.grow_many({slot: plen + g + gam - 1})
                c = int(rng.integers(1, gam + 1))
                freed_any += pool.commit_spec(slot, rng.integers(0, 100, size=c).tolist())
                assert len(s.blocks) == alloc.blocks_for_rows(plen + len(s.tokens) - 1)
                if s.remaining == 0:
                    pool.evict(slot)
            elif kind == 2:
                live = [i for i in range(pool.n_slots) if pool.slots[i].uid is not None]
                if live:
                    pool.evict(live[int(rng.integers(0, len(live)))])
        for i in range(pool.n_slots):
            if pool.slots[i].uid is not None:
                pool.evict(i)
        assert alloc.free_count == n_blocks and alloc.committed == 0, trial
    assert freed_any > 0


def test_untiered_engine_unchanged(models):
    """No tiers, no degrade: no plane bookkeeping, no plane metrics, no
    plane-count tensor passed (the static kernel at every projection),
    ``plane_log`` None, and the tokens of the JAX untiered engine."""
    runs = _serve_both(models, "packed", {}, lambda c, v: _rand_reqs(c, v, 2, 4, 9), None, None)
    (_, _, jout), (eng, _, out) = runs["jax"], runs["torch"]
    for uid, r in out.items():
        assert r.plane_log is None
        np.testing.assert_array_equal(r.tokens, jout[uid].tokens)
    sched = eng.scheduler
    assert not sched._tiered and sched.plane_dispatches() == 0
    assert sched._g_active_planes is None and sched._c_degrade is None


def test_grouped_decode_writes_each_lane_once_in_its_group(models):
    """A tiered step's dispatches: group A (lanes 0, 2) at 5 planes, then
    group B (lane 1) at 3, each under its own ``act`` mask.  Each lane's
    K/V row equals the one a single dispatch at its group's count writes,
    every other row of the pool's blocks is left as it was, and the later
    group's dispatch leaves the earlier group's rows alone."""
    cfg, params = models["cfg"], models["packed"][1]
    pool = SlotPool(cfg, 3, MAX_LEN, paged=True, block_size=4, n_blocks=14, device="cpu")
    rng = np.random.default_rng(0)
    for leaf in ("k", "v"):
        t = pool.cache["blocks"]["p0"][leaf]
        t.copy_(torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32)))
    table = torch.from_numpy(rng.permutation(14)[:12].reshape(3, 4).astype(np.int32))
    tok = torch.tensor([[5], [9], [13]])
    pos = torch.tensor([3, 6, 10], dtype=torch.int32)
    planes = {k: torch.tensor([k], dtype=torch.int32) for k in (3, 5)}
    groups = {5: torch.tensor([True, False, True]), 3: torch.tensor([False, True, False])}

    def step(cache, act, k):
        return ttf.decode_step(params, cache, tok, pos, cfg, active=act,
                               active_planes=planes[k], block_table=table)[0]

    def clone(cache):
        return {k: {p: {n: t.clone() for n, t in d.items()} for p, d in v.items()}
                for k, v in cache.items()}

    before = clone(pool.cache)
    grouped = clone(pool.cache)
    for k in (5, 3):  # costliest group first
        step(grouped, groups[k], k)
    every = torch.ones(3, dtype=torch.bool)
    single = {k: clone(pool.cache) for k in (5, 3)}
    for k in (5, 3):
        step(single[k], every, k)
    for leaf in ("k", "v"):
        got = grouped["blocks"]["p0"][leaf]
        want = before["blocks"]["p0"][leaf].clone()
        for lane, k in ((0, 5), (1, 3), (2, 5)):
            blk, row = table[lane, int(pos[lane]) // 4], int(pos[lane]) % 4
            want[:, blk, row] = single[k]["blocks"]["p0"][leaf][:, blk, row]
            assert not torch.equal(want[:, blk, row], before["blocks"]["p0"][leaf][:, blk, row])
        # the pool's last block is the drop sentinel that frozen lanes
        # write to (JAX drops those writes): the 14 real blocks must match
        assert torch.equal(got[:, :14], want[:, :14])


@pytest.mark.parametrize("argv", [
    ["--spec-decode", "--draft-planes", "3", "--gamma", "4", "--overcommit", "2",
     "--blocks", "6", "--tier", "mixed"],
    ["--precision-tier", "mixed", "--economy-planes", "3", "--degrade",
     "--degrade-queue-depth", "1", "--degrade-hysteresis", "2", "--requests", "8"],
])
def test_launcher_serves_the_policy_flags_on_cpu(argv, capsys):
    from repro_torch.launch import serve as launcher

    base = ["--device", "cpu", "--continuous", "--paged", "--paged-kernel", "--slots", "3",
            "--block-size", "16", "--packed-bits", "6", "--prompt-len", "8", "--mixed-lens",
            "--max-new", "10", "--smoke"]
    if "--requests" not in argv:
        base += ["--requests", "5"]
    results = launcher.main(base + argv)
    out = capsys.readouterr().out
    assert len(results) == (8 if "--requests" in argv else 5)
    assert "OBS_SMOKE_OK" in out and "leaked_blocks=0" in out
    assert ("[spec]" in out and "[overcommit]" in out) if "--spec-decode" in argv \
        else ("[tiers]" in out and "[degrade]" in out)
