"""Continuous-batching scheduler: admission queue + slot-pool decode loop.

PyTorch port of the continuous, chunked and paged core of
``repro.serve.scheduler``.  One :class:`~repro_torch.serve.slots.SlotPool`
holds ``n_slots`` persistent lanes; the loop is::

    while queue or active lanes:
        admit:   every placeable queued request claims a lane
        prefill: (chunked mode) ONE prefill_chunk call advances every
                 prefilling lane by up to C prompt tokens
        decode:  ONE pooled decode step over all n_slots lanes, driven by
                 the per-slot position vector and the ``act`` phase mask
        sample:  per-lane greedy/temperature on the pooled logits
        evict:   lanes that hit max_new stream a Result out and free up;
                 the next admission joins mid-flight

Two prefill styles:

* **Legacy (default)**: admission runs a batch-1 ``transformer.prefill``
  and scatters the fragment into the lane.  Kept as the reference.
* **Chunked** (``SchedulerPolicy(chunked_prefill=True)``): admission only
  claims lanes, and prompts stream through ``transformer.prefill_chunk``
  in fixed-size chunks (pad-to-chunk, per-lane ``start``/``n_valid``),
  interleaved with pooled decode steps, so a long prompt never blocks
  live lanes.  The chunk size comes from ``chunk_sizes``, occupancy-aware
  (:meth:`ContinuousScheduler._pick_chunk`).

**Paged KV** (``SchedulerPolicy(paged=True)``, requires chunked prefill):
the pool's attention caches become a global block pool + per-lane block
tables (``serve.slots``).  Admission checks block capacity on top of free
lanes (first-chunk demand against free blocks, worst-case lifetime demand
against uncommitted capacity, which makes on-demand growth infallible),
each prefill chunk and decode step grants the blocks its writes land in,
and eviction returns them.  ``paged_kernel=True`` reads decode attention
through the paged-attention CUDA kernel on the card.

**Compiled programs.**  The JAX scheduler counts compiled XLA programs
(``compiled_decode_programs() == 1``, the ``serve_compiled_programs``
gauge).  Eager PyTorch compiles nothing, so that count has no
counterpart here and none is reported.  The property it stood for is
kept: the decode step's tensor shapes depend only on ``n_slots`` and
``blocks_per_lane`` (``tok (n_slots, 1)``, ``pos``/``act (n_slots,)``,
the table), whatever the arrival pattern, and ``transformer.decode_step``
never syncs the host, so one CUDA graph could capture it.  The loop
syncs once per step, to read the sampled tokens.

Admission policy (:class:`SchedulerPolicy`): FIFO within an SLO tier
(``latency`` outranks ``throughput``; a request waiting ``aging_steps``
steps is promoted) with optional max-wait batching (``min_admit`` /
``max_wait``).  Time is measured in scheduler steps (one pooled decode =
one step); simulated arrivals are on that clock.

Overcommit with preemption, speculative decoding, precision tiers and
the degrade loop come with a later slice: their policy switches raise
``NotImplementedError``.

**Observability**: the scheduler emits through the engine's
:class:`repro_torch.obs.Observability` bundle the metrics and the
per-request spans of the JAX scheduler (``enqueued -> admitted(slot[,
blocks]) -> prefill_chunk* -> first_token -> decode_step* ->
finished|abandoned|evicted``); ``Result.prefill_ms`` is the request's
``admitted -> first_token`` span.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import transformer
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .slots import SlotPool, reset_recurrent_slots, scatter_slot


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} comes with a later slice of the port")


@dataclasses.dataclass
class SchedulerPolicy:
    """Admission knobs.  Defaults: admit greedily, legacy batch-1 prefill."""

    n_slots: int = 8
    min_admit: int = 1  # batch admissions until this many can go together
    max_wait: int = 0  # ...but never hold the oldest more than this many steps
    chunked_prefill: bool = False  # prompts stream through the pooled step
    # fixed chunk sizes (pad-to-chunk); the picker draws from this table
    chunk_sizes: Tuple[int, ...] = (128, 32, 1)
    # paged KV: a global pool of fixed-size blocks + per-lane block
    # tables; n_blocks=None sizes the pool to the unpaged capacity
    paged: bool = False
    block_size: int = 32
    n_blocks: Optional[int] = None
    # decode attention reads the pool through the paged-attention kernel
    paged_kernel: bool = False
    overcommit: float = 1.0  # > 1.0 (preemption) comes with a later slice
    # anti-starvation aging: a request that has waited this many steps is
    # admitted with the latency class
    aging_steps: int = 64
    # scale the prefill chunk down as more lanes decode; False restores
    # the static smallest-covering-chunk rule
    occupancy_chunking: bool = True
    spec_decode: bool = False  # later slice
    precision_tiers: Optional[Dict[str, int]] = None  # later slice
    precision_floors: Optional[Dict[str, int]] = None  # later slice
    degrade: bool = False  # later slice
    # per-step telemetry lives in fixed-size reservoirs of this many entries
    telemetry_capacity: int = obs_metrics.DEFAULT_HISTOGRAM_CAPACITY

    def __post_init__(self):
        if self.min_admit > 1 and self.max_wait <= 0:
            raise ValueError(
                "min_admit > 1 requires max_wait > 0: with max_wait=0 the hold "
                "window is empty and min_admit would be silently inert")
        if self.chunked_prefill and (
                not self.chunk_sizes or any(c < 1 for c in self.chunk_sizes)):
            raise ValueError(f"chunk_sizes={self.chunk_sizes!r}: need at least one size >= 1")
        if self.paged:
            if not self.chunked_prefill:
                raise ValueError(
                    "paged=True requires chunked_prefill=True: legacy batch-1 admission "
                    "scatters a contiguous lane row the block pool does not have")
            if self.block_size < 1:
                raise ValueError(f"block_size={self.block_size}: need >= 1")
            if self.n_blocks is not None and self.n_blocks < 1:
                raise ValueError(f"n_blocks={self.n_blocks}: need >= 1 (or None)")
        if self.paged_kernel and not self.paged:
            raise ValueError("paged_kernel=True requires paged=True: the kernel walks the "
                             "block table a dense cache does not have")
        if self.overcommit < 1.0:
            raise ValueError(f"overcommit={self.overcommit}: factors below 1.0 would "
                             "strand physical blocks behind the commitment gate")
        if self.overcommit > 1.0 and not self.paged:
            raise ValueError("overcommit > 1.0 requires paged=True: only the block pool "
                             "has the commitment accounting")
        if self.aging_steps < 1:
            raise ValueError(f"aging_steps={self.aging_steps}: need >= 1")
        if self.overcommit > 1.0:
            raise _later("overcommit > 1.0 (recompute-swap preemption)")
        if self.spec_decode:
            raise _later("spec_decode (bit-plane speculative decoding)")
        if self.precision_tiers is not None or self.precision_floors is not None:
            raise _later("precision_tiers / precision_floors")
        if self.degrade:
            raise _later("degrade (load-triggered plane shedding)")


@dataclasses.dataclass
class _Pending:
    """A queued request.  (The JAX one also carries the tokens a preempted
    run generated; preemption comes with a later slice.)"""

    request: "repro_torch.serve.engine.Request"  # noqa: F821 (engine imports us)
    arrival: int
    enqueued_at: Optional[int] = None  # step it became visible to admission
    seq: int = 0  # global FIFO sequence


class ContinuousScheduler:
    """Drives a ServeEngine's params/config through a slot-pool decode loop.

    The engine owns params and sampling; the scheduler owns the pool and
    the queue.  ``stream()`` yields Results as lanes finish; ``run()``
    collects them.
    """

    def __init__(self, engine, policy: SchedulerPolicy):
        self.engine = engine
        self.policy = policy
        self.pool = SlotPool(
            engine.cfg, policy.n_slots, engine.max_len, paged=policy.paged,
            block_size=policy.block_size, n_blocks=policy.n_blocks,
            registry=engine.obs.registry, device=engine.device)
        self.obs = engine.obs
        reg = self.obs.registry
        tcap = policy.telemetry_capacity
        self._h_occ = reg.histogram(
            "serve_occupancy", "live decode lanes per pooled decode step", capacity=tcap)
        self._h_step = reg.histogram(
            "serve_decode_step_ms", "pooled decode step wall time (ms)", capacity=tcap)
        self._h_ttft = reg.histogram(
            "serve_ttft_ms", "time to first token (admitted -> first_token span, ms)",
            capacity=tcap)
        self._h_burst = reg.histogram(
            "serve_admit_burst", "requests admitted per admission burst", capacity=tcap)
        self._c_req = reg.counter(
            "serve_requests_total", "requests retired, by terminal outcome",
            labels=("outcome",))
        self._c_blocked = reg.counter(
            "serve_admit_blocked_total",
            "scheduler steps where a queued request could not be placed")
        self._c_chunks = reg.counter("serve_prefill_chunks_total", "prefill_chunk dispatches")
        self._h_tier_ttft = reg.histogram(
            "serve_tier_ttft_ms",
            "time to first token by SLO tier (same span as serve_ttft_ms)",
            labels=("tier",), capacity=tcap)
        self._c_steps = reg.counter("serve_decode_steps_total", "pooled decode step dispatches")
        self._g_queue = reg.gauge("serve_queue_depth", "requests waiting for a lane")
        # paged telemetry, per decode step: pool blocks in use, live cache
        # rows, the wasted fraction of allocated rows, and the blocks the
        # decode attention reads (the kernel's live blocks; the gather path
        # reads blocks_per_lane per lane regardless)
        self._h_blocks = reg.histogram(
            "serve_blocks_used", "pool blocks in use per decode step", capacity=tcap)
        self._h_rows = reg.histogram(
            "serve_live_rows", "live KV cache rows per decode step", capacity=tcap)
        self._h_frag = reg.histogram(
            "serve_fragmentation", "wasted fraction of allocated block rows per decode step",
            capacity=tcap)
        self._h_attn = reg.histogram(
            "serve_attn_read_blocks", "pool blocks read by decode attention per step",
            capacity=tcap)
        self.admit_bursts = obs_metrics.Ring(tcap)
        self.decode_ms_total = 0.0
        self.decode_steps = 0
        self.prefill_chunks = 0

    # -- admission ---------------------------------------------------------
    def _first_chunk_blocks(self, plen: int) -> int:
        """Blocks the lane's FIRST prefill chunk will demand."""
        return self.pool.allocator.blocks_for_rows(min(plen, max(self.policy.chunk_sizes)))

    def _lifetime_blocks(self, req) -> int:
        """Worst-case blocks over the request's life: prompt rows plus
        max_new - 1 decode writes."""
        return self.pool.allocator.blocks_for_rows(len(req.tokens) + req.max_new - 1)

    def _paged_assign(self, order: List[_Pending],
                      free: List[int]) -> List[Tuple[_Pending, int]]:
        """Paged lane assignment: each admit needs a lane whose shard has
        free blocks for its first chunk and uncommitted capacity for its
        worst-case lifetime.  The walk STOPS at the first request that
        fits no lane (head-of-line: nothing jumps it)."""
        alloc = self.pool.allocator
        budget_free = [alloc.free_in(s) for s in range(alloc.n_shards)]
        budget_commit = [alloc.commit_capacity - alloc.committed_in(s)
                         for s in range(alloc.n_shards)]
        lanes = list(free)
        pairs: List[Tuple[_Pending, int]] = []
        for pend in order:
            if not lanes:
                break
            first = self._first_chunk_blocks(len(pend.request.tokens))
            life = self._lifetime_blocks(pend.request)
            chosen = None
            for lane in lanes:
                sh = self.pool.lane_shard(lane)
                if first <= budget_free[sh] and life <= budget_commit[sh]:
                    chosen = lane
                    break
            if chosen is None:
                break
            lanes.remove(chosen)
            sh = self.pool.lane_shard(chosen)
            budget_free[sh] -= first
            budget_commit[sh] -= life
            pairs.append((pend, chosen))
        return pairs

    def _priority_order(self, queue: Deque[_Pending], now: int) -> List[_Pending]:
        """Admission order: latency-tier (and aged-past-``aging_steps``)
        requests first, FIFO by global sequence within a class."""
        aging = self.policy.aging_steps

        def key(pend: _Pending):
            waited = now - (pend.enqueued_at if pend.enqueued_at is not None else now)
            urgent = pend.request.tier == "latency" or waited >= aging
            return (0 if urgent else 1, pend.seq)

        return sorted(queue, key=key)

    def _admit(self, queue: Deque[_Pending], now: int):
        free = self.pool.free_slots()
        if not queue:
            return
        if not free:
            self._c_blocked.inc()  # queued work, no lane
            return
        order = self._priority_order(queue, now)
        if self.policy.paged:
            pairs = self._paged_assign(order, free)
        else:
            pairs = list(zip(order, free))
        placeable = len(pairs)
        if placeable == 0:
            self._c_blocked.inc()  # lanes free, but no block budget fits the head
            return
        oldest_wait = now - (order[0].enqueued_at if order[0].enqueued_at is not None
                             else now)
        if placeable < self.policy.min_admit and oldest_wait < self.policy.max_wait:
            return  # max-wait batching: hold for a fuller admission burst
        batch = [pend for pend, _ in pairs]
        for pend in batch:
            queue.remove(pend)
        slots = [lane for _, lane in pairs]
        self.admit_bursts.append(placeable)
        self._h_burst.observe(placeable)
        if self.policy.chunked_prefill:
            self._admit_chunked(batch, slots, now)
        else:
            self._admit_legacy(batch, slots, now)

    @torch.no_grad()
    def _admit_legacy(self, batch: List[_Pending], slots: List[int], now: int):
        # Every request's ADMITTED span starts at the burst's wall clock,
        # so TTFT includes the wait behind earlier batch-1 prefills.
        engine = self.engine
        wall = obs_trace.now()
        rec = self.obs.recorder
        for pend, slot in zip(batch, slots):
            req = pend.request
            tr = rec.get(req.uid)
            tr.event(obs_trace.ADMITTED, ts=wall, slot=slot)
            plen = len(req.tokens)
            toks = torch.from_numpy(np.asarray(req.tokens, np.int64)[None, :]).to(
                engine.device)
            logits, part = transformer.prefill(engine.params, {"tokens": toks}, engine.cfg,
                                               engine.max_len, self.pool.cache_dtype)
            scatter_slot(self.pool.cache, part, slot)
            temps = torch.tensor([req.temperature], dtype=torch.float32, device=engine.device)
            first = int(engine._sample(logits, temps, req.temperature > 0)[0])
            tr.event(obs_trace.FIRST_TOKEN)
            ttft_ms = tr.ttft_ms()
            self._h_ttft.observe(ttft_ms)
            self._h_tier_ttft.labels(tier=req.tier).observe(ttft_ms)
            self.pool.occupy(slot, req.uid, first, plen, req.max_new, req.temperature,
                             ttft_ms, now, tier=req.tier)

    def _admit_chunked(self, batch: List[_Pending], slots: List[int], now: int):
        """Multi-admit: every placeable request claims its lane at once;
        the prompts then stream through chunk steps."""
        wall = obs_trace.now()
        rec = self.obs.recorder
        reset_recurrent_slots(self.pool.cache, slots)
        for pend, slot in zip(batch, slots):
            req = pend.request
            self.pool.admit(slot, req.uid, req.tokens, req.max_new, req.temperature, now, wall,
                            tier=req.tier)
            attrs = {"slot": slot}
            if self.policy.paged:
                attrs["blocks"] = self.pool.slots[slot].committed
            rec.get(req.uid).event(obs_trace.ADMITTED, ts=wall, **attrs)

    # -- chunked prefill ---------------------------------------------------
    def _pick_chunk(self, max_remaining: int, n_decoding: int = 0) -> int:
        """Occupancy-aware chunk size, always drawn from
        ``policy.chunk_sizes``: the smallest size covering the longest
        remaining prompt (else the largest), stepped down the size table
        by the fraction of lanes decoding, so a hot pool prefers small
        chunks (little added latency for live lanes) and a draining pool
        large ones.  Monotone non-increasing in occupancy."""
        sizes = sorted(self.policy.chunk_sizes)
        cover = next((c for c in sizes if c >= max_remaining), sizes[-1])
        if not self.policy.occupancy_chunking or n_decoding <= 0:
            return cover
        frac = n_decoding / max(self.pool.n_slots, 1)
        desc = sizes[::-1]
        idx = min(int(frac * len(desc)), len(desc) - 1)
        return min(cover, desc[idx])

    @torch.no_grad()
    def _prefill_step(self, now: int):
        """One prefill_chunk call: every prefilling lane consumes up to C
        prompt tokens; lanes whose prompt completes sample their first
        token and flip to the decode phase."""
        engine, pool = self.engine, self.pool
        lanes = pool.prefilling()
        remaining = {i: len(pool.slots[i].prompt) - pool.slots[i].filled for i in lanes}
        C = self._pick_chunk(max(remaining.values()), pool.n_decoding)
        if self.policy.paged:
            # alloc-on-demand: grant the blocks each lane's chunk rows land in
            pool.grow_many({i: pool.slots[i].filled + min(C, remaining[i]) for i in lanes})
        toks = np.zeros((pool.n_slots, C), np.int64)
        # non-prefilling lanes point past the cache: their writes go to the
        # drop row/block and n_valid=0 keeps them out of everything else
        start = np.full((pool.n_slots,), engine.max_len, np.int32)
        nval = np.zeros((pool.n_slots,), np.int32)
        for i in lanes:
            s = pool.slots[i]
            take = min(C, remaining[i])
            toks[i, :take] = s.prompt[s.filled:s.filled + take]
            start[i] = s.filled
            nval[i] = take
        dev = engine.device
        last_logits, _ = transformer.prefill_chunk(
            engine.params, pool.cache, torch.from_numpy(toks).to(dev),
            torch.from_numpy(start).to(dev), torch.from_numpy(nval).to(dev), engine.cfg,
            block_table=pool.block_table)
        done = [i for i in lanes if pool.slots[i].filled + int(nval[i])
                == len(pool.slots[i].prompt)]
        sampled_host = None
        if done:
            sampled_host = engine._sample(last_logits, pool.temps, pool.any_hot).cpu().numpy()
        self.prefill_chunks += 1
        self._c_chunks.inc()
        rec = self.obs.recorder
        for i in lanes:
            s = pool.slots[i]
            tr = rec.get(s.uid)
            tr.event(obs_trace.PREFILL_CHUNK, size=int(nval[i]))
            s.filled += int(nval[i])
            if s.filled == len(s.prompt):
                tr.event(obs_trace.FIRST_TOKEN)
                ttft_ms = tr.ttft_ms()
                self._h_ttft.observe(ttft_ms)
                self._h_tier_ttft.labels(tier=s.tier).observe(ttft_ms)
                pool.start_decode(i, int(sampled_host[i]), ttft_ms)

    # -- decode ------------------------------------------------------------
    @torch.no_grad()
    def _decode_step(self) -> Tuple[np.ndarray, np.ndarray]:
        """One pooled decode step over every lane; returns the lanes that
        decoded and the sampled tokens (the step's one host sync)."""
        engine, pool = self.engine, self.pool
        if self.policy.paged:
            # decode growth: lanes crossing a block boundary get their next
            # block before the write (one table update for the whole step)
            pool.grow_many({i: len(s.prompt) + len(s.tokens) for i, s in enumerate(pool.slots)
                            if s.uid is not None and s.phase == "decode"})
            self._h_attn.observe(sum(len(s.blocks) for s in pool.slots
                                     if s.uid is not None and s.phase == "decode"))
        t0 = time.perf_counter()
        active = pool.decode_mask
        logits, _ = transformer.decode_step(
            engine.params, pool.cache, pool.tok, pool.pos, engine.cfg, active=pool.act,
            block_table=pool.block_table, paged_kernel=self.policy.paged_kernel)
        sampled = engine._sample(logits, pool.temps, pool.any_hot)
        pool.tok.copy_(sampled[:, None])
        sampled_host = sampled.cpu().numpy()
        step_ms = (time.perf_counter() - t0) * 1e3
        self.decode_ms_total += step_ms
        self._h_step.observe(step_ms)
        self.decode_steps += 1
        self._c_steps.inc()
        return active, sampled_host

    # -- main loop ---------------------------------------------------------
    def _validate(self, requests, arrival_steps) -> None:
        if len(arrival_steps) != len(requests):
            raise ValueError(
                f"arrival_steps has {len(arrival_steps)} entries for {len(requests)} "
                "requests: zip would silently drop the excess")
        for r in requests:
            if r.tier not in ("latency", "throughput"):
                raise ValueError(f"request {r.uid}: unknown SLO tier {r.tier!r}; want "
                                 "'latency' or 'throughput'")
            if r.precision not in ("full", None):
                raise _later(f"request {r.uid}: precision={r.precision!r} (precision tiers)")
            if len(r.tokens) < 1:
                raise ValueError(f"request {r.uid}: empty prompt: there is no position to "
                                 "prefill and the lane would never leave the prefill phase")
            if r.max_new < 1:
                raise ValueError(f"request {r.uid}: max_new={r.max_new}: the slot pool "
                                 "always emits the prefill-sampled token")
            # last cache row written: prompt rows 0..plen-1, then max_new-1
            # decode writes at plen..plen+max_new-2
            need = len(r.tokens) + r.max_new - 1
            if need > self.engine.max_len:
                raise ValueError(
                    f"request {r.uid}: prompt {len(r.tokens)} + {r.max_new - 1} decode "
                    f"writes need {need} cache rows > max_len {self.engine.max_len}")
            if self.policy.paged:
                cap = self.pool.allocator.shard_blocks
                if self._lifetime_blocks(r) > cap:
                    raise ValueError(
                        f"request {r.uid}: needs {self._lifetime_blocks(r)} KV blocks "
                        f"worst-case > per-lane pool capacity {cap} ({self.pool.n_blocks} "
                        "blocks): it could never be admitted (raise n_blocks or shrink "
                        "prompt/max_new)")

    def stream(self, requests: Sequence["repro_torch.serve.engine.Request"],  # noqa: F821
               arrival_steps: Optional[Sequence[int]] = None
               ) -> Iterator["repro_torch.serve.engine.Result"]:  # noqa: F821
        """Run the workload; yield each Result the step its lane finishes.

        ``arrival_steps[i]`` is the scheduler step at which requests[i]
        becomes visible (default: all at step 0).  FIFO by arrival, then
        submission order.
        """
        if arrival_steps is None:
            arrival_steps = [0] * len(requests)
        self._validate(requests, arrival_steps)
        incoming = sorted((_Pending(r, int(t)) for r, t in zip(requests, arrival_steps)),
                          key=lambda p: p.arrival)
        for seq, pend in enumerate(incoming):
            pend.seq = seq
        incoming = deque(incoming)
        queue: Deque[_Pending] = deque()
        pool = self.pool
        rec = self.obs.recorder
        now = 0
        try:
            while incoming or queue or pool.n_active:
                while incoming and incoming[0].arrival <= now:
                    pend = incoming.popleft()
                    pend.enqueued_at = now
                    rec.begin(pend.request.uid, arrival=pend.arrival)
                    queue.append(pend)
                self._g_queue.set(len(queue))
                self._admit(queue, now)
                # legacy max_new == 1 finishes at admission
                yield from self._finished()
                worked = False
                if self.policy.chunked_prefill and pool.prefilling():
                    self._prefill_step(now)
                    worked = True
                    yield from self._finished()  # chunked max_new == 1
                if pool.n_decoding:
                    worked = True
                    active, sampled_host = self._decode_step()
                    pool.advance(sampled_host, active)
                    self._h_occ.observe(int(active.sum()))
                    for i, s in enumerate(pool.slots):
                        if active[i] and s.uid is not None:
                            rec.event(s.uid, obs_trace.DECODE_STEP)
                    if self.policy.paged:
                        used = pool.allocator.used_count
                        live = pool.live_rows()
                        self._h_blocks.observe(used)
                        self._h_rows.observe(live)
                        if used:
                            self._h_frag.observe(1.0 - live / (used * pool.block_size))
                    yield from self._finished()
                if not worked and incoming and not queue:
                    # idle gap before the next arrival: fast-forward the clock
                    # (a held queue must age step by step for max_wait)
                    now = max(now, incoming[0].arrival - 1)
                now += 1
        finally:
            # An abandoned generator (client disconnect, possibly mid-prefill)
            # must not leave ghost lanes: free every live lane so the shared
            # pool is clean for the next call, and close every open span.
            for i, s in enumerate(pool.slots):
                if s.uid is not None:
                    rec.finish(s.uid, obs_trace.EVICTED, phase=s.phase, filled=s.filled)
                    self._c_req.labels(outcome="evicted").inc()
                    pool.evict(i)
            for pend in queue:
                if pend.request.uid in rec.active:
                    rec.finish(pend.request.uid, obs_trace.ABANDONED)
                    self._c_req.labels(outcome="abandoned").inc()
            self._g_queue.set(0)

    def _finished(self):
        from .engine import Result

        pool = self.pool
        rec = self.obs.recorder
        per_tok = self.decode_ms_total / max(self.decode_steps, 1)
        for i, s in enumerate(pool.slots):
            if s.uid is not None and s.phase == "decode" and s.remaining <= 0:
                done = pool.evict(i)
                rec.finish(done.uid, obs_trace.FINISHED, n_tokens=len(done.tokens))
                self._c_req.labels(outcome="finished").inc()
                yield Result(uid=done.uid, tokens=np.asarray(done.tokens, np.int32),
                             prefill_ms=done.prefill_ms, decode_ms_per_tok=per_tok)

    def run(self, requests, arrival_steps: Optional[Sequence[int]] = None):
        return list(self.stream(requests, arrival_steps))

    # -- telemetry ---------------------------------------------------------
    def reset_telemetry(self) -> None:
        """Zero the obs bundle and the scalar counters (bench warm-up)."""
        self.obs.reset()
        self.admit_bursts.clear()
        self.prefill_chunks = 0
        self.decode_ms_total = 0.0
        self.decode_steps = 0

    def mean_occupancy(self) -> float:
        """Mean fraction of lanes live per decode step."""
        return self._h_occ.mean() / self.pool.n_slots

    def mean_block_occupancy(self) -> float:
        """Mean fraction of pool blocks in use per decode step (paged)."""
        return self._h_blocks.mean() / self.pool.n_blocks if self.pool.n_blocks else 0.0

    def mean_fragmentation(self) -> float:
        """Mean wasted fraction of allocated block rows (paged): the tail
        rows of each lane's last, partly filled block."""
        return self._h_frag.mean()
