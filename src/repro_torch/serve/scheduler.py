"""Continuous-batching scheduler: admission queue + slot-pool decode loop.

PyTorch port of ``repro.serve.scheduler``.  One
:class:`~repro_torch.serve.slots.SlotPool` holds ``n_slots`` persistent
lanes; the loop is::

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
against uncommitted capacity), each prefill chunk and decode step grants
the blocks its writes land in, and eviction returns them.
``paged_kernel=True`` reads decode attention through the paged-attention
CUDA kernel on the card.

**Overcommit + preemption** (``overcommit > 1.0``, paged only): admission
reserves against ``shard_blocks * overcommit`` instead of the physical
pool, so growth can exhaust it; before every grow ``_ensure_headroom``
preempts victims in :func:`preemption_order` (throughput tier before
latency, most recently admitted first).  Preemption is a recompute swap:
the victim's blocks are freed and its request re-enters the queue with
prompt + generated-so-far as its prompt.  Requests whose worst case
exceeds the physical pool are rejected up front, so a lane alone always
fits and the loop cannot deadlock.

**Bit-plane speculative decoding** (``spec_decode=True``, paged only):
decode lanes self-draft up to ``gamma`` pooled decode steps per round
from the ``draft_planes`` most significant planes of the SAME packed
weights (the runtime-plane bitserial kernel), then ONE full-precision
``prefill_chunk(return_all_logits=True)`` scores every drafted position.
The longest matching draft prefix commits, plus the verify's correction
on a rejection; rejected rows rewind by a position decrement and a
tail-block free (``SlotPool.commit_spec``).  Greedy verify keeps the
output that of non-speculative decode.  The draft chain carries
``tok``/``pos`` on the device; the host reads the round's drafts and
verify once, after the verify.

**Precision tiers + degrade** (``precision_tiers={...}`` / ``degrade``,
packed models, chunked prefill): ``Request.precision`` names a class
("full", a tier-table key, or an explicit plane count); prefill runs at
full precision, and each decode step groups its lanes by effective plane
count and runs one pooled dispatch per count, costliest first.  With
``degrade=True`` one plane is shed per pressured step from every tier
(floor-clamped) and restored after ``degrade_hysteresis`` calm steps.
Every token's plane count lands in ``Result.plane_log``.

**Plane counts reach the kernel as device tensors.**  The scheduler
makes one one-element int32 tensor per plane count on the engine's
device when it is built and passes them down through
``decode_step``/``prefill_chunk(active_planes=)``; nothing in the model
reads a plane count on the host (``kernels.ops`` refuses a Python int on
the card).

**Compiled programs.**  The JAX scheduler counts compiled XLA programs
(``compiled_decode_programs() == 1``, the ``serve_compiled_programs``
gauge).  Eager PyTorch compiles nothing, so that count has no
counterpart here and none is reported.  The property it stood for is
kept: the decode step's tensor shapes depend only on ``n_slots`` and
``blocks_per_lane`` (``tok (n_slots, 1)``, ``pos``/``act (n_slots,)``,
the table, the plane-count tensor), whatever the arrival pattern, and
``transformer.decode_step`` never syncs the host, so one CUDA graph could
capture it.  The loop reads the sampled tokens on the host once per step
(once per round under spec decode).

**On a mesh** (``engine.mesh``) every rank runs this same host scheduler
on the same requests, and every model call runs under
``models.common.packed_shard_mesh`` (each rank's blocks of the weights
and the pool) and, when the block tables co-shard with the pool
(``pool.table_shards > 1``), under ``paged_shard_mesh``: each data shard's
lanes attend over its own pool slice, and the allocator grants a lane's
blocks from its shard (shard-aware lane assignment and victim
selection).  Every decision is a function of host state and of tokens
taken from logits that are bitwise the same on every rank
(``common.logits_apply``), so every rank decides the same;
``digests`` (a list, when set) records :meth:`state_digest` after each
step so a caller can check that.

Admission policy (:class:`SchedulerPolicy`): FIFO within an SLO tier
(``latency`` outranks ``throughput``; a request waiting ``aging_steps``
steps is promoted) with optional max-wait batching (``min_admit`` /
``max_wait``).  Time is measured in scheduler steps (one pooled decode or
one spec round = one step); simulated arrivals are on that clock.

**Observability**: the scheduler emits through the engine's
:class:`repro_torch.obs.Observability` bundle the metrics and the
per-request spans of the JAX scheduler (``enqueued -> admitted(slot[,
blocks]) -> prefill_chunk* -> first_token -> decode_step* ->
finished|abandoned|evicted``, with ``preempted``/``re_prefill``,
``draft``/``verify``/``rollback`` and ``planes_shed``/``planes_restored``
where those policies run); ``Result.prefill_ms`` is the request's
``admitted -> first_token`` span.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import time
import warnings
from collections import deque
from typing import Callable, Deque, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.packing import packed_leaves
from ..models import transformer
from ..models.common import packed_shard_mesh, paged_shard_mesh
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from .slots import SlotPool, SlotState, reset_recurrent_slots, scatter_slot


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
    # optimistic overcommit (paged only): admit against shard_blocks *
    # overcommit commitment capacity; past 1.0 the scheduler preempts
    # victim lanes (recompute swap) when a step's block demand would
    # exhaust the pool
    overcommit: float = 1.0
    # anti-starvation aging: a request that has waited this many steps is
    # admitted with the latency class
    aging_steps: int = 64
    # scale the prefill chunk down as more lanes decode; False restores
    # the static smallest-covering-chunk rule
    occupancy_chunking: bool = True
    # bit-plane speculative decoding (paged only): up to ``gamma`` draft
    # steps per round at ``draft_planes`` active planes, then one verify
    # chunk; attention-only layer patterns and greedy requests only
    spec_decode: bool = False
    draft_planes: int = 2  # active bit planes during draft steps
    gamma: int = 4  # max draft steps per round (per-lane depth backs off)
    # serve-time precision tiers (packed models, chunked prefill): class
    # name -> active plane count, e.g. {"economy": 3}; "full" is implicit
    # (the model's n_bits).  None disables tier resolution: every request
    # must be "full".  Prefill always runs at full precision.
    precision_tiers: Optional[Dict[str, int]] = None
    # one decode dispatch per distinct effective plane count; off: one
    # dispatch at the max count serves every lane
    plane_grouping: bool = True
    # load-triggered degrade (tiered engines): shed one plane per pressured
    # step from every tier (floor-clamped), restore one per
    # ``degrade_hysteresis`` calm steps
    degrade: bool = False
    degrade_queue_depth: int = 2  # queued requests that count as pressure
    degrade_occupancy: float = 1.0  # lane occupancy that counts as pressure (queue non-empty)
    degrade_preempt_rate: float = 0.5  # preemptions/step over the window that count
    degrade_window: int = 16  # steps of preemption history in the rate
    degrade_hysteresis: int = 4  # calm steps required per restored plane
    # per-class plane floor the degrade loop may not shed below (default
    # 1; with spec_decode at least draft_planes + 1)
    precision_floors: Optional[Dict[str, int]] = None
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
                             "has the commitment accounting (and the preemption escape "
                             "hatch) overcommit relies on")
        if self.aging_steps < 1:
            raise ValueError(f"aging_steps={self.aging_steps}: need >= 1 (aging at 0 "
                             "steps would flatten the tier ordering entirely)")
        if self.spec_decode:
            if not self.paged:
                raise ValueError(
                    "spec_decode=True requires paged=True: the draft/verify rewind frees "
                    "rejected rows through the block tables, which a dense per-lane "
                    "cache does not have")
            if self.draft_planes < 1:
                raise ValueError(f"draft_planes={self.draft_planes}: need >= 1 (zero "
                                 "active planes is not a model)")
            if self.gamma < 1:
                raise ValueError(f"gamma={self.gamma}: need >= 1 draft step per round")
        if self.precision_tiers is not None:
            if not self.chunked_prefill:
                raise ValueError(
                    "precision_tiers requires chunked_prefill=True: legacy batch-1 "
                    "admission is the full-precision reference and does not carry "
                    "per-lane plane bookkeeping")
            for name, k in self.precision_tiers.items():
                if name == "full":
                    raise ValueError("precision_tiers must not remap 'full': it is "
                                     "implicitly the model's n_bits")
                if not isinstance(k, int) or k < 1:
                    raise ValueError(f"precision tier {name!r}: plane count {k!r} must be "
                                     "an int >= 1")
                if self.spec_decode and k <= self.draft_planes:
                    raise ValueError(
                        f"precision tier {name!r}: {k} planes <= draft_planes="
                        f"{self.draft_planes}: the effective serving precision must be "
                        "strictly above the draft precision for the verify to add "
                        "information")
        if self.precision_floors is not None:
            if self.precision_tiers is None and not self.degrade:
                raise ValueError("precision_floors without precision_tiers or degrade "
                                 "would be silently inert")
            for name, fl in self.precision_floors.items():
                if not isinstance(fl, int) or fl < 1:
                    raise ValueError(f"precision floor {name!r}: {fl!r} must be an int >= 1")
        if self.degrade:
            if not self.chunked_prefill:
                raise ValueError("degrade=True requires chunked_prefill=True (same "
                                 "per-lane plane bookkeeping as precision_tiers)")
            if self.degrade_queue_depth < 1:
                raise ValueError(f"degrade_queue_depth={self.degrade_queue_depth}: need "
                                 ">= 1 (depth 0 would mean permanent pressure)")
            if not 0.0 < self.degrade_occupancy <= 1.0:
                raise ValueError(f"degrade_occupancy={self.degrade_occupancy}: need a "
                                 "fraction in (0, 1]")
            if self.degrade_preempt_rate < 0.0:
                raise ValueError(f"degrade_preempt_rate={self.degrade_preempt_rate}: "
                                 "need >= 0")
            if self.degrade_window < 1:
                raise ValueError(f"degrade_window={self.degrade_window}: need >= 1 step")
            if self.degrade_hysteresis < 1:
                raise ValueError(f"degrade_hysteresis={self.degrade_hysteresis}: need "
                                 ">= 1 calm step per restored plane")


@dataclasses.dataclass
class _Pending:
    """A queued request, with the resume state of a preempted run: the
    tokens it had generated (``prior``) and their plane counts
    (``prior_planes``).  The effective prompt is the original prompt
    extended by them, and the effective max_new shrinks by their count."""

    request: "repro_torch.serve.engine.Request"  # noqa: F821 (engine imports us)
    arrival: int
    enqueued_at: Optional[int] = None  # step it became visible to admission
    seq: int = 0  # global FIFO sequence; stable across preemption requeues
    prior: Optional[List[int]] = None
    prior_planes: Optional[List[int]] = None

    @property
    def prompt_len(self) -> int:
        return len(self.request.tokens) + len(self.prior or ())

    def prompt_tokens(self) -> np.ndarray:
        toks = np.asarray(self.request.tokens, np.int32)
        if self.prior:
            toks = np.concatenate([toks, np.asarray(self.prior, np.int32)])
        return toks

    @property
    def max_new(self) -> int:
        return self.request.max_new - len(self.prior or ())

    @property
    def tier(self) -> str:
        return self.request.tier

    @property
    def precision(self):
        return self.request.precision


def preemption_order(candidates: List[Tuple[int, SlotState]]) -> List[Tuple[int, SlotState]]:
    """Victim priority over ``(slot, SlotState)`` live-lane candidates,
    best victim FIRST: throughput-tier lanes before latency-tier ones,
    most recently admitted first within a tier (the youngest lane has the
    least recompute debt, and the oldest always makes progress), highest
    slot index as the tie-break.  Pure and host-side."""
    return sorted(candidates, key=lambda c: (c[1].tier == "latency", -c[1].admit_seq, -c[0]))


def _on_mesh(method):
    """Run a scheduler method's model calls on the engine's mesh (a no-op
    without one): packed_shard_mesh always, paged_shard_mesh when the
    tables co-shard with the pool."""
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with self._mesh_context():
            return method(self, *args, **kwargs)

    return wrapped


class ContinuousScheduler:
    """Drives a ServeEngine's params/config through a slot-pool decode loop.

    The engine owns params and sampling; the scheduler owns the pool and
    the queue.  ``stream()`` yields Results as lanes finish; ``run()``
    collects them.
    """

    def __init__(self, engine, policy: SchedulerPolicy):
        self.engine = engine
        self.policy = policy
        cfg = engine.cfg
        if policy.spec_decode:
            # rewind is a position decrement: ring buffers wrap and cannot
            # be rewound that way (the JAX guard, kept as it is)
            bad = [k for k in cfg.layer_pattern if k.split("+")[0] != "attn" or "+" in k]
            if bad:
                raise ValueError(
                    f"spec_decode=True requires an attention-only layer pattern (rewind "
                    f"is a position decrement); got {cfg.layer_pattern!r} with "
                    f"non-rewindable kinds {bad!r}")
            if cfg.n_experts:
                raise ValueError("spec_decode=True does not support MoE layers "
                                 f"(n_experts={cfg.n_experts})")
        self.pool = SlotPool(
            cfg, policy.n_slots, engine.max_len, paged=policy.paged,
            block_size=policy.block_size, n_blocks=policy.n_blocks,
            overcommit=policy.overcommit, registry=engine.obs.registry, device=engine.device,
            mesh=engine.mesh)
        # shard-local paged attention where the tables co-shard with the pool
        self._paged_mesh = engine.mesh if policy.paged and self.pool.table_shards > 1 else None
        # per-step state digests (state_digest), recorded when set to a list
        self.digests: Optional[List[str]] = None

        # Precision tiers / degrade: the tier table against the model's
        # packed width; ``_tiered`` gates every per-lane plane bookkeeping.
        packed = packed_leaves(engine.params)
        self._n_bits: Optional[int] = max(pw.n_bits for pw in packed) if packed else None
        self._tiered = policy.precision_tiers is not None or policy.degrade
        if self._tiered:
            if self._n_bits is None:
                raise ValueError("precision_tiers/degrade need a packed model: float "
                                 "params have no bit planes to shed")
            self._tier_planes: Dict[str, int] = {"full": self._n_bits}
            for name, k in (policy.precision_tiers or {}).items():
                if k > self._n_bits:
                    raise ValueError(f"precision tier {name!r}: {k} planes > the model's "
                                     f"n_bits={self._n_bits}")
                self._tier_planes[name] = int(k)
            if policy.spec_decode and self._n_bits <= policy.draft_planes:
                raise ValueError(
                    f"draft_planes={policy.draft_planes} >= n_bits={self._n_bits}: no "
                    "tier can serve strictly above the draft precision")
            self._floors: Dict[str, int] = dict(policy.precision_floors or {})
            # past this shed every tier sits at its floor and sheds are inert
            self._shed_ceiling = max(0, max(k - self._floor(name)
                                            for name, k in self._tier_planes.items()))
        else:
            self._tier_planes = {}
            self._floors = {}
            self._shed_ceiling = 0
        # The plane-count operands, made once on the device: one int32
        # tensor per count the scheduler can ask for (1..n_bits, and the
        # draft count).  A float model has no planes: its calls pass None.
        counts = set(range(1, (self._n_bits or 0) + 1))
        if policy.spec_decode and packed:
            counts.add(policy.draft_planes)
        self._plane_t: Dict[int, torch.Tensor] = {
            k: torch.tensor([k], dtype=torch.int32, device=engine.device) for k in sorted(counts)}
        # degrade-loop state: planes shed (global, floor-clamped per tier),
        # consecutive calm steps, and a window of per-step preemptions
        self._shed = 0
        self._calm = 0
        self._preempt_step = 0
        self._preempt_window: Deque[int] = deque(maxlen=policy.degrade_window)
        self._degrade_warned = False
        # Deterministic test hook: ``force_shed(step) -> int`` overrides the
        # pressure triggers (still floor-clamped); needs policy.degrade.
        self.force_shed: Optional[Callable[[int], int]] = None
        self.degrade_sheds = 0
        self.degrade_restores = 0

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
        self._c_preempt = reg.counter(
            "serve_preemptions_total",
            "lanes preempted under overcommit pressure (blocks reclaimed, request "
            "re-queued for re-prefill), by SLO tier", labels=("tier",))
        self._c_preempt_rows = reg.counter(
            "serve_preempted_rows_total",
            "live KV cache rows discarded by preemption (recompute debt)")
        self._h_tier_ttft = reg.histogram(
            "serve_tier_ttft_ms",
            "time to first token by SLO tier (same span as serve_ttft_ms)",
            labels=("tier",), capacity=tcap)
        self._c_steps = reg.counter("serve_decode_steps_total", "pooled decode step dispatches")
        self._c_spec_rounds = reg.counter(
            "serve_spec_rounds_total", "speculative draft+verify round dispatches")
        self._c_spec_draft = reg.counter(
            "serve_spec_draft_steps_total", "per-lane draft steps run at draft precision")
        self._c_spec_accept = reg.counter(
            "serve_spec_accept_total", "drafted tokens accepted by the full-precision verify")
        self._c_spec_reject = reg.counter(
            "serve_spec_reject_total", "drafted tokens rejected by the full-precision verify")
        self._g_spec_rate = reg.gauge(
            "serve_spec_accept_rate", "running draft acceptance rate (accepted / drafted)")
        self._g_queue = reg.gauge("serve_queue_depth", "requests waiting for a lane")
        self._g_active_planes = None
        self._c_degrade = None
        if self._tiered:
            self._g_active_planes = reg.gauge(
                "serve_active_planes",
                "effective active bit planes by precision tier (tier plane count minus "
                "the degrade loop's shed, clamped at the tier's floor)", labels=("tier",))
            self._c_degrade = reg.counter(
                "serve_degrade_events_total",
                "degrade-loop plane transitions, by direction (shed / restore)",
                labels=("direction",))
            self._set_plane_gauges()
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
        self.spec_rounds = 0
        self.spec_drafted = 0  # per-lane draft steps (drafted tokens)
        self.spec_accepted = 0  # drafted tokens the verify accepted
        self.spec_committed = 0  # tokens committed (accepts + corrections)
        # model calls that pass a plane-count tensor (each launches the
        # runtime-plane bitserial kernel once per packed projection):
        # tiered decode dispatches, draft steps, tiered verify chunks
        self.tier_dispatches = 0
        self.draft_steps = 0
        self.tier_verifies = 0
        # which _Pending occupies each lane (a preemption rebuilds the
        # queue entry) and a monotone admission counter (LIFO victims)
        self._lane_pend: Dict[int, _Pending] = {}
        self._admit_seq = 0

    # -- precision tiers + degrade loop --------------------------------------
    def _floor(self, precision: str) -> int:
        """The plane count class ``precision`` may not be degraded below:
        the user floor (default 1), and with spec_decode at least
        draft_planes + 1, so a degraded verify stays above the draft."""
        fl = max(1, self._floors.get(precision, 1))
        if self.policy.spec_decode:
            fl = max(fl, self.policy.draft_planes + 1)
        return fl

    def _effective(self, precision: str) -> int:
        """Effective plane count of class ``precision`` under the current
        shed: ``max(floor, tier_planes - shed)``."""
        k = self._tier_planes.get(precision, self._n_bits)
        return max(min(self._floor(precision), k), k - self._shed)

    def _effective_planes(self, s: SlotState) -> int:
        """Effective plane count lane ``s`` decodes at this step."""
        k = s.planes if s.planes is not None else self._n_bits
        return max(min(self._floor(s.precision), k), k - self._shed)

    def _set_plane_gauges(self) -> None:
        for name in self._tier_planes:
            self._g_active_planes.labels(tier=name).set(self._effective(name))

    def _resolve_planes(self, precision, uid=None) -> Tuple[int, str]:
        """Validate Request.precision and resolve it to (planes, class):
        "full" -> n_bits; a tier-table key -> its entry; an int -> that
        explicit plane count (class "explicit" for floor lookups)."""
        who = f"request {uid}: " if uid is not None else ""
        if precision in ("full", None):
            return self._n_bits, "full"
        if isinstance(precision, str):
            k = self._tier_planes.get(precision)
            if k is None:
                raise ValueError(
                    f"{who}unknown precision class {precision!r}: want 'full', one of "
                    f"{sorted(self._tier_planes)}, or an explicit plane count")
            return k, precision
        k = int(precision)
        if not 1 <= k <= self._n_bits:
            raise ValueError(f"{who}precision={precision!r}: an explicit plane count must "
                             f"be in [1, n_bits={self._n_bits}]")
        if self.policy.spec_decode and k <= self.policy.draft_planes:
            raise ValueError(
                f"{who}precision={k} planes <= draft_planes={self.policy.draft_planes}: "
                "the effective serving precision must be strictly above the draft "
                "precision")
        return k, "explicit"

    def _record_transition(self, direction: str) -> None:
        """One shed/restore transition: counter, per-tier gauges, and a
        span event on every live lane with its NEW effective count."""
        self._c_degrade.labels(direction=direction).inc()
        if direction == "shed":
            self.degrade_sheds += 1
        else:
            self.degrade_restores += 1
        self._set_plane_gauges()
        kind = obs_trace.PLANES_SHED if direction == "shed" else obs_trace.PLANES_RESTORED
        rec = self.obs.recorder
        for s in self.pool.slots:
            if s.uid is not None:
                rec.event(s.uid, kind, shed=self._shed, planes=self._effective_planes(s))

    def _degrade_tick(self, queue_len: int, now: int) -> None:
        """One step of the load-triggered degrade loop.  Pressure: the
        queue at ``degrade_queue_depth`` or more, or every lane busy
        (``degrade_occupancy``) with work queued, or the windowed
        preemption rate past ``degrade_preempt_rate``.  A pressured step
        sheds one plane; ``degrade_hysteresis`` calm steps restore one.
        ``force_shed`` replaces the triggers with an exact schedule."""
        pol = self.policy
        self._preempt_window.append(self._preempt_step)
        self._preempt_step = 0
        if self.force_shed is not None:
            target = min(max(int(self.force_shed(now)), 0), self._shed_ceiling)
            while self._shed < target:
                self._shed += 1
                self._record_transition("shed")
            while self._shed > target:
                self._shed -= 1
                self._record_transition("restore")
            return
        occ = self.pool.n_active / max(self.pool.n_slots, 1)
        prate = sum(self._preempt_window) / max(len(self._preempt_window), 1)
        pressure = (queue_len >= pol.degrade_queue_depth
                    or (queue_len > 0 and occ >= pol.degrade_occupancy)
                    or prate > pol.degrade_preempt_rate)
        if pressure:
            self._calm = 0
            if self._shed < self._shed_ceiling:
                self._shed += 1
                self._record_transition("shed")
            elif pol.spec_decode and not self._degrade_warned:
                warnings.warn(
                    f"degrade loop clamped at shed={self._shed}: every tier sits at its "
                    f"floor (>= draft_planes + 1 = {pol.draft_planes + 1} under "
                    "spec_decode); shedding further would make the verify as imprecise "
                    "as the draft", RuntimeWarning, stacklevel=2)
                self._degrade_warned = True
        else:
            self._calm += 1
            if self._shed > 0 and self._calm >= pol.degrade_hysteresis:
                self._shed -= 1
                self._calm = 0
                self._record_transition("restore")

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
        free blocks for its first chunk (so a fresh admit always lands it
        before it can be chosen as a victim) and uncommitted capacity for
        its worst-case lifetime, against ``commit_capacity``.  The walk
        STOPS at the first request that fits no lane (head-of-line)."""
        alloc = self.pool.allocator
        budget_free = [alloc.free_in(s) for s in range(alloc.n_shards)]
        budget_commit = [alloc.commit_capacity - alloc.committed_in(s)
                         for s in range(alloc.n_shards)]
        lanes = list(free)
        pairs: List[Tuple[_Pending, int]] = []
        for pend in order:
            if not lanes:
                break
            first = self._first_chunk_blocks(pend.prompt_len)
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
            urgent = pend.tier == "latency" or waited >= aging
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

    @_on_mesh
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
            scatter_slot(self.pool.cache, part, slot, engine.mesh)
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
        reset_recurrent_slots(self.pool.cache, slots, self.engine.mesh)
        for pend, slot in zip(batch, slots):
            req = pend.request
            self._admit_seq += 1
            planes, prec = (self._resolve_planes(pend.precision, uid=req.uid)
                            if self._tiered else (None, "full"))
            self.pool.admit(slot, req.uid, pend.prompt_tokens(), pend.max_new,
                            req.temperature, now, wall, tier=pend.tier, prior=pend.prior,
                            admit_seq=self._admit_seq, planes=planes, precision=prec,
                            prior_planes=pend.prior_planes)
            if self.policy.spec_decode:
                # fresh lanes and preempted resumes start at the full depth
                self.pool.slots[slot].spec_gamma = self.policy.gamma
            self._lane_pend[slot] = pend
            attrs = {"slot": slot}
            if self.policy.paged:
                attrs["blocks"] = self.pool.slots[slot].committed
            if self._tiered:
                attrs["planes"] = planes
            tr = rec.get(req.uid)
            tr.event(obs_trace.ADMITTED, ts=wall, **attrs)
            if pend.prior is not None:
                # resumed after a preemption: the recompute prefill over
                # prompt + generated-so-far starts here
                tr.event(obs_trace.RE_PREFILL, ts=wall, rows=pend.prompt_len,
                         generated=len(pend.prior))

    # -- overcommit --------------------------------------------------------
    def _preempt(self, slot: int, queue: Deque[_Pending], now: int) -> None:
        """Recompute-swap preemption of lane ``slot``: snapshot its
        generated tokens, free its blocks and commitment, and re-enqueue
        the request with prompt + generated-so-far as its prompt.  The
        trace stays open (``preempted`` is not terminal)."""
        pool = self.pool
        s = pool.slots[slot]
        pend = self._lane_pend.pop(slot)
        gen = list(s.prior or []) + list(s.tokens or [])
        gen_planes = (list(s.prior_planes or []) + list(s.plane_log or [])
                      if self._tiered else None)
        rows_lost = s.filled if s.phase == "prefill" else len(s.prompt) + len(s.tokens) - 1
        self.obs.recorder.event(s.uid, obs_trace.PREEMPTED, slot=slot, phase=s.phase,
                                generated=len(gen), blocks=len(s.blocks or ()))
        self._c_preempt.labels(tier=s.tier).inc()
        self._c_preempt_rows.inc(rows_lost)
        self._preempt_step += 1
        pool.evict(slot)
        queue.append(_Pending(pend.request, pend.arrival, enqueued_at=now, seq=pend.seq,
                              prior=gen, prior_planes=gen_planes))

    def _ensure_headroom(self, demand: Dict[int, int], queue: Deque[_Pending],
                         now: int) -> Dict[int, int]:
        """Make this step's block demand (lane -> target cache rows)
        grantable in every shard, preempting victims where it is not.
        Returns the demand with preempted lanes dropped.  Each preemption
        shrinks the candidate set, and a lane alone in its shard always
        fits (the up-front rejection in :meth:`stream`), so the loop ends;
        at ``overcommit == 1.0`` every demand fits and it is a no-op."""
        pool, alloc = self.pool, self.pool.allocator
        demand = dict(demand)

        def shard_need(sh: int) -> int:
            return sum(max(0, alloc.blocks_for_rows(rows) - len(pool.slots[i].blocks))
                       for i, rows in demand.items() if pool.lane_shard(i) == sh)

        for sh in range(alloc.n_shards):
            while shard_need(sh) > alloc.free_in(sh):
                cands = [(i, pool.slots[i]) for i in range(pool.n_slots)
                         if pool.lane_shard(i) == sh and pool.slots[i].uid is not None
                         and (pool.slots[i].blocks or i in demand)]
                if len(cands) < 2:
                    raise RuntimeError(
                        f"shard {sh}: demand {shard_need(sh)} blocks > free "
                        f"{alloc.free_in(sh)} with {len(cands)} candidate lane(s): the "
                        "up-front per-request capacity check should make a sole lane fit")
                victim = preemption_order(cands)[0][0]
                self._preempt(victim, queue, now)
                demand.pop(victim, None)
        return demand

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

    @_on_mesh
    @torch.no_grad()
    def _prefill_step(self, queue: Deque[_Pending], now: int):
        """One prefill_chunk call: every prefilling lane consumes up to C
        prompt tokens; lanes whose prompt completes sample their first
        token (at full precision) and flip to the decode phase."""
        engine, pool = self.engine, self.pool
        # under overcommit the headroom pass may preempt prefilling lanes,
        # which changes the lane set and the chunk size: recompute until
        # the demand fits as it is
        while True:
            lanes = pool.prefilling()
            if not lanes:
                return
            remaining = {i: len(pool.slots[i].prompt) - pool.slots[i].filled for i in lanes}
            C = self._pick_chunk(max(remaining.values()), pool.n_decoding)
            if not self.policy.paged:
                break
            demand = {i: pool.slots[i].filled + min(C, remaining[i]) for i in lanes}
            if self._ensure_headroom(demand, queue, now) == demand:
                pool.grow_many(demand)  # the blocks each lane's chunk rows land in
                break
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
                if tr.find(obs_trace.FIRST_TOKEN) is None:
                    # a lane resumed after a decode-phase preemption emitted
                    # its first token in its first life: TTFT counts once
                    tr.event(obs_trace.FIRST_TOKEN)
                    ttft_ms = tr.ttft_ms()
                    self._h_ttft.observe(ttft_ms)
                    self._h_tier_ttft.labels(tier=s.tier).observe(ttft_ms)
                else:
                    ttft_ms = tr.ttft_ms()
                pool.start_decode(i, int(sampled_host[i]), ttft_ms)
                if self._tiered:
                    s.plane_log = [self._n_bits]  # the first token is full precision

    # -- decode ------------------------------------------------------------
    @_on_mesh
    @torch.no_grad()
    def _decode_step(self) -> Tuple[np.ndarray, np.ndarray, Dict[int, int]]:
        """One pooled decode step over every lane; returns the lanes that
        decoded, the sampled tokens (the step's one host read) and, on a
        tiered engine, each decoded lane's plane count.

        A tiered step groups its lanes by effective plane count and runs
        one dispatch per count, costliest first, each under its group's
        ``act`` mask (the others ride along frozen) and with the count as
        a device tensor; each group's tokens merge into ``tok`` under its
        mask, so a later group cannot overwrite an earlier group's."""
        engine, pool, pk = self.engine, self.pool, self.policy.paged_kernel
        t0 = time.perf_counter()
        active = pool.decode_mask
        lane_planes: Dict[int, int] = {}
        if self._tiered:
            eff = {i: self._effective_planes(pool.slots[i])
                   for i in range(pool.n_slots) if active[i]}
            if self.policy.plane_grouping:
                groups: Dict[int, List[int]] = {}
                for i, k in eff.items():
                    groups.setdefault(k, []).append(i)
            else:
                groups = {max(eff.values()): sorted(eff)}
            order = sorted(groups, reverse=True)
            masks = np.zeros((len(order), pool.n_slots), np.bool_)
            for g, k in enumerate(order):
                masks[g, groups[k]] = True
                for i in groups[k]:
                    lane_planes[i] = k
            masks_dev = torch.from_numpy(masks).to(engine.device)  # one copy per step
            for g, k in enumerate(order):
                act_g = masks_dev[g]
                logits, _ = transformer.decode_step(
                    engine.params, pool.cache, pool.tok, pool.pos, engine.cfg, active=act_g,
                    active_planes=self._plane_t[k], block_table=pool.block_table,
                    paged_kernel=pk)
                sampled = engine._sample(logits, pool.temps, pool.any_hot)
                pool.tok.copy_(torch.where(act_g[:, None], sampled[:, None].long(), pool.tok))
                self.tier_dispatches += 1
            sampled_host = pool.tok[:, 0].cpu().numpy()
        else:
            logits, _ = transformer.decode_step(
                engine.params, pool.cache, pool.tok, pool.pos, engine.cfg, active=pool.act,
                block_table=pool.block_table, paged_kernel=pk)
            sampled = engine._sample(logits, pool.temps, pool.any_hot)
            pool.tok.copy_(sampled[:, None])
            sampled_host = sampled.cpu().numpy()
        step_ms = (time.perf_counter() - t0) * 1e3
        self.decode_ms_total += step_ms
        self._h_step.observe(step_ms)
        self.decode_steps += 1
        self._c_steps.inc()
        return active, sampled_host, lane_planes

    # -- speculative decoding ----------------------------------------------
    @_on_mesh
    @torch.no_grad()
    def _spec_round(self, queue: Deque[_Pending], now: int) -> None:
        """One draft+verify round over every decode-phase lane.

        Lane ``i`` at ``pos0 = plen + g - 1`` (its last token ``d_0``
        sampled, its K/V row not yet written) drafts ``gamma_i =
        min(spec_gamma, remaining)`` tokens at ``draft_planes``; the
        verify chunk then scores rows ``pos0 .. pos0+gamma_i-1`` (inputs
        ``d_0..d_{gamma_i-1}``) at full precision (on a tiered engine at
        the round's effective count), overwriting every draft row.  With
        ``a`` the longest prefix where ``d_{j+1}`` equals the verified
        ``v_j``, the lane commits ``d_1..d_a`` plus ``v_a`` when a draft
        was rejected (always >= 1 token) and rewinds past the rejected
        rows (``SlotPool.commit_spec``).

        The draft steps chain on the device (an argmax, then
        ``torch.where`` on the step's ``act`` row) with the round's
        control vectors copied in once before them; the host reads the
        drafts and the verify's argmax once, after the verify.  Round
        setup is the only point this path can preempt, so a preemption
        snapshot never holds an unverified draft."""
        engine, pool, pol = self.engine, self.pool, self.policy
        while True:
            lanes = [i for i, s in enumerate(pool.slots)
                     if s.uid is not None and s.phase == "decode"]
            if not lanes:
                return  # every decode lane was preempted this step
            gam: Dict[int, int] = {}
            demand: Dict[int, int] = {}
            for i in lanes:
                s = pool.slots[i]
                gam[i] = max(1, min(s.spec_gamma, s.remaining))
                # the last verify write row is plen+g+gamma_i-2
                demand[i] = len(s.prompt) + len(s.tokens) + gam[i] - 1
            if self._ensure_headroom(demand, queue, now) == demand:
                pool.grow_many(demand)
                break
        gamma_r = max(gam.values())
        B = pool.n_slots
        # the round's control vectors in one host-to-device copy: the act
        # row of each draft step, the verify's start and n_valid
        ctrl = np.zeros((gamma_r + 2, B), np.int32)
        ctrl[gamma_r] = engine.max_len
        for i in lanes:
            s = pool.slots[i]
            ctrl[:gam[i], i] = 1
            ctrl[gamma_r, i] = len(s.prompt) + len(s.tokens) - 1  # pos0
            ctrl[gamma_r + 1, i] = gam[i]
        self._h_attn.observe(sum(len(pool.slots[i].blocks) for i in lanes))
        t0 = time.perf_counter()
        dev, cfg, params = engine.device, engine.cfg, engine.params
        V = cfg.vocab_size
        ctrl_dev = torch.from_numpy(ctrl).to(dev)
        act_dev = ctrl_dev[:gamma_r].bool()
        draft_planes = self._plane_t.get(pol.draft_planes)
        tok0 = pool.tok  # d_0 per lane (the verify's column 0)
        tok, pos = tok0, pool.pos
        drafts = []
        for j in range(gamma_r):
            act = act_dev[j]
            logits, _ = transformer.decode_step(
                params, pool.cache, tok, pos, cfg, active=act, active_planes=draft_planes,
                block_table=pool.block_table, paged_kernel=pol.paged_kernel)
            nxt = torch.argmax(logits[:, :V], dim=-1)
            tok = torch.where(act[:, None], nxt[:, None], tok)
            pos = pos + act.to(pos.dtype)
            drafts.append(nxt)
            self.draft_steps += 1
        # the verify's fixed width is gamma: pad shallower rounds with the
        # last draft (n_valid masks it)
        pad = [drafts[-1]] * (pol.gamma - gamma_r)
        vin = torch.stack([tok0[:, 0]] + drafts[:gamma_r - 1] + pad, dim=1)
        vplanes = None
        if self._tiered:
            # verify at the round's effective count: the max across the
            # lanes' tiers after the shed (the floors keep it > draft)
            vplanes = max(self._effective_planes(pool.slots[i]) for i in lanes)
            self.tier_verifies += 1
        all_logits, _ = transformer.prefill_chunk(
            params, pool.cache, vin, ctrl_dev[gamma_r], ctrl_dev[gamma_r + 1], cfg,
            block_table=pool.block_table,
            active_planes=None if vplanes is None else self._plane_t[vplanes],
            return_all_logits=True)
        verified = torch.argmax(all_logits[..., :V], dim=-1)
        # the round's one host read: drafts_h[i, j] = d_{j+1}, ver_h[i, j] = v_j
        host = torch.cat([torch.stack(drafts, dim=1), verified], dim=1).cpu().numpy()
        drafts_h, ver_h = host[:, :gamma_r], host[:, gamma_r:]
        step_ms = (time.perf_counter() - t0) * 1e3
        rec = self.obs.recorder
        fix = []  # (lane, correction token, rewound position)
        acc_total = rej_total = commit_total = 0
        for i in lanes:
            s = pool.slots[i]
            g_i = gam[i]
            a = 0
            while a < g_i and int(drafts_h[i, a]) == int(ver_h[i, a]):
                a += 1
            committed = [int(drafts_h[i, j]) for j in range(a)]
            if a < g_i:
                committed.append(int(ver_h[i, a]))  # the correction v_a
            freed = pool.commit_spec(i, committed)
            # per-lane depth backoff: a full accept deepens the next draft
            # (up to gamma), a full reject halves it (floor 1)
            if a == g_i:
                s.spec_gamma = min(s.spec_gamma + 1, pol.gamma)
            elif a == 0:
                s.spec_gamma = max(1, s.spec_gamma // 2)
            if a < g_i:
                # the draft chain's tok/pos overshot this lane
                fix.append((i, committed[-1], len(s.prompt) + len(s.tokens) - 1))
            if self._tiered:
                s.plane_log.extend([vplanes] * len(committed))
            rec.event(s.uid, obs_trace.DRAFT, steps=g_i)
            if self._tiered:
                rec.event(s.uid, obs_trace.VERIFY, accepted=a, committed=len(committed),
                          planes=vplanes)
            else:
                rec.event(s.uid, obs_trace.VERIFY, accepted=a, committed=len(committed))
            if a < g_i:
                rec.event(s.uid, obs_trace.ROLLBACK, rejected=g_i - a, freed_blocks=freed)
            acc_total += a
            rej_total += g_i - a
            commit_total += len(committed)
        # the chain's final tok/pos are right for fully accepted lanes and
        # untouched for inactive ones; only rejecting lanes are rewound
        if fix:
            f = torch.from_numpy(np.asarray(fix, np.int64).T.copy()).to(dev)
            tok = tok.index_put((f[0], torch.zeros_like(f[0])), f[1])
            pos = pos.index_put((f[0],), f[2].to(pos.dtype))
        pool.tok.copy_(tok)
        pool.pos.copy_(pos)
        # one round = one step on the decode clock
        self.decode_ms_total += step_ms
        self._h_step.observe(step_ms)
        self.decode_steps += 1
        self._c_steps.inc()
        self.spec_rounds += 1
        self.spec_drafted += acc_total + rej_total
        self.spec_accepted += acc_total
        self.spec_committed += commit_total
        self._c_spec_rounds.inc()
        self._c_spec_draft.inc(acc_total + rej_total)
        self._c_spec_accept.inc(acc_total)
        self._c_spec_reject.inc(rej_total)
        if self.spec_drafted:
            self._g_spec_rate.set(self.spec_accepted / self.spec_drafted)
        self._h_occ.observe(len(lanes))
        self._observe_blocks()

    def _observe_blocks(self) -> None:
        if not self.policy.paged:
            return
        pool = self.pool
        used = pool.allocator.used_count
        live = pool.live_rows()
        self._h_blocks.observe(used)
        self._h_rows.observe(live)
        if used:
            self._h_frag.observe(1.0 - live / (used * pool.block_size))

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
            if self._tiered:
                self._resolve_planes(r.precision, uid=r.uid)  # raises on a bad one
            elif r.precision not in ("full", None):
                raise ValueError(
                    f"request {r.uid}: precision={r.precision!r} but this engine has no "
                    "precision tiers: configure SchedulerPolicy(precision_tiers=...) (or "
                    "ServeEngine(precision_tiers=...)) to serve reduced plane counts")
            if len(r.tokens) < 1:
                raise ValueError(f"request {r.uid}: empty prompt: there is no position to "
                                 "prefill and the lane would never leave the prefill phase")
            if self.policy.spec_decode and r.temperature > 0:
                raise ValueError(
                    f"request {r.uid}: temperature={r.temperature}: spec_decode accepts "
                    "drafts by greedy verify; a sampled lane would silently diverge from "
                    "its non-speculative output")
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
                # against the PHYSICAL pool, not the overcommitted capacity:
                # this is also what lets a lane alone in its shard always fit
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
                if self._tiered and self.policy.degrade:
                    # measured after admission: "queue backed up" means work
                    # that could not be placed this step
                    self._degrade_tick(len(queue), now)
                # legacy max_new == 1 finishes at admission
                yield from self._finished()
                worked = False
                if self.policy.chunked_prefill and pool.prefilling():
                    self._prefill_step(queue, now)
                    worked = True
                    yield from self._finished()  # chunked max_new == 1
                if self.policy.spec_decode and pool.n_decoding:
                    # a round replaces the pooled decode step (block growth,
                    # headroom preemption and rewind live inside)
                    worked = True
                    self._spec_round(queue, now)
                    yield from self._finished()
                elif pool.n_decoding:
                    worked = True
                    if self.policy.paged:
                        # decode growth: lanes crossing a block boundary get
                        # their next block first (one table update); under
                        # overcommit the headroom pass may preempt every
                        # decode lane, hence the re-check below
                        pool.grow_many(self._ensure_headroom(
                            {i: len(s.prompt) + len(s.tokens) for i, s in enumerate(pool.slots)
                             if s.uid is not None and s.phase == "decode"}, queue, now))
                        self._h_attn.observe(sum(len(s.blocks) for s in pool.slots
                                                 if s.uid is not None and s.phase == "decode"))
                if not self.policy.spec_decode and pool.n_decoding:
                    active, sampled_host, lane_planes = self._decode_step()
                    pool.advance(sampled_host, active)
                    self._h_occ.observe(int(active.sum()))
                    for i, s in enumerate(pool.slots):
                        if active[i] and s.uid is not None:
                            if self._tiered:
                                s.plane_log.append(lane_planes[i])
                                rec.event(s.uid, obs_trace.DECODE_STEP, planes=lane_planes[i])
                            else:
                                rec.event(s.uid, obs_trace.DECODE_STEP)
                    self._observe_blocks()
                    yield from self._finished()
                if self.digests is not None:
                    self.digests.append(self.state_digest(queue))
                if not worked and incoming and not queue:
                    # idle gap before the next arrival: fast-forward the clock
                    # (a held queue must age step by step for max_wait)
                    now = max(now, incoming[0].arrival - 1)
                now += 1
        finally:
            # An abandoned generator (client disconnect, possibly mid-prefill)
            # must not leave ghost lanes: free every live lane so the shared
            # pool is clean for the next call, and close every open span
            # (preempted requests waiting in the queue included).
            for i, s in enumerate(pool.slots):
                if s.uid is not None:
                    rec.finish(s.uid, obs_trace.EVICTED, phase=s.phase, filled=s.filled)
                    self._c_req.labels(outcome="evicted").inc()
                    pool.evict(i)
            self._lane_pend.clear()
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
                self._lane_pend.pop(i, None)
                # a preempted-and-resumed lane stitches its earlier life back
                full = list(done.prior or []) + list(done.tokens)
                plane_log = None
                if self._tiered:
                    plane_log = np.asarray(list(done.prior_planes or [])
                                           + list(done.plane_log or []), np.int32)
                rec.finish(done.uid, obs_trace.FINISHED, n_tokens=len(full))
                self._c_req.labels(outcome="finished").inc()
                yield Result(uid=done.uid, tokens=np.asarray(full, np.int32),
                             prefill_ms=done.prefill_ms, decode_ms_per_tok=per_tok,
                             plane_log=plane_log)

    def run(self, requests, arrival_steps: Optional[Sequence[int]] = None):
        return list(self.stream(requests, arrival_steps))

    def _mesh_context(self):
        mesh = self.engine.mesh
        if mesh is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(packed_shard_mesh(mesh))
        stack.enter_context(paged_shard_mesh(self._paged_mesh))
        return stack

    def state_digest(self, queue=()) -> str:
        """A hash of the host scheduler's state: the queue, every lane's
        bookkeeping and the block table.  Every rank of a mesh must hold
        the same after every step."""
        h = hashlib.sha256()
        h.update(repr([(p.request.uid, p.arrival, p.seq, len(p.prior or ())) for p in queue])
                 .encode())
        for s in self.pool.slots:
            h.update(repr((s.uid, s.remaining, s.phase, s.filled, s.tokens, s.blocks,
                           s.committed, s.planes)).encode())
        if self.pool.block_table is not None:
            h.update(self.pool.block_table.cpu().numpy().tobytes())
        return h.hexdigest()

    # -- telemetry ---------------------------------------------------------
    def reset_telemetry(self) -> None:
        """Zero the obs bundle and the scalar counters (bench warm-up); the
        degrade loop restarts from full precision."""
        self.obs.reset()
        self.admit_bursts.clear()
        self.prefill_chunks = 0
        self.decode_ms_total = 0.0
        self.decode_steps = 0
        self.spec_rounds = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_committed = 0
        self.tier_dispatches = 0
        self.draft_steps = 0
        self.tier_verifies = 0
        self._shed = 0
        self._calm = 0
        self._preempt_step = 0
        self._preempt_window.clear()
        self._degrade_warned = False
        self.degrade_sheds = 0
        self.degrade_restores = 0
        if self._tiered:
            self._set_plane_gauges()

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

    def preemptions_total(self) -> int:
        """Lanes preempted (all tiers) since the last telemetry reset."""
        return int(sum(c.value for _, c in self._c_preempt.children()))

    def degrade_events_total(self) -> int:
        """Shed + restore transitions since the last telemetry reset."""
        return self.degrade_sheds + self.degrade_restores

    def active_planes(self, precision: str = "full") -> int:
        """Current effective plane count of a precision class (untiered
        engines report the packed width, or 0 for float params)."""
        if not self._tiered:
            return self._n_bits or 0
        return self._effective(precision)

    def spec_accept_rate(self) -> float:
        """Fraction of drafted tokens the verify accepted (0.0 before the
        first round)."""
        return self.spec_accepted / self.spec_drafted if self.spec_drafted else 0.0

    def plane_dispatches(self) -> int:
        """Model calls that passed a plane-count tensor: tiered decode
        dispatches, draft steps and tiered verify chunks.  Each launches
        the runtime-plane bitserial kernel once per packed projection."""
        return self.tier_dispatches + self.draft_steps + self.tier_verifies
