"""Fixed-capacity slot pool for continuous batching: PyTorch port of
``repro.serve.slots``.

A :class:`SlotPool` owns the persistent decode state of ``n_slots``
lanes: ONE preallocated cache whose batch axis is the slot index, the
per-slot position, temperature, last-token and decode-phase (``act``)
vectors on the device, and the host-side bookkeeping of each lane
(:class:`SlotState`).

Two admission styles share the pool:

* **Legacy (batch-1 prefill)**: a batch-1 ``transformer.prefill``
  produces a cache fragment and :func:`scatter_slot` writes it into the
  lane.
* **Chunked prefill**: admission only claims the lane
  (:meth:`SlotPool.admit` + :func:`reset_recurrent_slots`) and the prompt
  then streams through ``transformer.prefill_chunk`` in fixed-size
  chunks, interleaved with pooled decode steps.  Each lane carries a
  host-side ``phase`` ("prefill" -> "decode") mirrored by ``act``.

**Paged KV** (``SlotPool(paged=True)``): attention layers share a pool
of ``n_blocks`` fixed-size blocks plus a per-lane block table
(:class:`BlockAllocator` owns the free list).  Blocks are granted as
prefill chunks land and decode crosses a block boundary
(:meth:`SlotPool.grow_many`) and returned at eviction, so cache memory
scales with the live tokens, not ``n_slots * max_len``.  Admission
reserves each request's worst-case need up front
(:meth:`BlockAllocator.reserve`), which makes on-demand growth
infallible at ``overcommit == 1.0``; past 1.0 the scheduler admits
against ``BlockAllocator.commit_capacity`` and preempts a victim lane
(recompute swap) when growth would exhaust the pool.  A speculative
round's rejected rows rewind through :meth:`SlotPool.commit_spec`,
which frees tail blocks and moves no cache data.  The device pool holds
one block more than the allocator grants: the drop sentinel of
``models.attention``.  Likewise the unpaged
pool's "attn" caches hold one row more than ``max_len``.  Sliding-window
("local") layers keep a ring buffer of ``min(window, max_len)`` slots per
lane in both layouts: it never pages, and its rows need no reset (the
ring mask hides the last occupant's slots).

**On a mesh** (``SlotPool(mesh=...)``) each rank holds its block of the
pool under the dist rules (``dist.sharding.slot_pool_specs`` /
``block_pool_specs``: lanes or pool blocks over the data axes, K/V heads
over model; rings as the contiguous cache, or over their slots where the
K/V heads do not split; recurrent state and conv tails over the lanes
only; a local pool slice carries its own sentinel block), and the
allocator keeps one free list per table shard
(``dist.sharding.table_shards``).  The control vectors and the block
table are the same on every rank: every rank runs the same host
scheduler, and the attention paths take their lanes' rows of the table.
A lane's admission writes its state on the ranks that hold the lane
(:func:`scatter_slots`, :func:`reset_recurrent_slots`).

Caches and control vectors are updated in place.  Eviction is free: a
finished lane is marked inactive on the host and its stale rows are
dead weight until the next occupant overwrites (or masks) them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..dist.sharding import lane_shard  # noqa: F401  (the layout contract lives there)
from ..models import transformer


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)




class BlockAllocator:
    """Host-side free-list allocator for the paged KV block pool.

    Blocks are interchangeable (the per-lane block table provides the
    indirection), so there is no external fragmentation: ``alloc(k)``
    succeeds iff ``k <= free_count``, whatever the alloc/free history.
    Invariants:

    * a block is owned by at most one lane at a time (``alloc`` never
      hands out a live block; ``free`` rejects double-frees),
    * ``free_count + used_count == n_blocks`` at every step: a drained
      pool returns to ``free_count == n_blocks`` (zero leaks).

    ``reserve``/``release`` track *commitments*: the scheduler reserves a
    request's worst-case lifetime block need at admission and releases it
    at eviction.  With ``overcommit == 1.0`` the commitment capacity
    equals the physical pool, which guarantees every admitted lane can
    always grow to its last decode row.  With ``overcommit > 1.0`` the
    scheduler admits against ``commit_capacity = shard_blocks *
    overcommit`` per shard, so growth CAN hit an exhausted shard, and the
    scheduler preempts a victim first (``serve.scheduler``).  ``alloc``
    still fails only when a shard is physically out of blocks.

    **Sharded tables** (``n_shards > 1``): the block id space splits into
    ``n_shards`` contiguous ranges, each with its own free list and
    commitment counter, and a lane allocates only from its own shard.
    ``n_shards=1`` is the unsharded allocator.
    """

    def __init__(self, n_blocks: int, block_size: int, n_shards: int = 1,
                 overcommit: float = 1.0, registry=None,
                 labels: Optional[dict] = None):
        if n_blocks < 1 or block_size < 1:
            raise ValueError(f"need n_blocks >= 1 and block_size >= 1, got "
                             f"{n_blocks}, {block_size}")
        if n_shards < 1 or n_blocks % n_shards != 0:
            raise ValueError(
                f"n_shards {n_shards} must be >= 1 and divide n_blocks {n_blocks}")
        if overcommit < 1.0:
            raise ValueError(
                f"overcommit={overcommit}: factors below 1.0 would strand "
                "physical blocks behind the commitment gate")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.n_shards = n_shards
        self.shard_blocks = n_blocks // n_shards
        self.overcommit = overcommit
        # commitment ceiling per shard; == shard_blocks at overcommit 1.0
        self.commit_capacity = int(self.shard_blocks * overcommit)
        # per-shard stacks; pop() grants low ids first within each shard
        self._free = [
            list(range((s + 1) * self.shard_blocks - 1, s * self.shard_blocks - 1, -1))
            for s in range(n_shards)
        ]
        self._owner = {}  # live block id -> owner tag
        self._committed = [0] * n_shards  # blocks promised per shard (worst case)
        # Metrics (obs.metrics.Registry; optional): alloc/free counters and
        # free/committed gauges, one child per shard, resolved once here.
        self._m_alloc = self._m_freed = self._g_free = self._g_commit = None
        if registry is not None:
            extra = dict(labels or {})
            names = ("shard",) + tuple(sorted(extra))

            def mk(fam):  # one child per shard
                return [fam.labels(shard=str(s), **extra) for s in range(n_shards)]

            self._m_alloc = mk(registry.counter(
                "serve_blocks_alloc_total", "KV pool blocks granted", labels=names))
            self._m_freed = mk(registry.counter(
                "serve_blocks_freed_total", "KV pool blocks returned", labels=names))
            self._g_free = mk(registry.gauge(
                "serve_block_pool_free", "free KV pool blocks", labels=names))
            self._g_commit = mk(registry.gauge(
                "serve_blocks_committed",
                "KV pool blocks committed (worst-case reservations)", labels=names))
            for s in range(n_shards):
                self._g_free[s].set(len(self._free[s]))

    @property
    def committed(self) -> int:
        return sum(self._committed)

    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._free)

    @property
    def used_count(self) -> int:
        return self.n_blocks - self.free_count

    def shard_of(self, block: int) -> int:
        return block // self.shard_blocks

    def free_in(self, shard: int) -> int:
        return len(self._free[shard])

    def committed_in(self, shard: int) -> int:
        return self._committed[shard]

    def blocks_for_rows(self, rows: int) -> int:
        """Blocks needed to cover ``rows`` cache rows."""
        return _ceil_div(max(rows, 0), self.block_size)

    def alloc(self, k: int, owner=None, shard: int = 0) -> Optional[List[int]]:
        """Grant ``k`` blocks from ``shard`` to ``owner``; None if that
        shard cannot (the only failure mode)."""
        if k < 0:
            raise ValueError(f"alloc({k})")
        if k > len(self._free[shard]):
            return None
        out = [self._free[shard].pop() for _ in range(k)]
        for b in out:
            self._owner[b] = owner
        if self._m_alloc is not None and k:
            self._m_alloc[shard].inc(k)
            self._g_free[shard].set(len(self._free[shard]))
        return out

    def free(self, blocks: List[int]) -> None:
        for b in blocks:
            if b not in self._owner:
                raise ValueError(f"block {b} is not live (double free?)")
            del self._owner[b]
            sh = self.shard_of(b)
            self._free[sh].append(b)
            if self._m_freed is not None:
                self._m_freed[sh].inc()
                self._g_free[sh].set(len(self._free[sh]))

    def reserve(self, k: int, shard: int = 0) -> bool:
        """Commit ``k`` blocks of ``shard``'s future capacity; False past
        the shard's commitment ceiling."""
        if self._committed[shard] + k > self.commit_capacity:
            return False
        self._committed[shard] += k
        if self._g_commit is not None:
            self._g_commit[shard].set(self._committed[shard])
        return True

    def release(self, k: int, shard: int = 0) -> None:
        if k > self._committed[shard]:
            raise ValueError(
                f"release({k}) > committed {self._committed[shard]} in shard {shard}")
        self._committed[shard] -= k
        if self._g_commit is not None:
            self._g_commit[shard].set(self._committed[shard])


# ---------------------------------------------------------------------------
# Cache-tree scatters
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    """(path, tensor) for every leaf of a cache tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _slot_axis(path) -> int:
    """``blocks`` leaves carry the superblock axis before the slot axis."""
    return 1 if path[0] == "blocks" else 0


def _live_slots(slots, n_slots: int) -> np.ndarray:
    """The entries of a padded slot vector that name a lane: entries
    ``>= n_slots`` are padding (JAX drops their writes)."""
    slots = np.asarray(slots.cpu() if isinstance(slots, torch.Tensor) else slots).reshape(-1)
    return np.flatnonzero(slots < n_slots), slots


def scatter_slot(pool_cache, part_cache, slot: int, mesh=None) -> None:
    """Write a batch-1 cache fragment into lane ``slot`` of the pool, IN
    PLACE.  A fragment's rows fill the first rows of the lane (the pool's
    contiguous cache may be longer: its spare row)."""
    scatter_slots(pool_cache, part_cache, [slot], mesh)


def scatter_slots(pool_cache, part_cache, slots, mesh=None) -> None:
    """Write a batch-k cache fragment into lanes ``slots`` (k,), IN PLACE.
    Entries ``>= n_slots`` are padding and are skipped, as JAX's
    ``mode="drop"`` skips them.  On a ``mesh`` both caches are this rank's
    blocks (their ``mesh_spec``): the fragment is gathered whole and each
    rank writes the rows of its own pool block."""
    parts = dict(_leaves(part_cache))
    for path, pl in _leaves(pool_cache):
        pt = parts[path]
        axis = _slot_axis(path)
        if getattr(pl, "mesh_spec", None) is not None:
            _scatter_block(pl, pt, axis, slots, mesh, path[-1] in ("state", "conv"))
            continue
        keep, slots_np = _live_slots(slots, pl.shape[axis])
        lanes = torch.as_tensor(slots_np[keep], dtype=torch.int64, device=pl.device)
        src = pt.index_select(axis, torch.as_tensor(keep, device=pt.device)).to(
            device=pl.device, dtype=pl.dtype)
        dst = pl.narrow(axis + 1, 0, pt.shape[axis + 1]) if pl.ndim > axis + 1 else pl
        dst.index_copy_(axis, lanes, src)


def _scatter_block(pl, pt, axis: int, slots, mesh, recurrent: bool) -> None:
    """:func:`scatter_slots` for one leaf on a mesh: lane ``s`` of the
    pool, if this rank holds it, takes its sequence rows (or ring slots)
    and K/V heads of the whole fragment, or its whole recurrent state or
    conv tail."""
    from ..dist.sharding import axis_index, axis_size, block_range

    lead = (None,) * axis
    whole = mesh.gather_block(pt, lead + tuple(pt.mesh_spec))
    spec = pl.mesh_spec
    n_slots = pl.shape[axis] * axis_size(mesh, spec[0])
    b0, b1 = block_range(mesh, spec[0], n_slots)
    keep, slots_np = _live_slots(slots, n_slots)
    if recurrent:  # a lane's whole state or conv tail
        for i in keep:
            lane = int(slots_np[i])
            if b0 <= lane < b1:
                pl.select(axis, lane - b0).copy_(whole.select(axis, int(i)))
        return
    h0, h1 = block_range(mesh, spec[2], whole.shape[axis + 2])
    s_l = pl.shape[axis + 1]
    s0 = axis_index(mesh, spec[1]) * s_l
    rows = min(whole.shape[axis + 1], s0 + s_l) - s0
    for i in keep:
        lane = int(slots_np[i])
        if rows > 0 and b0 <= lane < b1:
            src = whole.select(axis, int(i)).narrow(axis, s0, rows).narrow(axis + 1, h0, h1 - h0)
            pl.select(axis, lane - b0).narrow(axis, 0, rows).copy_(src)


def reset_recurrent_slots(pool_cache, slots, mesh=None) -> None:
    """Zero the recurrent leaves (``state``/``conv``) of lanes ``slots``,
    IN PLACE; padding entries (``>= n_slots``) are skipped.  Attention
    rows need no reset (the chunk and decode masks confine every read to
    rows the new occupant wrote), so on an "attn"-only model this leaves
    the cache as it is.  On a ``mesh`` the leaves are this rank's lanes
    (their ``mesh_spec``): only the rank that holds a lane zeroes it."""
    from ..dist.sharding import axis_size, block_range

    for path, pl in _leaves(pool_cache):
        if path[-1] not in ("state", "conv"):
            continue
        axis = _slot_axis(path)
        spec = getattr(pl, "mesh_spec", None)
        lane_ax = spec[0] if spec is not None else None
        n_slots = pl.shape[axis] * axis_size(mesh, lane_ax)
        b0, b1 = block_range(mesh, lane_ax, n_slots) if lane_ax is not None else (0, n_slots)
        keep, slots_np = _live_slots(slots, n_slots)
        own = [int(s) - b0 for s in slots_np[keep] if b0 <= s < b1]
        lanes = torch.as_tensor(own, dtype=torch.int64, device=pl.device)
        pl.index_fill_(axis, lanes, 0)


# ---------------------------------------------------------------------------
# The pool
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SlotState:
    """Host-side view of one lane."""

    uid: Optional[int] = None
    remaining: int = 0  # tokens still to generate; 0 => free
    tokens: Optional[List[int]] = None  # generated tokens so far
    prefill_ms: float = 0.0
    admitted_at: int = 0  # scheduler step of admission
    temperature: float = 0.0  # host mirror of the device temps lane
    # chunked-prefill bookkeeping
    phase: str = "decode"  # "prefill" (consuming prompt chunks) | "decode"
    prompt: Optional[np.ndarray] = None  # staged prompt (chunked admission)
    filled: int = 0  # prompt tokens already written to the cache
    admit_wall: float = 0.0  # perf_counter at admission (TTFT accounting)
    # paged-KV bookkeeping
    blocks: Optional[List[int]] = None  # pool blocks owned, logical order
    committed: int = 0  # worst-case lifetime blocks reserved at admission
    # overcommit / SLO bookkeeping
    tier: str = "throughput"  # SLO class: "latency" outranks "throughput"
    prior: Optional[List[int]] = None  # tokens generated before a preemption
    admit_seq: int = 0  # monotone admission counter (LIFO victim order)
    # speculative decoding: per-lane draft depth (full accepts grow it
    # toward the policy gamma, zero accepts halve it); 0 on non-spec lanes
    spec_gamma: int = 0
    # precision tiers (tiered engines only): ``planes`` the request's
    # resolved plane count before any degrade shed, ``precision`` the class
    # it resolved from (floor lookups), ``plane_log`` the plane count of
    # each emitted token (parallel to ``tokens``), ``prior_planes`` that of
    # each ``prior`` token
    planes: Optional[int] = None
    precision: str = "full"
    plane_log: Optional[List[int]] = None
    prior_planes: Optional[List[int]] = None


class SlotPool:
    """Device state + host bookkeeping for ``n_slots`` decode lanes."""

    def __init__(self, cfg: ModelConfig, n_slots: int, max_len: int, cache_dtype=None,
                 paged: bool = False, block_size: int = 32, n_blocks: Optional[int] = None,
                 overcommit: float = 1.0, registry=None, device=None, mesh=None):
        from ..dist import sharding as dist_sharding

        self.cfg = cfg
        self.mesh = mesh
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.cache_dtype = cfg.cache_dtype if cache_dtype is None else cache_dtype
        self.paged = paged
        self.registry = registry
        self.block_size = block_size if paged else None
        self.blocks_per_lane = _ceil_div(max_len, block_size) if paged else None
        self.table_shards = 1
        self.overcommit = overcommit if paged else 1.0
        if paged:
            # default capacity matches the unpaged reservation (no admission
            # throttling); callers shrink n_blocks to save device memory
            self.n_blocks = n_slots * self.blocks_per_lane if n_blocks is None else n_blocks
            self.table_shards = dist_sharding.table_shards(mesh, n_slots, self.n_blocks)
            self.allocator = BlockAllocator(
                self.n_blocks, block_size, n_shards=self.table_shards, overcommit=overcommit,
                registry=registry,
                labels=dist_sharding.mesh_labels(mesh) if mesh is not None else None)
            self.cache = transformer.init_cache(
                cfg, n_slots, max_len, self.cache_dtype, self.device,
                paged_blocks=self.n_blocks, block_size=block_size, mesh=mesh)
        else:
            self.n_blocks = None
            self.allocator = None
            # "attn" leaves get one spare row past max_len, the drop row of
            # prefill_chunk; "local" rings keep JAX's min(window, max_len)
            # slots, so the spare row stays outside the ring's modulus
            self.cache = transformer.init_cache(cfg, n_slots, max_len, self.cache_dtype,
                                                self.device, drop_row=True, mesh=mesh)
        dev = self.device
        self.pos = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        self.temps = torch.zeros((n_slots,), dtype=torch.float32, device=dev)
        self.tok = torch.zeros((n_slots, 1), dtype=torch.int64, device=dev)  # last sampled
        self.act = torch.zeros((n_slots,), dtype=torch.bool, device=dev)  # decode-phase lanes
        # Per-lane block table: unallocated entries stay 0; reads through
        # them land past every lane's position and are masked, and writes
        # only go through entries grow_many() granted.
        self.block_table = (torch.zeros((n_slots, self.blocks_per_lane), dtype=torch.int32,
                                        device=dev) if paged else None)
        self.slots = [SlotState() for _ in range(n_slots)]

    def cache_bytes(self) -> int:
        """Device bytes of the attention cache (pool or contiguous, rings
        included)."""
        return sum(t.numel() * t.element_size() for _, t in _leaves(self.cache))

    def ring_bytes(self) -> int:
        """Device bytes of the sliding-window ring buffers alone."""
        total = 0
        for path, t in _leaves(self.cache):
            # ("blocks", "p{i}", leaf) or ("tail", i, leaf)
            i = int(path[1][1:]) if path[0] == "blocks" else path[1]
            if self.cfg.layer_pattern[i].split("+")[0] == "local":
                total += t.numel() * t.element_size()
        return total

    # -- host-side lane management ----------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.uid is None]

    def lane_shard(self, slot: int) -> int:
        return lane_shard(slot, self.n_slots, self.table_shards)

    @property
    def active_mask(self) -> np.ndarray:
        return np.asarray([s.uid is not None for s in self.slots])

    @property
    def n_active(self) -> int:
        return int(self.active_mask.sum())

    @property
    def decode_mask(self) -> np.ndarray:
        """Lanes currently in the decode phase (host mirror of ``act``)."""
        return np.asarray([s.uid is not None and s.phase == "decode" for s in self.slots])

    @property
    def n_decoding(self) -> int:
        return int(self.decode_mask.sum())

    def prefilling(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s.uid is not None and s.phase == "prefill"]

    @property
    def any_hot(self) -> bool:
        """True if any live lane samples with temperature > 0 (host-side,
        so the decode loop never reads the device temps vector)."""
        return any(s.uid is not None and s.temperature > 0 for s in self.slots)

    def occupy(self, slot: int, uid: int, first_token: int, prompt_len: int, max_new: int,
               temperature: float, prefill_ms: float, now: int, tier: str = "throughput"):
        """Mark lane ``slot`` as owned by request ``uid`` (legacy admission:
        the cache scatter has already happened); seed the control vectors."""
        self.slots[slot] = SlotState(
            uid=uid, remaining=max_new - 1, tokens=[first_token], prefill_ms=prefill_ms,
            admitted_at=now, temperature=temperature, tier=tier)
        self.pos[slot] = prompt_len
        self.temps[slot] = temperature
        self.tok[slot, 0] = first_token
        self.act[slot] = True

    def admit(self, slot: int, uid: int, prompt: np.ndarray, max_new: int, temperature: float,
              now: int, wall: float, tier: str = "throughput",
              prior: Optional[List[int]] = None, admit_seq: int = 0,
              planes: Optional[int] = None, precision: str = "full",
              prior_planes: Optional[List[int]] = None):
        """Claim lane ``slot`` for chunked prefill: the prompt is staged
        host-side and streams through ``prefill_chunk``; the lane joins
        the decode phase via :meth:`start_decode` once its last chunk
        lands.  Paged pools also reserve the request's worst-case
        lifetime need (prompt + max_new - 1 rows); the scheduler's
        admission check guarantees it fits.  At ``overcommit == 1.0`` the
        reservation in turn guarantees every later :meth:`grow_many`
        succeeds; past 1.0 the scheduler preempts to headroom first.

        Re-admitting a preempted request passes ``prior`` (the tokens it
        had generated) with ``prompt`` already extended by them: the
        re-prefill recomputes their KV rows, and the Result stitches
        ``prior + tokens`` back together."""
        self.slots[slot] = SlotState(
            uid=uid, remaining=max_new, tokens=[], admitted_at=now, temperature=temperature,
            phase="prefill", prompt=np.asarray(prompt, np.int32), filled=0, admit_wall=wall,
            blocks=[] if self.paged else None, tier=tier,
            prior=list(prior) if prior else None, admit_seq=admit_seq, planes=planes,
            precision=precision, prior_planes=list(prior_planes) if prior_planes else None)
        if self.paged:
            s = self.slots[slot]
            sh = self.lane_shard(slot)
            s.committed = self.allocator.blocks_for_rows(len(s.prompt) + max_new - 1)
            if not self.allocator.reserve(s.committed, shard=sh):
                raise RuntimeError(
                    f"admitted lane {slot} cannot reserve {s.committed} blocks (shard {sh} "
                    f"committed {self.allocator.committed_in(sh)}"
                    f"/{self.allocator.commit_capacity}): the scheduler's paged admission "
                    "check should have held it")
        self.pos[slot] = 0
        self.temps[slot] = temperature
        # act stays False: the interleaved decode step must freeze this
        # lane's cache until the prompt is fully written

    def grow_rows(self, slot: int, rows: int) -> None:
        """Ensure lane ``slot`` owns blocks covering cache rows [0, rows)."""
        self.grow_many({slot: rows})

    def grow_many(self, rows_by_slot) -> None:
        """Grant every lane's demand and apply ONE block-table update.
        At ``overcommit == 1.0`` the admission-time reservation makes
        failure impossible for admitted lanes; past 1.0 the scheduler must
        have preempted to headroom first.  Either way a failure here is a
        bug, and raises."""
        rr, cc, vv = [], [], []
        for slot, rows in rows_by_slot.items():
            s = self.slots[slot]
            need = self.allocator.blocks_for_rows(rows) - len(s.blocks)
            if need <= 0:
                continue
            sh = self.lane_shard(slot)
            got = self.allocator.alloc(need, owner=slot, shard=sh)
            if got is None:
                raise RuntimeError(
                    f"lane {slot} needs {need} blocks but only {self.allocator.free_in(sh)} "
                    f"are free in shard {sh}: the headroom invariant was violated")
            base = len(s.blocks)
            rr += [slot] * need
            cc += list(range(base, base + need))
            vv += got
            s.blocks.extend(got)
        if rr:
            upd = torch.tensor([rr, cc, vv], dtype=torch.int64).to(self.device)  # one copy
            self.block_table[upd[0], upd[1]] = upd[2].to(torch.int32)

    def live_rows(self) -> int:
        """Cache rows holding live K/V across lanes (telemetry)."""
        total = 0
        for s in self.slots:
            if s.uid is None:
                continue
            total += s.filled if s.phase == "prefill" else len(s.prompt) + len(s.tokens) - 1
        return total

    def start_decode(self, slot: int, first_token: int, ttft_ms: float):
        """Flip lane ``slot`` from prefill to decode: the final chunk's
        logits produced ``first_token``; decode writes continue at the
        prompt's end."""
        s = self.slots[slot]
        s.phase = "decode"
        s.remaining -= 1
        s.tokens = [first_token]
        s.prefill_ms = ttft_ms
        self.pos[slot] = len(s.prompt)
        self.tok[slot, 0] = first_token
        self.act[slot] = True

    def evict(self, slot: int) -> SlotState:
        """Free lane ``slot``; returns its final host state.  The device
        cache and the lane's table row are left stale (the next occupant
        overwrites the entries it uses; reads through stale ones sit past
        the lane's position and are masked).  Paged pools return the
        lane's blocks and its commitment to the allocator."""
        done = self.slots[slot]
        if self.paged and done.uid is not None:
            if done.blocks:
                self.allocator.free(done.blocks)
            self.allocator.release(done.committed, shard=self.lane_shard(slot))
        self.slots[slot] = SlotState()
        self.pos[slot] = 0
        self.temps[slot] = 0.0
        self.act[slot] = False
        return done

    def commit_spec(self, slot: int, tokens: List[int]) -> int:
        """Commit a speculative round's tokens on lane ``slot`` and rewind
        past the rejected draft rows.

        Appends ``tokens``, then returns to the allocator the tail blocks
        granted only for rejected draft rows: after the commit the lane's
        written rows are ``[0, plen + g - 1)`` with ``g = len(tokens)``
        (the last token's K/V, like ``tok`` after a decode step, is
        written by the next step), so the lane keeps
        ``blocks_for_rows(plen + g - 1)`` blocks.  The freed blocks' table
        entries go stale as an evicted lane's do (the paged kernel never
        reads past a lane's position), so the rewind moves no cache data.
        The device ``pos``/``tok`` rewind is the scheduler's.  Returns
        the number of blocks freed."""
        s = self.slots[slot]
        s.tokens.extend(tokens)
        s.remaining -= len(tokens)
        if not self.paged or not s.blocks:
            return 0
        keep = self.allocator.blocks_for_rows(len(s.prompt) + len(s.tokens) - 1)
        if keep >= len(s.blocks):
            return 0
        dead = s.blocks[keep:]
        del s.blocks[keep:]
        self.allocator.free(dead)
        return len(dead)

    def advance(self, sampled: np.ndarray, active: np.ndarray):
        """After one pool decode step: record each active lane's token and
        advance its position.  ``sampled``: (n_slots,) host int array."""
        self.pos += torch.as_tensor(np.asarray(active, np.int32)).to(self.device)
        for i, s in enumerate(self.slots):
            if active[i] and s.uid is not None:
                s.tokens.append(int(sampled[i]))
                s.remaining -= 1

    def reset(self):
        """Return every lane to free (bench warm-up); the cache is left stale."""
        self.slots = [SlotState() for _ in range(self.n_slots)]
        self.pos.zero_()
        self.temps.zero_()
        self.act.zero_()
        if self.paged:
            self.allocator = BlockAllocator(self.n_blocks, self.block_size,
                                            overcommit=self.overcommit, registry=self.registry)
            self.block_table.zero_()
