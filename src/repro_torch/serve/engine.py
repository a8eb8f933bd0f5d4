"""Serving engine over float or BSQ-packed weights (PyTorch port of
``repro.serve.engine``).

Bucketed (default): requests are grouped by prompt length; each bucket
runs one prefill and then a decode loop with one position shared by the
bucket.  Continuous (``continuous=True``): requests go through the
slot-pool scheduler (``serve.scheduler``), with legacy batch-1 or
chunked prefill and, with ``paged=True``, a block-table KV pool whose
decode reads run through the paged-attention kernel when
``paged_kernel=True``.  Packed weights are dequantised inside the
bitserial kernel at every projection (``kernels.ops.bitserial_matmul``),
so device-memory reads per decode step scale with the packed bit count.
The continuous scheduler's policies ride in the same arguments as in the
JAX engine: ``overcommit`` (recompute-swap preemption),
``spec_decode``/``draft_planes``/``gamma`` (bit-plane speculative
decoding), ``precision_tiers`` and ``degrade`` (per-request plane counts
and load-triggered plane shedding).
Whole-prompt prefill (the bucketed path and legacy admission) runs its
attention through the flash kernel; models with sliding-window layers
(gemma3) keep a ring buffer per lane for them.

The engine emits the ``serve_ttft_ms`` histogram, the
``serve_requests_total`` counter and the ``admitted -> first_token``
span exactly as the JAX engine does.

On a ("data", "model") mesh (``mesh=``, a
:class:`~repro_torch.launch.mesh.HostMesh`; one engine per rank, every
rank serving the same requests) the engine annotates the packed weights
(``dist.sharding.annotate_packed_specs``), keeps this rank's block of
every weight (``dist.elastic.reshard_tree``) and runs every model call
under ``models.common.packed_shard_mesh``; a bucket's prefill places its
cache under ``dist.sharding.cache_tree_specs``, so a bucket the data axis
does not divide runs with its batch axis replicated.  Every layer kind
and the MoE FFN serve on a mesh (rings over heads or slots, recurrent
state over lanes, experts over "model").  ``placed``:
the params are this rank's blocks already, as a state trained on the mesh
exports them (``core.bsq.export_packed_blocks``), and are kept as given.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.bsq import merge_params
from ..core.packing import (
    PackedWeight,
    packed_leaves,
    serving_cast,
    tree_map_with_path,
    unpack_to_float,
)
from ..device import resolve_device
from ..models import transformer
from ..models.common import packed_shard_mesh
from ..obs import Observability
from ..obs import trace as obs_trace


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray  # (S,) int32 prompt
    max_new: int = 32
    temperature: float = 0.0  # 0 => greedy
    # SLO class of the continuous scheduler: "latency" requests outrank
    # "throughput" at admission and are preempted last under overcommit;
    # the bucketed engine ignores it, as the JAX one does.
    tier: str = "throughput"
    # Precision class of a tiered continuous engine: "full", a key of the
    # policy's precision_tiers table, or an explicit plane count (int),
    # validated at stream() like ``tier``.  The bucketed engine ignores
    # it; an untiered continuous engine rejects anything but "full".
    precision: object = "full"


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray
    # TTFT: the request's admitted -> first_token span (RequestTrace.ttft_ms)
    prefill_ms: float
    decode_ms_per_tok: float
    # Tiered engines only: the active plane count each token was computed
    # at, parallel to ``tokens`` (the first token at full precision, decode
    # tokens at the step's effective count after any degrade shed).  None
    # on untiered paths.  ``obs.quality.replay_plane_log`` replays it.
    plane_log: Optional[np.ndarray] = None


def serving_params(params, cfg: ModelConfig, device: torch.device):
    """Params on ``device``, with float matrices (embedding, unpacked
    projections) cast once to the compute dtype (``serving_cast``, the
    rule ``transformer.init_params(pack_bits=)`` applies as it draws).
    The model casts them at every use anyway (``w.to(x.dtype)``), so the
    result is the same; norm scales stay f32 and PackedWeights keep their
    bytes."""
    dt = cfg.compute_dtype

    def place(name, leaf):
        return serving_cast(name, leaf.to(device), dt)

    return tree_map_with_path(place, params)


def dequantize_packed_params(template, packed: Dict[str, PackedWeight],
                             floats: Dict[str, torch.Tensor]):
    """Materialise a float param tree from a BSQ packed export: the plain
    route (``unpack_to_float``), where the bitserial kernel dequantises
    inside the matmul instead."""
    return merge_params(template, {name: unpack_to_float(pw) for name, pw in packed.items()},
                        floats)


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, max_len: int = 4096, seed: int = 0,
                 device=None, continuous: bool = False, n_slots: int = 8,
                 policy=None, chunked_prefill: bool = False, paged: bool = False,
                 block_size: int = 32, n_blocks: Optional[int] = None,
                 paged_kernel: bool = False, overcommit: float = 1.0,
                 spec_decode: bool = False, draft_planes: int = 2, gamma: int = 4,
                 precision_tiers: Optional[Dict[str, int]] = None, degrade: bool = False,
                 degrade_queue_depth: int = 2, degrade_hysteresis: int = 4,
                 obs: Optional[Observability] = None, mesh=None, placed: bool = False):
        self.cfg = cfg
        self.max_len = max_len
        self.mesh = mesh
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device={device} but this rank's mesh device is "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.obs = obs if obs is not None else Observability()
        # the packed weights' bytes: the whole model's, and this rank's block
        self.packed_bytes_global = sum(pw.hbm_bytes() for pw in packed_leaves(params))
        if mesh is not None:
            from ..dist import elastic, sharding

            if placed:  # each packed weight is a block: the sum over a pod's ranks
                self.packed_bytes_global = int(mesh.all_reduce(
                    torch.tensor(float(self.packed_bytes_global), dtype=torch.float64),
                    mesh.weight_axes))
            else:
                params = elastic.reshard_tree(sharding.annotate_packed_specs(params, mesh),
                                              mesh)
        self.params = serving_params(params, cfg, self.device)
        self.packed_bytes_local = sum(pw.hbm_bytes() for pw in packed_leaves(self.params))
        self.scheduler = None
        if (paged or paged_kernel) and not continuous:
            raise ValueError("paged=True requires continuous=True (the block pool lives "
                             "in the slot-pool scheduler)")
        if spec_decode and not continuous:
            raise ValueError("spec_decode=True requires continuous=True (the draft/verify "
                             "rounds live in the slot-pool scheduler)")
        if paged_kernel and not paged:
            raise ValueError("paged_kernel=True requires paged=True: the kernel walks the "
                             "block table a dense cache does not have")
        if continuous:
            from .scheduler import ContinuousScheduler, SchedulerPolicy

            if policy is None:
                policy = SchedulerPolicy(n_slots=n_slots,
                                         chunked_prefill=chunked_prefill or paged,
                                         paged=paged, block_size=block_size,
                                         n_blocks=n_blocks, paged_kernel=paged_kernel,
                                         overcommit=overcommit, spec_decode=spec_decode,
                                         draft_planes=draft_planes, gamma=gamma,
                                         precision_tiers=precision_tiers, degrade=degrade,
                                         degrade_queue_depth=degrade_queue_depth,
                                         degrade_hysteresis=degrade_hysteresis)
            else:
                if chunked_prefill and not policy.chunked_prefill:
                    policy = dataclasses.replace(policy, chunked_prefill=True)
                if paged and not policy.paged:
                    # paged implies chunked prefill (the policy validates)
                    policy = dataclasses.replace(policy, paged=True, chunked_prefill=True,
                                                 block_size=block_size, n_blocks=n_blocks)
                if paged_kernel and not policy.paged_kernel:
                    policy = dataclasses.replace(policy, paged_kernel=True)
                # each of these requires paged (or chunked) serving; the
                # policy validates
                if overcommit != 1.0 and policy.overcommit == 1.0:
                    policy = dataclasses.replace(policy, overcommit=overcommit)
                if spec_decode and not policy.spec_decode:
                    policy = dataclasses.replace(policy, spec_decode=True,
                                                 draft_planes=draft_planes, gamma=gamma)
                if precision_tiers is not None and policy.precision_tiers is None:
                    policy = dataclasses.replace(policy, precision_tiers=precision_tiers)
                if degrade and not policy.degrade:
                    policy = dataclasses.replace(policy, degrade=True,
                                                 degrade_queue_depth=degrade_queue_depth,
                                                 degrade_hysteresis=degrade_hysteresis)
            self.scheduler = ContinuousScheduler(self, policy)

    # -- sampling ---------------------------------------------------------
    def _sample(self, logits: torch.Tensor, temperatures: torch.Tensor,
                any_hot: bool) -> torch.Tensor:
        """Per-request sampling: row i uses temperatures[i]; 0 => greedy."""
        logits = logits[:, : self.cfg.vocab_size]  # mask padded vocab rows
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if not any_hot:
            return greedy
        safe_t = torch.where(temperatures > 0, temperatures,
                             torch.ones_like(temperatures))[:, None]
        probs = torch.softmax(logits / safe_t, dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self.generator)[:, 0].to(torch.int32)
        return torch.where(temperatures > 0, sampled, greedy)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- batching ---------------------------------------------------------
    @staticmethod
    def _buckets(requests: List[Request]) -> Dict[int, List[Request]]:
        out: Dict[int, List[Request]] = {}
        for r in requests:
            out.setdefault(len(r.tokens), []).append(r)
        return out

    def generate(self, requests: List[Request],
                 arrival_steps: Optional[Sequence[int]] = None) -> List[Result]:
        """Serve a request set.  Continuous engines route through the
        slot-pool scheduler (``arrival_steps`` simulates staggered
        arrivals on the scheduler's step clock); bucketed engines batch
        by prompt length and ignore arrivals (offline semantics)."""
        if self.scheduler is not None:
            return self.scheduler.run(requests, arrival_steps)
        rec = self.obs.recorder
        for r in requests:
            rec.begin(r.uid)
        try:
            results = []
            for plen, bucket in self._buckets(requests).items():
                results.extend(self._run_bucket(plen, bucket))
            return results
        finally:
            # A failed bucket must not leak the remaining spans.
            for r in requests:
                if r.uid in rec.active:
                    rec.finish(r.uid, obs_trace.ABANDONED)

    def stream(self, requests: List[Request],
               arrival_steps: Optional[Sequence[int]] = None):
        """Streaming completion: yield each Result as its lane finishes
        (continuous mode only)."""
        if self.scheduler is None:
            raise ValueError("stream() requires ServeEngine(continuous=True)")
        return self.scheduler.stream(requests, arrival_steps)

    @torch.inference_mode()
    def _run_bucket(self, plen: int, bucket: List[Request]) -> List[Result]:
        B = len(bucket)
        rec = self.obs.recorder
        h_ttft = self.obs.registry.histogram(
            "serve_ttft_ms",
            "time to first token (admitted -> first_token span, ms)")
        c_req = self.obs.registry.counter(
            "serve_requests_total", "requests retired, by terminal outcome",
            labels=("outcome",))
        prompts = torch.from_numpy(np.stack([r.tokens for r in bucket]).astype(np.int64)).to(
            self.device)
        temps = torch.tensor([r.temperature for r in bucket], dtype=torch.float32,
                             device=self.device)
        any_hot = any(r.temperature > 0 for r in bucket)
        max_new = max(r.max_new for r in bucket)
        if plen + max_new - 1 > self.max_len:
            raise ValueError(f"prompt {plen} + max_new {max_new} does not fit "
                             f"max_len={self.max_len}")
        # The bucket's prefill dispatch is every member's admission.
        t0 = obs_trace.now()
        for r in bucket:
            rec.event(r.uid, obs_trace.ADMITTED, ts=t0, batch=B)
        with packed_shard_mesh(self.mesh):
            logits, cache = transformer.prefill(self.params, {"tokens": prompts}, self.cfg,
                                                self.max_len)
        tok = self._sample(logits, temps, any_hot)
        self._sync()
        # TTFT = admitted -> first SAMPLED token
        t_first = obs_trace.now()
        for r in bucket:
            rec.event(r.uid, obs_trace.FIRST_TOKEN, ts=t_first)
        out_toks = [tok]
        t1 = time.perf_counter()
        for t in range(max_new - 1):
            with packed_shard_mesh(self.mesh):
                logits, cache = transformer.decode_step(self.params, cache, tok[:, None].long(),
                                                        plen + t, self.cfg)
            tok = self._sample(logits, temps, any_hot)
            out_toks.append(tok)
        self._sync()
        decode_ms = (time.perf_counter() - t1) * 1e3 / max(max_new - 1, 1)
        gen = torch.stack(out_toks, dim=1).cpu().numpy()
        results = []
        for i, r in enumerate(bucket):
            tr = rec.finish(r.uid, obs_trace.FINISHED, n_tokens=r.max_new)
            c_req.labels(outcome="finished").inc()
            h_ttft.observe(tr.ttft_ms())
            results.append(Result(r.uid, gen[i, : r.max_new], tr.ttft_ms(), decode_ms))
        return results
