"""Bucketed serving engine over float or BSQ-packed weights (PyTorch port
of the length-bucketing mode of ``repro.serve.engine``).

Requests are grouped by prompt length; each bucket runs one prefill and
then a decode loop with one position shared by the bucket.  Packed
weights are dequantised inside the bitserial kernel at every projection
(``kernels.ops.bitserial_matmul``), so device-memory reads per decode
step scale with the packed bit count.

The engine emits the ``serve_ttft_ms`` histogram, the
``serve_requests_total`` counter and the ``admitted -> first_token``
span exactly as the JAX engine's bucketed path does.  The continuous
slot-pool scheduler, paged KV and the mesh come with the next slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.packing import PACKABLE_SUFFIXES, PackedWeight, tree_map_with_path
from ..device import resolve_device
from ..models import transformer
from ..obs import Observability
from ..obs import trace as obs_trace


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray  # (S,) int32 prompt
    max_new: int = 32
    temperature: float = 0.0  # 0 => greedy
    # SLO and precision classes of the continuous scheduler; the
    # bucketed engine ignores both, as the JAX one does.
    tier: str = "throughput"
    precision: object = "full"


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray
    # TTFT: the request's admitted -> first_token span (RequestTrace.ttft_ms)
    prefill_ms: float
    decode_ms_per_tok: float


_MATRICES = frozenset(PACKABLE_SUFFIXES) | {"embed"}


def serving_params(params, cfg: ModelConfig, device: torch.device):
    """Params on ``device``, with float matrices (embedding, unpacked
    projections) cast once to the compute dtype.  The model casts them at
    every use anyway (``w.to(x.dtype)``), so the result is the same;
    norm scales stay f32 and PackedWeights keep their bytes."""
    dt = cfg.compute_dtype

    def place(name, leaf):
        if isinstance(leaf, PackedWeight):
            return leaf.to(device)
        leaf = leaf.to(device)
        if name.rsplit("/", 1)[-1] in _MATRICES:
            leaf = leaf.to(dt)
        return leaf

    return tree_map_with_path(place, params)


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, max_len: int = 4096, seed: int = 0,
                 device=None, continuous: bool = False,
                 obs: Optional[Observability] = None):
        if continuous:
            raise NotImplementedError(
                "continuous=True (the slot-pool scheduler, chunked prefill and "
                "paged KV) comes with the next slice of the port")
        transformer.check_supported(cfg)
        self.cfg = cfg
        self.max_len = max_len
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.obs = obs if obs is not None else Observability()
        self.params = serving_params(params, cfg, self.device)

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

    def generate(self, requests: List[Request]) -> List[Result]:
        """Serve a request set: batch by prompt length (offline semantics)."""
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
