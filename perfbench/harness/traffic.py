"""The one generator of the benchmark's traffic, read from a mix's data
file.

Serving (``serve_closed_loop``): prompt and output lengths are lognormal
(a median, a sigma, clipped to [min, max]).  Every seed gets the same
multiset of lengths, taken at evenly spaced quantiles, in its own order,
so seeds change which request comes when and what its tokens are, never
how much work there is; the order is stratified, so that every stretch
of a few tens of requests holds the whole distribution.  The first wave, one request per client, takes
its output lengths from the residual-life distribution (what is left of
a request found in flight), so completions are spread from the start
rather than arriving together.

Training (``train_steps``): rows of a first-order Markov chain over the
vocabulary, each token followed by one of ``successors`` tokens drawn
from the seed.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import List, Tuple

import numpy as np


def lognormal_lengths(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of the clipped lognormal."""
    nd = NormalDist()
    mu, sigma = math.log(spec["median"]), spec["sigma"]
    q = [math.exp(mu + sigma * nd.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(q), spec["min"], spec["max"]).astype(np.int64)


def residual_lengths(spec: dict, n: int, grid: int = 4096) -> np.ndarray:
    """``n`` lengths at evenly spaced quantiles of the residual life of the
    output-length distribution: P(r) = P(L >= r) / E[L], r >= 1."""
    lengths = lognormal_lengths(spec, grid)
    hi = int(lengths.max())
    counts = np.bincount(lengths, minlength=hi + 1).astype(np.float64)
    survive = counts[::-1].cumsum()[::-1]  # survive[r] = #(L >= r)
    pmf = survive[1:] / survive[1:].sum()  # r = 1 .. hi
    cdf = np.cumsum(pmf)
    qs = (np.arange(n) + 0.5) / n
    return (np.searchsorted(cdf, qs) + 1).astype(np.int64)


def stratified_order(values: np.ndarray, rng, block: int) -> np.ndarray:
    """``values`` in an order drawn from ``rng`` in which every run of
    ``block`` consecutive entries holds one value of each of ``block``
    quantile strata, so any stretch of the traffic carries the whole
    distribution; entries past the last whole block follow, shuffled."""
    v = np.sort(values)
    n = len(v) // block * block
    strata = v[:n].reshape(block, -1)  # row i: the i-th block-quantile stratum
    picks = np.stack([row[rng.permutation(row.size)] for row in strata], axis=1)
    for row in picks:
        rng.shuffle(row)
    return np.concatenate([picks.reshape(-1), v[n:][rng.permutation(len(v) - n)]])


def chat_requests(spec: dict, clients: int, seed: int, vocab: int
                  ) -> List[Tuple[np.ndarray, int]]:
    """(prompt tokens, max_new) of the first wave (``clients`` requests)
    and then the backlog, in send order.  Lengths are stratified in
    blocks of ``spec["block"]`` (``stratified_order``), the first wave's
    and the backlog's each on their own."""
    rng = np.random.default_rng(int(seed))
    n, block = int(spec["backlog"]), int(spec.get("block", 16))
    prompts = np.concatenate([
        stratified_order(lognormal_lengths(spec["prompt_tokens"], clients), rng, block),
        stratified_order(lognormal_lengths(spec["prompt_tokens"], n), rng, block)])
    outs = np.concatenate([
        stratified_order(residual_lengths(spec["output_tokens"], clients), rng, block),
        stratified_order(lognormal_lengths(spec["output_tokens"], n), rng, block)])
    reqs = []
    for i in range(clients + n):
        toks = rng.integers(0, vocab, size=int(prompts[i]), dtype=np.int64).astype(np.int32)
        reqs.append((toks, int(outs[i])))
    return reqs


def markov_rows(spec: dict, seed: int, vocab: int, rows: int, length: int) -> np.ndarray:
    """``rows`` sequences of ``length`` tokens of a Markov chain whose
    successor table and walks come from the seed: (rows, length) int64."""
    rng = np.random.default_rng(int(seed))
    succ = rng.integers(0, vocab, size=(vocab, int(spec["successors"])), dtype=np.int64)
    out = np.empty((rows, length), np.int64)
    out[:, 0] = rng.integers(0, vocab, size=rows)
    picks = rng.integers(0, succ.shape[1], size=(rows, length))
    for t in range(1, length):
        out[:, t] = succ[out[:, t - 1], picks[:, t]]
    return out
