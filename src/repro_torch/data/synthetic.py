"""Deterministic synthetic token streams (a copy of the numpy-only
``MarkovLM`` of ``repro.data.synthetic``; the launcher draws its
prompts from it).

:class:`MarkovLM` — an order-1 Markov token stream whose transition
matrix is a low-entropy random sparse matrix derived from a seed: a
model that learns the bigram statistics gets a much lower CE than
uniform, so compression-induced degradation is measurable.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MarkovLM:
    vocab: int
    branching: int = 4  # successors per token
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.successors = rng.integers(0, self.vocab, size=(self.vocab, self.branching))
        probs = rng.dirichlet(np.ones(self.branching) * 0.5, size=self.vocab)
        self.probs = probs.astype(np.float64)

    def sample(self, rng: np.random.Generator, batch: int, seq: int) -> np.ndarray:
        out = np.empty((batch, seq + 1), np.int32)
        out[:, 0] = rng.integers(0, self.vocab, size=batch)
        for t in range(seq):
            cur = out[:, t]
            choice = np.array(
                [rng.choice(self.branching, p=self.probs[c]) for c in cur], np.int64
            )
            out[:, t + 1] = self.successors[cur, choice]
        return out

    def batch(self, rng: np.random.Generator, batch: int, seq: int):
        toks = self.sample(rng, batch, seq)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def entropy_floor(self) -> float:
        """Mean next-token entropy (nats) — the best achievable CE."""
        p = self.probs
        return float(np.mean(-np.sum(p * np.log(np.maximum(p, 1e-12)), axis=1)))
