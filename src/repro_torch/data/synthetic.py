"""Deterministic synthetic datasets with learnable structure (a copy of
the numpy-only ``repro.data.synthetic``: both packages draw the same
tokens and images from one seed).

* :class:`MarkovLM` — an order-1 Markov token stream whose transition
  matrix is a low-entropy random sparse matrix derived from a seed: a
  model that learns the bigram statistics gets a much lower CE than
  uniform, so compression-induced degradation is measurable.
* :func:`gaussian_blobs` — class-conditional Gaussian images in the
  CIFAR-10 shape (32x32x3, 10 classes) for the ResNet-20 pipeline.
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


def gaussian_blobs(
    rng: np.random.Generator, batch: int, num_classes: int = 10, img: int = 32, noise: float = 0.6
):
    """CIFAR-10-shaped class-conditional images: per-class fixed mean
    pattern + Gaussian noise.  Linearly separable-ish but benefits from
    depth at high noise."""
    master = np.random.default_rng(1234)  # class patterns independent of rng
    patterns = master.normal(size=(num_classes, img, img, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=batch)
    x = patterns[labels] + noise * rng.normal(size=(batch, img, img, 3)).astype(np.float32)
    return {"images": x.astype(np.float32), "labels": labels.astype(np.int32)}
