"""Input pipeline: per-host slicing, packing, background prefetch.
PyTorch port of ``repro.data.pipeline``.

Each host produces only its slice of the global batch (``host_slice``)
and a background thread prefetches batches so the device never waits on
host-side sampling.  The port runs one process; placing batches on a
device mesh comes with the training mesh slice and raises until then.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device


def host_slice(global_batch: int, process_index: int, process_count: int) -> slice:
    """Contiguous per-host rows of the global batch."""
    if global_batch % process_count:
        raise ValueError(f"global_batch {global_batch} % hosts {process_count} != 0")
    per = global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def pack_documents(docs, seq_len: int, pad_id: int = 0, eod_id: int = 1):
    """Greedy sequence packing: concatenate docs, split into seq_len rows.

    Returns (tokens, labels) numpy int32 arrays, labels next-token shifted.
    """
    flat = []
    for d in docs:
        flat.extend(list(d))
        flat.append(eod_id)
    n_rows = max(1, len(flat) // (seq_len + 1))
    used = flat[: n_rows * (seq_len + 1)]
    arr = np.asarray(used, np.int32).reshape(n_rows, seq_len + 1)
    return arr[:, :-1], arr[:, 1:].copy()


_SENTINEL = object()


class Prefetcher:
    """Background-thread prefetch with a bounded queue (depth 2 default).
    An exception in the producer is raised by the ``next`` that reaches it."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def worker():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:  # re-raised by __next__
                self._err = e
            finally:
                self._q.put(_SENTINEL)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def sharded_lm_iterator(
    task,
    global_batch: int,
    seq_len: int,
    *,
    seed: int = 0,
    device=None,
    sharding=None,
    prefetch: int = 2,
) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite iterator of LM batches as int64 tensors on ``device`` (the
    card unless ``device="cpu"``).

    ``task`` is any object with ``.batch(rng, batch, seq) -> dict`` of
    numpy arrays (e.g. ``data.synthetic.MarkovLM``).  Batch ``step`` is
    drawn from ``SeedSequence([seed, process, step])``, the JAX package's
    stream, so both frameworks see the same tokens.
    """
    if sharding is not None:
        raise NotImplementedError("mesh-sharded batches come with the training mesh slice of "
                                  "the port (ROADMAP item 9b)")
    pi, pc = 0, 1
    sl = host_slice(global_batch, pi, pc)
    local = sl.stop - sl.start
    device = resolve_device(device)

    def gen():
        step = 0
        while True:
            # distinct stream per (host, step): deterministic resume
            rng = np.random.default_rng(np.random.SeedSequence([seed, pi, step]))
            b = task.batch(rng, local, seq_len)
            yield {k: torch.from_numpy(np.asarray(v, np.int64)).to(device) for k, v in b.items()}
            step += 1

    return Prefetcher(gen(), depth=prefetch)
