"""Input pipeline: per-host slicing, packing, background prefetch.
PyTorch port of ``repro.data.pipeline``.

Each host produces only its slice of the global batch (``host_slice``)
and a background thread prefetches batches so the device never waits on
host-side sampling.  On a ("data", "model") mesh each rank (a process)
keeps its block over the data axes of the global batch that the JAX
package draws on one host, the batch of process 0.
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
    """Infinite iterator of LM batches on ``device`` (the card unless
    ``device="cpu"``): integer arrays (tokens, labels) as int64 tensors,
    float ones (a frontend's ``embeds`` or ``cross_embeds``) as float32.

    ``task`` is any object with ``.batch(rng, batch, seq) -> dict`` of
    numpy arrays (e.g. ``data.synthetic.MarkovLM``).  Batch ``step`` is
    drawn from ``SeedSequence([seed, process, step])``, the JAX package's
    stream, so both frameworks see the same tokens.

    ``sharding``: a :class:`~repro_torch.launch.mesh.HostMesh`.  Each rank
    draws the whole global batch of process 0 (JAX's on one host) and
    keeps its rows under ``dist.sharding.data_batch_spec``, on the mesh's
    device; a batch the data axes do not divide raises.
    """
    pi, pc = 0, 1
    sl = host_slice(global_batch, pi, pc)
    local = sl.stop - sl.start
    mesh = sharding
    if mesh is not None:
        from ..dist.sharding import data_batch_spec, dp_axes, local_block

        n_dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
        if n_dp > 1 and dp_axes(mesh, global_batch) is None:
            raise ValueError(f"global batch {global_batch} does not divide over the mesh's "
                             f"data axes ({mesh.shape})")
        device = mesh.device
    device = resolve_device(device)

    def place(v):
        v = np.asarray(v)
        t = torch.from_numpy(v.astype(np.float32 if v.dtype.kind == "f" else np.int64))
        if mesh is not None:
            t = local_block(t, data_batch_spec(mesh, global_batch, t.ndim), mesh)
        return t.to(device)

    def gen():
        step = 0
        while True:
            # distinct stream per (host, step): deterministic resume
            rng = np.random.default_rng(np.random.SeedSequence([seed, pi, step]))
            b = task.batch(rng, local, seq_len)
            yield {k: place(v) for k, v in b.items()}
            step += 1

    return Prefetcher(gen(), depth=prefetch)
