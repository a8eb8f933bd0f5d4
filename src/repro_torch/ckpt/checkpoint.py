"""Fault-tolerant checkpointing: npz shards + manifest + async save.
PyTorch port of ``repro.ckpt.checkpoint``, with the same files, so a
checkpoint written by the JAX trainer restores into the port's state and
the other way round.

Layout:  <dir>/step_<n>/shard_<i>.npz  +  MANIFEST.json (leaf paths,
shapes, dtypes, per-file sha256).  Leaf names are the "/"-joined tree
paths in the JAX flatten order (``repro_torch.tree``), stored in the npz
with "/" written as "|".  Writes go to ``step_<n>.tmp`` and are renamed
only after every shard and the manifest are written, so a preempted
save is never mistaken for a complete checkpoint; ``restore_latest``
walks back over steps to the newest one that passes its hashes.

``save`` copies every leaf to host memory before it returns (a CPU
leaf is cloned), so a non-blocking save is not disturbed by the
training step updating the state in place.  ``restore`` writes each
leaf into the template's tensor when shape and dtype match, so a resumed
run holds one copy of its state, not the fresh one and the restored one
(32 GB each for 2-layer full-width granite-3-2b); any other leaf is put
on the device of the template's leaf.

On a ("data", "model") mesh (``mesh=``) the files are the same whole
tensors.  ``save`` gathers each leaf from the ranks' blocks on the
calling thread (every rank calls it: a collective inside the writer
thread could deadlock against the next step's), one leaf at a time, and
only rank 0 keeps the host copies and writes.  ``restore`` reads the
whole tensors and keeps this rank's block of each
(``dist.elastic.train_state_specs`` on the whole shapes), so a state
saved on one mesh resumes on another.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from ..tree import flatten_with_path, unflatten_like

PyTree = Any


def _host_copy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        t = x.detach()
        return (t.cpu() if t.device.type != "cpu" else t.clone()).numpy()
    return np.array(x)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _gathered_host_copies(tree: PyTree, mesh, specs: PyTree):
    """(name, whole leaf on the host) of a tree of blocks: every rank joins
    each leaf's gather, rank 0 keeps the copies (the others get None)."""
    from ..dist.sharding import flatten_specs

    spec = dict(flatten_specs(specs))
    out = []
    for n, x in flatten_with_path(tree):
        whole = mesh.gather_block(x, spec[n]) if isinstance(x, torch.Tensor) else x
        out.append((n, _host_copy(whole) if mesh.rank == 0 else None))
    return out if mesh.rank == 0 else None


def save(tree: PyTree, directory: str, step: int, shards: int = 1, blocking: bool = True,
         mesh=None, specs: PyTree = None):
    """Save a tree at ``directory/step_<step>``; ``shards`` splits leaves
    round-robin across files.  Non-blocking: returns the writer thread.
    ``mesh``/``specs``: the tree is this rank's blocks under ``specs``;
    every rank calls it and rank 0 writes (the others return None)."""
    if mesh is not None:
        host = _gathered_host_copies(tree, mesh, specs)
        if host is None:
            return None
    else:
        host = [(n, _host_copy(x)) for n, x in flatten_with_path(tree)]
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    def write():
        buckets = [dict() for _ in range(shards)]
        for i, (n, a) in enumerate(host):
            buckets[i % shards][n] = a
        manifest = {"step": step, "files": {}, "leaves": {}}
        for i, b in enumerate(buckets):
            fname = f"shard_{i}.npz"
            fpath = os.path.join(tmp, fname)
            np.savez(fpath, **{k.replace("/", "|"): v for k, v in b.items()})
            manifest["files"][fname] = _sha256(fpath)
            for k, v in b.items():
                manifest["leaves"][k] = {"file": fname, "shape": list(v.shape),
                                         "dtype": str(v.dtype)}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _verify(ckpt_dir: str) -> bool:
    """Every shard named by the manifest exists and matches its sha256."""
    mpath = os.path.join(ckpt_dir, "MANIFEST.json")
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        for fname, digest in manifest["files"].items():
            fpath = os.path.join(ckpt_dir, fname)
            if not os.path.exists(fpath) or _sha256(fpath) != digest:
                return False
        return True
    except (OSError, ValueError, KeyError, AttributeError):
        return False


def available_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(steps)


def _load(tree_like: PyTree, ckpt_dir: str, mesh=None):
    with open(os.path.join(ckpt_dir, "MANIFEST.json")) as f:
        manifest = json.load(f)
    files = {}
    out = {}
    specs = None
    if mesh is not None:
        from ..dist.elastic import specs_for_shapes

        specs = specs_for_shapes(tree_like, {n: tuple(v["shape"]) for n, v in
                                             manifest["leaves"].items()}, mesh)
    try:
        for name, like in flatten_with_path(tree_like):
            info = manifest["leaves"][name]
            if info["file"] not in files:
                files[info["file"]] = np.load(os.path.join(ckpt_dir, info["file"]))
            # an npz member is read into a fresh, writable array
            arr = torch.from_numpy(files[info["file"]][name.replace("/", "|")])
            if specs is not None:
                from ..dist.sharding import local_block

                arr = local_block(arr, specs[name], mesh).contiguous()
            if (isinstance(like, torch.Tensor) and like.shape == arr.shape
                    and like.dtype == arr.dtype):
                with torch.no_grad():
                    out[name] = like.copy_(arr)
            else:
                dev = like.device if isinstance(like, torch.Tensor) else torch.device("cpu")
                out[name] = arr.to(dev)
    finally:
        for f in files.values():
            f.close()
    return unflatten_like(tree_like, out)


def restore(tree_like: PyTree, directory: str, step: int, mesh=None):
    """Restore into the structure of ``tree_like``.  Shapes and dtypes come
    from the files.  A template tensor of the same shape and dtype is
    overwritten with the leaf and returned; any other leaf lands on the
    device of the template's leaf (the CPU for a leaf that is not a
    tensor).  ``mesh``: ``tree_like`` is this rank's blocks, and each whole
    leaf read is cut to its block under the rules for this mesh."""
    ckpt_dir = os.path.join(directory, f"step_{step}")
    if not _verify(ckpt_dir):
        raise IOError(f"checkpoint {ckpt_dir} failed integrity check")
    return _load(tree_like, ckpt_dir, mesh)


def restore_latest(tree_like: PyTree, directory: str, mesh=None):
    """Newest checkpoint that passes integrity; returns (tree, step) or
    (None, -1).  Each candidate's hashes are checked once.  ``mesh`` as
    :func:`restore` takes it."""
    for step in reversed(available_steps(directory)):
        ckpt_dir = os.path.join(directory, f"step_{step}")
        if _verify(ckpt_dir):
            return _load(tree_like, ckpt_dir, mesh), step
    return None, -1


def prune_old(directory: str, keep: int = 3):
    steps = available_steps(directory)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)
