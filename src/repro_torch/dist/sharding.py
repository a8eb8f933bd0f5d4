"""Partition rules: name/shape-driven specs for every tensor (PyTorch
port of ``repro.dist.sharding``).

This module is the ONLY place in the port that decides how a tensor is
laid out over the ``("data", "model")`` (optionally ``("pod", "data",
"model")``) mesh.  The rules are the JAX package's, copied: keyed on the
"/"-joined tree path and the shape, never on values, and reading only
``mesh.shape`` (an ordered axis -> size dict), so the same rules run on a
live :class:`~repro_torch.launch.mesh.HostMesh` (one process per mesh
position) and on a shape-only :class:`~repro_torch.launch.mesh.AbstractMesh`
(the production meshes, which one card cannot hold).

Rule summary (2x4 mesh shown as data=2, model=4):

==========================================  =================================
tensor                                      spec
==========================================  =================================
col-parallel matmul  ``wq`` (L, in, out)    ``P(None, "data", "model")``
row-parallel ``wo``/``w_down`` (L, in, out) ``P(None, "model", "data")``
BSQ planes ``.../wq/wp`` (nb, L, in, out)   base rule + leading ``None``
packed ``.../wq/planes`` (L, nb, K/8, out)  base rule + ``None`` bit axis
packed ``.../wq/sign`` (L, K/8, out)        base rule (K/8 on the K axis)
packed scale row ``.../wq/scale`` (.., 1, G) group axis follows base out axis
embedding ``embed`` (V, d)                  ``P("model", "data")``
stacked MoE experts (L, E, in, out)         experts -> ``"model"``
norm scales / biases / BSQ scales / masks   replicated
KV cache (B, S, KV, hd)                     ``P("data", None, "model", None)``
paged KV block pool (Nb, bs, KV, hd)        block axis -> ``"data"`` (as slots)
block table (n_slots, blocks_per_lane)      lanes -> data axes when they
                                            co-shard with pool blocks,
                                            else replicated
pool control vectors (pos, temps, ...)      replicated
KV cache, KV-heads % model != 0             seq -> ``"model"`` instead
KV cache, batch 1 (long context)            seq -> ``("data", "model")``
any other dim not divisible by its axis     that dim replicated
==========================================  =================================

A spec is a :class:`PartitionSpec`: a tuple with one entry per leading
dim, each ``None`` (replicated), an axis name or a tuple of axis names
(row-major over them); dims past its length are replicated.  Where JAX
wraps specs in ``NamedSharding`` for ``device_put``, the port takes
:func:`local_block`: the slice of a full tensor that this rank owns.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Tuple

from ..core.packing import PACKABLE_SUFFIXES, PackedWeight

PyTree = Any

# Tree wrapper segments that may prefix a model-param path inside a
# train-state tree (state dicts, optimizer moments, BSQ containers).
_WRAPPERS = frozenset(
    {"trainable", "opt", "masks", "reps", "float", "params", "mu", "nu", "residual"}
)

# Leaf names whose matmul convention is row-parallel (input dim is the
# sharded contraction axis): attention output and down projections.
_ROW_PARALLEL = frozenset({"wo", "out_proj", "w_out", "w_down"})

# Stacked-expert MoE weights (leading expert axis under /moe/).
_MOE_EXPERT = frozenset({"w_gate", "w_up", "w_down"})

# Matmul leaf names that may be replaced by a PackedWeight (tells a packed
# scale row ".../wq/scale" apart from a norm gain ".../norm1/scale").
_PACKED_PARENTS = frozenset(PACKABLE_SUFFIXES)

# Name fragments that force replication: norms, biases, per-group scales,
# recurrence scalars, depthwise convs: all tiny and/or value-coupled.
_REPLICATED_FRAGMENTS = (
    "norm", "scale", "bias", "lambda", "a_log", "d_skip", "conv",
    "step", "count", "rope", "pact", "pos_emb",
)


class PartitionSpec(tuple):
    """One mesh-axis entry per leading dim: ``None``, an axis name, or a
    tuple of axis names.  ``PartitionSpec()`` is fully replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):  # pickles (to a spawned rank) as P(*axes)
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


P = PartitionSpec


def replicated() -> PartitionSpec:
    """The fully-replicated spec (scalars, tiny tensors)."""
    return P()


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------


def _axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[axis]) if axis in mesh.shape else 0


def axis_size(mesh, ax) -> int:
    """Devices along a spec entry: 1 for ``None``, the product over a
    tuple of axis names."""
    if ax is None:
        return 1
    size = 1
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        size *= int(mesh.shape[a])
    return size


def axis_index(mesh, ax) -> int:
    """This rank's block index along a spec entry (row-major over a tuple
    of axis names, as ``jax.make_mesh`` lays devices out); needs a live
    mesh's ``coords``."""
    if ax is None:
        return 0
    idx = 0
    for a in (ax if isinstance(ax, tuple) else (ax,)):
        idx = idx * int(mesh.shape[a]) + int(mesh.coords[a])
    return idx


def block_range(mesh, ax, dim: int) -> Tuple[int, int]:
    """The ``[lo, hi)`` slice of a dim of size ``dim`` that this rank owns
    under spec entry ``ax``."""
    n = axis_size(mesh, ax)
    if dim % n:
        raise ValueError(f"dim {dim} does not split over {ax!r} ({n} ranks)")
    size = dim // n
    lo = axis_index(mesh, ax) * size
    return lo, lo + size


def local_block(tensor, spec, mesh):
    """The block of a full ``tensor`` this rank owns under ``spec`` (a view
    where slicing allows; the replacement of JAX's
    ``device_put(x, NamedSharding(mesh, spec))``)."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        lo, hi = block_range(mesh, ax, tensor.shape[dim])
        tensor = tensor.narrow(dim, lo, hi - lo)
    return tensor


def place_block(block, spec, shape, mesh):
    """A tensor of the whole ``shape`` holding ``block`` (this rank's block
    under ``spec``) at its offsets, zeros elsewhere: the adjoint of
    :func:`local_block`, differentiable (its backward cuts the block)."""
    import torch.nn.functional as F

    pad = []
    for dim in reversed(range(block.ndim)):
        lo, hi = block_range(mesh, spec[dim] if dim < len(spec) else None, shape[dim])
        pad += [lo, shape[dim] - hi]
    return F.pad(block, pad)


def group_spec(spec, group_axes, ndim: int, lead: int = 0) -> PartitionSpec:
    """The spec of a group-shaped tensor of a weight whose spec is ``spec``
    (``ndim`` dims, groups over ``group_axes``): the weight's entries on
    its group axes, None elsewhere, behind ``lead`` whole axes (a rep's
    scale: 0; its mask or its any-nonzero flags: 1, the plane axis)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return P(*((None,) * lead + tuple(spec[i] if i in group_axes else None
                                      for i in range(ndim))))


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """The shape of :func:`local_block` of a tensor of ``shape``."""
    shape = list(shape)
    for dim, ax in enumerate(spec):
        if ax is not None:
            shape[dim] //= axis_size(mesh, ax)
    return tuple(shape)


def spec_axes(spec) -> Tuple[str, ...]:
    """The mesh axes a spec splits over, in the order they appear."""
    out = []
    for ax in spec:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None and a not in out:
                out.append(a)
    return tuple(out)


def counted_once(spec, mesh) -> float:
    """1.0 on the ranks whose block of a tensor under ``spec`` counts in a
    sum over the mesh's weight axes (every axis but "pod", whose ranks
    hold copies), else 0.0: every rank counts its distinct block, and of
    the ranks along an axis the tensor is whole on, only index 0 counts."""
    split = spec_axes(spec)
    return float(all(mesh.coords[ax] == 0 for ax in mesh.weight_axes
                     if mesh.shape[ax] > 1 and ax not in split))


def flatten_specs(spec_tree, prefix: str = ""):
    """``(name, spec)`` pairs of a spec tree (:func:`tree_param_specs`'s
    output) in the JAX flatten order, a :class:`PartitionSpec` a leaf."""
    if isinstance(spec_tree, PartitionSpec):
        return [(prefix, spec_tree)]
    if isinstance(spec_tree, dict):
        items = [(str(k), spec_tree[k]) for k in sorted(spec_tree)]
    elif isinstance(spec_tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(spec_tree)]
    else:
        return [(prefix, spec_tree)]
    out = []
    for k, v in items:
        out.extend(flatten_specs(v, f"{prefix}/{k}" if prefix else k))
    return out


def mesh_labels(mesh) -> dict:
    """Metric labels identifying this process's mesh placement:
    ``{"mesh": "data2xmodel4", "process": "3"}`` on a 2x4 mesh (rank 3),
    ``{"mesh": "none", "process": "0"}`` without one.  Attached to the
    serve allocator's per-shard metric families so a scraped exposition
    says which topology and rank produced the numbers."""
    process = str(getattr(mesh, "rank", 0))
    if mesh is None:
        return {"mesh": "none", "process": process}
    shape = "x".join(f"{ax}{n}" for ax, n in mesh.shape.items())
    return {"mesh": shape or "none", "process": process}


def _fits(mesh, axis: str, dim: int) -> bool:
    n = _axis_size(mesh, axis)
    return n > 0 and dim % n == 0


def dp_axes(mesh, dim: int):
    """Data-parallel assignment for a batch-like dim: ("pod", "data") when
    both exist and divide, else "data", else None (replicated)."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    for cand in (axes, axes[-1:]):
        if not cand:
            continue
        total = 1
        for a in cand:
            total *= _axis_size(mesh, a)
        if total > 0 and dim % total == 0:
            return cand[0] if len(cand) == 1 else cand
    return None


def _canonical(name: str) -> Tuple[str, ...]:
    """Strip state-tree wrapper segments so ``opt/mu/reps/blocks/...`` and
    ``blocks/...`` resolve to the same rule."""
    segs = [s for s in name.split("/") if s]
    while segs and segs[0] in _WRAPPERS:
        segs.pop(0)
    return tuple(segs)


# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------


def param_spec(name: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Spec for one (possibly stacked) parameter tensor.

    ``name`` is the "/"-joined tree path; wrapper segments from train
    state (``trainable/reps/...``, ``opt/mu/...``, ``masks/...``) are
    stripped, so the same rules cover params, optimizer moments and BSQ
    bit-plane state."""
    segs = _canonical(name)
    ndim = len(shape)
    if not segs or ndim == 0:
        return replicated()
    leaf = segs[-1].lower()

    # BSQ bit-plane tensors (wp / wn) carry a leading plane axis and
    # inherit the base weight's layout.
    if leaf in ("wp", "wn") and ndim >= 1:
        base = "/".join(segs[:-1])
        return P(None, *param_spec(base, shape[1:], mesh))

    # Packed serving weights follow the BASE weight's layout: sign
    # (..., K/8, N) takes the base rule directly, planes (..., n_bits,
    # K/8, N) add a replicated bit axis in front of the trailing two.
    # Each rank runs the bitserial kernel on its LOCAL bytes
    # (kernels.ops.bitserial_matmul_sharded).
    if leaf in ("planes", "sign") and ndim >= 2:
        base = "/".join(segs[:-1])
        if leaf == "planes":
            if ndim < 3:
                return replicated()
            bspec = tuple(param_spec(base, shape[:-3] + shape[-2:], mesh))
            return P(*bspec[:-2], None, *bspec[-2:])
        return param_spec(base, shape, mesh)

    # Per-group packed scale rows (..., 1, G) live with their output
    # columns: the base weight's rule on the row's own shape (the 1-sized
    # K slot never fits an axis; G shards onto the base's out axis iff it
    # divides).  Every other "scale" falls through to replication.
    if (
        leaf == "scale"
        and len(segs) >= 2
        and segs[-2].lower() in _PACKED_PARENTS
        and ndim >= 2
        and shape[-2] == 1
        and shape[-1] > 1
    ):
        return param_spec("/".join(segs[:-1]), shape, mesh)

    if ndim < 2 or any(f in leaf for f in _REPLICATED_FRAGMENTS):
        return replicated()

    # Embedding table: vocab -> model (the logit contraction axis),
    # d_model -> data.
    if leaf == "embed" and ndim == 2:
        return P(
            "model" if _fits(mesh, "model", shape[0]) else None,
            "data" if _fits(mesh, "data", shape[1]) else None,
        )

    # Stacked MoE expert weights (L?, E, d_in, d_out): experts -> model;
    # the freed mesh axis goes to the dim "model" would otherwise take.
    if leaf in _MOE_EXPERT and "moe" in segs and "shared" not in segs and ndim >= 3:
        spec = [None] * ndim
        e_ax = ndim - 3
        if _fits(mesh, "model", shape[e_ax]):
            spec[e_ax] = "model"
        d_ax = ndim - 2 if leaf == "w_down" else ndim - 1  # row- vs col-parallel
        if _fits(mesh, "data", shape[d_ax]):
            spec[d_ax] = "data"
        return P(*spec)

    # Dense matmul weights (..., d_in, d_out); leading axes (stacked
    # layers, tail indices) stay replicated.
    spec = [None] * ndim
    if leaf in _ROW_PARALLEL:
        in_ax, out_ax = ("model", "data")
    else:  # col-parallel: wq/wk/wv, w_gate/w_up, in_proj, lm_head, ...
        in_ax, out_ax = ("data", "model")
    if _fits(mesh, in_ax, shape[-2]):
        spec[-2] = in_ax
    if _fits(mesh, out_ax, shape[-1]):
        spec[-1] = out_ax
    return P(*spec)


def _map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples, with
    PackedWeights descended into (their ``planes``/``sign``/``scale``
    fields named ``path/planes`` and so on, as JAX's flatten names them)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    if isinstance(tree, PackedWeight):
        return dataclasses.replace(
            tree, planes=fn(f"{path}/planes", tree.planes), sign=fn(f"{path}/sign", tree.sign),
            scale=fn(f"{path}/scale", tree.scale))
    return fn(path, tree)


def tree_param_specs(tree: PyTree, mesh) -> PyTree:
    """:func:`param_spec` over a whole tree (params or train state): the
    same structure with a spec at every leaf, a PackedWeight's fields each
    with its own.  Leaves need only a ``shape`` (tensors, meta tensors,
    numpy arrays)."""
    return _map_with_path(lambda name, leaf: param_spec(name, tuple(leaf.shape), mesh), tree)


def annotate_packed_specs(params: PyTree, mesh) -> PyTree:
    """Stamp every PackedWeight in ``params`` with its ``kn_spec``: the
    (K-axis, N-axis) mesh-axis pair of its trailing two logical dims,
    derived from the ``sign`` leaf's rule so annotation and placement
    cannot drift.  ``kernels.ops.bitserial_matmul_sharded`` reads it to
    take the K slice of ``x`` and to stitch the partial products."""
    def annotate(name, leaf):
        if not isinstance(leaf, PackedWeight):
            return leaf
        spec = tuple(param_spec(name + "/sign", tuple(leaf.sign.shape), mesh))
        kn = (spec[-2], spec[-1]) if len(spec) >= 2 else (None, None)
        return dataclasses.replace(leaf, kn_spec=kn)

    def walk(tree, path=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, f"{path}/{i}" if path else str(i))
                              for i, v in enumerate(tree))
        return annotate(path, tree)

    return walk(params)


# ---------------------------------------------------------------------------
# Cache rules
# ---------------------------------------------------------------------------


def cache_spec(name: str, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Spec for one decode-cache tensor (no leading stack axis).

    KV tensors are (B, S, KV, hd): batch -> data, kv-heads -> model, with
    two fallbacks: a kv-head count the model axis does not divide moves
    "model" to the sequence axis (the attention read then combines
    partial softmaxes over it), and a batch of exactly 1 (long context)
    additionally spreads the sequence over the data axes.  Any other
    indivisible dim is replicated.  Recurrent state/conv tensors shard
    batch only."""
    leaf = name.split("/")[-1].lower()
    ndim = len(shape)
    if leaf in ("k", "v", "kv") and ndim == 4:
        B, S, KV, _ = shape
        spec: list = [None] * 4
        spec[0] = dp_axes(mesh, B)
        if KV > 1 and _fits(mesh, "model", KV):
            spec[2] = "model"
        elif _fits(mesh, "model", S):
            spec[1] = "model"
        if B == 1:
            # batch-1 long context: the sequence is the only big axis left
            dm = _axis_size(mesh, "data") * max(_axis_size(mesh, "model"), 1)
            if spec[1] == "model" and _axis_size(mesh, "data") > 0 and S % dm == 0:
                spec[1] = ("data", "model")
            elif spec[1] is None:
                spec[1] = dp_axes(mesh, S)
        return P(*spec)
    # Recurrent caches (ssm/rglru state, conv tails): batch-sharded only.
    spec = [None] * ndim
    if ndim >= 1:
        spec[0] = dp_axes(mesh, shape[0])
    return P(*spec)


def _map_cache(fn, cache, path=""):
    if isinstance(cache, dict):
        return {k: _map_cache(fn, v, f"{path}/{k}" if path else str(k)) for k, v in cache.items()}
    if isinstance(cache, (list, tuple)):
        return type(cache)(_map_cache(fn, v, f"{path}/{i}" if path else str(i))
                           for i, v in enumerate(cache))
    return fn(path, cache)


def cache_tree_specs(cache: PyTree, mesh) -> PyTree:
    """:func:`cache_spec` over a whole decode cache; entries under
    ``blocks`` carry a leading superblock axis (replicated)."""
    def spec(name, leaf):
        segs = name.split("/")
        if segs and segs[0] == "blocks":
            return P(None, *cache_spec(segs[-1], tuple(leaf.shape)[1:], mesh))
        return cache_spec(segs[-1], tuple(leaf.shape), mesh)

    return _map_cache(spec, cache)


def slot_pool_specs(pool_state: PyTree, mesh) -> PyTree:
    """Specs for a continuous-batching slot pool (``serve/slots.py``): the
    pool's decode cache under the cache rules (slots over the data axes,
    KV heads over model); the per-slot control vectors (``pos``,
    ``temps``, any leaf outside "cache") replicated: they are tiny and
    every lane's masking reads them."""
    return {
        k: cache_tree_specs(v, mesh) if k == "cache"
        else _map_cache(lambda _n, _l: replicated(), v)
        for k, v in pool_state.items()
    }


def paged_block_spec(shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Spec for one paged KV pool leaf ``(n_blocks, block_size, KV, hd)``:
    the block axis over the data axes (the slot axis's role), KV heads
    over model when divisible.  The intra-block row axis never shards: a
    block is the unit of table indirection."""
    Nb, _bs, KV, _hd = shape
    spec: list = [None] * 4
    spec[0] = dp_axes(mesh, Nb)
    if KV > 1 and _fits(mesh, "model", KV):
        spec[2] = "model"
    return P(*spec)


def block_table_spec(n_slots: int, n_blocks: int, mesh) -> PartitionSpec:
    """Spec for the per-lane block table ``(n_slots, blocks_per_lane)``.

    The lane axis shards over the data axes when, and only when, the
    pool's block axis shards over the *same* axes: shard s's lanes own
    exactly shard s's blocks, so the shard-local decode path
    (``models.attention._paged_attend_sharded`` +
    ``BlockAllocator(n_shards=D)``) translates global block ids with a
    subtraction and never touches another shard's pool slice.  Else the
    table replicates."""
    ax = dp_axes(mesh, n_slots)
    if ax is None or dp_axes(mesh, n_blocks) != ax:
        return replicated()
    return P(ax, None)


def table_shards(mesh, n_slots: int, n_blocks: int) -> int:
    """How many shards :func:`block_table_spec` splits the lane axis into
    (1 = replicated); the serve allocator's per-shard free-list count."""
    if mesh is None:
        return 1
    spec = block_table_spec(n_slots, n_blocks, mesh)
    if len(spec) == 0 or spec[0] is None:
        return 1
    return axis_size(mesh, spec[0])


def lane_shard(slot: int, n_slots: int, n_shards: int) -> int:
    """Which table shard lane ``slot`` belongs to: contiguous lane groups
    (shard s owns lanes ``[ceil(s*n_slots/n_shards),
    ceil((s+1)*n_slots/n_shards))``), the layout the allocator and the
    scheduler's shard-aware admission and victim selection lean on."""
    return slot * n_shards // n_slots


def shard_lanes(shard: int, n_slots: int, n_shards: int) -> range:
    """Inverse of :func:`lane_shard`: the contiguous lane range shard
    ``shard`` owns."""
    lo = -(-shard * n_slots // n_shards)
    hi = -(-(shard + 1) * n_slots // n_shards)
    return range(lo, hi)


def block_pool_specs(pool_state: PyTree, mesh, n_blocks: int, block_size: int) -> PyTree:
    """Specs for a PAGED slot pool: cache leaves whose leading dims match
    the block pool shape take :func:`paged_block_spec`; everything else
    in the cache (ring buffers, recurrent state) keeps the ordinary cache
    rules.  The ``block_table`` shards over the data axes when lanes and
    pool blocks co-shard (:func:`block_table_spec`); the remaining control
    vectors stay replicated."""
    def cache_specs(cache):
        def spec(name, leaf):
            segs = name.split("/")
            stacked = segs and segs[0] == "blocks"
            shape = tuple(leaf.shape)[1:] if stacked else tuple(leaf.shape)
            if (segs[-1].lower() in ("k", "v") and len(shape) == 4
                    and shape[:2] == (n_blocks, block_size)):
                s = paged_block_spec(shape, mesh)
            else:
                s = cache_spec(segs[-1], shape, mesh)
            return P(None, *s) if stacked else s

        return _map_cache(spec, cache)

    def other_specs(k, v):
        if k == "block_table":
            return _map_cache(lambda _n, leaf: block_table_spec(leaf.shape[0], n_blocks, mesh), v)
        return _map_cache(lambda _n, _l: replicated(), v)

    return {k: cache_specs(v) if k == "cache" else other_specs(k, v)
            for k, v in pool_state.items()}


def chunk_buffer_specs(buffers: PyTree, mesh) -> PyTree:
    """Specs for chunked-prefill staging buffers: the per-dispatch control
    tensors (token block, ``start``/``n_valid``, the slot vector) are
    tiny and every lane's masking reads them, so they replicate."""
    return _map_cache(lambda _n, _l: replicated(), buffers)


# ---------------------------------------------------------------------------
# Batch rules
# ---------------------------------------------------------------------------


def data_batch_spec(mesh, batch_dim: int, ndim: int) -> PartitionSpec:
    """Input batches: leading dim over the DP axes, rest replicated."""
    spec = [None] * ndim
    if ndim >= 1:
        spec[0] = dp_axes(mesh, batch_dim)
    return P(*spec)


def batch_block(tensor, mesh, microbatches: int = 1):
    """This rank's rows of a global batch (leading dim B) for a step of
    ``microbatches``: JAX's microbatch i is global rows ``i*B/mb ..
    (i+1)*B/mb``, and the rank keeps its block of each under
    :func:`data_batch_spec`, in microbatch order, so that the step's i-th
    block of its rows is its part of microbatch i.  With one microbatch it
    is :func:`local_block` under :func:`data_batch_spec`."""
    B = tensor.shape[0]
    if microbatches == 1:
        return local_block(tensor, data_batch_spec(mesh, B, tensor.ndim), mesh)
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
    split = tensor.reshape((microbatches, B // microbatches) + tuple(tensor.shape[1:]))
    spec = P(None, *data_batch_spec(mesh, B // microbatches, tensor.ndim))
    block = local_block(split, spec, mesh)
    return block.reshape((-1,) + tuple(tensor.shape[1:]))
