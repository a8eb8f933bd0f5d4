"""Mesh construction and the mesh's collectives (PyTorch port of
``repro.launch.mesh``).

A mesh position is a process: rank ``(pod_index * data + data_index) *
model + model_index`` (``pod`` 1 gives the ("data", "model") mesh),
row-major as ``jax.make_mesh`` lays devices out.  :func:`make_host_mesh`
builds the live mesh on an initialised ``torch.distributed`` process
group (a ``DeviceMesh`` gives the per-axis groups; a pod mesh adds one
group over ("pod", "data"), the batch's axes, and one over ("data",
"model"), a weight's, so a sum over either is one collective);
:func:`make_production_mesh` returns the shape-only 16x16 or 2x16x16 mesh
that the partition rules read, and :func:`meta_mesh` rank 0's live view
of such a mesh in this one process, on torch's fake backend (every
collective a no-op on ``meta`` tensors), which the dry run counts.
Nothing here touches device or process-group state at import.

The partition rules never name "pod" for a parameter: a pod holds a whole
copy of every weight block and of the training state, and only the batch
(and the serving cache's lanes) splits over it.  So a sum over the batch
runs over a mesh's ``data_axes`` and a sum over a weight's blocks over
its ``weight_axes``, never over "pod", which would count each block once
per pod.

:func:`run_on_mesh` starts the ``pod * data * model`` ranks itself, the role
``XLA_FLAGS=--xla_force_host_platform_device_count`` plays for JAX: one
``spawn``-ed process per rank (CUDA forbids fork) meeting at a
``file://`` rendezvous in a temporary directory, so parallel test
workers never collide on a port.  The backend is the caller's choice and
nothing switches it quietly: ``nccl`` needs one card per rank, ``gloo``
runs on the CPU and on CUDA tensors, where several ranks share one card
(NCCL refuses two ranks on one GPU).

Every collective of the port goes through :class:`HostMesh`'s methods:
``all_reduce`` (float sums, int32 sums, which are exact, and maxima),
``any`` (one flag per rank, or-ed), ``all_gather`` (and ``gather_block``
built on it) and ``reduce_scatter``.  An ``all_reduce`` leaves the same
bits on every rank (gloo's and NCCL's algorithms reduce each element
once and hand the result on), so every rank's host takes the same token
from the logits.  Gloo takes CUDA tensors for these (``chip_smoke.py``
phase 4k probes it on the card), so nothing is staged through the host
by hand; NCCL takes only the rank's card, so a host tensor (a flag, a
byte count, the step) crosses on ``device`` and comes back.
:class:`LocalMesh` is the 1x1 mesh of one process without a process
group: every collective there is the identity, so one train step serves
both.

Training differentiates through them.  On a tensor that requires grad
``all_reduce`` (a sum) and ``all_gather`` are autograd functions whose
backward is the conjugate for a computation that is the same on every
rank of the axes downstream (the Megatron convention of the "model"
axis): identity, and this rank's block.  :meth:`HostMesh.enter` is the
other half (identity forward, the gradient summed over the axes: a
tensor that every rank holds whole enters a rank-local product) and
:meth:`HostMesh.shard_gather` is the data axis's FSDP gather (its
backward is ``reduce_scatter``: each data rank's batch adds its part).
:meth:`HostMesh.training_view` hides the data axis (size 1 there): the
training forward runs on the "model" axis alone, its batch already this
data rank's; :meth:`HostMesh.batch_sum` sums a statistic of the whole
batch over the hidden axis, its gradient summed back.  A pod mesh's
training view hides "pod" as it hides "data".
"""
from __future__ import annotations

import contextlib
import math
import os
import pickle
import tempfile
from typing import Callable, Dict, Optional, Sequence

import torch

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


class AbstractMesh:
    """A shape-only mesh: ``shape`` (ordered axis -> size) is all the
    partition rules read."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)

    @property
    def data_axes(self) -> tuple:
        """The axes a batch splits over: ("pod", "data") on a pod mesh."""
        return tuple(ax for ax in ("pod", "data") if ax in self.shape)

    @property
    def weight_axes(self) -> tuple:
        """The axes the partition rules may split a weight over: every axis
        but "pod", over which each weight block is a copy."""
        return tuple(ax for ax in self.shape if ax != "pod")

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape: ("data", "model") 16x16, or ("pod",
    "data", "model") 2x16x16."""
    if multi_pod:
        return AbstractMesh({"pod": 2, "data": 16, "model": 16})
    return AbstractMesh({"data": 16, "model": 16})


class HostMesh(AbstractMesh):
    """This process's place on a live ("data", "model") or ("pod", "data",
    "model") mesh: ``coords`` (axis -> index), ``device`` (where its
    tensors live), the per-axis process groups, and the collectives the
    port runs over them."""

    # frozenset of two axes -> the process group over both (a pod mesh's
    # ("pod", "data") and ("data", "model")); none on a 2-axis mesh
    _pairs: Dict[frozenset, object] = {}

    def __init__(self, data: int, model: int, device, backend: str, pod: int = 1):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        axes = POD_AXES if pod > 1 else AXES
        dims = (pod, data, model) if pod > 1 else (data, model)
        super().__init__(dict(zip(axes, dims)))
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.backend = backend
        idx, r = [], self.rank
        for n in reversed(dims):  # row-major: the last axis fastest
            idx.append(r % n)
            r //= n
        self.coords = dict(zip(axes, reversed(idx)))
        dev_type = "cuda" if backend == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(dev_type, dims, mesh_dim_names=axes)
        if pod > 1:  # one group over each pair of axes a sum runs over together
            self._pairs = {frozenset(pair): _pair_group(self.shape, pair, self.rank)
                           for pair in (("pod", "data"), ("data", "model"))}
        self._root = self  # a view counts its collectives on the mesh it views
        self._count = 0

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    @property
    def collectives(self) -> int:
        """Collectives issued so far by this mesh and its views (settable:
        a caller resets it before what it counts)."""
        return self._root._count

    @collectives.setter
    def collectives(self, n: int) -> None:
        self._root._count = n

    def _issued(self) -> None:
        self._root._count += 1

    def live(self, axes) -> tuple:
        """The axes of ``axes`` (a name or a tuple) with more than one rank."""
        return tuple(ax for ax in _axes(axes) if self.shape[ax] > 1)

    def training_view(self) -> "HostMesh":
        """This rank's place as the training forward sees it: the data axes
        ("pod" too) have size 1 and index 0 (each rank's batch is its own,
        and its weight blocks are gathered over "data" before the forward),
        so the partition rules and the collectives run on the "model" axis
        alone.  The groups are this mesh's."""
        import copy

        v = copy.copy(self)
        v.shape = {ax: (n if ax == "model" else 1) for ax, n in self.shape.items()}
        v.coords = {ax: (i if ax == "model" else 0) for ax, i in self.coords.items()}
        return v

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the live axes this training view hides (the data
        axis: each rank's batch is its own), with its gradient summed back
        over them: a statistic of the whole batch (the MoE router loss's
        token and probability sums) that every rank then uses alike, each
        counting its part of what it feeds.  ``t`` itself on a mesh that
        hides nothing (serving, one process)."""
        root = self._root
        axes = tuple(ax for ax in root.live(tuple(root.shape)) if self.shape[ax] == 1)
        if not axes:
            return t
        return root.enter(root.all_reduce(t, axes), axes)

    def _groups(self, axes) -> list:
        """The process groups of ``axes``'s live axes: one group (the
        world's) where they are every live axis of the mesh, so a sum over
        the whole mesh is one collective."""
        import torch.distributed as dist

        live = self.live(axes)
        if len(live) > 1 and set(live) == set(self.live(tuple(self.shape))) \
                and dist.get_world_size() == self.size():
            return [None]
        if frozenset(live) in self._root._pairs:
            return [self._root._pairs[frozenset(live)]]
        return [self.group(ax) for ax in live]

    def size(self) -> int:
        n = 1
        for ax in self.shape:
            n *= self.shape[ax]
        return n

    def _all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        work = t.to(device=self._wire(t), dtype=torch.float32 if _sixteen_bit(t) else t.dtype,
                    copy=True).contiguous()
        for g in self._groups(axes):
            self._issued()
            dist.all_reduce(work, op=red, group=g)
        return work.to(device=t.device, dtype=t.dtype)

    def _wire(self, t: torch.Tensor) -> torch.device:
        """Where ``t`` crosses: NCCL takes only this rank's card."""
        return self.device if self.backend == "nccl" else t.device

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum",
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``t`` summed (or maxed) over the ranks along ``axes`` (an axis
        name or a tuple of them); a new tensor.  A 16-bit ``t`` is summed
        in float32 and rounded back once, as the kernels accumulate; an
        integer ``t`` is summed exactly.  A sum of a tensor that requires
        grad is differentiable, its backward the identity (the tensor's
        use downstream is the same on every rank of ``axes``).  ``keep``
        (broadcast against ``t``, 0 or 1) multiplies this rank's part of a
        sum in the forward only: rows a rank holds a copy of, and that
        another rank of the axes adds already, count once."""
        if op == "sum" and self.live(axes) and (keep is not None or _differentiable(t)):
            return _Psum.apply(t, self, axes, keep)
        return self._all_reduce(t, axes, op)

    def any(self, flags) -> torch.Tensor:
        """Or of ``flags`` (a bool, or a bool/integer tensor, elementwise)
        over the whole mesh: one ``all_reduce`` (max), the same bits on
        every rank, on the device ``flags`` came from (the host for a
        bool)."""
        t = torch.as_tensor(flags).to(torch.int32)
        return self._all_reduce(t, tuple(self.shape), "max") > 0

    def enter(self, t: torch.Tensor, axes) -> torch.Tensor:
        """``t`` unchanged, its gradient summed over ``axes``: a tensor that
        every rank of ``axes`` holds whole, entering work that is this
        rank's part (a product by its block, a scale on its block)."""
        if not (_differentiable(t) and self.live(axes)):
            return t
        return _Enter.apply(t, self, axes)

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int, also=()) -> torch.Tensor:
        """``t`` summed over the ranks along ``axes`` (and along the axes
        ``also``, whose ranks hold the same block), this rank's block of
        the sum over ``axes`` on ``dim`` kept: an ``all_reduce`` and a
        slice, since gloo has no reduce-scatter (the same bits as one)."""
        if not self.live(axes):
            return self._all_reduce(t, also) if self.live(also) else t
        summed = self._all_reduce(t, _axes(also) + _axes(axes))
        return _block(self, summed, axes, dim % t.ndim).contiguous()

    def shard_gather(self, t: torch.Tensor, axes, dim: int, also=()) -> torch.Tensor:
        """:meth:`all_gather` whose backward is :meth:`reduce_scatter`: a
        weight block gathered whole for the ranks of ``axes`` whose batches
        differ (the data axis's FSDP), each adding its part of the
        gradient, and the ranks of ``also`` (the pods, each a copy of the
        block) theirs."""
        if not (self.live(axes) or self.live(also)):
            return t
        if not _differentiable(t):
            return self._all_gather(t, axes, dim)
        return _ShardGather.apply(t, self, axes, dim, also)

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The blocks of ``t`` along ``axes`` concatenated on ``dim`` in
        block order (row-major over a tuple of axes): the inverse of
        ``dist.sharding.local_block`` on that dim.  Differentiable where
        ``t`` requires grad, its backward this rank's block (the use
        downstream is the same on every rank of ``axes``)."""
        if _differentiable(t) and self.live(axes):
            return _Gather.apply(t, self, axes, dim)
        return self._all_gather(t, axes, dim)

    def _all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        import torch.distributed as dist

        dim = dim % t.ndim
        work = t.to(self._wire(t))
        for ax in reversed(_axes(axes)):  # minor axis first: row-major block order
            n = self.shape[ax]
            if n == 1:
                continue
            self._issued()
            parts = [torch.empty_like(work, memory_format=torch.contiguous_format)
                     for _ in range(n)]
            dist.all_gather(parts, work.contiguous(), group=self.group(ax))
            work = torch.cat(parts, dim=dim)
        return work.to(t.device)

    def gather_block(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor from this rank's block under ``spec``."""
        for dim, ax in enumerate(spec):
            if ax is not None:
                t = self.all_gather(t, ax, dim)
        return t


class LocalMesh(HostMesh):
    """The 1x1 mesh of one process, with no process group: no axis is live,
    so every collective of :class:`HostMesh` is the identity (a sum or a
    maximum over one rank, a gather of one block) and issues nothing.
    The train step off a mesh runs on it."""

    def __init__(self, device="cpu"):
        AbstractMesh.__init__(self, {"data": 1, "model": 1})
        self.rank = 0
        self.device = torch.device(device)
        self.backend = None
        self.coords = {"data": 0, "model": 0}
        self._root = self
        self._count = 0

    def group(self, axis: str):
        raise RuntimeError("a LocalMesh has no process groups")


def _sixteen_bit(t: torch.Tensor) -> bool:
    return t.is_floating_point() and t.element_size() < 4


def _differentiable(t: torch.Tensor) -> bool:
    return t.requires_grad and torch.is_grad_enabled()


def _block(mesh, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
    """This rank's block on ``dim`` of a tensor whole along ``axes``."""
    from ..dist.sharding import block_range

    live = mesh.live(axes)
    lo, hi = block_range(mesh, live if len(live) > 1 else live[0], t.shape[dim])
    return t.narrow(dim, lo, hi - lo)


class _Psum(torch.autograd.Function):
    """Sum over ranks forward (``keep`` masking this rank's part), identity
    backward."""

    @staticmethod
    def forward(ctx, t, mesh, axes, keep=None):
        return mesh._all_reduce(t if keep is None else t * keep.to(t.dtype), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _Enter(torch.autograd.Function):
    """Identity forward, gradient summed over ranks backward."""

    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh._all_reduce(g, ctx.axes), None, None


class _Gather(torch.autograd.Function):
    """All-gather forward, this rank's block of the gradient backward."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim % t.ndim
        return mesh._all_gather(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _block(ctx.mesh, g, ctx.axes, ctx.dim).contiguous(), None, None, None


class _ShardGather(torch.autograd.Function):
    """All-gather forward, reduce-scatter of the gradient backward."""

    @staticmethod
    def forward(ctx, t, mesh, axes, dim, also):
        ctx.mesh, ctx.axes, ctx.dim, ctx.also = mesh, axes, dim % t.ndim, also
        return mesh._all_gather(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim, ctx.also), None, None, None, None


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return axes if isinstance(axes, tuple) else (axes,)


def _pair_group(shape: Dict[str, int], pair, rank: int):
    """The process group of this rank's ranks along the two axes ``pair``
    (every group of that pair is made, as ``torch.distributed`` asks of
    every rank); its ranks in row-major order over the pair."""
    import itertools

    import torch.distributed as dist

    axes = list(shape)
    strides = {ax: math.prod(shape[b] for b in axes[i + 1:]) for i, ax in enumerate(axes)}
    rest = [ax for ax in axes if ax not in pair]
    groups = []
    for fixed in itertools.product(*(range(shape[ax]) for ax in rest)):
        base = sum(i * strides[ax] for ax, i in zip(rest, fixed))
        groups.append(sorted(base + sum(i * strides[ax] for ax, i in zip(pair, idx))
                             for idx in itertools.product(*(range(shape[ax]) for ax in pair))))
    mine, _ = dist.new_subgroups_by_enumeration(groups)
    return mine


def make_host_mesh(data: int = 1, model: int = 1, *, pod: int = 1, device="cpu",
                   backend: Optional[str] = None) -> HostMesh:
    """The live (data, model) mesh of this process, or with ``pod`` > 1 the
    (pod, data, model) one, on a process group of world size ``pod * data
    * model`` that the caller has initialised."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised torch.distributed process "
                           "group (run_on_mesh starts one per rank)")
    world = pod * data * model
    if dist.get_world_size() != world:
        name = f"{pod}x{data}x{model}" if pod > 1 else f"{data}x{model}"
        raise ValueError(f"a {name} mesh needs world size {world}, "
                         f"not {dist.get_world_size()}")
    return HostMesh(data, model, device, backend or dist.get_backend(), pod=pod)


@contextlib.contextmanager
def meta_mesh(shape: Dict[str, int]):
    """Rank 0's live view of a mesh of ``shape`` (``{"data": 16, "model":
    16}``, or with "pod" first), in this one process and on ``meta``
    tensors: a :class:`HostMesh` on torch's fake process group
    (``torch.testing._internal.distributed.fake_pg``), whose collectives
    run the c10d ops without moving a byte.  The dry run counts them as the
    live mesh issues them.  The process group lives only inside the
    ``with`` and is destroyed after it; a process with a group of its own
    is refused."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # a private module of torch: say what is missing
        raise RuntimeError(f"the meta mesh needs torch's fake process group "
                           f"(torch.testing._internal.distributed.fake_pg): {e}") from e
    if dist.is_initialized():
        raise RuntimeError("meta_mesh: this process already has a torch.distributed group")
    dims = tuple(shape.values())
    expect = POD_AXES if len(dims) == 3 else AXES
    if tuple(shape) != expect:
        raise ValueError(f"a mesh shape's axes are {AXES} or {POD_AXES}, not {tuple(shape)}")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=math.prod(dims))
    try:
        yield HostMesh(dims[-2], dims[-1], "meta", "fake",
                       pod=dims[0] if len(dims) == 3 else 1)
    finally:
        dist.destroy_process_group()


def check_backend(backend: str, device, world: int) -> None:
    """Refuse a backend that cannot run ``world`` ranks on ``device``."""
    dev = torch.device(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: want 'nccl' or 'gloo'")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA devices; the CPU takes 'gloo'")
        n = torch.cuda.device_count()
        if n < world:
            raise ValueError(
                f"backend 'nccl' needs one card per rank: {world} ranks, {n} card(s); "
                "several ranks on one card take backend 'gloo'")


def _rank_device(backend: str, device, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", dev.index or 0)  # gloo: the ranks share the card


def _rank_main(rank, fn, pod, data, model, backend, device, tmp, args, threads):
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dev = _rank_device(backend, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=pod * data * model, rank=rank)
    try:
        mesh = make_host_mesh(data, model, pod=pod, device=dev, backend=backend)
        result = fn(mesh, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_on_mesh(fn: Callable, data: int, model: int, *, backend: str, device="cuda",
                args: Sequence = (), threads: Optional[int] = None, pod: int = 1) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``data x model`` mesh
    (``pod x data x model`` with ``pod`` > 1), each rank a spawned
    process, and return the ranks' results in rank
    order (``fn`` and its results must pickle).  A rank that raises fails
    the call: the others are stopped and the error is raised here.  On
    CUDA the kernels are built here first, so the ranks load the
    libraries and never race on a build.  ``threads`` (default: the CPU
    count over the world size) sets each rank's ``torch.set_num_threads``."""
    import torch.multiprocessing as mp

    world = pod * data * model
    check_backend(backend, device, world)
    if torch.device(device).type == "cuda":
        from ..kernels import _build

        _build.build_all(["bitserial_matmul", "paged_attention", "flash_attention",
                          "bgl_sumsq"])
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        mp.start_processes(_rank_main, args=(fn, pod, data, model, backend, str(device), tmp,
                                             tuple(args), threads),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
