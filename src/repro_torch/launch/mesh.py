"""Mesh construction and the mesh's collectives (PyTorch port of
``repro.launch.mesh``).

A mesh position is a process: rank ``data_index * model + model_index``,
row-major as ``jax.make_mesh`` lays devices out.  :func:`make_host_mesh`
builds the live mesh on an initialised ``torch.distributed`` process
group (a ``DeviceMesh`` gives the per-axis groups);
:func:`make_production_mesh` returns the shape-only 16x16 or 2x16x16 mesh
that the partition rules read, since one card cannot hold 256 ranks.
Nothing here touches device or process-group state at import.

:func:`run_on_mesh` starts the ``data * model`` ranks itself, the role
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
data rank's.
"""
from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, Dict, Optional, Sequence

import torch

AXES = ("data", "model")


class AbstractMesh:
    """A shape-only mesh: ``shape`` (ordered axis -> size) is all the
    partition rules read."""

    def __init__(self, shape: Dict[str, int]):
        self.shape = dict(shape)

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape: ("data", "model") 16x16, or ("pod",
    "data", "model") 2x16x16."""
    if multi_pod:
        return AbstractMesh({"pod": 2, "data": 16, "model": 16})
    return AbstractMesh({"data": 16, "model": 16})


class HostMesh(AbstractMesh):
    """This process's place on a live ("data", "model") mesh: ``coords``
    (axis -> index), ``device`` (where its tensors live), the per-axis
    process groups, and the collectives the port runs over them."""

    def __init__(self, data: int, model: int, device, backend: str):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        super().__init__({"data": data, "model": model})
        self.rank = dist.get_rank()
        self.device = torch.device(device)
        self.backend = backend
        self.coords = {"data": self.rank // model, "model": self.rank % model}
        dev_type = "cuda" if backend == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(dev_type, (data, model), mesh_dim_names=AXES)
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
        """This rank's place as the training forward sees it: the data axis
        has size 1 and index 0 (each rank's batch is its own, and its weight
        blocks are gathered over "data" before the forward), so the
        partition rules and the collectives run on the "model" axis alone.
        The groups are this mesh's."""
        import copy

        v = copy.copy(self)
        v.shape = {ax: (n if ax == "model" else 1) for ax, n in self.shape.items()}
        v.coords = {ax: (i if ax == "model" else 0) for ax, i in self.coords.items()}
        return v

    def _groups(self, axes) -> list:
        """The process groups of ``axes``'s live axes: one group (the
        world's) where they are every live axis of the mesh, so a sum over
        the whole mesh is one collective."""
        import torch.distributed as dist

        live = self.live(axes)
        if len(live) > 1 and set(live) == set(self.live(tuple(self.shape))) \
                and dist.get_world_size() == self.size():
            return [None]
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

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """``t`` summed over the ranks along ``axes``, this rank's block of
        the sum on ``dim`` kept: an ``all_reduce`` and a slice, since gloo
        has no reduce-scatter (the same bits as one)."""
        if not self.live(axes):
            return t
        return _block(self, self._all_reduce(t, axes), axes, dim % t.ndim).contiguous()

    def shard_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """:meth:`all_gather` whose backward is :meth:`reduce_scatter`: a
        weight block gathered whole for the ranks of ``axes`` whose batches
        differ (the data axis's FSDP), each adding its part of the
        gradient."""
        if not self.live(axes):
            return t
        if not _differentiable(t):
            return self._all_gather(t, axes, dim)
        return _ShardGather.apply(t, self, axes, dim)

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
    def forward(ctx, t, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim % t.ndim
        return mesh._all_gather(t, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axes, ctx.dim), None, None, None


def _axes(axes) -> tuple:
    if axes is None:
        return ()
    return axes if isinstance(axes, tuple) else (axes,)


def make_host_mesh(data: int = 1, model: int = 1, *, device="cpu",
                   backend: Optional[str] = None) -> HostMesh:
    """The live (data, model) mesh of this process, on a process group of
    world size ``data * model`` that the caller has initialised."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialised torch.distributed process "
                           "group (run_on_mesh starts one per rank)")
    if dist.get_world_size() != data * model:
        raise ValueError(f"a {data}x{model} mesh needs world size {data * model}, "
                         f"not {dist.get_world_size()}")
    return HostMesh(data, model, device, backend or dist.get_backend())


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


def _rank_main(rank, fn, data, model, backend, device, tmp, args, threads):
    import torch.distributed as dist

    torch.set_num_threads(threads)
    dev = _rank_device(backend, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=data * model, rank=rank)
    try:
        mesh = make_host_mesh(data, model, device=dev, backend=backend)
        result = fn(mesh, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_on_mesh(fn: Callable, data: int, model: int, *, backend: str, device="cuda",
                args: Sequence = (), threads: Optional[int] = None) -> list:
    """Run ``fn(mesh, *args)`` on every rank of a ``data x model`` mesh,
    each rank a spawned process, and return the ranks' results in rank
    order (``fn`` and its results must pickle).  A rank that raises fails
    the call: the others are stopped and the error is raised here.  On
    CUDA the kernels are built here first, so the ranks load the
    libraries and never race on a build.  ``threads`` (default: the CPU
    count over the world size) sets each rank's ``torch.set_num_threads``."""
    import torch.multiprocessing as mp

    world = data * model
    check_backend(backend, device, world)
    if torch.device(device).type == "cuda":
        from ..kernels import _build

        _build.build_all(["bitserial_matmul", "paged_attention", "flash_attention",
                          "bgl_sumsq"])
    threads = threads or max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        mp.start_processes(_rank_main, args=(fn, data, model, backend, str(device), tmp,
                                             tuple(args), threads),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
