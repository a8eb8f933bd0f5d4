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
``all_reduce`` and ``all_gather`` (and ``gather_block`` built on the
latter).  An ``all_reduce`` leaves the same bits on every rank (gloo's
and NCCL's algorithms reduce each element once and hand the result on),
so every rank's host takes the same token from the logits.  Gloo takes CUDA tensors for both (``chip_smoke.py``
phase 4k probes it on the card), so nothing is staged through the host
by hand.
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
        self.collectives = 0  # calls of the methods below (each a collective or more)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over the ranks along ``axes`` (an axis
        name or a tuple of them); a new tensor.  A 16-bit ``t`` is summed
        in float32 and rounded back once, as the kernels accumulate."""
        import torch.distributed as dist

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        work = t.to(torch.float32 if _sixteen_bit(t) else t.dtype, copy=True).contiguous()
        for ax in _axes(axes):
            if self.shape[ax] > 1:
                self.collectives += 1
                dist.all_reduce(work, op=red, group=self.group(ax))
        return work.to(device=t.device, dtype=t.dtype)

    def all_gather(self, t: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """The blocks of ``t`` along ``axes`` concatenated on ``dim`` in
        block order (row-major over a tuple of axes): the inverse of
        ``dist.sharding.local_block`` on that dim."""
        import torch.distributed as dist

        dim = dim % t.ndim
        work = t
        for ax in reversed(_axes(axes)):  # minor axis first: row-major block order
            n = self.shape[ax]
            if n == 1:
                continue
            self.collectives += 1
            parts = [torch.empty_like(work, memory_format=torch.contiguous_format)
                     for _ in range(n)]
            dist.all_gather(parts, work.contiguous(), group=self.group(ax))
            work = torch.cat(parts, dim=dim)
        return work

    def gather_block(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The whole tensor from this rank's block under ``spec``."""
        for dim, ax in enumerate(spec):
            if ax is not None:
                t = self.all_gather(t, ax, dim)
        return t


def _sixteen_bit(t: torch.Tensor) -> bool:
    return t.is_floating_point() and t.element_size() < 4


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

        _build.build_all(["bitserial_matmul", "paged_attention", "flash_attention"])
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
