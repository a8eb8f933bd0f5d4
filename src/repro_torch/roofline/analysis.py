"""Roofline terms of one eager call, counted on the meta device.

  compute    = FLOPs / hw.PEAK_FLOPS_BF16
  memory     = bytes / hw.HBM_BW
  collective = collective bytes / hw.LINK_BW

:func:`analyze` runs ``fn`` on meta tensors (shapes and dtypes, no
storage) under a :class:`Counter`, which sees every aten op the call
dispatches, the autograd backward's too.  This is the port's counterpart
of ``repro.roofline.analysis``, which reads XLA's ``cost_analysis()`` of
a compiled module.  Conventions:

* **FLOPs** are torch's own formulas, the registry of
  ``torch.utils.flop_counter`` (mm, addmm, bmm, baddbmm, convolution,
  scaled-dot-product attention, and their backwards).  Elementwise ops
  count 0, where XLA counts them too: on the reduced decoders the
  products are 0.96-0.97 of XLA's FLOPs.
* **Bytes**: each op reads its input tensors once and writes its outputs
  once, which is what the eager port moves (XLA's "bytes accessed" counts
  a fused module instead).  View and metadata ops (``view``,
  ``transpose``, ``detach``, ``_unsafe_view``, ...) and ``empty``
  allocations count 0.  An in-place op reads ``self`` too, except
  ``copy_``, ``fill_`` and ``zero_``, which only write it.  A gather
  (``index``, ``embedding``, ``gather``, ``index_select``) reads the rows
  it gathers and its indices, not the table; an in-place scatter
  (``index_put_``, ``scatter_``, ``index_add_``, ...) reads and writes
  the rows it writes (an accumulating one reads them a second time).
* **Kernels**: a kernel entry of ``kernels.ops`` that sees meta tensors
  returns an empty output of the kernel's shape and reports its FLOPs,
  bytes and one launch by name (:func:`record_kernel`), with the bound
  formulas ``chip_smoke.py`` states for it; a bitserial product thus
  counts its packed bytes, as XLA counts the dequantisation fused into
  the dot.
* **Collectives**: the output bytes of every c10d collective op, by
  kind (0 on one card).
* **Peak live bytes**: the largest sum of the storages that ops made
  during the call and that were still alive, tracked through weak
  references to the storages.  An estimate of the eager call's
  liveness, with no allocator rounding or fragmentation.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
import weakref
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from . import hw

_COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
# substrings of c10d op names -> kind
_COLLECTIVE_NAMES = (
    ("all_gather", "all-gather"), ("allgather", "all-gather"),
    ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
    ("reduce_scatter", "reduce-scatter"),
    ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
    ("send", "collective-permute"), ("recv", "collective-permute"),
)
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

_aten = torch.ops.aten
# ops that allocate without writing
_ALLOCATIONS = {_aten.empty.memory_format, _aten.empty_strided.default,
                _aten.empty_like.default, _aten.new_empty.default,
                _aten.new_empty_strided.default}
# ops whose schema returns a fresh tensor that is the input re-labelled
_RELABELS = {_aten._unsafe_view.default, _aten.lift_fresh.default}
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
               _aten.zero_.default}
_GATHERS = {_aten.index.Tensor, _aten.embedding.default, _aten.gather.default,
            _aten.index_select.default}
_SCATTERS = {_aten.index_put_.default, _aten._index_put_impl_.default, _aten.scatter_.src,
             _aten.scatter_.value, _aten.index_copy_.default}
_ACCUMULATING_SCATTERS = {_aten.index_add_.default, _aten.scatter_add_.default}

# The counters in effect, innermost last.  Process-wide, not per thread:
# the autograd engine may run a backward's kernel entries on a worker
# thread.
_ACTIVE: List["Counter"] = []
_ACTIVE_LOCK = threading.Lock()


def _tensors(x) -> list:
    """The tensors in a nested list/tuple/dict (other leaves dropped)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _shape_bytes(tree) -> int:
    """Bytes of every tensor in a nested list/tuple/dict tree, the fields
    of a ``PackedWeight`` included (JAX's ``_shape_bytes`` of an HLO
    shape string)."""
    if hasattr(tree, "planes") and hasattr(tree, "sign") and hasattr(tree, "scale"):
        tree = [tree.planes, tree.sign, tree.scale]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_shape_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _is_view(func) -> bool:
    return func in _RELABELS or any(r.alias_info is not None and not r.alias_info.is_write
                                    for r in func._schema.returns)


def _allocates(func) -> bool:
    """Whether the op's outputs are new storage (not a view, not in place)."""
    return func not in _RELABELS and all(r.alias_info is None for r in func._schema.returns)


def _collective_kind(name: str) -> str | None:
    """The collective kind of an op named "namespace.op", None for an op
    that is not a c10d collective."""
    namespace, _, op = name.partition(".")
    if namespace not in _COLLECTIVE_NAMESPACES:
        return None
    return next((kind for sub, kind in _COLLECTIVE_NAMES if sub in op), None)


def collective_bytes(records) -> Dict[str, int]:
    """Output bytes per collective kind of ``records``, (op name, output
    bytes) pairs as :class:`Counter` names them; ops that are not c10d
    collectives count nothing."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVE_KINDS}
    for name, nbytes in records:
        kind = _collective_kind(name)
        if kind is not None:
            out[kind] += nbytes
    return out


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one op moves, by the conventions of the module docstring."""
    outs = _tensors(out)
    if func in _ALLOCATIONS or not outs or _is_view(func):
        return 0
    ins = _tensors(args) + _tensors(kwargs)
    out_bytes = sum(t.numel() * t.element_size() for t in outs)
    if func in _GATHERS:
        idx = sum(t.numel() * t.element_size() for t in ins[1:])
        return 2 * out_bytes + idx
    if func in _SCATTERS or func in _ACCUMULATING_SCATTERS:
        # index_put_(self, indices, values); the others (self, dim, index, src)
        if func.overloadpacket in (_aten.index_put_, _aten._index_put_impl_):
            index, values = _tensors(args[1]), args[2]
        else:
            index, values = _tensors(args[2]), args[3] if len(args) > 3 else None
        rows = (values.numel() * values.element_size() if isinstance(values, torch.Tensor)
                else sum(t.numel() for t in index) * outs[0].element_size())
        idx = sum(t.numel() * t.element_size() for t in index)
        return (3 if func in _ACCUMULATING_SCATTERS else 2) * rows + idx
    if func in _WRITE_ONLY:
        ins = ins[1:]
    return sum(t.numel() * t.element_size() for t in ins) + out_bytes


class _Mode(TorchDispatchMode):
    def __init__(self, counter: "Counter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.counter._op(func, args, kwargs, out)
        return out


class Counter:
    """Counts what the ops run inside ``with Counter() as c:`` do; the
    call's tensors are meta tensors (any device works, but only meta
    kernel entries report their kernels).  :meth:`terms` gives the
    :class:`RooflineTerms`."""

    BIG_OPS = 64  # individual ops kept for :meth:`RooflineTerms.biggest_ops`

    def __init__(self):
        self.bytes = 0
        self.kernel_flops = 0.0
        self.torch_flops = 0.0
        self.by_op: Dict[str, List[int]] = {}  # name -> [bytes, count]
        self.big: List[Tuple[int, str, str]] = []  # min-heap (bytes, name, what)
        self.launches: Dict[str, int] = {}
        self.collectives: Dict[str, int] = {k: 0 for k in _COLLECTIVE_KINDS}
        self.live = 0
        self.peak_live = 0
        self._tracked: set = set()

    def __enter__(self) -> "Counter":
        self._flops = FlopCounterMode(display=False)
        self._flops.__enter__()
        self._mode = _Mode(self)
        self._mode.__enter__()
        with _ACTIVE_LOCK:
            _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        with _ACTIVE_LOCK:
            _ACTIVE.remove(self)
        self._mode.__exit__(*exc)
        self._flops.__exit__(*exc)
        self.torch_flops = float(self._flops.get_total_flops())
        return False

    @property
    def flops(self) -> float:
        return self.torch_flops + self.kernel_flops

    def _count(self, name: str, nbytes: int, what: str) -> None:
        self.bytes += nbytes
        agg = self.by_op.setdefault(name, [0, 0])
        agg[0] += nbytes
        agg[1] += 1
        item = (nbytes, name, what)
        if len(self.big) < self.BIG_OPS:
            heapq.heappush(self.big, item)
        elif nbytes > self.big[0][0]:
            heapq.heapreplace(self.big, item)

    def _free(self, key, nbytes) -> None:
        self._tracked.discard(key)
        self.live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            s = t.untyped_storage()
            key = s._cdata
            if key in self._tracked:
                continue
            nbytes = s.nbytes()
            self._tracked.add(key)
            self.live += nbytes
            weakref.finalize(s, self._free, key, nbytes)
        self.peak_live = max(self.peak_live, self.live)

    def _op(self, func, args, kwargs, out) -> None:
        nbytes = op_bytes(func, args, kwargs, out)
        name = str(func.overloadpacket)
        outs = _tensors(out)
        kind = _collective_kind(name)
        if kind is not None:
            self.collectives[kind] += sum(t.numel() * t.element_size() for t in outs)
        if nbytes:
            shapes = ", ".join(f"{str(t.dtype)[6:]}{list(t.shape)}" for t in outs)
            self._count(name, nbytes, f"{name} -> {shapes}"[:120])
        if outs and _allocates(func):
            self._track(outs)

    def kernel(self, name: str, flops: float, nbytes: int) -> None:
        """One launch of a hand-written kernel, as its entry reports it."""
        self.kernel_flops += flops
        self.launches[name] = self.launches.get(name, 0) + 1
        self._count(f"kernel.{name}", nbytes, f"kernel.{name}")

    def terms(self, n_devices: int = 1) -> "RooflineTerms":
        coll = dict(self.collectives)
        return RooflineTerms(
            flops_per_device=self.flops,
            bytes_per_device=float(self.bytes),
            collective_bytes_per_device=float(sum(coll.values())),
            collectives=coll,
            n_devices=n_devices,
            launches=dict(self.launches),
            peak_live_bytes=self.peak_live,
            op_bytes={k: (v[0], v[1]) for k, v in self.by_op.items()},
            big_ops=[(name, b, what) for b, name, what in sorted(self.big, reverse=True)],
        )


def record_kernel(name: str, flops: float, nbytes: int) -> None:
    """Report one launch of kernel ``name`` to the innermost active
    :class:`Counter`; nothing happens outside one."""
    with _ACTIVE_LOCK:
        counter = _ACTIVE[-1] if _ACTIVE else None
    if counter is not None:
        counter.kernel(name, flops, nbytes)


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, int]
    n_devices: int
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    peak_live_bytes: int = 0
    op_bytes: Dict[str, Tuple[int, int]] = dataclasses.field(default_factory=dict)
    big_ops: List[Tuple[str, int, str]] = dataclasses.field(default_factory=list)

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / hw.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / hw.HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / hw.LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        """Perfect-overlap model: the slowest term bounds the step."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self, model_flops_per_device: float) -> float:
        """Useful-FLOPs MFU bound implied by the dominant term."""
        t = self.step_time_lower_bound_s
        if t <= 0:
            return 0.0
        return (model_flops_per_device / t) / hw.PEAK_FLOPS_BF16

    def op_byte_profile(self, top_k: int = 20) -> List[Tuple[str, int, int]]:
        """(op name, bytes, calls) of the ops that moved the most bytes."""
        top = sorted(self.op_bytes.items(), key=lambda kv: -kv[1][0])[:top_k]
        return [(k, b, n) for k, (b, n) in top]

    def biggest_ops(self, top_k: int = 15) -> List[Tuple[str, int, str]]:
        """(op name, bytes, description) of the single largest calls."""
        return self.big_ops[:top_k]

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collectives": self.collectives,
            "n_devices": self.n_devices,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "kernel_launches": self.launches,
            "peak_live_bytes": self.peak_live_bytes,
        }


def analyze(fn, *args, n_devices: int = 1, **kw) -> RooflineTerms:
    """Run ``fn(*args, **kw)`` under a :class:`Counter` and return its
    terms; ``fn``'s output is dropped."""
    with Counter() as c:
        fn(*args, **kw)
    return c.terms(n_devices)


def model_flops(n_params_active: float, tokens: float) -> float:
    """MODEL_FLOPS = 6*N*D (training) — use 2*N*D for inference."""
    return 6.0 * n_params_active * tokens


def model_flops_inference(n_params_active: float, tokens: float) -> float:
    return 2.0 * n_params_active * tokens
