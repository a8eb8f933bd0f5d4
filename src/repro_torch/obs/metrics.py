"""Metrics registry: counters, gauges, bounded-reservoir histograms.

Zero third-party dependencies — the whole module is stdlib-only so the
serve hot loop can emit telemetry without pulling a metrics client into
the runtime image.  Three instrument kinds:

* :class:`Counter` — monotone float, ``inc()``.
* :class:`Gauge` — last-write-wins float, ``set()`` / ``inc()``.
* :class:`Histogram` — a *bounded reservoir*: total ``count``/``sum``
  never reset, but the raw observations live in a fixed-capacity ring so
  a long-lived serving process holds O(capacity) memory no matter how
  many decode steps it survives.  Percentiles (p50/p95/p99 and arbitrary
  ``percentile(p)``) are computed over the ring with the same linear
  interpolation as ``numpy.percentile`` — on workloads smaller than the
  capacity (every bench/CI run) the numbers are bit-identical to the
  unbounded lists they replaced.

Instruments are created through a :class:`Registry` (``reg.counter(...)``
etc. — idempotent, so independent modules can ask for the same family).
Passing ``labels=('outcome',)`` makes a labeled *family*:
``fam.labels(outcome='finished').inc()``.  Label cardinality is capped
(default 64 children) so an unbounded label value (a request id, say)
cannot leak memory — exceeding the cap raises.

A process-global default registry (:func:`get_registry`) backs
``launch.serve --metrics-port``; tests and benchmarks inject fresh
``Registry()`` instances instead, so runs never share state.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

DEFAULT_HISTOGRAM_CAPACITY = 4096
DEFAULT_LABEL_CARDINALITY = 64


def percentile(values: Sequence[float], p: float) -> float:
    """``numpy.percentile(values, p)`` (linear interpolation), stdlib-only.

    The serve benchmarks historically used numpy over unbounded lists;
    this is the drop-in so the registry's p50/p95/p99 match them exactly
    on any workload that fits the reservoir.
    """
    if not values:
        raise ValueError("percentile of empty reservoir")
    if not 0.0 <= p <= 100.0:
        raise ValueError(f"percentile {p} not in [0, 100]")
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    rank = (p / 100.0) * (len(v) - 1)
    lo = math.floor(rank)
    hi = math.ceil(rank)
    if lo == hi:
        return float(v[lo])
    return float(v[lo] + (v[hi] - v[lo]) * (rank - lo))


class Counter:
    """Monotone counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v

    def _reset(self) -> None:
        self.value = 0.0

    def _sample(self) -> Dict[str, float]:
        return {"value": self.value}


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v

    def _reset(self) -> None:
        self.value = 0.0

    def _sample(self) -> Dict[str, float]:
        return {"value": self.value}


class Histogram:
    """Bounded-reservoir histogram: O(capacity) memory, exact totals.

    ``count`` and ``sum`` accumulate over every observation; the ring
    keeps the most recent ``capacity`` raw values for percentiles and
    means.  ``values()`` returns the retained observations oldest-first.
    """

    __slots__ = ("capacity", "count", "sum", "_ring", "_next")

    def __init__(self, capacity: int = DEFAULT_HISTOGRAM_CAPACITY):
        if capacity < 1:
            raise ValueError(f"histogram capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.count = 0
        self.sum = 0.0
        self._ring: List[float] = []
        self._next = 0  # overwrite cursor once the ring is full

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if len(self._ring) < self.capacity:
            self._ring.append(v)
        else:
            self._ring[self._next] = v
            self._next = (self._next + 1) % self.capacity

    def values(self) -> List[float]:
        """Retained observations, oldest first."""
        if len(self._ring) < self.capacity:
            return list(self._ring)
        return self._ring[self._next:] + self._ring[: self._next]

    def __len__(self) -> int:
        return len(self._ring)

    def mean(self) -> float:
        """Mean of the *retained* reservoir (0.0 when empty)."""
        if not self._ring:
            return 0.0
        return sum(self._ring) / len(self._ring)

    def percentile(self, p: float) -> float:
        if not self._ring:
            return 0.0
        return percentile(self._ring, p)

    def last(self) -> Optional[float]:
        vals = self.values()
        return vals[-1] if vals else None

    def _reset(self) -> None:
        self.count = 0
        self.sum = 0.0
        self._ring = []
        self._next = 0

    def clear(self) -> None:  # bench-facing alias (list-like)
        self._reset()

    def _sample(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "sum": self.sum,
            "mean": self.mean(),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
        }


class Ring:
    """Bounded list: appends past ``capacity`` drop the oldest entry.

    Compares equal to a plain list of its retained contents, so test
    assertions written against the old unbounded-list telemetry keep
    working (``sched.admit_bursts == [1, 2]``).
    """

    __slots__ = ("capacity", "_items")

    def __init__(self, capacity: int = DEFAULT_HISTOGRAM_CAPACITY):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._items: List = []

    def append(self, item) -> None:
        self._items.append(item)
        if len(self._items) > self.capacity:
            del self._items[0]

    def clear(self) -> None:
        self._items = []

    def __iter__(self):
        return iter(self._items)

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, Ring):
            return self._items == other._items
        return self._items == other

    def __repr__(self) -> str:
        return f"Ring({self._items!r}, capacity={self.capacity})"


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """A labeled metric family: one child instrument per label-value set."""

    def __init__(self, kind: str, name: str, help: str,
                 label_names: Tuple[str, ...],
                 max_children: int = DEFAULT_LABEL_CARDINALITY,
                 **kwargs):
        self.kind = kind
        self.name = name
        self.help = help
        self.label_names = label_names
        self.max_children = max_children
        self._kwargs = kwargs
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **labels):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got "
                f"{tuple(sorted(labels))}"
            )
        key = tuple(str(labels[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            if len(self._children) >= self.max_children:
                raise ValueError(
                    f"{self.name}: label cardinality cap ({self.max_children}) "
                    f"exceeded by {dict(zip(self.label_names, key))} — an "
                    "unbounded label value (request id?) would leak memory"
                )
            child = _KINDS[self.kind](**self._kwargs)
            self._children[key] = child
        return child

    def ensure_capacity(self, n: int) -> None:
        """Raise the cardinality cap to at least ``n`` children.

        For callers that know their label space up front (the quality
        probe enumerates ``planes x group`` combinations): bounding the
        cap to the enumerated size keeps the leak protection while never
        raising mid-run.  The cap only ever grows — a later caller cannot
        shrink it under an earlier one's children.
        """
        if n < 1:
            raise ValueError(f"family capacity must be >= 1, got {n}")
        self.max_children = max(self.max_children, int(n))

    def children(self) -> Iterable[Tuple[Dict[str, str], object]]:
        for key, child in self._children.items():
            yield dict(zip(self.label_names, key)), child

    def _reset(self) -> None:
        for child in self._children.values():
            child._reset()


class Registry:
    """Instrument namespace + snapshot source for the exporters.

    ``counter`` / ``gauge`` / ``histogram`` are idempotent: asking again
    with the same name returns the existing instrument (and raises on a
    kind or label-name conflict), so independent modules can share
    families without coordination.  Unlabeled metrics return the bare
    instrument; ``labels=(...)`` returns a :class:`Family`.
    """

    def __init__(self):
        self._metrics: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def _get(self, kind: str, name: str, help: str, labels: Sequence[str],
             **kwargs):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labels = tuple(labels)
        for ln in labels:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} for {name}")
        with self._lock:
            entry = self._metrics.get(name)
            if entry is not None:
                if entry["kind"] != kind or entry["labels"] != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{entry['kind']}{entry['labels']} — cannot re-register "
                        f"as {kind}{labels}"
                    )
                return entry["obj"]
            if labels:
                obj = Family(kind, name, help, labels, **kwargs)
            else:
                obj = _KINDS[kind](**kwargs)
            self._metrics[name] = {
                "kind": kind, "help": help, "labels": labels, "obj": obj,
            }
            return obj

    @staticmethod
    def _family_kwargs(labels, max_children):
        if max_children is None:
            return {}
        if not labels:
            raise ValueError("max_children only applies to labeled families")
        return {"max_children": int(max_children)}

    def counter(self, name: str, help: str = "", labels: Sequence[str] = (),
                max_children: Optional[int] = None):
        """``max_children`` bounds a labeled family's cardinality cap at
        creation time (ignored on idempotent re-gets, like histogram
        ``capacity``); use :meth:`Family.ensure_capacity` to grow an
        existing family."""
        return self._get("counter", name, help, labels,
                         **self._family_kwargs(labels, max_children))

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = (),
              max_children: Optional[int] = None):
        return self._get("gauge", name, help, labels,
                         **self._family_kwargs(labels, max_children))

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  capacity: int = DEFAULT_HISTOGRAM_CAPACITY):
        return self._get("histogram", name, help, labels, capacity=capacity)

    def collect(self):
        """Yield ``(name, kind, help, [(labels_dict, samples_dict)])`` per
        family, in registration order."""
        with self._lock:
            entries = list(self._metrics.items())
        for name, entry in entries:
            obj = entry["obj"]
            if isinstance(obj, Family):
                rows = [(lbl, child._sample()) for lbl, child in obj.children()]
            else:
                rows = [({}, obj._sample())]
            yield name, entry["kind"], entry["help"], rows

    def snapshot(self) -> Dict[str, dict]:
        """JSON-able view of every instrument's current state."""
        out: Dict[str, dict] = {}
        for name, kind, help, rows in self.collect():
            out[name] = {
                "type": kind,
                "help": help,
                "samples": [{"labels": lbl, **vals} for lbl, vals in rows],
            }
        return out

    def reset(self) -> None:
        """Zero every instrument (bench warmup); definitions survive."""
        with self._lock:
            for entry in self._metrics.values():
                entry["obj"]._reset()


_default_registry = Registry()


def get_registry() -> Registry:
    """The process-global default registry (``launch.serve`` scrapes it)."""
    return _default_registry


def set_registry(registry: Registry) -> Registry:
    """Swap the process-global default (tests); returns the previous one."""
    global _default_registry
    prev = _default_registry
    _default_registry = registry
    return prev
