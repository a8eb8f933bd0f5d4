"""Which modules a process holds, by whole top-level name: the benchmark
must hold none of the JAX package's or JAX's own."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def top_level(names: Iterable[str]) -> set:
    return {n.split(".", 1)[0] for n in names}


def forbidden_loaded(names: Iterable[str] = None, forbidden=FORBIDDEN) -> List[str]:
    """The forbidden top-level names among ``names`` (default: this
    process's ``sys.modules``), compared whole: ``repro_torch`` is not
    ``repro``."""
    tops = top_level(sys.modules if names is None else names)
    return sorted(t for t in tops if t in forbidden)
