"""The grouped bit-level sum of squares of BSQ's regulariser: one forward
launch reads every plane element once and writes one f32 sum per (plane,
group) row; the backward reads every element and the row gradients once
and writes every element's gradient once.  Two operations per element,
at the f32 rate."""
from __future__ import annotations

from . import least_seconds


def work(elements: int, rows: int, backward: bool = False, elt: int = 4):
    nbytes = elements * elt * (2 if backward else 1) + 4 * rows
    return 2.0 * elements, float(nbytes)


def least(elements: int, rows: int, backward: bool = False, elt: int = 4) -> float:
    flops, nbytes = work(elements, rows, backward, elt)
    return least_seconds(flops, nbytes, "float32")
