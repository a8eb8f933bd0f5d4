"""One paged decode-attention call over a pool of lanes: each live lane's
query (H heads of d) reads its K and V rows once (``rows`` cache rows of
``kv`` heads), writes its output once.  Operations: q.k and p.v, 4*H*d
per row read.  Inactive lanes read nothing."""
from __future__ import annotations

from . import least_seconds


def work(lane_rows, H: int, kv: int, d: int, elt: int = 2):
    """(operations, bytes) of one call; ``lane_rows`` lists each live
    lane's rows (its position + 1)."""
    rows = float(sum(lane_rows))
    lanes = len(lane_rows)
    nbytes = rows * kv * d * elt * 2 + lanes * H * d * elt * 2
    return 4.0 * H * d * rows, nbytes


def least(lane_rows, H: int, kv: int, d: int, elt: int = 2) -> float:
    flops, nbytes = work(lane_rows, H, kv, d, elt)
    return least_seconds(flops, nbytes, "bfloat16")
