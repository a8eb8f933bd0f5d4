"""One bitserial matmul launch: ``x (M, K) @ W (K, N)`` where W is packed
into ``n_bits`` magnitude planes and a sign plane of K/8 bytes per column
each, with ``groups`` f32 scales.  x is read once, the planes, sign and
scales once, the output written once; 2*M*K*N operations."""
from __future__ import annotations

from . import least_seconds


def work(M: int, K: int, N: int, n_bits: int, elt: int = 2, groups: int = 1):
    """(operations, bytes) of one launch; ``elt`` is x's and the output's
    element size (2 for bf16)."""
    k8 = -(-K // 8)
    nbytes = M * K * elt + (n_bits + 1) * k8 * N + 4 * groups + M * N * elt
    return 2.0 * M * K * N, float(nbytes)


def least(M: int, K: int, N: int, n_bits: int, elt: int = 2, groups: int = 1) -> float:
    """Least seconds of one launch at the bf16 rate and the HBM rate."""
    flops, nbytes = work(M, K, N, n_bits, elt, groups)
    return least_seconds(flops, nbytes, "bfloat16")
