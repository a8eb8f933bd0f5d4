"""The bitserial kernel's share of its roofline over the traced slice: the
least time of every launch the slice's model calls make (each packed
projection at the call's rows, ``counts.bitserial_matmul``) over the
kernel's device time.  Nothing where the launches the profile shows are
not the launches those calls make."""
from perfbench.counts import bitserial_matmul
from perfbench.metrics._common import BITSERIAL, diff, traced


def read(ctx):
    s = traced(ctx, "serve")
    if s is None:
        return None
    lm, serve, n = ctx["lm"], ctx["serve"], ctx["n_slots"]
    packed, bits = serve["packed_leaves"], int(serve["packed_bits"])
    e = {"open": ctx["slice_edges"][0], "close": ctx["slice_edges"][1]}
    calls = [(diff(e, "prefill_chunks"), lm.packed_launches(packed, n * ctx["C"], n)),
             (diff(e, "decode_steps"), lm.packed_launches(packed, n, n))]
    seconds, launches = s.time_of(lambda name: BITSERIAL.search(name) is not None)
    if launches == 0 or launches != sum(c * len(ls) for c, ls in calls):
        return None
    least = sum(c * sum(bitserial_matmul.least(M, K, N, bits) for M, K, N in ls)
                for c, ls in calls)
    return 100.0 * least / seconds
