"""The share of the window's prefill-chunk rows that carry no prompt
token: 1 - (the chunks' real tokens, from their span events) / (chunks x
n_slots x chunk size).  The chunk runs over every lane of the pool."""
from perfbench.metrics._common import diff, window_events


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    e = ctx["edges"]
    chunks = diff(e, "prefill_chunks")
    if chunks <= 0:
        return None
    real = sum(int(ev.attrs["size"]) for _, ev, _ in
               window_events(ctx, "prefill_chunk", e["open"]["t"], e["close"]["t"]))
    return 100.0 * (1.0 - real / (chunks * ctx["n_slots"] * ctx["C"]))
