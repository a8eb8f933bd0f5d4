"""The paged-attention kernel's share of its roofline over the traced
slice: each decode step's live rows (a lane at its k-th decode step
reads its prompt's rows and k more), every layer, read once
(``counts.paged_attention``), over the split and merge kernels' device
time.  Nothing where the launches do not match the slice's decode steps."""
from perfbench.counts import paged_attention
from perfbench.metrics._common import PAGED_MERGE, PAGED_SPLIT, diff, traced, window_events


def read(ctx):
    s = traced(ctx, "serve")
    if s is None:
        return None
    lm = ctx["lm"]
    e = {"open": ctx["slice_edges"][0], "close": ctx["slice_edges"][1]}
    steps = diff(e, "decode_steps")
    t_split, n_split = s.time_of(lambda name: PAGED_SPLIT.search(name) is not None)
    t_merge, _ = s.time_of(lambda name: PAGED_MERGE.search(name) is not None)
    if n_split == 0 or n_split != steps * lm.n_layers:
        return None
    rows = [ctx["prompt_len"][uid] + k for uid, _, k in
            window_events(ctx, "decode_step", e["open"]["t"], e["close"]["t"])]
    if not rows:
        return None
    # memory-bound at every step (H / kv_heads operations a byte), so the
    # steps' least times add up to that of all their rows together
    least = lm.n_layers * paged_attention.least(rows, lm.n_heads, lm.n_kv_heads, lm.head_dim)
    return 100.0 * least / (t_split + t_merge)
