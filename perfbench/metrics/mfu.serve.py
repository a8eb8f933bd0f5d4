"""Model FLOPs of the prompt and output tokens the window processed (2*N
active per token plus causal attention, ``counts.model``), over the
window's seconds at the bf16 peak.  Prompt tokens count by their prefill
chunk's span event, output tokens by their decode step's."""
from perfbench.metrics._common import mfu, window_events


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    lm, t0 = ctx["lm"], ctx["edges"]["open"]["t"]
    t1 = t0 + ctx["seconds"]
    flops = 0.0
    for uid, trc in ctx["traces"].items():
        filled, k = 0, 0
        for e in trc.events:
            if e.kind == "prefill_chunk":
                size = int(e.attrs["size"])
                if t0 <= e.ts <= t1:
                    flops += lm.tokens_flops(filled, size)
                filled += size
            elif e.kind == "decode_step":
                k += 1
                if t0 <= e.ts <= t1:
                    flops += lm.token_flops(ctx["prompt_len"][uid] + k - 1)
    return mfu(flops, ctx["seconds"])
