"""Helpers the per-layer readers share.  A reader returns None where it
finds nothing to read; it never returns 0 for a share it could not take."""
from __future__ import annotations

import re

from perfbench.counts import peak_flops

BITSERIAL = re.compile(r"\b(splitk|tiled|wgmma)_kernel\b")
PAGED_SPLIT = re.compile(r"\bpaged_attention_split\b")
PAGED_MERGE = re.compile(r"\bpaged_attention_merge\b")
BGL_FWD = re.compile(r"\bbgl_grouped_kernel\b")
BGL_BWD = re.compile(r"\bbgl_grad_kernel\b")


def traced(ctx, kind: str):
    """The profiled slice of a ``kind`` run, or None."""
    if ctx.get("kind") != kind:
        return None
    s = ctx.get("slice")
    return s if s is not None and s.kernels and s.window_s > 0 else None


def idle_share(ctx, kind: str):
    s = traced(ctx, kind)
    return None if s is None else 100.0 * (1.0 - s.busy_s() / s.window_s)


def mfu(flops: float, seconds: float):
    return None if seconds <= 0 or flops <= 0 else 100.0 * flops / (seconds * peak_flops("bfloat16"))


def diff(edges: dict, key: str, a: str = "open", b: str = "close"):
    return edges[b][key] - edges[a][key]


def window_events(ctx, kind_name: str, t0: float, t1: float):
    """(uid, event, index of the event among the request's events of its
    kind) of every span event of ``kind_name`` in [t0, t1]."""
    for uid, trc in ctx["traces"].items():
        n = 0
        for e in trc.events:
            if e.kind == kind_name:
                n += 1
                if t0 <= e.ts <= t1:
                    yield uid, e, n
