"""Window arithmetic over host-clock token events: every statistic is
taken over every sample inside the window, never from medians of pieces."""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# one request's tokens: (host time of each token's event), in order
TokenTimes = Sequence[float]


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The ``q``-th percentile (0..100) of every value, by linear
    interpolation between order statistics (numpy's default rule)."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def inside(t: float, t0: float, t1: float) -> bool:
    return t0 <= t <= t1


def tokens_in_window(requests: Iterable[TokenTimes], t0: float, t1: float) -> int:
    """Every output token whose event lies in [t0, t1], of every request,
    finished or not."""
    return sum(1 for times in requests for t in times if inside(t, t0, t1))


def ttfts_in_window(sent_first: Iterable[Tuple[float, float]], t0: float,
                    t1: float) -> List[float]:
    """Send -> first token, in ms, of every request whose first token came
    inside the window."""
    return [(first - sent) * 1e3 for sent, first in sent_first if inside(first, t0, t1)]


def gaps_in_window(requests: Iterable[TokenTimes], t0: float, t1: float) -> List[float]:
    """Every gap between consecutive tokens of one request with both ends
    inside the window, in ms."""
    out = []
    for times in requests:
        for a, b in zip(times, times[1:]):
            if t0 <= a and b <= t1:
                out.append((b - a) * 1e3)
    return out


def window_summary(tokens: Dict[object, TokenTimes], sent: Dict[object, float],
                   t0: float, t1: float) -> Dict[str, Optional[float]]:
    """The serving cell's end-to-end numbers over the window [t0, t1]."""
    seconds = t1 - t0
    n_tok = tokens_in_window(tokens.values(), t0, t1)
    ttft = ttfts_in_window(((sent[u], ts[0]) for u, ts in tokens.items()
                            if ts and u in sent), t0, t1)
    gaps = gaps_in_window(tokens.values(), t0, t1)
    return {
        "serve_tokens_per_s": n_tok / seconds if seconds > 0 else None,
        "ttft_p90_ms": percentile(ttft, 90.0),
        "itl_p95_ms": percentile(gaps, 95.0),
        "tokens": n_tok, "first_tokens": len(ttft), "gaps": len(gaps),
    }
