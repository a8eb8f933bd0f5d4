"""Per-request trace spans + flight recorder.

A request's life in the serve stack is an ordered event sequence::

    enqueued -> admitted(slot, blocks) -> prefill_chunk(size)*
             -> first_token -> decode_step* -> finished|abandoned|evicted

Overcommitted scheduling can interrupt that mid-flight: a preempted
request records a non-terminal ``preempted`` event (its lane and blocks
are reclaimed), stays an *open* trace while it waits in the queue, and
on re-admission records ``admitted`` again plus ``re_prefill`` before
its recompute chunks.  A preempted-and-resumed trace therefore reads::

    ... decode_step* -> preempted -> admitted -> re_prefill
                     -> prefill_chunk* -> decode_step* -> finished

Speculative decoding replaces the per-token ``decode_step`` events on a
spec lane with one ``draft`` + ``verify`` pair per round (and a
``rollback`` when drafts were rejected)::

    ... first_token -> (draft -> verify [-> rollback])* -> finished

Every path that serves a request (bucketed engine, legacy continuous,
chunked/paged continuous) records the same events through one
:class:`FlightRecorder`, which keeps the in-flight traces plus a ring of
the last ``capacity`` completed ones — a live process can always answer
"what happened to the most recent N requests" in O(capacity) memory.

**TTFT has exactly one definition**: :meth:`RequestTrace.ttft_ms`, the
wall time from the ``admitted`` event (the moment the request's
admission burst began processing — for bucketed serving, the bucket's
prefill dispatch) to its ``first_token`` event.  ``Result.prefill_ms``
is *derived from the trace* on every path, so the bucketed and
continuous engines cannot drift apart again (tests/test_obs.py pins
this).

Exports: :meth:`FlightRecorder.dump_jsonl` (one JSON object per request,
timestamps relative to the recorder epoch) and
:meth:`FlightRecorder.chrome_trace` (a ``chrome://tracing`` /
https://ui.perfetto.dev -loadable document: one track per request with
queued/prefill/decode slices and chunk instants).

Stdlib-only; ``perf_counter`` is imported at module level so tests can
monkeypatch the clock.
"""
from __future__ import annotations

import dataclasses
import json
from collections import deque
from time import perf_counter
from typing import Dict, List, Optional

# Event kinds (the span schema — see docs/observability.md)
ENQUEUED = "enqueued"
ADMITTED = "admitted"
PREFILL_CHUNK = "prefill_chunk"
FIRST_TOKEN = "first_token"
DECODE_STEP = "decode_step"
FINISHED = "finished"
ABANDONED = "abandoned"
EVICTED = "evicted"
# Overcommit: a preempted lane's request is NOT terminal — its trace
# stays open across the requeue and records ADMITTED again (plus
# RE_PREFILL) when it resumes, so ttft_ms (find = FIRST occurrence)
# still measures the original admitted -> first_token span.
PREEMPTED = "preempted"
RE_PREFILL = "re_prefill"
# Bit-plane speculative decoding: each spec round records one DRAFT
# event (steps = pooled draft steps the lane rode at draft precision)
# and one VERIFY event (accepted / committed counts from the
# full-precision chunk scoring).  A round that rejected drafts also
# records ROLLBACK (rejected draft count + tail blocks returned to the
# pool) — position rewind is pure bookkeeping, so these three replace
# the per-token DECODE_STEP events on spec lanes.
DRAFT = "draft"
VERIFY = "verify"
ROLLBACK = "rollback"
# Precision-tier degrade loop: the engine shed (or restored) active bit
# planes under load.  Non-terminal, recorded on every live lane at the
# transition step with the lane's NEW effective plane count — a trace
# reads exactly which precision each of its decode steps ran at.
PLANES_SHED = "planes_shed"
PLANES_RESTORED = "planes_restored"

TERMINAL = frozenset({FINISHED, ABANDONED, EVICTED})
KINDS = (ENQUEUED, ADMITTED, PREFILL_CHUNK, FIRST_TOKEN, DECODE_STEP,
         DRAFT, VERIFY, ROLLBACK, PLANES_SHED, PLANES_RESTORED,
         PREEMPTED, RE_PREFILL, FINISHED, ABANDONED, EVICTED)


def now() -> float:
    """The trace clock (monotonic seconds).  One function so every span
    start/stop — and the TTFT definition — reads the same clock."""
    return perf_counter()


@dataclasses.dataclass
class Event:
    kind: str
    ts: float  # trace-clock seconds (absolute; serialised relative to epoch)
    attrs: Optional[dict] = None


class RequestTrace:
    """Ordered event list for one request."""

    __slots__ = ("uid", "events")

    def __init__(self, uid):
        self.uid = uid
        self.events: List[Event] = []

    def event(self, kind: str, ts: Optional[float] = None, **attrs) -> Event:
        if kind not in KINDS:
            raise ValueError(f"unknown span event kind {kind!r}")
        ev = Event(kind, now() if ts is None else ts, attrs or None)
        self.events.append(ev)
        return ev

    def find(self, kind: str) -> Optional[Event]:
        for ev in self.events:
            if ev.kind == kind:
                return ev
        return None

    @property
    def terminal(self) -> Optional[Event]:
        for ev in reversed(self.events):
            if ev.kind in TERMINAL:
                return ev
        return None

    def terminal_count(self) -> int:
        return sum(1 for ev in self.events if ev.kind in TERMINAL)

    def span_ms(self, start_kind: str, end_kind: str) -> Optional[float]:
        a, b = self.find(start_kind), self.find(end_kind)
        if a is None or b is None:
            return None
        return (b.ts - a.ts) * 1e3

    def ttft_ms(self) -> Optional[float]:
        """THE TTFT definition: admitted -> first_token, in ms.  Every
        ``Result.prefill_ms`` on every serve path is this number."""
        return self.span_ms(ADMITTED, FIRST_TOKEN)

    def to_dict(self, epoch: float = 0.0) -> dict:
        return {
            "uid": self.uid,
            "events": [
                {"kind": ev.kind, "t_ms": (ev.ts - epoch) * 1e3,
                 **(ev.attrs or {})}
                for ev in self.events
            ],
        }


class FlightRecorder:
    """In-flight traces + a bounded ring of the last N completed ones."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"flight recorder capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.epoch = now()
        self.active: Dict[object, RequestTrace] = {}
        self.completed: deque = deque(maxlen=capacity)
        self.begun_total = 0
        self.finished_by_kind: Dict[str, int] = {k: 0 for k in TERMINAL}

    # -- lifecycle ---------------------------------------------------------
    def begin(self, uid, ts: Optional[float] = None, **attrs) -> RequestTrace:
        """Open a trace for ``uid`` with its ``enqueued`` event.  A uid with
        an open trace is a span leak — fail loudly rather than mask it."""
        if uid in self.active:
            raise ValueError(f"request {uid!r} already has an open span")
        tr = RequestTrace(uid)
        tr.event(ENQUEUED, ts=ts, **attrs)
        self.active[uid] = tr
        self.begun_total += 1
        return tr

    def get(self, uid) -> RequestTrace:
        return self.active[uid]

    def event(self, uid, kind: str, ts: Optional[float] = None, **attrs) -> None:
        self.active[uid].event(kind, ts=ts, **attrs)

    def finish(self, uid, kind: str = FINISHED, ts: Optional[float] = None,
               **attrs) -> RequestTrace:
        """Record the terminal event and retire the trace to the ring."""
        if kind not in TERMINAL:
            raise ValueError(f"finish() needs a terminal kind, got {kind!r}")
        tr = self.active.pop(uid)
        tr.event(kind, ts=ts, **attrs)
        self.completed.append(tr)
        self.finished_by_kind[kind] += 1
        return tr

    @property
    def leaked(self) -> List:
        """Uids with an open span — must be empty once the engine drains."""
        return list(self.active)

    def traces(self) -> List[RequestTrace]:
        """Completed (oldest first) then still-active traces."""
        return list(self.completed) + list(self.active.values())

    def clear(self) -> None:
        self.active.clear()
        self.completed.clear()
        self.begun_total = 0
        self.finished_by_kind = {k: 0 for k in TERMINAL}
        self.epoch = now()

    # -- export ------------------------------------------------------------
    def dump_jsonl(self, path: str) -> int:
        """One JSON object per trace (completed then active), timestamps in
        ms relative to the recorder epoch; returns the trace count."""
        traces = self.traces()
        with open(path, "w") as f:
            for tr in traces:
                f.write(json.dumps(tr.to_dict(self.epoch)) + "\n")
        return len(traces)

    def chrome_trace(self) -> dict:
        """A ``chrome://tracing``-loadable document: per request (= one
        tid) complete slices for the queued / prefill / decode phases and
        instant events for prefill chunks."""
        events = []

        def us(ts: float) -> float:
            return (ts - self.epoch) * 1e6

        for tr in self.traces():
            tid = tr.uid if isinstance(tr.uid, int) else abs(hash(tr.uid)) % 2**31
            events.append({
                "ph": "M", "pid": 0, "tid": tid, "name": "thread_name",
                "args": {"name": f"req {tr.uid}"},
            })
            term = tr.terminal
            phases = (
                ("queued", ENQUEUED, ADMITTED),
                ("prefill", ADMITTED, FIRST_TOKEN),
                ("decode", FIRST_TOKEN, None),
            )
            for name, a_kind, b_kind in phases:
                a = tr.find(a_kind)
                b = tr.find(b_kind) if b_kind else term
                if a is None or b is None:
                    continue
                events.append({
                    "ph": "X", "pid": 0, "tid": tid, "name": name,
                    "cat": "serve", "ts": us(a.ts),
                    "dur": max(us(b.ts) - us(a.ts), 0.0),
                })
            for ev in tr.events:
                if ev.kind in (PREFILL_CHUNK, PREEMPTED, RE_PREFILL,
                               DRAFT, VERIFY, ROLLBACK,
                               PLANES_SHED, PLANES_RESTORED):
                    events.append({
                        "ph": "i", "pid": 0, "tid": tid, "name": ev.kind,
                        "cat": "serve", "ts": us(ev.ts), "s": "t",
                        "args": ev.attrs or {},
                    })
            if term is not None and term.kind != FINISHED:
                events.append({
                    "ph": "i", "pid": 0, "tid": tid, "name": term.kind,
                    "cat": "serve", "ts": us(term.ts), "s": "t",
                })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def dump_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def validate_jsonl(path: str) -> int:
    """Schema-check a :meth:`FlightRecorder.dump_jsonl` file: every line
    is an object with ``uid`` and a non-empty ``events`` list of known
    kinds with monotone ``t_ms``, and any trace containing ``admitted``
    carries exactly one terminal event.  Returns the trace count; raises
    ``ValueError`` on the first violation (the CI smoke's contract)."""
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            obj = json.loads(line)
            if "uid" not in obj or not isinstance(obj.get("events"), list) \
                    or not obj["events"]:
                raise ValueError(f"{path}:{lineno}: trace needs uid + events")
            last_t = None
            kinds = []
            for ev in obj["events"]:
                if ev.get("kind") not in KINDS:
                    raise ValueError(
                        f"{path}:{lineno}: unknown event kind {ev.get('kind')!r}")
                t = ev.get("t_ms")
                if not isinstance(t, (int, float)):
                    raise ValueError(f"{path}:{lineno}: event missing t_ms")
                if last_t is not None and t < last_t:
                    raise ValueError(f"{path}:{lineno}: t_ms not monotone")
                last_t = t
                kinds.append(ev["kind"])
            if ADMITTED in kinds:
                terms = sum(1 for k in kinds if k in TERMINAL)
                if terms != 1:
                    raise ValueError(
                        f"{path}:{lineno}: admitted trace has {terms} terminal "
                        "events (want exactly 1)")
            n += 1
    return n
