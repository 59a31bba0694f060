"""Spans and counters at the program's layer boundaries.

``with trace.span("round"):`` names a stretch of the program;
``trace.count("fista.evals")`` adds to a counter of the innermost open
``round`` span.  The tracer is on while a ``torch.profiler`` profile runs,
and between ``enable()`` and ``disable()``.  While it is off, ``span``
returns one shared no-op context after a check of the profiler's flag, and
``count`` returns at once: no record, no profiler range, no CUDA event.

While it is on, a span keeps a record in memory: its name, its parent, the
solve and the round it belongs to (a ``solve`` span numbers the solves, a
``round`` span the rounds of its solve), and its start and end on
``time.perf_counter_ns()``.  Under a profiler it also opens a
``record_function`` range named ``repro.<name>``, so the span sits on the
profiler's timeline.  Where CUDA is in use it records a pair of CUDA events
on the current stream; their interval is read only by ``rounds()``, and a
span never synchronizes the device.

``enable()``, and the first span after a profiler starts, begin an empty
buffer and a new anchor: a pair (``perf_counter_ns``, ``time_ns``) that
``epoch_ns`` maps a record's times through onto the wall clock's epoch,
the clock of the profiler's events.  At most ``MAX_RECORDS`` records are
kept; ``dropped()`` counts the spans past that.  The profiler's own Chrome
trace carries the ``repro.*`` ranges; the tracer writes no file.

The tracer serves one thread: the program's scheduler loop.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch
from torch.autograd.profiler import record_function

MAX_RECORDS = 1 << 17
RANGE_PREFIX = "repro."

_profiling = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class SpanTotal:
    """One span name's intervals in a round, summed.  The device clock is
    the CUDA events' (None where none were recorded); self time is the
    span's less its child spans'."""
    n: int
    host_s: float
    device_s: Optional[float]
    self_host_s: float
    self_device_s: Optional[float]


@dataclasses.dataclass
class RoundSummary:
    solve: Optional[int]          # the solve's number in the buffer
    round: int                    # the round's number in its solve, from 1
    spans: Dict[str, SpanTotal]   # "round" itself and every span inside it
    counters: Dict[str, int]


@dataclasses.dataclass
class SpanRecord:
    name: str
    parent: Optional[int]         # index of the parent's record
    solve: Optional[int]
    round: Optional[int]
    t0_ns: int
    t1_ns: Optional[int]          # None while the span is open


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Record:
    __slots__ = ("name", "parent", "solve", "round", "owner", "t0", "t1",
                 "events", "counts")

    def __init__(self, name, parent, solve, rnd, owner):
        self.name = name
        self.parent = parent
        self.solve = solve
        self.round = rnd
        self.owner = owner            # the innermost open round record
        self.t0 = 0
        self.t1 = None
        self.events = None
        self.counts = None


class _Span:
    __slots__ = ("tracer", "name", "rec", "range", "outer_round")

    def __init__(self, tracer: "Tracer", name: str):
        self.tracer = tracer
        self.name = name

    def __enter__(self):
        tr = self.tracer
        name = self.name
        stack = tr._stack
        if name == "solve":
            tr._solve, tr._n_rounds = tr._n_solves, 0
            tr._n_solves += 1
        parent = stack[-1] if stack else None
        self.outer_round = owner = tr._round
        if name == "round":
            tr._n_rounds += 1
            rec = _Record(name, parent, tr._solve, tr._n_rounds, None)
            rec.owner, rec.counts = rec, {}
            tr._round = rec
        else:
            rec = _Record(name, parent, tr._solve,
                          owner.round if owner is not None else None, owner)
        if len(tr._records) < MAX_RECORDS:
            tr._records.append(rec)
        else:
            tr._dropped += 1
        stack.append(rec)
        self.rec = rec
        self.range = None
        if _profiling():
            self.range = record_function(RANGE_PREFIX + name)
            self.range.__enter__()
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start, end)
        rec.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        rec = self.rec
        rec.t1 = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        tr = self.tracer
        tr._stack.pop()
        tr._round = self.outer_round
        return False


class Tracer:
    """The state behind the module's functions; one serves the process,
    as the profiler does."""

    def __init__(self):
        self._explicit = False
        self._profiled = False    # a profiler session is being recorded
        self._stack: List[_Record] = []
        self._round: Optional[_Record] = None
        self._begin()

    def _begin(self) -> None:
        self._records: List[_Record] = []
        self._dropped = 0
        self._solve: Optional[int] = None
        self._n_solves = 0
        self._n_rounds = 0
        self._anchor = (time.perf_counter_ns(), time.time_ns())

    # -- recording ----------------------------------------------------------
    def span(self, name: str):
        """A context manager naming a stretch of the program."""
        if not self._explicit:
            if not _profiling():
                self._profiled = False
                return _NOOP
            if not self._profiled:
                self._profiled = True
                self._begin()
        return _Span(self, name)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name`` of the innermost open round."""
        rnd = self._round
        if rnd is None:
            return
        counts = rnd.counts
        counts[name] = counts.get(name, 0) + n

    # -- switches -----------------------------------------------------------
    def enable(self) -> None:
        """Record from now on, into an empty buffer with a new anchor."""
        self._explicit = True
        self._begin()

    def disable(self) -> None:
        """Record only while a profiler runs; the buffer is kept."""
        self._explicit = False

    def reset(self) -> None:
        """Empty the buffer; on or off stays as it is."""
        self._begin()

    def enabled(self) -> bool:
        return self._explicit or _profiling()

    # -- reading ------------------------------------------------------------
    def epoch_ns(self, t_ns: int) -> int:
        """A record's perf_counter_ns time on the wall clock's epoch,
        through the anchor taken when the buffer began."""
        return self._anchor[1] + (t_ns - self._anchor[0])

    def dropped(self) -> int:
        return self._dropped

    def records(self) -> List[SpanRecord]:
        """The buffer's records, in the order their spans opened."""
        where = {id(r): i for i, r in enumerate(self._records)}
        return [SpanRecord(r.name, where.get(id(r.parent)), r.solve,
                           r.round, r.t0, r.t1) for r in self._records]

    def rounds(self) -> List[RoundSummary]:
        """One summary per closed ``round`` span in the buffer, in order:
        each span name's summed host, device and self seconds within the
        round, and the round's counters.  Waits for the device to reach
        the spans' CUDA events."""
        closed = [r for r in self._records
                  if r.t1 is not None and r.owner is not None]
        dev = {}
        for r in closed:
            if r.events is not None:
                start, end = r.events
                end.synchronize()
                dev[id(r)] = start.elapsed_time(end) * 1e-3
        kids_host: Dict[int, float] = {}
        kids_dev: Dict[int, Optional[float]] = {}
        for r in closed:
            if r.parent is None or r is r.owner:
                continue
            p = id(r.parent)
            kids_host[p] = kids_host.get(p, 0.0) + (r.t1 - r.t0) * 1e-9
            d, acc = dev.get(id(r)), kids_dev.get(p, 0.0)
            kids_dev[p] = None if d is None or acc is None else acc + d
        out: Dict[int, RoundSummary] = {}
        for r in closed:
            owner = r.owner
            if owner.t1 is None:
                continue
            summary = out.get(id(owner))
            if summary is None:
                summary = out[id(owner)] = RoundSummary(
                    owner.solve, owner.round, {}, dict(owner.counts))
            host = (r.t1 - r.t0) * 1e-9
            d = dev.get(id(r))
            self_host = host - kids_host.get(id(r), 0.0)
            kd = kids_dev.get(id(r), 0.0)
            self_dev = None if d is None or kd is None else d - kd
            t = summary.spans.get(r.name)
            if t is None:
                summary.spans[r.name] = SpanTotal(1, host, d, self_host,
                                                  self_dev)
            else:
                t.n += 1
                t.host_s += host
                t.self_host_s += self_host
                t.device_s = None if t.device_s is None or d is None \
                    else t.device_s + d
                t.self_device_s = (None if t.self_device_s is None
                                   or self_dev is None
                                   else t.self_device_s + self_dev)
        return list(out.values())


_TRACER = Tracer()
span = _TRACER.span
count = _TRACER.count
enable = _TRACER.enable
disable = _TRACER.disable
reset = _TRACER.reset
enabled = _TRACER.enabled
epoch_ns = _TRACER.epoch_ns
dropped = _TRACER.dropped
records = _TRACER.records
rounds = _TRACER.rounds
