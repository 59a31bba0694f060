"""The measured window: one caller in a closed loop of solves.

Each solve is the cell's spec run from cold through the program's entry
(``api.run``), started as soon as the previous one ends.  A round ends
when the program's ``on_round`` fires; the window closes at the end of the
first round that ends after ``seconds``, so no round is cut or lost.
Spans, taken by the benchmark's own wrappers around the problem's calls,
are host-clock intervals between two synchronisations of the device; they
are kept in memory and read after the window.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Dict, List, Optional


class StopWindow(Exception):
    """Raised from ``on_round`` to end the window at a round's end."""


class Spans:
    """Named host-clock spans; those of the round in progress are handed
    to the round's record when it ends.  ``sync`` (the device's
    synchronize) runs at each edge when given; ``label`` wraps each span
    in a profiler range when tracing."""

    def __init__(self, sync: Optional[Callable] = None, label=None):
        self.sync = sync
        self.label = label
        self.pending: Dict[str, float] = {}
        self.setup: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, *, setup: bool = False):
        if self.sync:
            self.sync()
        ctx = self.label(f"pb.{name}") if self.label else \
            contextlib.nullcontext()
        t0 = time.perf_counter()
        try:
            with ctx:
                yield
        finally:
            if self.sync:
                self.sync()
            dt = time.perf_counter() - t0
            book = self.setup if setup else self.pending
            book[name] = book.get(name, 0.0) + dt

    def take(self) -> Dict[str, float]:
        out, self.pending = self.pending, {}
        return out


@dataclasses.dataclass
class Round:
    solve: int                    # index of the solve in the window
    k: int                        # round within its solve (1-based)
    t_end: float                  # perf_counter at the round's end
    wall_s: float                 # since the previous round's end
    metrics: object               # the program's RoundMetrics
    spans: Dict[str, float]
    traced: bool


@dataclasses.dataclass
class Window:
    t0: float
    t_end: float
    rounds: List[Round]
    solves_done: int
    traced_s: float = 0.0         # the profiled part of the window

    @property
    def seconds(self) -> float:
        return self.t_end - self.t0


def run(solve: Callable, seconds: float, sync: Callable, spans: Spans, *,
        max_solves: Optional[int] = None, tracer=None) -> Window:
    """Drive ``solve(on_round)`` in a closed loop for ``seconds`` (or
    ``max_solves`` whole solves).  ``tracer`` (start, stop) brackets the
    first solve under the profiler."""
    rounds: List[Round] = []
    state = {"solve": 0, "k": 0, "last": 0.0, "traced": False}
    sync()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    state["last"] = t0

    def on_round(m):
        sync()
        now = time.perf_counter()
        state["k"] += 1
        rounds.append(Round(solve=state["solve"], k=state["k"], t_end=now,
                            wall_s=now - state["last"], metrics=m,
                            spans=spans.take(), traced=state["traced"]))
        state["last"] = now
        if max_solves is None and now >= deadline:
            raise StopWindow

    traced_s = 0.0
    solves_done = 0
    spans.take()
    while True:
        state["k"] = 0
        trace_this = tracer is not None and state["solve"] == 0
        if trace_this:
            tracer[0]()
            sync()
            t_tr = time.perf_counter()
            state["traced"] = True
        try:
            solve(on_round)
            stopped = False
        except StopWindow:
            stopped = True
        finally:
            if trace_this:
                sync()
                traced_s = time.perf_counter() - t_tr
                tracer[1]()
                state["traced"] = False
        if stopped:
            break
        solves_done += 1
        state["solve"] += 1
        if max_solves is not None and solves_done >= max_solves:
            break
        if max_solves is None and time.perf_counter() >= deadline:
            break
    sync()
    t_end = rounds[-1].t_end if rounds else time.perf_counter()
    return Window(t0=t0, t_end=t_end, rounds=rounds,
                  solves_done=solves_done, traced_s=traced_s)


def attach(solves: List[List[dict]], win: Window) -> List[List[dict]]:
    """The records a kind kept for each solve of the window (one dict a
    round, in order), each given its round's ``metrics``, cut to the
    rounds the window counted."""
    solves = [s for s in solves if s]
    for rnd in win.rounds:
        solves[rnd.solve][rnd.k - 1]["metrics"] = rnd.metrics
    return [s[:max((r.k for r in win.rounds if r.solve == i), default=0)]
            for i, s in enumerate(solves)]
