"""The program's own spans and counters (``repro_torch.trace``), as the
per-layer metrics read them.

In a traced run the program's tracer is on while the profiler runs, so its
buffer holds the rounds of the window's traced solve, one summary a round
(``trace.rounds()``).  A program without the tracer, or a run in which it
recorded no round, reads as nothing.  A device-clock metric reads the
spans' CUDA events; on a CPU run, where none are recorded, it reads the
host's clock, which is then the device's.
"""
from __future__ import annotations

import importlib
from typing import List, Optional, Sequence


def rounds() -> Optional[List[object]]:
    """The program's summaries of its traced rounds, or None."""
    try:
        trace = importlib.import_module("repro_torch.trace")
    except ImportError:
        return None
    return trace.rounds() or None


def _seconds(total, clock: str, self_time: bool) -> float:
    if clock == "host":
        return total.self_host_s if self_time else total.host_s
    dev = total.self_device_s if self_time else total.device_s
    if dev is None:
        return total.self_host_s if self_time else total.host_s
    return dev


def mean_ms(names: Sequence[str], clock: str,
            self_time: bool = False) -> Optional[float]:
    """The spans ``names``, summed within each round on ``clock`` ("host"
    or "device"), their own time less their children's with
    ``self_time``; the mean over the traced rounds in ms.  None where no
    round holds any of them."""
    summaries = rounds()
    if not summaries or not any(n in s.spans for s in summaries
                                for n in names):
        return None
    per_round = [sum(_seconds(s.spans[n], clock, self_time)
                     for n in names if n in s.spans) for s in summaries]
    return 1e3 * sum(per_round) / len(per_round)


def counts(name: str) -> Optional[List[int]]:
    """Counter ``name`` of each traced round, or None where no round
    counted it."""
    summaries = rounds()
    if not summaries or not any(name in s.counters for s in summaries):
        return None
    return [int(s.counters.get(name, 0)) for s in summaries]
