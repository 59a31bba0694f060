"""The device timeline of the traced part of a window, from
``torch.profiler``.

``busy_s`` is the union of the intervals in which an operation (kernel,
copy or fill) ran on the device; ``window_s`` is the traced span itself.
``kernels`` sums device seconds and counts by name.  ``idle_gaps`` gives
the gaps between device operations by what the host was doing at their
middle: the innermost profiler range open on the host there, under the
benchmark's own span (``pb.*``) that contained it, if any.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

# gaps labelled one by one (the longest); shorter ones are summed apart
LABELLED_GAPS = 400
NAME_CHARS = 100


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]      # name -> (seconds, count)
    idle_by_host: List[Tuple[str, float]]      # label -> idle seconds
    n_device_ops: int

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        items = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        return [[name[:NAME_CHARS], secs] for name, (secs, _) in
                items[:top]]

    def kernel_time(self, fragment: str) -> Tuple[float, int]:
        """Total device seconds and count of the operations whose name
        holds ``fragment``."""
        secs, n = 0.0, 0
        for name, (s, c) in self.kernels.items():
            if fragment in name:
                secs += s
                n += c
        return secs, n


def _annotation(ev) -> bool:
    flag = getattr(ev, "is_user_annotation", None)
    return bool(flag and flag()) or ev.name().startswith("pb.")


def _union(starts: np.ndarray, ends: np.ndarray) -> float:
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    # each run of overlapping intervals: its first start to its last end
    firsts = np.flatnonzero(new)
    lasts = np.append(firsts[1:] - 1, len(s) - 1)
    return float(np.sum(run_end[lasts] - s[firsts]))


def read(prof, window_s: float) -> DeviceTrace:
    """Summarise a stopped ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    dev_s, dev_e, kernels = [], [], {}
    cpu = []
    for ev in events:
        kind = str(ev.device_type())
        start, dur = ev.start_ns(), ev.duration_ns()
        if kind.endswith("CUDA"):
            # a profiler range mirrored on the device timeline spans the
            # gaps between its kernels: it is no operation
            if dur <= 0 or _annotation(ev):
                continue
            dev_s.append(start)
            dev_e.append(start + dur)
            name = ev.name()
            secs, n = kernels.get(name, (0.0, 0))
            kernels[name] = (secs + dur * 1e-9, n + 1)
        elif kind.endswith("CPU") and dur > 0:
            cpu.append((start, start + dur, ev.name()))
    if not dev_s:
        return DeviceTrace(window_s, 0.0, {}, [], 0)
    starts = np.asarray(dev_s, np.int64)
    ends = np.asarray(dev_e, np.int64)
    busy = _union(starts, ends) * 1e-9
    return DeviceTrace(window_s=window_s, busy_s=busy, kernels=kernels,
                       idle_by_host=_idle_by_host(starts, ends, cpu),
                       n_device_ops=len(dev_s))


def _idle_by_host(starts, ends, cpu) -> List[Tuple[str, float]]:
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], np.maximum.accumulate(ends[order])
    gap_lo, gap_hi = e[:-1], s[1:]
    keep = gap_hi > gap_lo
    gap_lo, gap_hi = gap_lo[keep], gap_hi[keep]
    if not len(gap_lo) or not cpu:
        return []
    lens = gap_hi - gap_lo
    top = np.argsort(-lens, kind="stable")[:LABELLED_GAPS]
    c_start = np.asarray([c[0] for c in cpu], np.int64)
    c_end = np.asarray([c[1] for c in cpu], np.int64)
    names = [c[2] for c in cpu]
    bench = np.asarray([n.startswith("pb.") for n in names])
    out: Dict[str, float] = {}
    for i in top:
        mid = (gap_lo[i] + gap_hi[i]) // 2
        inside = (c_start <= mid) & (c_end >= mid)
        label = "host idle"
        if inside.any():
            span = "pb.scheduler"
            outer = np.flatnonzero(inside & bench)
            if len(outer):
                span = names[outer[np.argmin(c_start[outer])]]
            plain = np.flatnonzero(inside & ~bench)
            op = (names[plain[np.argmax(c_start[plain])]] if len(plain)
                  else "python")
            label = f"{span} / {op}"[:NAME_CHARS]
        out[label] = out.get(label, 0.0) + float(lens[i]) * 1e-9
    rest = float(lens.sum() - lens[top].sum()) * 1e-9
    if rest > 0:
        out[f"gaps shorter than the {len(top)} longest"] = rest
    return sorted(out.items(), key=lambda kv: -kv[1])
