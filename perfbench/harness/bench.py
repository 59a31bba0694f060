"""One run of one cell: set up, measure, check, report.

``run_cell`` is the whole run but the look for a card; ``main`` adds that
look, the guard against JAX in the process, and the printing.  The result
is the last line of standard output, one JSON object; the numbers that
decided ``correct`` end standard error, each beside its limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from typing import Dict, List, Optional

from perfbench.harness import spec as spec_mod
from perfbench.harness import window as window_mod

# top-level module names that must not be loaded in a run: the JAX stack
# and the JAX package the port was made from (whole names: the port's own
# name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""
    spec: spec_mod.CellSpec
    cell: object                  # the kind's Cell
    window: window_mod.Window
    setup_s: float
    setup_spans: Dict[str, float]
    trace: Optional[object] = None   # devtrace.DeviceTrace


def device_info(device, peak: int) -> dict:
    """The result's ``device``: the card's name as torch gives it, the
    cards used, the peak of device memory allocated."""
    import torch
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {"platform": "gpu" if device.type == "cuda" else "cpu",
            "kind": kind, "count": 1, "memory_peak_bytes": peak}


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (by default the
    modules this process has loaded), compared whole."""
    names = list(sys.modules) if names is None else names
    loaded = {name.split(".")[0] for name in names}
    return sorted(loaded.intersection(FORBIDDEN))


def run_cell(spec: spec_mod.CellSpec, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             log=lambda msg: None, max_solves: Optional[int] = None,
             control: bool = False) -> dict:
    """Set up the cell, run its window, free the program, check what the
    window produced, read the metrics.  Returns the result object (without
    ``checks``), the checks, the window and the cell, under "result",
    "checks", "window" and "cell".  ``max_solves`` runs whole solves in
    place of ``seconds``; ``control`` puts the kind's control in the
    program's place (``calibrate.py``)."""
    import torch
    from perfbench.harness import devtrace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    is_cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if is_cuda else (lambda: None)
    label = None
    if trace:
        from torch.profiler import record_function
        label = record_function
    spans = window_mod.Spans(sync=sync if trace else None, label=label)
    kind = spec_mod.load_kind(spec.config["kind"], spec.root)
    cell = kind.Cell(spec, seed=seed, device=device, spans=spans, log=log)
    log(f"set-up: the cell's own steps began "
        f"{time.perf_counter() - t_start:.2f} s after the process started")
    try:
        cell.setup()
        tracer, prof = None, None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if is_cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            tracer = (prof.start, prof.stop)
        setup_s = time.perf_counter() - t_start
        if control:
            win = cell.control_window()
        else:
            win = window_mod.run(cell.solve, seconds, sync, spans,
                                 max_solves=max_solves, tracer=tracer)
    finally:
        # the program's state goes before the check, whatever happened
        peak = int(torch.cuda.max_memory_allocated()) if is_cuda else 0
        cell.close_program()
    dev_trace = devtrace.read(prof, win.traced_s) if prof is not None \
        else None
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_round = cell.check(win)
    log(f"check took {time.perf_counter() - t0:.2f} s over "
        f"{len(per_round)} rounds")
    limits = spec.config["limits"]
    checks = [Check(name, max((r[name] for r in per_round), default=0.0),
                    float(limit)) for name, limit in limits.items()]
    failed = sum(any(r[name] > float(limit) for name, limit in
                     limits.items()) for r in per_round)
    ctx = Context(spec=spec, cell=cell, window=win, setup_s=setup_s,
                  setup_spans=dict(spans.setup), trace=dev_trace)
    metrics = {}
    for name, (reader, unit) in spec_mod.metric_readers(spec, trace).items():
        value = reader.read(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": unit}
    result = {
        "correct": (all(c.ok for c in checks) and bool(per_round)
                    and len(per_round) == len(win.rounds)),
        "attempted": len(win.rounds),
        "failed": failed,
        "metrics": metrics,
        "device": device_info(torch.device(device), peak),
    }
    if dev_trace is not None:
        result["device"]["busy_s"] = dev_trace.busy_s
        result["device"]["window_s"] = dev_trace.window_s
        result["breakdown"] = {
            "device_ops": dev_trace.device_ops(10),
            "idle_gaps": [[k, v] for k, v in dev_trace.idle_by_host[:10]]}
    return {"result": result, "checks": checks, "window": win,
            "cell": cell}


def parse(argv) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    try:
        spec = spec_mod.cell_spec(args.workload)
    except (OSError, KeyError, ValueError) as err:
        say(f"perfbench: cannot find the cell: {err}")
        return 2
    try:
        import torch
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as err:
        say(f"perfbench: the program cannot be imported: {err}")
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        say(f"perfbench: {args.workload} needs {spec.chips} CUDA card(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start, log=lambda m: say(f"perfbench: {m}"))
    bad = forbidden_modules()
    if bad:
        say(f"perfbench: the run loaded {', '.join(bad)}; the port's "
            f"benchmark may load neither JAX nor the JAX package")
        return 3
    result, checks = out["result"], out["checks"]
    for c in checks:
        say(f"check {c.name}: {c.value!r} (limit {c.limit!r})"
            f"{'' if c.ok else '  FAILED'}")
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    print(json.dumps(result), flush=True)
    return 0

