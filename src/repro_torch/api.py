"""The experiment API of the port: declare a run, get a priced result.

    from repro_torch.api import ExperimentSpec, run
    from repro_torch.runtime import SchedulerConfig

    result = run(ExperimentSpec(
        problem="logreg",
        scheduler=SchedulerConfig(n_workers=64, engine="batched",
                                  kernel="cuda"),
        max_rounds=2))
    result.trace[-1]["r_norm"], result.cost_usd

``run`` and ``build`` put the problem on the card unless ``device`` says
otherwise; without a card, ``device="cuda"`` raises.  The multi-tenant
cluster surface (``submit``, ``run_all``, ``replay``, DAGs) is not ported
yet.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import problems
from repro_torch.runtime.scheduler import (RoundMetrics, Scheduler,
                                           SchedulerConfig)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """A complete, declarative description of one run: a registered
    problem name, its JSON-friendly factory kwargs, the scheduler config,
    and an optional round cap (defaults to ``scheduler.admm.max_iters``)."""
    problem: str = "logreg"
    problem_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    scheduler: SchedulerConfig = SchedulerConfig()
    max_rounds: Optional[int] = None
    label: str = ""

    def to_dict(self) -> dict:
        return {
            "problem": self.problem,
            "problem_kwargs": dict(self.problem_kwargs),
            "scheduler": dataclasses.asdict(self.scheduler),
            "max_rounds": self.max_rounds,
            "label": self.label,
        }


def _trace_row(m: RoundMetrics) -> Dict[str, float]:
    return {
        "k": m.k, "sim_time": m.sim_time, "r_norm": m.r_norm,
        "s_norm": m.s_norm, "rho": m.rho, "cost_usd": m.cost_usd,
        "n_workers": m.n_workers, "n_respawns": m.n_respawns,
        "round_wall_s": m.round_wall_s, "t_fanin_wait": m.t_fanin_wait,
        "t_comp_mean": float(m.t_comp.mean()),
        "t_comp_std": float(m.t_comp.std()),
        "t_idle_mean": float(m.t_idle.mean()),
        "t_idle_std": float(m.t_idle.std()),
        "inner_mean": float(m.inner_iters.mean()),
        "z_nnz": m.z_nnz,
    }


@dataclasses.dataclass
class RunResult:
    """What a run produced: solution, trace, dollars, live handles."""
    spec: ExperimentSpec
    problem: Any                      # the WorkerProblem instance
    scheduler: Scheduler              # live handle
    z: np.ndarray                     # consensus solution, on the host
    trace: List[Dict[str, float]]     # one row per round (see _trace_row)
    converged: bool                   # hit the ADMM eps pair
    rounds: int
    sim_time_s: float
    cost_usd: float
    cost_breakdown: Dict[str, float]  # BillingMeter.summary()
    n_respawns: int
    w_start: int
    w_final: int
    wall_s: float                     # real wall-clock of solve()

    @property
    def history(self) -> List[RoundMetrics]:
        return self.scheduler.history

    def final(self) -> RoundMetrics:
        return self.scheduler.history[-1]

    def to_dict(self) -> dict:
        """JSON-safe summary (the live handles and the full z stay out)."""
        return {
            "spec": self.spec.to_dict(),
            "label": self.spec.label,
            "problem": self.spec.problem,
            "converged": self.converged,
            "rounds": self.rounds,
            "sim_time_s": self.sim_time_s,
            "cost_usd": self.cost_usd,
            "cost_breakdown": dict(self.cost_breakdown),
            "n_respawns": self.n_respawns,
            "w_start": self.w_start,
            "w_final": self.w_final,
            "z_norm": float(np.linalg.norm(self.z)),
            "z_nnz": int(np.sum(np.abs(self.z) > 1e-6)),
            "wall_s": self.wall_s,
            "trace": self.trace,
        }

    def to_json(self, indent: int = 1) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=float)


def build(spec: ExperimentSpec, *, problem=None, device="cuda"):
    """Instantiate (problem, Scheduler) from a spec without running it.
    Pass ``problem`` to reuse an existing instance (its shard caches); its
    own device then holds."""
    if problem is None:
        problem = problems.make(spec.problem, device=device,
                                **dict(spec.problem_kwargs))
    return problem, Scheduler(problem, spec.scheduler)


def result_from_scheduler(spec: ExperimentSpec, problem, sched: Scheduler,
                          *, wall_s: float = 0.0) -> RunResult:
    """Package a driven scheduler's state as a ``RunResult``."""
    last = sched.history[-1]
    eps = spec.scheduler.admm
    return RunResult(
        spec=spec, problem=problem, scheduler=sched,
        z=sched.z.detach().cpu().numpy(),
        trace=[_trace_row(m) for m in sched.history],
        converged=bool(last.r_norm <= eps.eps_primal
                       and last.s_norm <= eps.eps_dual),
        rounds=len(sched.history),
        sim_time_s=float(last.sim_time),
        cost_usd=float(sched.meter.total_usd()),
        cost_breakdown=sched.meter.summary(),
        n_respawns=sched.n_respawns,
        w_start=spec.scheduler.n_workers,
        w_final=sched.cfg.n_workers,
        wall_s=wall_s)


def run(spec: ExperimentSpec, *, problem=None, device="cuda",
        on_round: Optional[Callable[[RoundMetrics], None]] = None
        ) -> RunResult:
    """Run a spec end to end on ``device`` (the card unless asked).
    ``on_round`` fires once per round."""
    prob, sched = build(spec, problem=problem, device=device)
    t0 = time.time()
    sched.solve(max_rounds=spec.max_rounds, on_round=on_round)
    return result_from_scheduler(spec, prob, sched,
                                 wall_s=time.time() - t0)
