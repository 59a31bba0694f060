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
otherwise; without a card, ``device="cuda"`` raises.  So do the
multi-tenant verbs, which queue specs on a shared-pool ``Cluster``
(``runtime/cluster.py``) instead of running them solo:

    submit(spec_a, tenant="alice")
    submit(spec_b, tenant="bob", priority=2)
    result = run_all()           # ClusterResult: jobs + ClusterReport

``submit_dag`` queues a phase-structured job, ``submit_at`` a timestamped
arrival, ``replay`` a whole ``runtime.loadgen`` trace; ``demand`` is a
spec's (workers, mem_gb, egress_mbps) vector.

Every registered workload of the reference runs here: the first-order
ones (``logreg``, ``svm``, ``lasso``, ``softmax``, ``logreg_l2``),
``double_ml`` and the second-order ``newton_sketch``, under every barrier
mode (sync, drop_slowest, replicated, async_), both engines and fan-ins,
with ω compression (topk, qsgd), solo or on the cluster.  ``newton_sketch``
refuses async_, compression and ``kernel="cuda"``, as the reference does.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch import problems, trace
from repro_torch.device import resolve_device
from repro_torch.runtime.cluster import (Cluster, ClusterConfig,
                                         ClusterResult, DagRun, DagSpec,
                                         StageResult, StageSpec)
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
    with trace.span("solve"):
        prob, sched = build(spec, problem=problem, device=device)
        t0 = time.time()
        sched.solve(max_rounds=spec.max_rounds, on_round=on_round)
        return result_from_scheduler(spec, prob, sched,
                                     wall_s=time.time() - t0)


# ---------------------------------------------------------------------------
# Multi-tenant surface: many specs, one shared warm pool
# ---------------------------------------------------------------------------

_default_cluster: Optional[Cluster] = None


def _cluster_for(cluster: Optional[Cluster], device) -> Cluster:
    """The given cluster, else the module-default one, made on ``device``
    at the first submit of a batch."""
    global _default_cluster
    if cluster is not None:
        return cluster
    if _default_cluster is None:
        _default_cluster = Cluster(device=device)
    elif _default_cluster.device != resolve_device(device):
        raise ValueError(f"the default cluster's batch lives on "
                         f"{_default_cluster.device}, not {device}; "
                         f"run_all() it first or pass a Cluster")
    return _default_cluster


def submit(spec: ExperimentSpec, *, tenant: str = "default",
           priority: int = 0, deadline_s: Optional[float] = None,
           at: float = 0.0, problem=None,
           cluster: Optional[Cluster] = None, device="cuda"):
    """Queue a spec on a cluster (the module-default one, on ``device``,
    unless given) instead of running it solo: many submitted jobs then
    share one warm sandbox pool, interleaved round by round by
    ``run_all()``.  Returns the ``Job`` handle (state ``queued``, or
    ``rejected`` with a reason: admission control)."""
    return _cluster_for(cluster, device).submit(
        spec, tenant=tenant, priority=priority, deadline_s=deadline_s,
        at=at, problem=problem)


def run_all(cluster: Optional[Cluster] = None, on_job_done=None):
    """Drive every job submitted to the cluster (module-default unless
    given) to completion; returns the ``ClusterResult``.  The default
    cluster is reset afterwards, so the next ``submit()`` starts a fresh
    batch."""
    global _default_cluster
    if cluster is None:
        cluster = _default_cluster
        _default_cluster = None
        if cluster is None:
            raise RuntimeError("nothing submitted: call api.submit() "
                               "first or pass a Cluster")
    return cluster.run_all(on_job_done=on_job_done)


def submit_dag(dag: DagSpec, *, tenant: str = "default", priority: int = 0,
               deadline_s: Optional[float] = None, at: float = 0.0,
               problems: Optional[Dict[str, Any]] = None,
               cluster: Optional[Cluster] = None, device="cuda") -> DagRun:
    """Queue a phase-structured job (a ``DagSpec`` of named stages with
    per-stage parallelism) on a cluster (module-default, on ``device``,
    unless given).  Root stages queue at ``at``; a downstream stage is held
    until its last predecessor completes, then dispatches with its own
    worker demand and receives the predecessors' ``StageResult``s through
    ``problem.consume_stage_results`` if its problem has that hook.
    ``ClusterConfig(reservation=...)`` picks what admission reserves
    (``"phase"``: each running stage; ``"peak"``: the DAG's peak level for
    its whole life).  Returns the ``DagRun`` handle."""
    return _cluster_for(cluster, device).submit_dag(
        dag, tenant=tenant, priority=priority, deadline_s=deadline_s,
        at=at, problems=problems)


def demand(spec: ExperimentSpec) -> Dict[str, float]:
    """The (workers, mem_gb, egress_mbps) demand a spec presents to a
    cluster — what DRF admission and class-aware placement reason about
    (``runtime.placement``)."""
    from repro_torch.runtime.placement import spec_resource_vector
    return spec_resource_vector(spec).to_dict()


def submit_at(spec: ExperimentSpec, at: float, **kw):
    """``submit`` with the arrival instant as a positional: the job stays
    invisible to admission until the cluster clock reaches ``at``."""
    return submit(spec, at=at, **kw)


def replay(workload, *, cluster: Optional[Cluster] = None,
           on_job_done=None, progress_every: int = 0, device="cuda"):
    """Replay a ``runtime.loadgen.TraceWorkload`` against a cluster (a
    fresh one on ``device`` unless given): submit every trace job at its
    timestamped arrival, with the trace's tenant and deadline and one
    problem instance per template, built on the cluster's device and
    shared by every job of that template; then drive the event loop to
    completion.  ``progress_every`` > 0 prints a progress line every that
    many completions.  Returns the ``ClusterResult``."""
    if cluster is None:
        cluster = Cluster(device=device)
    problems_by_template = workload.problem_instances(device=cluster.device)
    for tj in workload.jobs:
        cluster.submit(workload.experiment_spec(tj), tenant=tj.tenant,
                       deadline_s=tj.deadline_s, at=tj.submit_at,
                       problem=problems_by_template[tj.template])
    n_done = [0]

    def _hook(job):
        n_done[0] += 1
        if progress_every and n_done[0] % progress_every == 0:
            print(f"  [replay] {n_done[0]}/{len(workload.jobs)} jobs done "
                  f"(sim t={job.finished_at:.0f}s)", flush=True)
        if on_job_done:
            on_job_done(job)

    return cluster.run_all(on_job_done=_hook)
