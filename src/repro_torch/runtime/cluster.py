"""Multi-tenant cluster: many concurrent experiments on ONE warm pool —
the counterpart of ``repro.runtime.cluster``.  Jobs' problems are built on
the cluster's ``device`` (the card unless the caller asks for the CPU);
everything else is the reference's numpy and Python.

The paper's master–worker setup serves exactly one optimization job per
pool, but its economic pitch — elastic, event-driven runtimes as a
cost-effective substrate — only pays off when many jobs SHARE the warm
capacity: keep-alive sandboxes, account concurrency, and billing all
amortize across tenants (the direction "Exploiting Inherent Elasticity
of Serverless in Irregular Algorithms" and "Distributed Double Machine
Learning with a Serverless Architecture" both argue — multi-stage jobs
with wildly varying parallelism, and fleets of concurrent related
solves).  ``repro_torch.api.run()`` builds a private pool per experiment;
this module is the shared-substrate alternative.

``Cluster`` accepts many jobs (an ``ExperimentSpec`` each, plus tenant
id, priority, optional deadline) and interleaves their scheduler rounds
**event-driven** over one provider-backed sandbox pool:

* **Admission control** — a job is rejected at submit when its spec
  cannot ever be placed (fleet larger than the capacity ceiling,
  ``async_`` mode — which paces itself per-arrival and has no round
  boundary to interleave at) or when the backlog exceeds
  ``max_queued``.  Admitted jobs wait in the queue until worker
  capacity and a job slot free up.
* **Job scheduling policy** — ``fifo`` (submission order),
  ``priority`` (higher first), ``deadline`` (earliest first),
  ``fair_share`` (least-served tenant first, by accumulated
  worker-seconds), or ``drf`` (Dominant Resource Fairness: least
  dominant share of the (workers, mem_gb, egress_mbps) demand vector
  first — the Mesos sorter semantics, ``runtime/placement.py``)
  decides which queued job dispatches when capacity frees.
* **Vector capacity & heterogeneous placement** — ``policy="drf"`` or
  ``vector_capacity=True`` turns admission multi-dimensional (memory
  and egress are checked next to workers), and
  ``PlacementConfig(enabled=True)`` lands each job on one of 2–3
  instance classes (1769/3008/10240 MB tiers with distinct $/GB-s and
  cold starts, each with its OWN warm pool) chosen by
  ``cheapest_fit``/``latency_min``/``cost_latency``.  Both are
  default-off; the scalar single-pool path is byte-identical to
  pre-vector traces.
* **Event-driven interleaving** — every running job keeps its own sim
  clock (its ``Scheduler``'s); the cluster always steps the job whose
  clock trails furthest (``Scheduler.step()``, one round), so pool
  interactions across jobs happen in (approximately) global time
  order and a finished job's retired sandboxes are warm for the NEXT
  admission — whoever the tenant is.
* **Shared keep-alive** — one tenant-aware ``Provider`` backs every
  job's ``LambdaPool`` (``share_provider=True``); per-tenant leases and
  hit/miss stats come with it (``runtime/provider.py``).  With
  ``share_provider=False`` each job gets the private pool its spec
  asks for — the isolated baseline ``benchmarks/bench_cluster.py``
  measures against.
* **Cluster elasticity** — ``runtime/autoscale.ClusterAutoscaler``
  resizes the aggregate worker capacity between a floor and a ceiling
  on the queue-depth signal (demand), modeling the account-level
  concurrency the operator reserves.
* **Tenant accounting** — per-job dollars roll up into per-tenant
  ledgers (``BillingMeter.absorb``), and ``ClusterReport`` summarizes
  p50/p95 job latency, warm-hit rate, per-tenant dollars/latency/
  slowdown, and deadline hits.

The surface: ``Cluster.submit(spec, tenant=..., priority=...,
deadline_s=...)`` → ``Cluster.run_all()`` → per-job ``RunResult``s
(same type ``repro_torch.api.run`` returns) plus the ``ClusterReport``.
``repro_torch.api.submit()/run_all()`` wrap a module-default cluster for
the two-line version.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.runtime.autoscale import (ClusterAutoscaleConfig,
                                           ClusterAutoscaler)
from repro_torch.runtime.billing import BillingMeter
from repro_torch.runtime.placement import (DRFSorter, PlacementConfig,
                                           ResourceVector, choose_class,
                                           spec_resource_vector,
                                           spec_worker_demand)
from repro_torch.runtime.pool import LambdaPool
from repro_torch.runtime.provider import (ClassedProvider, Provider,
                                          ProviderConfig)
from repro_torch.runtime.scheduler import Scheduler

POLICIES = ("fifo", "fair_share", "priority", "deadline", "drf")
ENGINES = ("heap", "scan")
RESERVATIONS = ("phase", "peak")

QUEUED, RUNNING, DONE, REJECTED = "queued", "running", "done", "rejected"
HELD = "held"          # DAG stage waiting on predecessors (not yet arrived)


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    policy: str = "fifo"          # fifo | fair_share | priority | deadline
    #                               | drf (Dominant Resource Fairness over
    #                               the (workers, mem, egress) vector)
    max_concurrent_jobs: int = 4  # job slots
    max_active_workers: int = 64  # aggregate worker capacity (the account
    #                               concurrency limit; autoscale ceiling)
    max_queued: Optional[int] = None   # admission control; None = unbounded
    share_provider: bool = True   # one warm pool for every job (the point)
    provider: ProviderConfig = ProviderConfig(enabled=True)
    autoscale: ClusterAutoscaleConfig = ClusterAutoscaleConfig()
    cold_base_s: float = 2.2      # greedy-dual's saved-latency calibration
    engine: str = "heap"          # heap (O(log jobs)/round) | scan (legacy
    #                               O(jobs)/round reference implementation)
    reservation: str = "phase"    # DAG admission: "phase" reserves each
    #                               stage's demand only while it runs;
    #                               "peak" charges the DAG's peak level
    #                               demand from first dispatch to DAG
    #                               completion (gang-style).  Identical
    #                               for plain single-stage jobs.
    # -- multi-resource capacity (vector mode) ------------------------------
    # Vector admission tracks (workers, mem_gb, egress_mbps) per job
    # (runtime/placement.spec_resource_vector) against the capacities
    # below.  It is ON when policy="drf" (DRF needs the accounting) or
    # when vector_capacity=True under any policy; otherwise everything
    # below is inert and the cluster is byte-identical to the scalar
    # worker-count model.
    vector_capacity: bool = False
    mem_capacity_gb: Optional[float] = None    # None: 3 GB x worker cap
    #                               (the paper's homogeneous 3008 MB pool)
    egress_capacity_mbps: Optional[float] = None   # None: unmetered
    # -- heterogeneous instance classes (default-off) -----------------------
    placement: PlacementConfig = PlacementConfig()

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")
        if self.engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {self.engine!r}")
        if self.reservation not in RESERVATIONS:
            raise ValueError(f"reservation must be one of {RESERVATIONS}, "
                             f"got {self.reservation!r}")


# spec_worker_demand lives in runtime/placement.py now (the scalar
# component of the full spec_resource_vector) and is re-exported here
# for its long-standing callers.

# ---------------------------------------------------------------------------
# Phase-structured jobs: a DAG of stages, each with its own parallelism
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage of a phase-structured job: an ``ExperimentSpec`` with
    its own worker demand, gated on the named predecessor stages."""
    name: str
    spec: Any                     # repro_torch.api.ExperimentSpec
    after: Tuple[str, ...] = ()   # predecessor stage names

    def __post_init__(self):
        object.__setattr__(self, "after", tuple(self.after))


@dataclasses.dataclass(frozen=True)
class DagSpec:
    """A phase-structured job: named stages + edges.  ``validate()``
    raises ``ValueError`` on duplicate/unknown stage names or cycles and
    returns the topological levels (level of a stage = longest
    predecessor chain); the DAG's *peak demand* is the maximum level-sum
    of stage worker demands — what ``reservation="peak"`` charges."""
    stages: Tuple[StageSpec, ...]
    label: str = ""

    def __post_init__(self):
        object.__setattr__(self, "stages", tuple(self.stages))

    def validate(self) -> List[List[str]]:
        if not self.stages:
            raise ValueError("DagSpec needs at least one stage")
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise ValueError(f"duplicate stage name(s) {dup}")
        known = set(names)
        for s in self.stages:
            unknown = [a for a in s.after if a not in known]
            if unknown:
                raise ValueError(f"stage {s.name!r} depends on unknown "
                                 f"stage(s) {unknown}")
            if s.name in s.after:
                raise ValueError(f"stage {s.name!r} depends on itself")
        # Kahn's algorithm, emitting topological levels
        deps = {s.name: set(s.after) for s in self.stages}
        levels: List[List[str]] = []
        remaining = list(names)
        while remaining:
            ready = [n for n in remaining if not deps[n]]
            if not ready:
                raise ValueError(f"cycle among stages {sorted(remaining)}")
            levels.append(ready)
            remaining = [n for n in remaining if n not in ready]
            for n in remaining:
                deps[n] -= set(ready)
        return levels

    def peak_demand(self) -> int:
        by_name = {s.name: s for s in self.stages}
        return max(sum(spec_worker_demand(by_name[n].spec) for n in level)
                   for level in self.validate())


@dataclasses.dataclass
class StageResult:
    """What a completed stage hands to its dependents: the consensus
    solution plus the full per-stage ``RunResult`` (trace, dollars,
    spec) — a dependent stage's problem receives these at dispatch via
    ``consume_stage_results({name: StageResult, ...})``."""
    stage: str
    z: np.ndarray
    result: Any                   # repro_torch.api.RunResult
    finished_at: float = 0.0

    @property
    def cost_usd(self) -> float:
        return float(self.result.cost_usd)


class DagRun:
    """Runtime state of one submitted DAG: the stage jobs, the
    dependency counters, the reservation ledger, and the per-stage
    result/billing rollup.  Returned by ``Cluster.submit_dag`` as the
    handle (``.stage_results``, ``.summary()``, ``.result_of(name)``)."""

    def __init__(self, dag: DagSpec, *, dag_id: int, tenant: str,
                 priority: int, deadline_s: Optional[float],
                 submit_at: float):
        self.spec = dag
        self.dag_id = dag_id
        self.label = dag.label or f"dag{dag_id}"
        self.tenant = tenant
        self.priority = priority
        self.deadline_s = deadline_s
        self.submit_at = submit_at
        self.levels = dag.validate()
        self.peak_demand = dag.peak_demand()
        self.jobs: Dict[str, "Job"] = {}
        self.stage_results: Dict[str, StageResult] = {}
        self.dependents: Dict[str, List[str]] = {s.name: []
                                                 for s in dag.stages}
        for s in dag.stages:
            for pred in s.after:
                self.dependents[pred].append(s.name)
        self.state = QUEUED
        self.reject_reason: Optional[str] = None
        self.n_unfinished = len(dag.stages)
        self.active_demand = 0    # summed demand of RUNNING stages
        self.reserved = 0         # cluster capacity currently charged
        #                           (peak mode: peak_demand while any
        #                           stage is unfinished after first
        #                           dispatch; phase mode: unused)

    # -- lifecycle hooks called by the cluster ------------------------------

    def stage_started(self, job: "Job", reservation: str):
        self.active_demand += job.worker_demand
        if reservation == "peak" and not self.reserved:
            self.reserved = self.peak_demand
        self.state = RUNNING

    def stage_finished(self, job: "Job", reservation: str
                       ) -> Tuple[List["Job"], int]:
        """Record the stage's result, release dependents whose last
        predecessor this was, and return (released stage jobs, worker
        reservation freed by this completion)."""
        self.active_demand -= job.worker_demand
        self.n_unfinished -= 1
        self.stage_results[job.stage] = StageResult(
            stage=job.stage, z=np.asarray(job.result.z), result=job.result,
            finished_at=job.finished_at)
        released = []
        for dep in self.dependents[job.stage]:
            dj = self.jobs[dep]
            dj.deps_remaining -= 1
            if dj.deps_remaining == 0:
                dj.state = QUEUED
                dj.submit_at = max(
                    [dj.submit_at]
                    + [self.stage_results[p].finished_at
                       for p in dj.stage_after])
                released.append(dj)
        if reservation == "peak":
            freed = self.reserved if self.n_unfinished == 0 else 0
            if self.n_unfinished == 0:
                self.reserved = 0
        else:
            freed = job.worker_demand
        if self.n_unfinished == 0:
            self.state = DONE
        return released, freed

    # -- the handle's reporting surface -------------------------------------

    @property
    def uid(self) -> str:
        """Unique report key (labels may repeat across submissions)."""
        return f"{self.dag_id}:{self.label}"

    @property
    def finished_at(self) -> float:
        return max((j.finished_at for j in self.jobs.values()
                    if j.state == DONE), default=0.0)

    @property
    def latency_s(self) -> float:
        """DAG submit → last stage completion, in cluster sim time."""
        return self.finished_at - self.submit_at

    @property
    def total_cost_usd(self) -> float:
        return sum(sr.cost_usd for sr in self.stage_results.values())

    @property
    def deadline_met(self) -> Optional[bool]:
        if self.deadline_s is None:
            return None
        return bool(self.latency_s <= self.deadline_s)

    def result_of(self, stage: str) -> StageResult:
        return self.stage_results[stage]

    def summary(self) -> dict:
        out = {"dag_id": self.dag_id, "label": self.label,
               "tenant": self.tenant, "state": self.state,
               "n_stages": len(self.spec.stages),
               "peak_demand": self.peak_demand,
               "submit_at": self.submit_at}
        if self.state == REJECTED:
            out["reject_reason"] = self.reject_reason
            return out
        out.update({
            "finished_at": float(self.finished_at),
            "latency_s": float(self.latency_s),
            "total_cost_usd": float(self.total_cost_usd),
            "deadline_met": self.deadline_met,
            "stages": {name: {
                "latency_s": float(j.latency_s),
                "exec_s": float(j.exec_s),
                "rounds": j.rounds,
                "cost_usd": (float(j.result.cost_usd)
                             if j.result else None),
            } for name, j in self.jobs.items() if j.state == DONE},
        })
        return out


@dataclasses.dataclass
class Job:
    """One submitted experiment and its lifecycle bookkeeping."""
    job_id: int
    spec: Any                     # repro_torch.api.ExperimentSpec
    tenant: str
    priority: int = 0
    deadline_s: Optional[float] = None    # latency budget from submit
    submit_at: float = 0.0
    state: str = QUEUED
    reject_reason: Optional[str] = None
    # filled at dispatch / completion
    problem: Any = None
    scheduler: Optional[Scheduler] = None
    started_at: float = 0.0
    finished_at: float = 0.0
    rounds: int = 0
    max_rounds: int = 0
    service_ws: float = 0.0       # worker-seconds consumed (fair share)
    result: Any = None            # repro_torch.api.RunResult
    # DAG-stage bookkeeping (all None/empty for plain jobs)
    dag: Optional[DagRun] = None
    stage: Optional[str] = None
    stage_after: Tuple[str, ...] = ()
    deps_remaining: int = 0
    # placement-assigned instance class (None on the homogeneous path)
    instance_class: Optional[str] = None
    _rvec: Any = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n_workers(self) -> int:
        return self.spec.scheduler.n_workers

    @property
    def worker_demand(self) -> int:
        """The capacity admission must RESERVE: the starting fleet, or
        the per-job autoscaler's ceiling when the spec enables one — a
        job's mid-run rescale() never consults the cluster, so the
        cluster budgets its worst case up front."""
        return spec_worker_demand(self.spec)

    @property
    def resources(self) -> ResourceVector:
        """The job's demand vector (workers, mem_gb, egress_mbps) —
        derived once from the spec and cached."""
        if self._rvec is None:
            self._rvec = spec_resource_vector(self.spec)
        return self._rvec

    @property
    def latency_s(self) -> float:
        """Submit → finish, in cluster sim time (queue wait included)."""
        return self.finished_at - self.submit_at

    @property
    def exec_s(self) -> float:
        """Dispatch → finish: the job's own execution span."""
        return self.finished_at - self.started_at

    @property
    def slowdown(self) -> float:
        """Latency inflation over the job's own execution span (≥ 1;
        1.0 = never waited for capacity)."""
        return self.latency_s / self.exec_s if self.exec_s > 0 else 1.0

    @property
    def deadline_met(self) -> Optional[bool]:
        if self.deadline_s is None:
            return None
        return bool(self.latency_s <= self.deadline_s)

    def summary(self) -> dict:
        out = {
            "job_id": self.job_id, "tenant": self.tenant,
            "label": getattr(self.spec, "label", ""),
            "problem": getattr(self.spec, "problem", ""),
            "state": self.state, "priority": self.priority,
            "deadline_s": self.deadline_s, "submit_at": self.submit_at,
        }
        if self.state == REJECTED:
            out["reject_reason"] = self.reject_reason
            return out
        out.update({
            "started_at": float(self.started_at),
            "finished_at": float(self.finished_at),
            "latency_s": float(self.latency_s),
            "exec_s": float(self.exec_s),
            "slowdown": float(self.slowdown), "rounds": self.rounds,
            "deadline_met": self.deadline_met,
            "cost_usd": (self.result.cost_usd if self.result else None),
            "converged": (self.result.converged if self.result else None),
        })
        if self.instance_class is not None:
            out["instance_class"] = self.instance_class
        if self.dag is not None:
            out["dag"] = self.dag.label
            out["stage"] = self.stage
        return out


@dataclasses.dataclass
class ClusterReport:
    """The cluster-level rollup ``run_all`` returns next to the per-job
    results: latency percentiles, pool economics, tenant fairness."""
    policy: str
    n_jobs: int
    n_rejected: int
    makespan_s: float             # first admission → last completion
    p50_latency_s: float
    p95_latency_s: float
    p99_latency_s: float
    warm_hit_rate: float          # launches that landed on a warm sandbox
    total_cost_usd: float
    tenant_cost_usd: Dict[str, float]
    tenant_mean_latency_s: Dict[str, float]
    tenant_slowdown: Dict[str, float]     # mean latency/exec inflation
    deadlines_met: int
    deadlines_missed: int
    final_worker_cap: int
    rescales: List
    # phase-structured (DAG) jobs — zeros when none were submitted
    n_dags: int = 0
    dag_p50_latency_s: float = 0.0
    dag_p95_latency_s: float = 0.0
    dag_cost_usd: Dict[str, float] = dataclasses.field(default_factory=dict)
    # vector (DRF) fairness — inert defaults outside vector mode.
    # tenant_dominant_share is each tenant's TIME-AVERAGED dominant
    # share over that tenant's own active window (informational);
    # vector_fairness_ratio is the time-average of the INSTANTANEOUS
    # max/min dominant-share imbalance across allocated tenants over
    # the cluster's span (1.0 = even service at every instant) — the
    # quantity DRF's serve-the-lowest rule bounds at each dispatch.
    tenant_dominant_share: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    vector_fairness_ratio: float = 1.0
    # heterogeneous placement rollups — empty on the homogeneous path
    class_jobs: Dict[str, int] = dataclasses.field(default_factory=dict)
    class_cost_usd: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    class_warm_hit_rate: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    class_keepalive_usd: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    final_class_caps: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def deadline_attainment(self) -> Optional[float]:
        """Fraction of deadline-carrying completed jobs that met their
        deadline (the SLO-attainment headline); None when no completed
        job carried a deadline."""
        total = self.deadlines_met + self.deadlines_missed
        return self.deadlines_met / total if total else None

    @property
    def fairness_ratio(self) -> float:
        """max/min tenant slowdown — 1.0 is perfectly even service."""
        vals = [v for v in self.tenant_slowdown.values() if v > 0]
        return max(vals) / min(vals) if vals else 1.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fairness_ratio"] = self.fairness_ratio
        d["deadline_attainment"] = self.deadline_attainment
        return d


class Cluster:
    """Submit many jobs, run them to completion over one shared pool.
    Problems the cluster builds live on ``device``; without a card the
    default raises."""

    def __init__(self, cfg: ClusterConfig = ClusterConfig(), *,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        # heterogeneous placement: one warm pool PER instance class
        # (ClassedProvider) replaces the single shared provider
        self.classed: Optional[ClassedProvider] = None
        if cfg.placement.enabled:
            self.classed = ClassedProvider(
                cfg.placement.classes,
                base_cfg=(cfg.provider if cfg.provider.enabled
                          else dataclasses.replace(cfg.provider,
                                                   enabled=True)))
        self.provider: Optional[Provider] = (
            Provider(cfg.provider, cold_base_s=cfg.cold_base_s)
            if (cfg.share_provider and cfg.provider.enabled
                and self.classed is None) else None)
        self.jobs: List[Job] = []
        self.worker_cap = (min(cfg.autoscale.min_workers,
                               cfg.max_active_workers)
                           if cfg.autoscale.policy != "off"
                           else cfg.max_active_workers)
        self.autoscaler = (ClusterAutoscaler(cfg.autoscale)
                           if cfg.autoscale.policy != "off" else None)
        self.ledgers: Dict[str, BillingMeter] = {}
        self._dags: List[DagRun] = []
        self._ran = False
        # -- vector (multi-resource) mode: DRF accounting + capacity ---------
        self._vector_mode = cfg.policy == "drf" or cfg.vector_capacity
        mem_cap = (cfg.mem_capacity_gb if cfg.mem_capacity_gb is not None
                   else 3.0 * cfg.max_active_workers)
        egress_cap = (cfg.egress_capacity_mbps
                      if cfg.egress_capacity_mbps is not None
                      else float("inf"))
        self.total_vec = np.array([float(cfg.max_active_workers),
                                   float(mem_cap), float(egress_cap)])
        # the sorter does double duty: DRF *ordering* when policy="drf",
        # and allocated-vector *accounting* (capacity checks + the
        # fairness integrals) whenever vector mode is on
        self.drf: Optional[DRFSorter] = (
            DRFSorter(ResourceVector(*self.total_vec))
            if self._vector_mode else None)
        self._reserved_vec = np.zeros(3)
        # dominant-share time integrals: share x seconds per tenant,
        # advanced at every allocation change (dispatch/finish)
        self._share_int: Dict[str, float] = {}
        self._imb_int = 0.0
        self._share_clock = 0.0
        self._share_start: Optional[float] = None
        # -- per-class usage / ledgers (placement mode) ----------------------
        self._class_used: Dict[str, int] = {}
        self._class_jobs: Dict[str, int] = {}
        self.class_ledgers: Dict[str, BillingMeter] = {}
        if self.classed is not None:
            for name in self.classed.classes:
                self._class_used[name] = 0
                self._class_jobs[name] = 0

    # -- admission ----------------------------------------------------------

    def submit(self, spec, *, tenant: str = "default", priority: int = 0,
               deadline_s: Optional[float] = None, at: float = 0.0,
               problem=None) -> Job:
        """Admission control + enqueue.  Returns the Job handle (state
        ``queued`` or ``rejected`` — a structurally unplaceable spec or
        a full backlog is refused HERE, not discovered mid-run).
        ``problem`` optionally reuses a built instance (shared shard
        caches across a sweep, exactly like ``api.run``); its own device
        then holds."""
        if self._ran:
            raise RuntimeError("run_all() already ran — a late submit "
                               "would be stranded; build a fresh Cluster "
                               "per batch")
        job = Job(job_id=len(self.jobs), spec=spec, tenant=tenant,
                  priority=priority, deadline_s=deadline_s, submit_at=at,
                  problem=problem)
        # the hard placement ceiling: even an autoscaled cap is clamped
        # to max_active_workers at admission, so a fleet beyond it could
        # never dispatch — refuse it now instead of deadlocking later
        cap_ceiling = self.cfg.max_active_workers
        if spec.scheduler.mode == "async_":
            job.state = REJECTED
            job.reject_reason = ("async_ jobs pace themselves per-arrival "
                                 "and cannot be round-interleaved; run "
                                 "them via repro_torch.api.run")
        elif job.worker_demand > cap_ceiling:
            job.state = REJECTED
            job.reject_reason = (f"needs {job.worker_demand} workers "
                                 f"(fleet or per-job autoscale ceiling) "
                                 f"but the cluster caps at {cap_ceiling}")
        elif self._vector_mode and (
                job.resources.mem_gb > self.total_vec[1] + 1e-9
                or job.resources.egress_mbps > self.total_vec[2] + 1e-9):
            job.state = REJECTED
            job.reject_reason = (
                f"vector demand {job.resources.to_dict()} exceeds the "
                f"cluster capacity (workers={self.total_vec[0]:g}, "
                f"mem_gb={self.total_vec[1]:g}, "
                f"egress_mbps={self.total_vec[2]:g})")
        elif (self.classed is not None
              and (job.resources.mem_gb / max(job.worker_demand, 1)
                   > self.cfg.placement.max_mem_gb() + 1e-9)):
            job.state = REJECTED
            job.reject_reason = (
                f"needs {job.resources.mem_gb / max(job.worker_demand, 1):.2f}"
                f" GB per sandbox but the largest instance class offers "
                f"{self.cfg.placement.max_mem_gb():.2f} GB")
        elif (self.cfg.max_queued is not None
              and sum(j.state == QUEUED for j in self.jobs)
              >= self.cfg.max_queued):
            job.state = REJECTED
            job.reject_reason = (f"backlog full "
                                 f"(max_queued={self.cfg.max_queued})")
        self.jobs.append(job)
        return job

    def submit_dag(self, dag: DagSpec, *, tenant: str = "default",
                   priority: int = 0, deadline_s: Optional[float] = None,
                   at: float = 0.0, problems: Optional[Dict[str, Any]] = None
                   ) -> DagRun:
        """Submit a phase-structured job: every stage becomes a Job,
        root stages queued at ``at``, downstream stages ``held`` until
        their last predecessor completes (release re-queues them at that
        instant).  Validation errors (cycles, unknown refs, duplicates)
        raise ``ValueError``; a structurally unplaceable DAG — any stage
        (or, under ``reservation="peak"``, the peak level demand) beyond
        the cluster's worker ceiling, or an ``async_`` stage — is
        REJECTED whole.  ``problems`` optionally maps stage name → a
        pre-built problem instance.  Returns the ``DagRun`` handle."""
        if self._ran:
            raise RuntimeError("run_all() already ran — a late submit "
                               "would be stranded; build a fresh Cluster "
                               "per batch")
        run = DagRun(dag, dag_id=len(self._dags), tenant=tenant,
                     priority=priority, deadline_s=deadline_s,
                     submit_at=at)       # validates (raises ValueError)
        cap_ceiling = self.cfg.max_active_workers
        reason = None
        for s in dag.stages:
            if s.spec.scheduler.mode == "async_":
                reason = (f"stage {s.name!r} is async_ — async jobs pace "
                          "themselves per-arrival and cannot be "
                          "round-interleaved; run them via "
                          "repro_torch.api.run")
                break
            if spec_worker_demand(s.spec) > cap_ceiling:
                reason = (f"stage {s.name!r} needs "
                          f"{spec_worker_demand(s.spec)} workers (fleet "
                          f"or per-job autoscale ceiling) but the "
                          f"cluster caps at {cap_ceiling}")
                break
            rv = (spec_resource_vector(s.spec)
                  if (self._vector_mode or self.classed is not None)
                  else None)
            if self._vector_mode and (
                    rv.mem_gb > self.total_vec[1] + 1e-9
                    or rv.egress_mbps > self.total_vec[2] + 1e-9):
                reason = (f"stage {s.name!r} vector demand "
                          f"{rv.to_dict()} exceeds the cluster capacity")
                break
            if (self.classed is not None
                    and (rv.mem_gb / max(spec_worker_demand(s.spec), 1)
                         > self.cfg.placement.max_mem_gb() + 1e-9)):
                reason = (f"stage {s.name!r} needs more GB per sandbox "
                          f"than the largest instance class offers")
                break
        if (reason is None and self.cfg.reservation == "peak"
                and run.peak_demand > cap_ceiling):
            reason = (f"peak level demand {run.peak_demand} exceeds the "
                      f"cluster cap {cap_ceiling} under "
                      f'reservation="peak" (use "phase" or shrink the '
                      "fan-out)")
        if (reason is None and self.cfg.max_queued is not None
                and sum(j.state == QUEUED for j in self.jobs)
                >= self.cfg.max_queued):
            reason = f"backlog full (max_queued={self.cfg.max_queued})"
        for s in dag.stages:
            job = Job(job_id=len(self.jobs), spec=s.spec, tenant=tenant,
                      priority=priority, submit_at=at,
                      problem=(problems or {}).get(s.name),
                      dag=run, stage=s.name, stage_after=s.after,
                      deps_remaining=len(s.after))
            if reason is not None:
                job.state = REJECTED
                job.reject_reason = reason
            elif s.after:
                job.state = HELD
            run.jobs[s.name] = job
            self.jobs.append(job)
        if reason is not None:
            run.state = REJECTED
            run.reject_reason = reason
        self._dags.append(run)
        return run

    # -- the job-scheduling policy -------------------------------------------

    def _tenant_service(self) -> Dict[str, float]:
        svc: Dict[str, float] = {}
        for j in self.jobs:
            if j.state in (RUNNING, DONE):
                svc[j.tenant] = svc.get(j.tenant, 0.0) + j.service_ws
        return svc

    def _dispatch_order(self, eligible: List[Job]) -> List[Job]:
        p = self.cfg.policy
        if p == "fifo":
            key = lambda j: (j.submit_at, j.job_id)
        elif p == "priority":
            key = lambda j: (-j.priority, j.submit_at, j.job_id)
        elif p == "deadline":
            key = lambda j: (j.submit_at + (j.deadline_s
                                            if j.deadline_s is not None
                                            else float("inf")),
                             j.submit_at, j.job_id)
        elif p == "drf":
            # least dominant share first (live sorter state — callers
            # that dispatch mid-iteration must re-sort; see _admit)
            key = lambda j: (self.drf.dominant_share(j.tenant),
                             j.submit_at, j.job_id)
        else:                                           # fair_share
            svc = self._tenant_service()
            key = lambda j: (svc.get(j.tenant, 0.0), j.submit_at, j.job_id)
        return sorted(eligible, key=key)

    # -- dispatch / completion ------------------------------------------------

    def _active_workers(self) -> int:
        """Live fleet count across running jobs (reporting; tracks
        mid-run rescales through each scheduler's live cfg)."""
        return sum(j.scheduler.cfg.n_workers for j in self.jobs
                   if j.state == RUNNING)

    def _reserved_workers(self) -> int:
        """Capacity admission has committed: worst-case demand of every
        running job (>= the live count, so the cap holds even while a
        per-job autoscaler resizes fleets without asking the cluster).
        Under ``reservation="peak"`` a DAG's stages are covered by the
        DAG-level peak reservation instead of per-stage demand."""
        total = 0
        for j in self.jobs:
            if j.state != RUNNING:
                continue
            if j.dag is None or self.cfg.reservation == "phase":
                total += j.worker_demand
        if self.cfg.reservation == "peak":
            total += sum(d.reserved for d in self._dags)
        return total

    def _admission_delta(self, job: Job) -> int:
        """Workers this dispatch would ADD to the reserved total: the
        job's own demand, except a peak-reserved DAG charges its whole
        peak at the first stage dispatch and 0 for every stage after."""
        if job.dag is None or self.cfg.reservation == "phase":
            return job.worker_demand
        return 0 if job.dag.reserved else job.dag.peak_demand

    def _dag_can_place(self, job: Job) -> bool:
        """Peak mode's per-DAG budget: concurrently running stages of
        one DAG may not exceed the reservation the DAG holds (always
        satisfiable — a single stage's demand never exceeds the peak
        level sum, so no new deadlock is introduced)."""
        if job.dag is None or self.cfg.reservation != "peak":
            return True
        return (job.dag.active_demand + job.worker_demand
                <= job.dag.peak_demand)

    # -- vector accounting / placement (inert outside the new modes) ---------

    def _integrate_shares(self, t: float):
        """Advance the dominant-share time integrals to ``t``: each
        tenant accrues (instantaneous dominant share) x dt since the
        last allocation change, and the cluster accrues (instantaneous
        max/min dominant share over allocated tenants) x dt — the
        imbalance integral behind ``vector_fairness_ratio``.  The event
        clock is clamped monotone — a completion admitting at
        ``finished_at`` behind the frontier integrates zero span, in
        BOTH engines."""
        t = max(t, self._share_clock)
        dt = t - self._share_clock
        # nothing accrues before the first dispatch starts the span
        if dt > 0.0 and self.drf is not None and self._share_start is not None:
            pos = []
            for tenant in self.drf.allocations:
                share = self.drf.dominant_share(tenant)
                if share > 0.0:
                    pos.append(share)
                    self._share_int[tenant] = (
                        self._share_int.get(tenant, 0.0) + share * dt)
            # one allocated tenant (or none) is trivially balanced
            imb = max(pos) / min(pos) if len(pos) >= 2 else 1.0
            self._imb_int += imb * dt
        self._share_clock = t

    def _choose_class(self, job: Job):
        """Placement decision for one dispatch: the per-class headroom
        is the static class cap clamped by the (possibly autoscaled)
        aggregate cap, minus the workers the class already hosts."""
        p = self.cfg.placement
        per_worker = job.resources.mem_gb / max(job.worker_demand, 1)
        cap_now = min(self.worker_cap, self.cfg.max_active_workers)
        caps = p.class_caps or {}
        headroom = {n: (min(caps.get(n, self.cfg.max_active_workers),
                            cap_now) - self._class_used[n])
                    for n in self.classed.classes}
        warm_idle = {n: len(prov.idle)
                     for n, prov in self.classed.providers.items()}
        return choose_class(p, mem_gb_per_worker=per_worker,
                            workers=job.worker_demand,
                            warm_idle=warm_idle, headroom=headroom)

    def _place_check(self, job: Job, reserved_ws: int, n_running: int):
        """The admission gate BOTH engines run, in this order: DAG
        budget, scalar worker capacity (with the empty-cluster
        demand_grow branch), vector (mem/egress) capacity, instance-
        class choice.  Returns (ok, worker delta, chosen class)."""
        if not self._dag_can_place(job):
            return False, 0, None       # its own DAG's budget is busy
        delta = self._admission_delta(job)
        if delta and reserved_ws + delta > min(
                self.worker_cap, self.cfg.max_active_workers):
            # capacity follows demand: an autoscaled cluster sitting
            # EMPTY below a placeable job's demand grows to meet it
            # (the queue-depth policy only shapes the cap under load;
            # it must never starve the head of the queue)
            if (n_running == 0 and self.autoscaler is not None
                    and delta <= self.cfg.max_active_workers):
                old_cap = self.worker_cap
                self.worker_cap = max(old_cap, delta)
                self.autoscaler.decisions.append(
                    (-1, old_cap, self.worker_cap, "demand_grow"))
            else:
                return False, delta, None
        if self._vector_mode:
            vec = job.resources.as_array()
            free = self.total_vec - self._reserved_vec
            if (vec[1] > free[1] + 1e-9) or (vec[2] > free[2] + 1e-9):
                return False, delta, None
        klass = None
        if self.classed is not None:
            klass = self._choose_class(job)
            if klass is None:
                return False, delta, None
        return True, delta, klass

    def _dispatch(self, job: Job, at: float, klass=None):
        """Build the job's problem (on the cluster's device, unless it
        was handed one) and its scheduler on a pool backed by the shared
        provider (or the chosen class's warm pool), and start its clock
        at the admission instant."""
        from repro_torch import problems                # lazy: no cycle
        if job.problem is None:
            job.problem = problems.make(job.spec.problem, device=self.device,
                                        **dict(job.spec.problem_kwargs))
        if job.dag is not None:
            job.dag.stage_started(job, self.cfg.reservation)
            inputs = {name: job.dag.stage_results[name]
                      for name in job.stage_after}
            if inputs and hasattr(job.problem, "consume_stage_results"):
                job.problem.consume_stage_results(inputs)
        scfg = job.spec.scheduler
        provider = self.provider
        if klass is not None:
            # the class re-derives the job's sandbox constants: cold
            # provisioning and the billed memory/rate follow the tier
            scfg = dataclasses.replace(
                scfg,
                pool=dataclasses.replace(scfg.pool,
                                         cold_base_s=klass.cold_base_s),
                billing=dataclasses.replace(
                    scfg.billing, mem_gb=klass.mem_gb,
                    gb_second_usd=klass.gb_second_usd))
            provider = self.classed.provider_for(klass.name)
            job.instance_class = klass.name
            self._class_used[klass.name] += job.worker_demand
        pool = LambdaPool(scfg.pool, provider=provider, tenant=job.tenant)
        job.scheduler = Scheduler(job.problem, scfg,
                                  pool=pool, start_time=at)
        if self._vector_mode:
            self._integrate_shares(at)
            if self._share_start is None:
                self._share_start = at
            vec = job.resources.as_array()
            self.drf.allocate(job.tenant, vec)
            self._reserved_vec += vec
        job.started_at = at
        job.max_rounds = (job.spec.max_rounds
                          or job.spec.scheduler.admm.max_iters)
        job.state = RUNNING

    def _admit(self, now: float):
        """Fill free capacity from the queue, in policy order."""
        eligible = [j for j in self.jobs
                    if j.state == QUEUED and j.submit_at <= now]
        if self.cfg.policy == "drf":
            # dominant shares CHANGE at every dispatch, so DRF re-picks
            # the minimum under the LIVE shares after each placement
            # (the heap engine's head comparison does the same); a job
            # skipped for capacity stays skipped for this call
            blocked: set = set()
            while True:
                running = sum(j.state == RUNNING for j in self.jobs)
                if running >= self.cfg.max_concurrent_jobs:
                    return
                cands = [j for j in eligible
                         if j.state == QUEUED and j.job_id not in blocked]
                if not cands:
                    return
                job = min(cands,
                          key=lambda j: (self.drf.dominant_share(j.tenant),
                                         j.submit_at, j.job_id))
                ok, _, klass = self._place_check(
                    job, self._reserved_workers(), running)
                if ok:
                    self._dispatch(job, max(now, job.submit_at),
                                   klass=klass)
                else:
                    blocked.add(job.job_id)
            return
        for job in self._dispatch_order(eligible):
            running = sum(j.state == RUNNING for j in self.jobs)
            if running >= self.cfg.max_concurrent_jobs:
                return
            ok, _, klass = self._place_check(
                job, self._reserved_workers(), running)
            if not ok:
                continue                # try a smaller job further down
            self._dispatch(job, max(now, job.submit_at), klass=klass)

    def _finish(self, job: Job) -> Tuple[List[Job], int]:
        """Retire the fleet (sandboxes → shared warm pool), build the
        RunResult, roll the meter into the tenant's ledger.  For a DAG
        stage, record its StageResult and release dependents whose last
        predecessor this was.  Returns (released stage jobs, reserved
        workers freed) — the heap engine needs both; the scan engine
        recomputes and ignores them."""
        from repro_torch.api import result_from_scheduler   # lazy: no cycle
        sched = job.scheduler
        job.finished_at = sched.sim_time
        job.state = DONE
        sched.pool.retire(list(sched.pool.workers), at=sched.sim_time)
        job.result = result_from_scheduler(
            job.spec, job.problem, sched, wall_s=0.0)
        ledger = self.ledgers.get(job.tenant)
        if ledger is None:
            ledger = self.ledgers[job.tenant] = BillingMeter(
                sched.meter.cfg)
        ledger.absorb(sched.meter)
        if self._vector_mode:
            # recover-on-completion: integrate the span the allocation
            # covered, then return the vector to the pool (Mesos
            # unallocated semantics, clamped at zero)
            self._integrate_shares(job.finished_at)
            vec = job.resources.as_array()
            self.drf.unallocated(job.tenant, vec)
            self._reserved_vec = np.maximum(self._reserved_vec - vec, 0.0)
        if job.instance_class is not None:
            self._class_used[job.instance_class] -= job.worker_demand
            self._class_jobs[job.instance_class] += 1
            cl = self.class_ledgers.get(job.instance_class)
            if cl is None:
                cl = self.class_ledgers[job.instance_class] = BillingMeter(
                    sched.meter.cfg)
            cl.absorb(sched.meter)
        if job.dag is not None:
            return job.dag.stage_finished(job, self.cfg.reservation)
        return [], job.worker_demand

    def _autoscale_depth(self, queued_jobs) -> int:
        """The demand signal the cluster autoscaler sees.  Scalar mode:
        every arrived queued job.  Vector mode with
        ``autoscale.blocked_only`` (default): only jobs whose mem/egress
        demand FITS the free vector capacity — jobs a bigger worker cap
        could actually admit.  A memory-saturated, worker-idle cluster
        therefore reports zero demand instead of triggering a spurious
        grow (tests/test_drf.py pins this)."""
        jobs = list(queued_jobs)
        if not (self._vector_mode and self.cfg.autoscale.blocked_only):
            return len(jobs)
        free = self.total_vec - self._reserved_vec
        n = 0
        for j in jobs:
            vec = j.resources.as_array()
            if vec[1] <= free[1] + 1e-9 and vec[2] <= free[2] + 1e-9:
                n += 1
        return n

    def _heap_autoscale_depth(self) -> int:
        """Heap-engine demand signal: the O(1) arrived counter on the
        scalar path; the filtered count over the policy queues in
        vector mode (same job set, so scan == heap)."""
        if not (self._vector_mode and self.cfg.autoscale.blocked_only):
            return self._n_arrived

        def _queued():
            if self.cfg.policy in ("fair_share", "drf"):
                for h in self._tenant_q.values():
                    for _, _, j in h:
                        yield j
            else:
                for _, _, j in self._queued_q:
                    yield j
        return self._autoscale_depth(_queued())

    def _observe_autoscale(self, queue_depth: int,
                           active_workers: Optional[int] = None):
        if self.autoscaler is None:
            return
        new_cap = self.autoscaler.decide(
            cap=self.worker_cap, queue_depth=queue_depth,
            active_workers=(self._active_workers()
                            if active_workers is None else active_workers))
        if new_cap is not None:
            self.worker_cap = min(new_cap, self.cfg.max_active_workers)

    # -- the event loop -------------------------------------------------------

    def run_all(self, on_job_done=None) -> "ClusterResult":
        """Drive every submitted job to completion, event-driven: always
        step the running job whose sim clock trails furthest, admit from
        the queue whenever capacity frees.  Returns a ``ClusterResult``
        (per-job ``RunResult``s + the ``ClusterReport``).

        Two engines compute the SAME schedule (``ClusterConfig.engine``):
        ``heap`` pops the trailing job from a (sim_time, job_id) heap in
        O(log jobs) and keeps arrivals / the policy queue / all capacity
        counters as incremental structures — the 10k-job path; ``scan``
        is the original O(jobs)-per-round reference implementation kept
        for differential testing (``tests/test_cluster_heap.py`` pins
        heap == scan report-for-report)."""
        if self._ran:
            raise RuntimeError("run_all() already ran; build a fresh "
                               "Cluster per batch")
        self._ran = True
        if self.cfg.engine == "heap":
            return self._run_all_heap(on_job_done)
        return self._run_all_scan(on_job_done)

    def _run_all_scan(self, on_job_done=None) -> "ClusterResult":
        clock = 0.0
        while True:
            queued = [j for j in self.jobs if j.state == QUEUED]
            running = [j for j in self.jobs if j.state == RUNNING]
            if not queued and not running:
                break
            self._admit(clock)
            running = [j for j in self.jobs if j.state == RUNNING]
            if not running:
                # nothing placeable now: jump to the next arrival
                future = [j.submit_at for j in queued
                          if j.submit_at > clock]
                if not future:
                    raise RuntimeError(
                        "deadlock: queued jobs but none placeable — "
                        "check max_active_workers vs job fleet sizes")
                clock = min(future)
                continue
            job = min(running, key=lambda j: (j.scheduler.sim_time,
                                              j.job_id))
            m, done = job.scheduler.step()
            job.rounds += 1
            job.service_ws = (job.service_ws
                              + m.round_wall_s * m.n_workers)
            clock = max(clock, job.scheduler.sim_time)
            if done or job.rounds >= job.max_rounds:
                self._finish(job)
                if on_job_done:
                    on_job_done(job)
                # completion frees capacity AT the job's finish instant
                self._admit(job.finished_at)
            # demand = jobs that have actually ARRIVED and are waiting
            # (future submit_at entries are not backlog yet)
            self._observe_autoscale(self._autoscale_depth(
                j for j in self.jobs
                if j.state == QUEUED and j.submit_at <= clock))
        return ClusterResult(jobs=list(self.jobs), report=self._report(),
                             dags=list(self._dags))

    # -- the event-heap engine ------------------------------------------------
    #
    # Firmament-batch-mode style (SNIPPETS.md snippets 2-3): three
    # incremental structures instead of per-round full scans —
    #
    #   _arrivals   heap of (submit_at, job_id, job): not-yet-arrived
    #               submissions; drained into the policy queue as the
    #               frontier clock passes them
    #   policy queue  arrived-but-undispatched jobs in dispatch order
    #               (one heap keyed by the static policy key, or
    #               per-tenant (submit_at, job_id) heaps for fair_share
    #               whose heads are compared under the live service
    #               counters)
    #   _run_heap   heap of (sim_time, job_id, job): the next round
    #               completion of every running job; popping the min IS
    #               the scan loop's trailing-job selection
    #
    # plus O(1) counters for everything the scan loop recomputed per
    # round (_n_running, _reserved_ws, _live_ws, _tenant_svc).  A single
    # unified time-ordered event heap would NOT be byte-identical: the
    # scan loop admits every arrival at or before the frontier clock in
    # POLICY order, not in global time order, so arrivals must stay a
    # separate structure drained at the frontier.

    def _policy_key(self, job: Job):
        """The static dispatch key (non-fair_share policies) — exactly
        ``_dispatch_order``'s sort key."""
        p = self.cfg.policy
        if p == "priority":
            return (-job.priority, job.submit_at, job.job_id)
        if p == "deadline":
            return (job.submit_at + (job.deadline_s
                                     if job.deadline_s is not None
                                     else float("inf")),
                    job.submit_at, job.job_id)
        return (job.submit_at, job.job_id)                # fifo

    def _drain_arrivals(self, now: float):
        """Move every arrival with ``submit_at <= now`` into the policy
        queue (state is QUEUED throughout — this is a bookkeeping move,
        not a state change)."""
        arr = self._arrivals
        while arr and arr[0][0] <= now:
            _, jid, job = heapq.heappop(arr)
            if self.cfg.policy in ("fair_share", "drf"):
                # tenant-ranked policies: per-tenant submit-ordered
                # heaps whose heads are compared under the LIVE rank
                # (service counters / dominant shares)
                heapq.heappush(
                    self._tenant_q.setdefault(job.tenant, []),
                    (job.submit_at, jid, job))
            else:
                heapq.heappush(self._queued_q,
                               (self._policy_key(job), jid, job))
            self._n_arrived += 1

    def _try_place(self, job: Job, now: float) -> bool:
        """One admission attempt: the capacity check (with the
        empty-cluster demand_grow branch) + dispatch + counter updates.
        Returns False when the job must stay queued (the scan loop's
        ``continue``: try a smaller job further down)."""
        ok, delta, klass = self._place_check(job, self._reserved_ws,
                                             self._n_running)
        if not ok:
            return False
        self._dispatch(job, max(now, job.submit_at), klass=klass)
        self._n_arrived -= 1
        self._n_running += 1
        self._reserved_ws += delta
        live = job.scheduler.cfg.n_workers
        self._live_of[job.job_id] = live
        self._live_ws += live
        heapq.heappush(self._run_heap,
                       (job.scheduler.sim_time, job.job_id, job))
        return True

    def _admit_heap(self, now: float):
        """Heap-engine ``_admit``: same policy-order traversal with the
        same skip semantics, popping from the incremental queue.  Jobs
        skipped for capacity — or not yet eligible because a mid-loop
        completion admits at ``finished_at < clock`` — are stashed and
        restored, preserving their queue position."""
        self._drain_arrivals(now)
        if self._n_arrived == 0:
            return
        if self.cfg.policy in ("fair_share", "drf"):
            self._admit_fair(now)
            return
        q, stash = self._queued_q, []
        fifo = self.cfg.policy == "fifo"
        try:
            while q:
                if self._n_running >= self.cfg.max_concurrent_jobs:
                    return
                key, jid, job = heapq.heappop(q)
                if job.submit_at > now:
                    stash.append((key, jid, job))
                    if fifo:
                        return   # fifo key IS submit order: rest is later
                    continue
                if not self._try_place(job, now):
                    stash.append((key, jid, job))
        finally:
            for entry in stash:
                heapq.heappush(q, entry)

    def _tenant_rank(self, tenant: str) -> float:
        """The live tenant-priority term of the dispatch key:
        accumulated worker-seconds for fair_share, the DRF dominant
        share for drf.  Lower serves first in both."""
        if self.cfg.policy == "drf":
            return self.drf.dominant_share(tenant)
        return self._tenant_svc.get(tenant, 0.0)

    def _admit_fair(self, now: float):
        """Tenant-ranked admission (fair_share AND drf) over per-tenant
        (submit_at, job_id) heaps: the next candidate is the min head
        under (tenant rank, submit_at, job_id) — exactly the scan sort
        key, since jobs of one tenant share the rank term.  The rank is
        re-read every iteration, which matters for drf: a dispatch
        RAISES the dispatching tenant's dominant share, so the next head
        comparison sees the updated shares (the scan engine re-sorts for
        the same reason).  A head with ``submit_at > now`` closes its
        whole tenant for this call (heads are submit-ordered, so
        everything behind it is later too)."""
        stash, closed = [], set()
        try:
            while self._n_running < self.cfg.max_concurrent_jobs:
                best_key, best_t = None, None
                for t, h in self._tenant_q.items():
                    if not h or t in closed:
                        continue
                    if h[0][0] > now:
                        closed.add(t)
                        continue
                    key = (self._tenant_rank(t), h[0][0], h[0][1])
                    if best_key is None or key < best_key:
                        best_key, best_t = key, t
                if best_t is None:
                    return
                _, jid, job = heapq.heappop(self._tenant_q[best_t])
                if not self._try_place(job, now):
                    stash.append((best_t, (job.submit_at, jid, job)))
        finally:
            for t, entry in stash:
                heapq.heappush(self._tenant_q[t], entry)

    def _run_all_heap(self, on_job_done=None) -> "ClusterResult":
        # build the event state from the submitted batch
        self._arrivals = [(j.submit_at, j.job_id, j) for j in self.jobs
                          if j.state == QUEUED]
        heapq.heapify(self._arrivals)
        self._queued_q: List = []           # (policy_key, job_id, job)
        self._tenant_q: Dict[str, List] = {}
        self._run_heap: List = []           # (sim_time, job_id, job)
        self._n_arrived = 0                 # jobs sitting in the policy queue
        self._n_running = 0
        self._reserved_ws = 0               # admission-reserved demand
        self._live_ws = 0                   # live fleet count (reporting)
        self._live_of: Dict[int, int] = {}  # job_id -> counted fleet size
        self._tenant_svc: Dict[str, float] = {}
        tick_s = (self.cfg.autoscale.tick_s
                  if self.autoscaler is not None else 0.0)
        next_tick = tick_s
        clock = 0.0
        while self._arrivals or self._n_arrived or self._n_running:
            if self._n_running < self.cfg.max_concurrent_jobs:
                self._admit_heap(clock)
            if self._n_running == 0:
                if not self._arrivals:
                    raise RuntimeError(
                        "deadlock: queued jobs but none placeable — "
                        "check max_active_workers vs job fleet sizes")
                clock = self._arrivals[0][0]   # jump to the next arrival
                continue
            _, _, job = heapq.heappop(self._run_heap)
            m, done = job.scheduler.step()
            job.rounds += 1
            served = m.round_wall_s * m.n_workers
            job.service_ws += served
            self._tenant_svc[job.tenant] = (
                self._tenant_svc.get(job.tenant, 0.0) + served)
            # a per-job autoscaler may have rescaled the fleet this round
            live = job.scheduler.cfg.n_workers
            self._live_ws += live - self._live_of[job.job_id]
            self._live_of[job.job_id] = live
            clock = max(clock, job.scheduler.sim_time)
            if done or job.rounds >= job.max_rounds:
                released, freed = self._finish(job)
                self._n_running -= 1
                self._reserved_ws -= freed
                self._live_ws -= self._live_of.pop(job.job_id)
                # released DAG stages arrive at the predecessor's finish
                # instant — exactly how the scan loop discovers them
                for rj in released:
                    heapq.heappush(self._arrivals,
                                   (rj.submit_at, rj.job_id, rj))
                if on_job_done:
                    on_job_done(job)
                # completion frees capacity AT the job's finish instant
                self._admit_heap(job.finished_at)
            else:
                heapq.heappush(self._run_heap,
                               (job.scheduler.sim_time, job.job_id, job))
            if tick_s > 0.0:
                # periodic autoscaler ticks decouple control cadence
                # from round cadence (tick_s=0 keeps the legacy per-step
                # observation the scan engine makes)
                while next_tick <= clock:
                    self._drain_arrivals(next_tick)
                    self._observe_autoscale(self._heap_autoscale_depth(),
                                            active_workers=self._live_ws)
                    next_tick += tick_s
            else:
                # demand = jobs that have actually ARRIVED and wait
                self._drain_arrivals(clock)
                self._observe_autoscale(self._heap_autoscale_depth(),
                                        active_workers=self._live_ws)
        return ClusterResult(jobs=list(self.jobs), report=self._report(),
                             dags=list(self._dags))

    # -- reporting ------------------------------------------------------------

    def _warm_hit_rate(self) -> float:
        if self.classed is not None:
            return self.classed.warm_hit_rate()
        if self.provider is not None:
            return self.provider.warm_hit_rate()
        provs = {id(j.scheduler.pool.provider): j.scheduler.pool.provider
                 for j in self.jobs
                 if j.scheduler is not None
                 and j.scheduler.pool.provider is not None}
        hits = sum(p.stats.warm_hits for p in provs.values())
        total = hits + sum(p.stats.cold_misses for p in provs.values())
        return hits / total if total else 0.0

    def _report(self) -> ClusterReport:
        done = [j for j in self.jobs if j.state == DONE]
        lats = np.array([j.latency_s for j in done]) if done else np.zeros(1)
        tenants = sorted({j.tenant for j in done})
        t_cost = {t: float(self.ledgers[t].total_usd()) for t in tenants
                  if t in self.ledgers}
        t_lat = {t: float(np.mean([j.latency_s for j in done
                                   if j.tenant == t])) for t in tenants}
        t_slow = {t: float(np.mean([j.slowdown for j in done
                                    if j.tenant == t])) for t in tenants}
        met = sum(1 for j in done if j.deadline_met is True)
        missed = sum(1 for j in done if j.deadline_met is False)
        dags_done = [d for d in self._dags if d.state == DONE]
        dag_lats = (np.array([d.latency_s for d in dags_done])
                    if dags_done else np.zeros(1))
        # vector fairness.  ``tenant_dominant_share``: each tenant's
        # dominant-share integral averaged over the tenant's own ACTIVE
        # window (first submit -> last finish) — a per-tenant progress
        # rate.  ``vector_fairness_ratio``: the time-average of the
        # INSTANTANEOUS max/min dominant share across allocated tenants
        # — the quantity DRF's serve-the-lowest-share rule bounds at
        # every dispatch instant.  (End-of-run consumption totals are
        # policy-independent in a drain-everything run — every job runs
        # its rounds under any order — so the instantaneous imbalance,
        # not the totals, is where a fairness policy shows.)
        t_share: Dict[str, float] = {}
        vec_ratio = 1.0
        if self._vector_mode and self._share_start is not None:
            for t, v in sorted(self._share_int.items()):
                tj = [j for j in self.jobs
                      if j.tenant == t and j.state == DONE]
                if not tj:
                    continue
                lo = min(j.submit_at for j in tj)
                hi = max(j.finished_at for j in tj)
                if hi > lo:
                    t_share[t] = float(v / (hi - lo))
            span = self._share_clock - self._share_start
            if span > 0:
                vec_ratio = self._imb_int / span
        # per-class rollups (placement mode)
        cls_jobs: Dict[str, int] = {}
        cls_cost: Dict[str, float] = {}
        cls_warm: Dict[str, float] = {}
        cls_keep: Dict[str, float] = {}
        cls_caps: Dict[str, int] = {}
        if self.classed is not None:
            caps = self.cfg.placement.class_caps or {}
            cap_now = min(self.worker_cap, self.cfg.max_active_workers)
            cls_jobs = dict(self._class_jobs)
            cls_cost = {n: (float(self.class_ledgers[n].total_usd())
                            if n in self.class_ledgers else 0.0)
                        for n in self.classed.classes}
            cls_warm = {n: float(v) for n, v in
                        self.classed.warm_hit_rate_by_class().items()}
            end = max((j.finished_at for j in done
                       if j.finished_at is not None), default=0.0)
            cls_keep = {n: float(v) for n, v in
                        self.classed.keepalive_cost_usd(at=end).items()}
            cls_caps = {n: min(caps.get(n, self.cfg.max_active_workers),
                               cap_now)
                        for n in self.classed.classes}
        return ClusterReport(
            policy=self.cfg.policy,
            n_jobs=len(self.jobs),
            n_rejected=sum(j.state == REJECTED for j in self.jobs),
            makespan_s=float(max(j.finished_at for j in done)
                             - min(j.started_at for j in done))
            if done else 0.0,
            p50_latency_s=float(np.percentile(lats, 50)),
            p95_latency_s=float(np.percentile(lats, 95)),
            p99_latency_s=float(np.percentile(lats, 99)),
            warm_hit_rate=self._warm_hit_rate(),
            total_cost_usd=float(sum(j.result.cost_usd for j in done)),
            tenant_cost_usd=t_cost,
            tenant_mean_latency_s=t_lat,
            tenant_slowdown=t_slow,
            deadlines_met=met,
            deadlines_missed=missed,
            final_worker_cap=self.worker_cap,
            rescales=(list(self.autoscaler.decisions)
                      if self.autoscaler else []),
            n_dags=len(self._dags),
            dag_p50_latency_s=float(np.percentile(dag_lats, 50)),
            dag_p95_latency_s=float(np.percentile(dag_lats, 95)),
            dag_cost_usd={d.uid: float(d.total_cost_usd)
                          for d in dags_done},
            tenant_dominant_share=t_share,
            vector_fairness_ratio=float(vec_ratio),
            class_jobs=cls_jobs,
            class_cost_usd=cls_cost,
            class_warm_hit_rate=cls_warm,
            class_keepalive_usd=cls_keep,
            final_class_caps=cls_caps,
        )


@dataclasses.dataclass
class ClusterResult:
    """What ``run_all`` hands back: the jobs (each with its
    ``RunResult`` at ``.result``) and the cluster rollup."""
    jobs: List[Job]
    report: ClusterReport
    dags: List[DagRun] = dataclasses.field(default_factory=list)

    def job_results(self) -> List:
        """The per-job RunResults, completed jobs only, submit order."""
        return [j.result for j in self.jobs if j.state == DONE]

    def to_dict(self) -> dict:
        out = {"report": self.report.to_dict(),
               "jobs": [j.summary() for j in self.jobs]}
        if self.dags:
            out["dags"] = [d.summary() for d in self.dags]
        return out
