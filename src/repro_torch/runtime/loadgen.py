"""Trace-driven production load generator: ``LoadSpec -> TraceWorkload``
— the counterpart of ``repro.runtime.loadgen``; generation is numpy only.

The paper (and every benchmark in this repo up to ``bench_cluster``)
evaluates the cluster against hand-arranged job lists — 16 jobs, all
submitted at t=0.  Production FaaS traffic looks nothing like that: the
Azure Functions 2019 trace — the accepted realism standard for
serverless load — shows a *diurnal* invocations-per-minute curve
(piecewise-constant per-minute buckets, day/half-day harmonics, bursty
bucket-to-bucket noise), *heavy-tailed* durations (a lognormal body
whose cross-function spread adds an effective Pareto tail), and a
*Zipf-skewed* application popularity (a handful of hot apps dominate
the invocation count).  "Serverless architecture efficiency: an
exploratory study" (PAPERS.md) argues cost/latency must be reported
under such realistic mixes rather than single-shot benchmarks, and
"Exploiting Inherent Elasticity of Serverless in Irregular Algorithms"
motivates the bursty on/off arrival shapes phase-varying workloads
produce.

This module generates that traffic as timestamped experiment
submissions for ``runtime/cluster.py``:

* ``model="azure"`` — the synthetic Azure-2019-shaped default: a
  diurnal rate curve built from day + half-day harmonics with
  per-bucket lognormal noise (piecewise-constant invocations-per-minute
  buckets), per-app lognormal duration scales (the cross-app spread IS
  the heavy tail) plus an explicit Pareto tail mix, and app ids drawn
  Zipf and hash-bucketed onto tenants.  No dataset download needed —
  CI runs this shape hermetically.
* ``model="poisson"`` — memoryless constant-rate arrivals, plain
  lognormal durations: the null hypothesis against which the diurnal /
  bursty effects are measured.
* ``model="onoff"`` — alternating burst/idle phases (``on_s`` at
  ``burst_factor``× the base rate, ``off_s`` near-idle): the
  phase-varying irregular-algorithm shape.

When the REAL Azure CSVs are on disk, ``load_azure_invocations`` /
``load_azure_durations`` ingest them (per-minute column sums become the
bucket rate curve; per-app invocation totals become the popularity
weights; per-app average durations replace the synthetic scales) and
``generate`` replays the measured shape instead of the synthetic model
— set ``LoadSpec(azure_invocations_csv=...)``.  Nothing in CI depends
on the files existing.

A drawn *duration* (the trace's service demand, in model seconds) is
mapped onto the knobs an ``ExperimentSpec`` actually has: the fleet
size is drawn from ``fleet_choices`` and ``max_rounds`` is the demand
divided by the template's calibrated per-round wall estimate — so a
heavy-tailed duration distribution becomes a heavy-tailed round-count
distribution, which is what the cluster's event loop experiences.

``TraceWorkload.compare_to_model()`` is the sanity report: empirical
rate / duration / tenant-share histograms vs the configured model, with
pass/fail flags — ``benchmarks/bench_load.py`` prints it before the
run so a miscalibrated trace is caught before minutes of simulation.
"""
from __future__ import annotations

import csv
import dataclasses
import math
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MODELS = ("azure", "poisson", "onoff")

# Problem templates: small real instances whose shard/solver caches
# amortize across thousands of jobs (the cluster passes ONE problem
# instance per template to every job using it).  ``est_round_s`` is the
# calibrated per-round wall estimate the duration->max_rounds mapping
# divides by; ``engine="batched"`` keeps the per-round simulator cost at
# one vmapped device call regardless of fleet size.  ``mem_gb`` is the
# per-sandbox memory hint the vector/placement layers read (it becomes
# the spec's billed GB, hence its mem demand and its instance-class
# fit); 3.0 is the pre-vector billing default, so these hints leave
# every scalar trace byte-identical.
DEFAULT_TEMPLATES: Dict[str, dict] = {
    "lasso_s": dict(problem="lasso",
                    problem_kwargs=dict(n_samples=512, n_features=32),
                    est_round_s=0.35, mem_gb=3.0),
    "lasso_m": dict(problem="lasso",
                    problem_kwargs=dict(n_samples=1024, n_features=48),
                    est_round_s=0.55, mem_gb=3.0),
    "logreg_s": dict(problem="logreg",
                     problem_kwargs=dict(n_samples=512, n_features=32,
                                         density=0.1, lam1=0.3,
                                         fista=dict(min_iters=1,
                                                    max_iters=20,
                                                    eps_grad=1e-3)),
                     est_round_s=0.45, mem_gb=3.0),
}


@dataclasses.dataclass(frozen=True)
class LoadSpec:
    """Declarative description of one workload trace.

    Everything is JSON-friendly; ``generate(spec)`` is a pure function
    of the spec (same spec -> byte-identical ``TraceWorkload``)."""
    model: str = "azure"          # azure | poisson | onoff
    horizon_s: float = 4 * 3600.0  # simulated span the arrivals cover
    jobs: Optional[int] = None    # exact job count; None = rate-driven
    seed: int = 0                 # trace realization (arrivals + draws)
    universe_seed: int = 0        # app population (scales, templates)
    # -- arrival rate (all models) -----------------------------------------
    rate_per_min: float = 6.0     # mean invocations per minute
    bucket_s: float = 60.0        # piecewise-constant bucket width
    # azure: diurnal harmonics + per-bucket burst noise
    diurnal_amp: float = 0.45     # day-cycle amplitude (peak/mean - 1)
    diurnal_amp2: float = 0.15    # half-day harmonic amplitude
    diurnal_phase_h: float = 10.0  # hour of the daily peak
    rate_noise_sigma: float = 0.25  # lognormal per-bucket jitter
    # onoff: alternating burst/idle phases
    on_s: float = 600.0
    off_s: float = 1800.0
    burst_factor: float = 6.0     # on-phase rate multiplier
    idle_factor: float = 0.1      # off-phase rate multiplier
    # -- durations (model seconds of service demand) -----------------------
    duration_median_s: float = 20.0
    duration_sigma: float = 0.8   # per-invocation lognormal sigma
    app_sigma: float = 0.9        # cross-app lognormal spread (azure)
    pareto_tail_frac: float = 0.03  # invocations drawn from the tail
    pareto_alpha: float = 1.5     # tail index (heavy: mean exists, var big)
    duration_cap_s: float = 1800.0  # provider would kill longer runs
    # -- tenant mix --------------------------------------------------------
    n_apps: int = 64              # hash-bucketed application ids
    zipf_a: float = 1.4           # popularity exponent over app ranks
    n_tenants: int = 8            # apps hash onto this many tenants
    # -- job-shape mapping -------------------------------------------------
    templates: Tuple[str, ...] = ("lasso_s", "lasso_m", "logreg_s")
    fleet_choices: Tuple[int, ...] = (2, 4, 8)
    fleet_weights: Tuple[float, ...] = (0.5, 0.35, 0.15)
    rounds_min: int = 2
    rounds_max: int = 40
    slo_slack: float = 6.0        # deadline = slack * demand + floor
    deadline_floor_s: float = 45.0  # cold ramp + queueing allowance
    # -- real Azure CSVs (optional; synthetic model when unset) ------------
    azure_invocations_csv: Optional[str] = None
    azure_durations_csv: Optional[str] = None

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError(f"model must be one of {MODELS}, "
                             f"got {self.model!r}")
        if len(self.fleet_choices) != len(self.fleet_weights):
            raise ValueError("fleet_choices and fleet_weights must have "
                             "the same length")
        if not self.templates:
            raise ValueError("need at least one problem template")


@dataclasses.dataclass(frozen=True)
class TraceJob:
    """One timestamped submission of the trace."""
    idx: int
    submit_at: float
    app: str
    tenant: str
    template: str
    n_workers: int
    max_rounds: int
    duration_s: float             # the drawn service demand
    deadline_s: float
    seed: int                     # per-job pool seed


def tenant_of(app: str, n_tenants: int) -> str:
    """Hash-bucket an app id onto a tenant — crc32, not ``hash()``,
    so the mapping is stable across processes and platforms."""
    return f"t{zlib.crc32(app.encode()) % max(n_tenants, 1)}"


# ---------------------------------------------------------------------------
# the real Azure Functions 2019 CSVs (optional ingestion)
# ---------------------------------------------------------------------------


def load_azure_invocations(path) -> Tuple[np.ndarray, Dict[str, float]]:
    """Ingest an Azure-2019 ``invocations_per_function_md.anon.dXX.csv``:
    rows are functions, columns ``1``..``1440`` are per-minute
    invocation counts.  Returns (per-minute totals (1440,), per-app
    invocation-share weights).  Raises ``FileNotFoundError`` when the
    dataset is absent — callers gate on the path being configured."""
    path = Path(path)
    with path.open(newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        app_col = header.index("HashApp")
        minute_cols = [i for i, h in enumerate(header) if h.isdigit()]
        if not minute_cols:
            raise ValueError(f"{path}: no per-minute count columns")
        counts = np.zeros(len(minute_cols), np.float64)
        apps: Dict[str, float] = {}
        for row in reader:
            if not row:
                continue
            per_min = np.array([float(row[i] or 0) for i in minute_cols])
            counts += per_min
            app = row[app_col]
            apps[app] = apps.get(app, 0.0) + float(per_min.sum())
        total = sum(apps.values())
        if total <= 0:
            raise ValueError(f"{path}: trace has zero invocations")
        return counts, {a: w / total for a, w in apps.items()}


def load_azure_durations(path) -> Dict[str, float]:
    """Ingest ``function_durations_percentiles.anon.dXX.csv``: returns
    per-app mean execution seconds (count-weighted across the app's
    functions; the CSV's ``Average`` column is milliseconds)."""
    path = Path(path)
    sums: Dict[str, float] = {}
    counts: Dict[str, float] = {}
    with path.open(newline="") as f:
        for row in csv.DictReader(f):
            app = row["HashApp"]
            n = float(row.get("Count", 1) or 1)
            avg_ms = float(row.get("Average", 0) or 0)
            sums[app] = sums.get(app, 0.0) + avg_ms * n
            counts[app] = counts.get(app, 0.0) + n
    return {a: (sums[a] / counts[a]) / 1000.0 for a in sums if counts[a]}


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


def _bucket_rates(spec: LoadSpec, rng: np.random.RandomState) -> np.ndarray:
    """Expected arrivals per bucket over the horizon — the
    piecewise-constant invocations-per-minute curve."""
    n = max(int(math.ceil(spec.horizon_s / spec.bucket_s)), 1)
    base = spec.rate_per_min * spec.bucket_s / 60.0
    t_h = (np.arange(n) + 0.5) * spec.bucket_s / 3600.0
    if spec.model == "poisson":
        return np.full(n, base)
    if spec.model == "onoff":
        phase = np.mod(t_h * 3600.0, spec.on_s + spec.off_s)
        shape = np.where(phase < spec.on_s,
                         spec.burst_factor, spec.idle_factor)
        return base * shape / shape.mean()  # mean rate = rate_per_min
    # azure: day + half-day harmonics, floored, with bucket burst noise
    w = 2.0 * math.pi / 24.0
    diurnal = (1.0
               + spec.diurnal_amp * np.cos(w * (t_h - spec.diurnal_phase_h))
               + spec.diurnal_amp2 * np.cos(2 * w * (t_h
                                                     - spec.diurnal_phase_h)))
    diurnal = np.maximum(diurnal, 0.05)
    diurnal /= diurnal.mean()  # rate_per_min = mean over the horizon
    noise = np.exp(rng.normal(-0.5 * spec.rate_noise_sigma ** 2,
                              spec.rate_noise_sigma, n))
    return base * diurnal * noise


def _arrival_times(spec: LoadSpec, rates: np.ndarray,
                   rng: np.random.RandomState) -> np.ndarray:
    """Arrival instants from the bucket curve: Poisson counts per
    bucket (rate-driven), or exactly ``spec.jobs`` arrivals multinomially
    thinned onto buckets proportional to their rates (count-driven) —
    the conditional law of a Poisson process given its total."""
    if spec.jobs is not None:
        p = rates / rates.sum()
        counts = rng.multinomial(int(spec.jobs), p)
    else:
        counts = rng.poisson(rates)
    times = []
    for b, c in enumerate(counts):
        if c:
            times.append((b + rng.rand(c)) * spec.bucket_s)
    if not times:
        return np.zeros(0)
    return np.sort(np.concatenate(times))


def _zipf_weights(n: int, a: float) -> np.ndarray:
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** a
    return w / w.sum()


def generate(spec: LoadSpec, templates: Optional[Dict[str, dict]] = None
             ) -> "TraceWorkload":
    """The generator: spec in, deterministic ``TraceWorkload`` out.
    ``templates`` overrides ``DEFAULT_TEMPLATES`` (each entry needs
    ``problem``, ``problem_kwargs``, ``est_round_s``)."""
    templates = dict(DEFAULT_TEMPLATES if templates is None else templates)
    missing = [t for t in spec.templates if t not in templates]
    if missing:
        raise ValueError(f"unknown template(s) {missing}; have "
                         f"{sorted(templates)}")
    rng = np.random.RandomState(spec.seed)
    # The app universe is the *population* (fixed apps, as in the real
    # Azure trace); ``seed`` varies only the realization drawn from it.
    # compare_to_model relies on this: its reference redraw changes
    # ``seed`` but keeps ``universe_seed``, so two traces are samples
    # from the SAME mixture and their CDFs are comparable.
    rng_u = np.random.RandomState(spec.universe_seed)

    # -- the app universe: popularity + per-app character -------------------
    azure_rates = azure_durs = None
    if spec.azure_invocations_csv is not None:
        counts, app_weights = load_azure_invocations(
            spec.azure_invocations_csv)
        azure_rates = counts
        apps = sorted(app_weights, key=lambda a: -app_weights[a])
        weights = np.array([app_weights[a] for a in apps])
        if spec.azure_durations_csv is not None:
            azure_durs = load_azure_durations(spec.azure_durations_csv)
    else:
        apps = [f"app{i:03d}" for i in range(spec.n_apps)]
        weights = _zipf_weights(spec.n_apps, spec.zipf_a)
    n_apps = len(apps)
    # sticky per-app character: a template and a duration scale.  The
    # cross-app lognormal spread is what makes the aggregate duration
    # distribution heavy-tailed even before the Pareto mix.
    app_template = [spec.templates[int(rng_u.randint(len(spec.templates)))]
                    for _ in range(n_apps)]
    if azure_durs is not None:
        med = np.array([azure_durs.get(a, spec.duration_median_s)
                        for a in apps])
        app_scale = np.log(np.maximum(med, 0.5))
    else:
        sigma = spec.app_sigma if spec.model == "azure" else 0.0
        app_scale = (math.log(spec.duration_median_s)
                     + rng_u.normal(0.0, sigma, n_apps))

    # -- arrivals ------------------------------------------------------------
    if azure_rates is not None:
        n_b = max(int(math.ceil(spec.horizon_s / spec.bucket_s)), 1)
        reps = int(math.ceil(n_b / len(azure_rates)))
        rates = np.tile(azure_rates, reps)[:n_b].astype(np.float64)
        if spec.jobs is None and rates.sum() > 0:
            # rate-driven replay of a real curve honors rate_per_min by
            # scaling the measured shape to the configured mean
            rates *= (spec.rate_per_min * spec.bucket_s / 60.0
                      ) / rates.mean()
    else:
        rates = _bucket_rates(spec, rng)
    times = _arrival_times(spec, rates, rng)

    # -- per-invocation draws (vectorized) -----------------------------------
    n = len(times)
    app_idx = rng.choice(n_apps, size=n, p=weights)
    dur = np.exp(app_scale[app_idx]
                 + rng.normal(0.0, spec.duration_sigma, n))
    tail = rng.rand(n) < spec.pareto_tail_frac
    if tail.any():
        # Pareto tail anchored at the body median: rare invocations an
        # order of magnitude (or more) longer than typical
        xm = spec.duration_median_s
        dur[tail] = xm * (1.0 + rng.pareto(spec.pareto_alpha,
                                           int(tail.sum())))
    dur = np.clip(dur, 0.5, spec.duration_cap_s)
    fleet = rng.choice(list(spec.fleet_choices), size=n,
                       p=np.asarray(spec.fleet_weights, np.float64)
                       / np.sum(spec.fleet_weights))

    jobs: List[TraceJob] = []
    for i in range(n):
        a = int(app_idx[i])
        tname = app_template[a]
        est = float(templates[tname]["est_round_s"])
        rounds = int(np.clip(int(round(dur[i] / est)),
                             spec.rounds_min, spec.rounds_max))
        jobs.append(TraceJob(
            idx=i, submit_at=float(times[i]), app=apps[a],
            tenant=tenant_of(apps[a], spec.n_tenants), template=tname,
            n_workers=int(fleet[i]), max_rounds=rounds,
            duration_s=float(dur[i]),
            deadline_s=float(spec.deadline_floor_s
                             + spec.slo_slack * dur[i]),
            seed=spec.seed * 1_000_003 + i))
    return TraceWorkload(spec=spec, jobs=jobs, templates=templates)


# ---------------------------------------------------------------------------
# the workload object
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceWorkload:
    """A generated trace: timestamped jobs + the spec that produced it."""
    spec: LoadSpec
    jobs: List[TraceJob]
    templates: Dict[str, dict]

    def __len__(self) -> int:
        return len(self.jobs)

    def problem_instances(self, device="cuda"):
        """One problem per template used, built on ``device`` — shared
        across every job of that template so shard generation amortizes
        over the whole trace (pass to ``api.replay``).  Without a card,
        the default device raises."""
        from repro_torch import problems               # lazy: no cycle
        used = sorted({j.template for j in self.jobs})
        return {t: problems.make(self.templates[t]["problem"], device=device,
                                 **dict(self.templates[t]["problem_kwargs"]))
                for t in used}

    def experiment_spec(self, job: TraceJob):
        """The ``ExperimentSpec`` for one trace job: batched engine, a
        per-job pool seed, and the template's problem."""
        from repro_torch.api import ExperimentSpec     # lazy: no cycle
        from repro_torch.core.admm import AdmmOptions
        from repro_torch.runtime.billing import BillingConfig
        from repro_torch.runtime.pool import PoolConfig
        from repro_torch.runtime.provider import ProviderConfig
        from repro_torch.runtime.scheduler import SchedulerConfig
        t = self.templates[job.template]
        return ExperimentSpec(
            problem=t["problem"],
            problem_kwargs=dict(t["problem_kwargs"]),
            scheduler=SchedulerConfig(
                n_workers=job.n_workers,
                engine="batched",
                # the template's per-sandbox memory hint: what billing
                # meters and what the DRF/placement layers read as the
                # job's memory shape (3.0 = the scalar-era default)
                billing=BillingConfig(mem_gb=float(t.get("mem_gb", 3.0))),
                # templates may override ADMM options (e.g. benchmarks
                # pin eps tiny so round counts stay structural — every
                # job runs exactly its max_rounds)
                admm=AdmmOptions(max_iters=job.max_rounds,
                                 **dict(t.get("admm", {}))),
                # templates may also override the pool's simulated-time
                # constants (e.g. t_inner_floor_s) so one simulated
                # round spans est_round_s of model time — that is what
                # makes trace durations mean something on the cluster
                # clock without costing real wall time
                pool=PoolConfig(seed=job.seed,
                                provider=ProviderConfig(enabled=True),
                                **dict(t.get("pool", {})))),
            max_rounds=job.max_rounds,
            label=f"{job.tenant}/{job.app}/{job.template}")

    # -- histograms ----------------------------------------------------------

    def rate_histogram(self, bucket_s: Optional[float] = None
                       ) -> np.ndarray:
        """Arrivals per bucket over the horizon (the empirical
        invocations-per-bucket curve)."""
        b = bucket_s or self.spec.bucket_s
        n = max(int(math.ceil(self.spec.horizon_s / b)), 1)
        idx = np.minimum((np.array([j.submit_at for j in self.jobs]) // b
                          ).astype(int), n - 1)
        return np.bincount(idx, minlength=n) if len(idx) else np.zeros(n)

    def duration_quantiles(self, qs: Sequence[float] = (50, 90, 99)
                           ) -> Dict[str, float]:
        d = np.array([j.duration_s for j in self.jobs])
        return {f"p{q:g}": float(np.percentile(d, q)) for q in qs}

    def tenant_shares(self) -> Dict[str, float]:
        shares: Dict[str, float] = {}
        for j in self.jobs:
            shares[j.tenant] = shares.get(j.tenant, 0.0) + 1.0
        n = max(len(self.jobs), 1)
        return {t: c / n for t, c in sorted(shares.items())}

    # -- the sanity report ---------------------------------------------------

    def compare_to_model(self, *, rate_rtol: float = 0.2,
                         cdf_tol: float = 0.08) -> dict:
        """Does the generated trace match the configured model?  Rate:
        empirical arrivals/min vs ``rate_per_min``.  Durations: max CDF
        gap (two-sample KS statistic) against a fresh reference draw
        from the same model at another seed.  Tenants: the Zipf skew
        must actually show up (top tenant ≫ uniform share).  Each block
        carries an ``ok`` flag; ``ok`` at the top is their AND."""
        spec = self.spec
        n = len(self.jobs)
        emp_rate = n / max(spec.horizon_s / 60.0, 1e-9)
        hist = self.rate_histogram()
        per_min = hist * 60.0 / spec.bucket_s
        # exact-count mode pins the mean rate by construction; the
        # meaningful target is then the count-implied one
        target = (spec.rate_per_min if spec.jobs is None
                  else spec.jobs / max(spec.horizon_s / 60.0, 1e-9))
        rate_ok = abs(emp_rate - target) <= rate_rtol * target
        peak_to_mean = (float(per_min.max() / per_min.mean())
                        if per_min.mean() > 0 else 0.0)

        ref = generate(dataclasses.replace(
            spec, seed=spec.seed + 7919,
            jobs=max(n, 2000)), templates=self.templates)
        mine = np.sort(np.log([j.duration_s for j in self.jobs]))
        theirs = np.sort(np.log([j.duration_s for j in ref.jobs]))
        grid = np.unique(np.concatenate([mine, theirs]))
        gap = float(np.max(np.abs(
            np.searchsorted(mine, grid, side="right") / len(mine)
            - np.searchsorted(theirs, grid, side="right") / len(theirs))))
        dq = self.duration_quantiles()
        heavy = dq["p99"] / max(dq["p50"], 1e-9)
        dur_ok = gap <= cdf_tol

        shares = self.tenant_shares()
        top = max(shares.values()) if shares else 0.0
        uniform = 1.0 / max(spec.n_tenants, 1)
        skew_ok = (top >= 1.2 * uniform) if spec.model == "azure" else True

        report = {
            "model": spec.model, "n_jobs": n,
            "rate": {"target_per_min": target,
                     "empirical_per_min": emp_rate,
                     "peak_to_mean": peak_to_mean, "ok": bool(rate_ok)},
            "duration": {**dq, "heavy_tail_p99_over_p50": float(heavy),
                         "cdf_gap_vs_model": gap, "ok": bool(dur_ok)},
            "tenants": {"shares": shares, "top_share": float(top),
                        "uniform_share": uniform, "ok": bool(skew_ok)},
        }
        report["ok"] = bool(rate_ok and dur_ok and skew_ok)
        return report
