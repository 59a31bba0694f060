"""The port's multi-tenant cluster (``repro_torch.runtime.cluster``,
``placement``, ``api.submit``/``run_all``) against the JAX package's, live,
in the same process.

Both packages get the same specs, seeds and ``ClusterConfig``s over float64
problems: a lasso instance (``tests/test_cluster.py``'s size) and a logreg
instance of the same size on the batched engine, whose FISTA counts drive
the simulated clock.  The port's problems carry the reference's shards
(``problems.carry_shards``), so the cluster, not data generation, is under
test.  JAX runs in x64 with the partitionable threefry layout
(``jax_config``), restored afterwards.

Held: every job's trace to 1e-12 relative (measured 2.1e-14) with equal
inner counts, and the ``ClusterReport`` and job summaries equal field for
field (latencies, costs, warm-hit rates, tenant ledgers, deadline hits,
rescales, class rollups): the simulators are the same numpy code fed the
same counts.  Then the port's own contracts: heap == scan pop for pop, the
scheduler's ``pool``/``start_time`` hooks, admission control, two jobs on
one problem instance, and the card as the default device.
"""
import contextlib
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import api as j_api                                # noqa: E402
from repro import problems as j_problems                      # noqa: E402
from repro import runtime as j_rt                             # noqa: E402
from repro.core.admm import AdmmOptions as JAdmm              # noqa: E402
from repro.runtime import placement as j_place                # noqa: E402
from repro_torch import api as t_api                          # noqa: E402
from repro_torch import problems as t_problems                # noqa: E402
from repro_torch import runtime as t_rt                       # noqa: E402
from repro_torch.core.admm import AdmmOptions as TAdmm        # noqa: E402
from repro_torch.runtime import placement as t_place          # noqa: E402
from repro_torch.runtime.cluster import ENGINES, POLICIES     # noqa: E402


@contextlib.contextmanager
def jax_config(**options):
    """Set JAX config options for the enclosed block, then restore them."""
    old = {k: getattr(jax.config, k) for k in options}
    for k, v in options.items():
        jax.config.update(k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            jax.config.update(k, v)


def reference():
    return jax_config(jax_threefry_partitionable=True, jax_enable_x64=True)


def _pkg(api, rt, admm, device):
    """One package's cluster vocabulary; ``cluster(**cfg)`` builds a
    Cluster on ``device`` (the port's) or the reference's."""
    ns = types.SimpleNamespace(
        Spec=api.ExperimentSpec, Admm=admm, Pool=rt.PoolConfig,
        Provider=rt.ProviderConfig, Sched=rt.SchedulerConfig,
        Billing=rt.BillingConfig, Auto=rt.AutoscaleConfig,
        ClusterAuto=rt.ClusterAutoscaleConfig, Place=rt.PlacementConfig,
        Dag=rt.DagSpec, Stage=rt.StageSpec, api=api)
    kw = {} if device is None else {"device": device}
    ns.cluster = lambda **cfg: rt.Cluster(rt.ClusterConfig(**cfg), **kw)
    return ns


REF = _pkg(j_api, j_rt, JAdmm, None)
PORT = _pkg(t_api, t_rt, TAdmm, "cpu")

F64 = dict(dtype="float64")
LASSO_KW = dict(n_samples=256, n_features=32, **F64)
LOGREG_KW = dict(n_samples=256, n_features=32, density=0.2, **F64)
FLEETS = (2, 4)


@pytest.fixture(scope="module")
def problems():
    """(reference problems, port problems) by name; the port's carry the
    reference's shards for every fleet size the scenarios use."""
    ref, port = {}, {}
    with reference():
        for name, kw in (("lasso", LASSO_KW), ("logreg", LOGREG_KW)):
            p = j_problems.make(name, **kw)
            for W in FLEETS:
                for w in range(W):
                    p._shard(w, W)
            ref[name] = p
            port[name] = t_problems.make(name, device="cpu", **kw)
            t_problems.carry_shards(port[name], {
                k: tuple(np.asarray(a) for a in v)
                for k, v in p._shard_cache.items()})
    return ref, port


def spec(P, seed, *, w=4, rounds=3, problem="lasso", mem_gb=None,
         label=""):
    """The reference tests' lasso job (or the logreg twin on the batched
    engine), with a per-job pool seed."""
    extra = {} if mem_gb is None else {"billing": P.Billing(mem_gb=mem_gb)}
    return P.Spec(
        problem=problem,
        problem_kwargs=LASSO_KW if problem == "lasso" else LOGREG_KW,
        scheduler=P.Sched(
            n_workers=w, replication=2,
            engine="loop" if problem == "lasso" else "batched",
            admm=P.Admm(max_iters=rounds),
            pool=P.Pool(seed=seed, provider=P.Provider()), **extra),
        max_rounds=rounds, label=label or f"job{seed}")


def submit_mix(P, c, probs):
    """``tests/test_cluster_heap.py``'s contended 16-job / 4-tenant mix
    (staggered arrivals, fleets of 2 and 4, varied priorities and
    deadlines), every fifth job a logreg one."""
    tenants = ("alice", "bob", "carol", "dave")
    for i in range(16):
        name = "logreg" if i % 5 == 2 else "lasso"
        c.submit(spec(P, 100 + i, w=4 if i % 3 == 0 else 2, problem=name),
                 tenant=tenants[i % 4], priority=(i * 5) % 7,
                 deadline_s=40.0 + (i * 13) % 60, at=float((i * 7) % 40),
                 problem=probs[name])


MEMS = (1.5, 2.5, 9.0)    # one per instance-class tier


def submit_place_mix(P, c, probs):
    """``tests/test_cluster_heap.py``'s 12-job / 3-tenant mix cycling the
    three instance-class tiers' memory shapes."""
    tenants = ("alice", "bob", "carol")
    for i in range(12):
        mem = MEMS[i % 3]
        c.submit(spec(P, 300 + i, w=2 if mem > 4 else 4, rounds=2,
                      mem_gb=mem, label=f"vjob{300 + i}"),
                 tenant=tenants[i % 3], priority=(i * 3) % 5,
                 deadline_s=50.0 + (i * 11) % 40, at=float((i * 5) % 25),
                 problem=probs["lasso"])


def submit_dag_mix(P, c, probs):
    """The 16-job mix and two interleaved diamond DAGs."""
    submit_mix(P, c, probs)
    for i, at in enumerate((3.0, 21.0)):
        dag = P.Dag(stages=(
            P.Stage("root", spec(P, 200 + i, w=2, rounds=2)),
            P.Stage("fan0", spec(P, 210 + i, w=4, rounds=2),
                    after=("root",)),
            P.Stage("fan1", spec(P, 220 + i, w=4, rounds=2,
                                 problem="logreg"), after=("root",)),
            P.Stage("join", spec(P, 230 + i, w=2, rounds=3),
                    after=("fan0", "fan1")),
        ), label=f"dag{i}")
        c.submit_dag(dag, tenant=("alice", "carol")[i], priority=i, at=at,
                     problems={"root": probs["lasso"],
                               "fan0": probs["lasso"],
                               "fan1": probs["logreg"],
                               "join": probs["lasso"]})


def autoscale(P, tick_s=0.0):
    return P.ClusterAuto(policy="queue_depth", min_workers=6, max_workers=10,
                         grow_at_depth=2, cooldown_events=2, tick_s=tick_s)


# name -> (submit function, ClusterConfig kwargs given the package)
SCENARIOS = {
    "isolated": (submit_mix, lambda P: dict(share_provider=False)),
    "vector_capacity": (submit_place_mix,
                        lambda P: dict(vector_capacity=True,
                                       mem_capacity_gb=24.0)),
    "cheapest_fit": (submit_place_mix, lambda P: dict(
        placement=P.Place(enabled=True, policy="cheapest_fit"))),
    "latency_min": (submit_place_mix, lambda P: dict(
        placement=P.Place(enabled=True, policy="latency_min"))),
    "cost_latency": (submit_place_mix, lambda P: dict(
        placement=P.Place(enabled=True, policy="cost_latency"))),
    "drf_placement": (submit_place_mix, lambda P: dict(
        policy="drf", placement=P.Place(enabled=True))),
    "autoscaler": (submit_mix, lambda P: dict(policy="fair_share",
                                              autoscale=autoscale(P))),
    "autoscaler_ticks": (submit_mix, lambda P: dict(
        autoscale=autoscale(P, tick_s=25.0))),
    "autoscaler_placement": (submit_place_mix, lambda P: dict(
        placement=P.Place(enabled=True), autoscale=autoscale(P))),
    "dags_phase": (submit_dag_mix, lambda P: dict(policy="fair_share",
                                                  reservation="phase")),
    "dags_peak": (submit_dag_mix, lambda P: dict(policy="fair_share",
                                                 reservation="peak")),
}


def run_scenario(P, probs, submit, engine="heap", spy=None, **cfg):
    c = P.cluster(engine=engine, max_concurrent_jobs=3,
                  max_active_workers=10, **cfg)
    if spy is not None:
        spy(c)
    submit(P, c, probs)
    return c, c.run_all()


def fingerprint(res):
    return (res.report.to_dict(),
            [j.summary() for j in sorted(res.jobs, key=lambda j: j.job_id)])


TRACE_KEYS = ("r_norm", "s_norm", "rho", "sim_time", "cost_usd",
              "round_wall_s", "inner_mean", "z_nnz")


def assert_jobs_match(ref_res, port_res):
    """Every done job's trace to 1e-12 relative with equal inner counts."""
    ref_jobs = [j for j in ref_res.jobs if j.state == "done"]
    port_jobs = [j for j in port_res.jobs if j.state == "done"]
    assert [j.job_id for j in port_jobs] == [j.job_id for j in ref_jobs]
    for a, b in zip(ref_jobs, port_jobs):
        assert len(a.result.trace) == len(b.result.trace)
        for key in TRACE_KEYS:
            want = np.array([r[key] for r in a.result.trace], np.float64)
            got = np.array([r[key] for r in b.result.trace], np.float64)
            if key in ("inner_mean", "z_nnz"):
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-12,
                                           atol=1e-14, err_msg=key)
        np.testing.assert_allclose(b.result.z, np.asarray(a.result.z),
                                   rtol=1e-12, atol=1e-14)


def run_both(problems, submit, engine="heap", cfg=lambda P: {}):
    """The scenario under each package (``cfg(P)`` its ClusterConfig
    kwargs); holds the port's report, summaries and traces to the
    reference's and returns both (cluster, result) pairs."""
    ref_probs, port_probs = problems
    with reference():
        ref = run_scenario(REF, ref_probs, submit, engine, **cfg(REF))
    port = run_scenario(PORT, port_probs, submit, engine, **cfg(PORT))
    assert fingerprint(port[1]) == fingerprint(ref[1])
    assert_jobs_match(ref[1], port[1])
    return ref, port


# ---------------------------------------------------------------------------
# port against reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,engine", [(p, "heap") for p in POLICIES]
                         + [("fifo", "scan"), ("drf", "scan")])
def test_cluster_matches_reference(problems, policy, engine):
    """The contended mix under every policy: the same admissions, schedule,
    report and traces."""
    _, (_, res) = run_both(problems, submit_mix, engine,
                           lambda P: dict(policy=policy))
    assert all(j.state == "done" for j in res.jobs)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_cluster_options_match_reference(problems, name):
    """Private pools, vector capacity, the three placement policies, DRF
    with placement, the cluster autoscaler (per round, on ticks, with
    placement) and DAG stages under both reservations."""
    submit, cfg = SCENARIOS[name]
    (rc, _), (pc, res) = run_both(problems, submit, "heap", cfg)
    assert pc.worker_cap == rc.worker_cap
    if rc.autoscaler is not None:
        assert pc.autoscaler.decisions == rc.autoscaler.decisions
    if name.startswith("dags"):
        assert [d.summary() for d in res.dags] == [
            d.summary() for d in rc._dags]


def placement_specs(P):
    """Specs of every shape: fleets, memory tiers, compression and a
    per-job autoscale ceiling."""
    return [spec(P, 0, w=w, mem_gb=m)
            for w in (1, 4, 8) for m in (1.5, 2.5, 3.0, 9.0)] + [
        P.Spec(problem="lasso", problem_kwargs=dict(n_features=100),
               scheduler=P.Sched(n_workers=4, compress="topk",
                                 autoscale=P.Auto(policy="target_efficiency",
                                                  max_workers=12)))]


def test_placement_units_match_reference():
    """Demand vectors and class choices, spec for spec."""
    for a, b in zip(placement_specs(REF), placement_specs(PORT)):
        assert (t_place.spec_resource_vector(b).to_dict()
                == j_place.spec_resource_vector(a).to_dict())
        assert t_place.spec_worker_demand(b) == j_place.spec_worker_demand(a)
        for policy in t_place.PLACEMENTS:
            for warm in (0, 2, 8):
                kw = dict(mem_gb_per_worker=float(b.scheduler.billing.mem_gb),
                          workers=b.scheduler.n_workers,
                          warm_idle={"s1769": warm, "l10240": 8 - warm},
                          headroom={"s1769": 8, "m3008": 4, "l10240": 8})
                got = t_place.choose_class(
                    t_place.PlacementConfig(enabled=True, policy=policy),
                    **kw)
                want = j_place.choose_class(
                    j_place.PlacementConfig(enabled=True, policy=policy),
                    **kw)
                assert (got and got.name) == (want and want.name)


def test_drf_sorter_matches_reference():
    rng = np.random.default_rng(0)
    total = (16.0, 64.0, 128.0)
    ref = j_place.DRFSorter(j_place.ResourceVector(*total))
    port = t_place.DRFSorter(t_place.ResourceVector(*total))
    for _ in range(200):
        client = f"c{rng.integers(4)}"
        vec = rng.integers(0, 8, 3) * np.array([1.0, 0.25, 0.125])
        op = "allocate" if rng.random() < 0.6 else "unallocated"
        getattr(ref, op)(client, vec)
        getattr(port, op)(client, vec)
        assert port.sort() == ref.sort()
        assert port.shares() == ref.shares()
        np.testing.assert_array_equal(port.free(), ref.free())


# ---------------------------------------------------------------------------
# heap == scan in the port, pop for pop
# ---------------------------------------------------------------------------


def step_spy(record):
    """Wrap ``c._dispatch`` so every dispatched scheduler's ``step``
    records its pre-step sim clock: the key the run heap popped it at."""
    def install(c):
        orig_dispatch = c._dispatch

        def spy(job, at, **kw):
            orig_dispatch(job, at, **kw)
            orig_step = job.scheduler.step

            def stepped(_job=job, _orig=orig_step):
                record.append((_job.scheduler.sim_time, _job.job_id))
                return _orig()
            job.scheduler.step = stepped
        c._dispatch = spy
    return install


@pytest.mark.parametrize("name", ["policy_" + p for p in POLICIES]
                         + ["cost_latency", "drf_placement",
                            "autoscaler", "dags_phase", "dags_peak"])
def test_port_heap_matches_scan_pop_for_pop(problems, name):
    if name.startswith("policy_"):
        submit, cfg = submit_mix, (lambda P: dict(policy=name[7:]))
    else:
        submit, cfg = SCENARIOS[name]
    runs = []
    for engine in ENGINES:
        pops = []
        c, res = run_scenario(PORT, problems[1], submit, engine,
                              spy=step_spy(pops), **cfg(PORT))
        runs.append((fingerprint(res), pops, c.worker_cap))
    assert runs[0] == runs[1]
    times = [t for t, _ in runs[0][1]]
    assert times == sorted(times)          # the frontier never goes back


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_heap_matches_scan_random_batches(problems, seed):
    """``tests/test_cluster_heap.py``'s random arrival batches: 1-round
    jobs with random fleets, tenants, priorities, deadlines, arrivals."""
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 50, size=int(rng.integers(2, 7)))
    policy = POLICIES[int(rng.integers(len(POLICIES)))]
    fps = []
    for engine in ENGINES:
        c = PORT.cluster(engine=engine, policy=policy, max_concurrent_jobs=2,
                         max_active_workers=6)
        for i, s in enumerate(int(v) for v in seeds):
            c.submit(spec(PORT, s, w=2 + 2 * (s % 2), rounds=1,
                          label=f"r{i}"),
                     tenant=f"t{s % 3}", priority=s % 4,
                     deadline_s=float(10 + s), at=float(3 * s % 17),
                     problem=problems[1]["lasso"])
        fps.append(fingerprint(c.run_all()))
    assert fps[0] == fps[1]


# ---------------------------------------------------------------------------
# the scheduler hooks the cluster rests on
# ---------------------------------------------------------------------------


def test_single_job_cluster_matches_api_run(problems):
    """One job, no shared provider: the cluster-driven trace is the solo
    ``api.run`` trace, bit for bit."""
    lasso = problems[1]["lasso"]
    solo = t_api.run(spec(PORT, 7, rounds=5), problem=lasso)
    c = PORT.cluster(share_provider=False)
    job = c.submit(spec(PORT, 7, rounds=5), problem=lasso)
    res = c.run_all()
    assert job.state == "done"
    assert job.result.trace == solo.trace
    np.testing.assert_array_equal(job.result.z, solo.z)
    assert res.report.total_cost_usd == solo.cost_usd


def test_step_interleaving_is_isolated(problems):
    """Two schedulers on one problem instance, stepped alternately, give
    exactly their solo traces — the batched logreg path, whose shards and
    stacked batches the two share."""
    logreg = problems[1]["logreg"]
    cfg = lambda seed: spec(PORT, seed, problem="logreg").scheduler  # noqa

    def trace(s):
        return [(m.r_norm, m.s_norm, m.rho, m.sim_time, m.z_nnz,
                 m.inner_iters.tolist()) for m in s.history]
    solo = {}
    for seed in (1, 2):
        s = t_rt.Scheduler(logreg, cfg(seed))
        s.solve(max_rounds=4)
        solo[seed] = trace(s)
    a = t_rt.Scheduler(logreg, cfg(1))
    b = t_rt.Scheduler(logreg, cfg(2))
    for _ in range(4):
        a.step()
        b.step()
    assert trace(a) == solo[1] and trace(b) == solo[2]


def test_start_time_offsets_the_clock(problems):
    lasso = problems[1]["lasso"]
    base = t_rt.Scheduler(lasso, spec(PORT, 3).scheduler)
    late = t_rt.Scheduler(lasso, spec(PORT, 3).scheduler, start_time=100.0)
    base.solve(max_rounds=3)
    late.solve(max_rounds=3)
    for mb, ml in zip(base.history, late.history):
        assert ml.sim_time == pytest.approx(mb.sim_time + 100.0)
        assert ml.round_wall_s == pytest.approx(mb.round_wall_s)
        assert ml.r_norm == mb.r_norm
    assert late.meter.total_usd() == pytest.approx(base.meter.total_usd())


def test_injected_pool_is_used(problems):
    lasso = problems[1]["lasso"]
    pool = t_rt.LambdaPool(t_rt.PoolConfig(seed=4))
    s = t_rt.Scheduler(lasso, spec(PORT, 4).scheduler, pool=pool)
    assert s.pool is pool and len(pool.workers) == 4


# ---------------------------------------------------------------------------
# admission, the surface, the device
# ---------------------------------------------------------------------------


def test_admission_rejects_unplaceable(problems):
    lasso = problems[1]["lasso"]
    c = PORT.cluster(max_active_workers=8, max_queued=1)
    ok = c.submit(spec(PORT, 0), problem=lasso)
    async_job = c.submit(PORT.Spec(
        problem="lasso", problem_kwargs=LASSO_KW,
        scheduler=PORT.Sched(n_workers=4, mode="async_")), problem=lasso)
    too_big = c.submit(spec(PORT, 2, w=16), problem=lasso)
    overflow = c.submit(spec(PORT, 3), problem=lasso)
    assert ok.state == "queued"
    assert async_job.state == "rejected"
    assert "async" in async_job.reject_reason
    assert too_big.state == "rejected" and "caps" in too_big.reject_reason
    assert overflow.state == "rejected"
    assert "backlog" in overflow.reject_reason
    res = c.run_all()
    assert res.report.n_rejected == 3
    with pytest.raises(RuntimeError, match="already ran"):
        c.run_all()
    with pytest.raises(RuntimeError, match="already ran"):
        c.submit(spec(PORT, 1), problem=lasso)


def test_api_default_cluster_resets_and_builds_on_its_device():
    """``api.submit`` with no problem: the default cluster builds it on
    its device at dispatch."""
    kw = dict(n_samples=64, n_features=8)
    job = t_api.submit(PORT.Spec(problem="lasso", problem_kwargs=kw,
                                 max_rounds=2), device="cpu")
    res = t_api.run_all()
    assert res.report.n_jobs == 1 and job.problem.device.type == "cpu"
    assert t_api.demand(job.spec) == j_api.demand(REF.Spec(
        problem="lasso", problem_kwargs=kw, max_rounds=2))
    with pytest.raises(RuntimeError, match="nothing submitted"):
        t_api.run_all()


def test_entry_points_default_to_the_card():
    spec0 = PORT.Spec(problem="lasso",
                      problem_kwargs=dict(n_samples=64, n_features=8))
    if torch.cuda.is_available():
        assert t_rt.Cluster().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        t_rt.Cluster()
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.submit(spec0)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.submit_dag(t_problems.double_ml_dag(n_samples=64,
                                                  n_features=4))
    with pytest.raises(RuntimeError, match="CUDA"):
        t_api.replay(t_rt.generate(t_rt.LoadSpec(model="poisson", jobs=2)))
