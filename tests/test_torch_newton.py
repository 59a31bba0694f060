"""The port's second-order path (``problems/newton_sketch.py`` and
``Scheduler.run_round_newton``) against the JAX package's, live, in the
same process.

The port carries the reference's rows (``problems.carry_shards``, the
reference's ``worker_shard_sparse`` under the same JAX config as its run),
so the Newton path, not data generation, is under test.  JAX runs with the
partitionable threefry layout and, for float64, x64.

Held in float64: every round's r_norm and s_norm to 1e-12 relative
(measured 7.1e-15), sim_time, cost_usd and the other trace keys to 1e-12
(measured 0: the clock reads only the inner counts), equal inner counts, z
to 1e-12 (measured 4.9e-14), under sync, drop_slowest, replicated, tree
fan-in, stragglers with failures, the uncoded plan, an SRHT sketch and a
mid-run rescale, on both engines; the messages, the master step and the
contract helpers likewise.  The port's own guarantees are held exactly:
loop == batched, and under the replicated barrier a straggling, failing
fleet gives the clean fleet's trace.  In float32 the rounds-to-target of
``tests/test_newton.py::test_newton_beats_admm_twin_on_rounds``'s
configuration equal the live reference's counts (9 Newton rounds, 25 ADMM
rounds: its 5x claim does not hold on this threefry stream, so the counts
are compared, not the claim).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import api as j_api                                # noqa: E402
from repro import problems as j_problems                      # noqa: E402
from repro.core.admm import AdmmOptions as JAdmm              # noqa: E402
from repro.data import logreg as j_data                       # noqa: E402
from repro.runtime import PoolConfig as JPool                 # noqa: E402
from repro.runtime import SchedulerConfig as JCfg             # noqa: E402
from repro.runtime.scheduler import Scheduler as JScheduler   # noqa: E402
from repro_torch import api as t_api                          # noqa: E402
from repro_torch import problems as t_problems                # noqa: E402
from repro_torch.core.admm import AdmmOptions                 # noqa: E402
from repro_torch.runtime import PoolConfig, SchedulerConfig   # noqa: E402
from repro_torch.runtime.scheduler import Scheduler           # noqa: E402
from test_torch_cluster import (PORT, REF, assert_jobs_match,  # noqa: E402
                                fingerprint)
from test_torch_data import jax_config                        # noqa: E402

KW = dict(n_samples=512, n_features=32, redundancy=1)
F64 = dict(KW, dtype="float64")
W = 8
ROUNDS = 8
RTOL = 1e-12
TRACE_KEYS = ("r_norm", "s_norm", "rho", "sim_time", "cost_usd",
              "round_wall_s", "t_fanin_wait", "t_comp_mean", "t_idle_mean")
FAULTY = dict(straggler_frac=0.5, straggler_slowdown=25.0,
              fail_rate_per_round=0.05)


def reference(x64=True):
    return jax_config(jax_threefry_partitionable=True, jax_enable_x64=x64)


def ref_rows(p):
    """The reference problem's rows as a carry_shards dict (call under the
    run's JAX config: the draws depend on x64)."""
    idx, vals, b = j_data.worker_shard_sparse(p.cfg, 0, 1)
    return {(0, 1): (np.asarray(idx), np.asarray(vals), np.asarray(b))}


def port_problem(name, kw, rows):
    p = t_problems.make(name, device="cpu", **kw)
    t_problems.carry_shards(p, rows)
    return p


def spec(P, kw=F64, *, w=W, rounds=ROUNDS, mode="sync", engine="batched",
         pool=None, **cfg):
    """``P`` picks the package: (api, SchedulerConfig, AdmmOptions,
    PoolConfig)."""
    api, Cfg, Admm, Pool = P
    return api.ExperimentSpec(
        problem="newton_sketch", problem_kwargs=kw,
        scheduler=Cfg(n_workers=w, mode=mode, engine=engine,
                      admm=Admm(eps_primal=1e-9, eps_dual=1e9),
                      pool=Pool(seed=0, **(pool or {})), **cfg),
        max_rounds=rounds)


JP = (j_api, JCfg, JAdmm, JPool)
TP = (t_api, SchedulerConfig, AdmmOptions, PoolConfig)


def run_pair(kw=F64, *, rescale_to=None, **cfg):
    """The same spec through both packages: (reference result, port
    result); the port carries the reference's rows."""
    def drive(api, s, p):
        if rescale_to is None:
            return api.run(s, problem=p)
        _, sched = api.build(s, problem=p)
        for k in range(s.max_rounds):
            if k == s.max_rounds // 2:
                sched.rescale(rescale_to)
            sched.step()
        return api.result_from_scheduler(s, p, sched)

    with reference(kw.get("dtype") == "float64"):
        pj = j_problems.make("newton_sketch", **kw)
        ref = drive(j_api, spec(JP, kw, **cfg), pj)
        rows = ref_rows(pj)
    got = drive(t_api, spec(TP, kw, **cfg),
                port_problem("newton_sketch", kw, rows))
    return ref, got


def assert_exact(ref, got):
    assert len(got.trace) == len(ref.trace)
    for key in TRACE_KEYS:
        np.testing.assert_allclose([r[key] for r in got.trace],
                                   [r[key] for r in ref.trace], rtol=RTOL,
                                   atol=1e-14, err_msg=key)
    assert ([m.inner_iters.tolist() for m in got.history]
            == [m.inner_iters.tolist() for m in ref.history])
    assert [r["n_workers"] for r in got.trace] == [
        r["n_workers"] for r in ref.trace]
    assert [r["z_nnz"] for r in got.trace] == [-1] * len(got.trace)
    np.testing.assert_allclose(got.z, np.asarray(ref.z), rtol=RTOL,
                               atol=1e-14)
    assert got.z.dtype == np.asarray(ref.z).dtype


CASES = {
    "sync": dict(mode="sync"),
    "drop_slowest": dict(mode="drop_slowest", drop_frac=0.125),
    "replicated": dict(mode="replicated", replication=2),
    "tree": dict(mode="sync", fanin="tree"),
    "replicated_tree": dict(mode="replicated", replication=2, fanin="tree"),
    "faulty": dict(mode="replicated", replication=2, pool=FAULTY),
}


@pytest.mark.parametrize("engine", ["loop", "batched"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_matches_jax(case, engine):
    ref, got = run_pair(engine=engine, **CASES[case])
    assert_exact(ref, got)


@pytest.mark.parametrize("kw,cfg", [
    (dict(F64, coded=False, redundancy=2),
     dict(mode="drop_slowest", drop_frac=0.25, rounds=15)),
    (dict(F64, sketch="srht", sketch_dim=128), dict(mode="replicated",
                                                    replication=2)),
    (dict(F64, redundancy=2), dict(mode="drop_slowest", drop_frac=0.25,
                                   w=7)),
], ids=["uncoded", "srht", "cyclic"])
def test_plan_variants_match_jax(kw, cfg):
    """ignore-extra-blocks (subset-dependent, so the straggler order
    matters), an SRHT sketch, and a cyclic code (r = 3 does not divide
    W = 7: the decode solves for its coefficients)."""
    ref, got = run_pair(kw, **cfg)
    assert_exact(ref, got)


def test_rescale_matches_jax():
    """A mid-run rescale builds a new plan for the new fleet size."""
    ref, got = run_pair(rescale_to=4)
    assert [r["n_workers"] for r in got.trace] == [8] * 4 + [4] * 4
    assert_exact(ref, got)


def test_float32_trace_close_to_jax():
    """float32: the rounds' sums run in other orders (the reference's dense
    rows, the port's sparse ones), measured 5.9e-5 relative on r_norm and
    s_norm as r_norm reaches 1.8e-2: held at 5e-4, the clock exact."""
    ref, got = run_pair(dict(KW), rounds=12)
    for key in ("r_norm", "s_norm"):
        np.testing.assert_allclose([r[key] for r in got.trace],
                                   [r[key] for r in ref.trace], rtol=5e-4,
                                   err_msg=key)
    for key in ("sim_time", "cost_usd"):
        assert [r[key] for r in got.trace] == [r[key] for r in ref.trace]


# ---------------------------------------------------------------------------
# the port's own guarantees, exactly
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rows64():
    with reference():
        return ref_rows(j_problems.make("newton_sketch", **F64))


def test_loop_and_batched_engines_identical(rows64):
    """One round computation behind both engines: equal messages and equal
    traces, bit for bit."""
    traces = {}
    for engine in ("loop", "batched"):
        res = t_api.run(spec(TP, mode="replicated", replication=2,
                             engine=engine),
                        problem=port_problem("newton_sketch", F64, rows64))
        traces[engine] = [(r["r_norm"], r["s_norm"], r["sim_time"],
                           r["cost_usd"]) for r in res.trace]
    assert traces["loop"] == traces["batched"]
    p = port_problem("newton_sketch", F64, rows64)
    z = torch.as_tensor(np.random.RandomState(1).randn(32) * 0.1)
    msgs, iters = p.round_messages_all(z, W)
    for w in range(W):
        row, it = p.round_message(w, W, z)
        assert torch.equal(row, msgs[w]) and it == iters[w]


def test_straggler_exact_at_scheduler_boundary(rows64):
    """Under the replicated barrier the master decodes the exact full-sketch
    Hessian from the first W-(r-1) responses: stragglers and failures
    change the clock, not the math."""
    runs = [t_api.run(spec(TP, mode="replicated", replication=2, pool=pool),
                      problem=port_problem("newton_sketch", F64, rows64))
            for pool in (None, FAULTY)]
    clean, faulty = runs
    for key in ("r_norm", "s_norm"):
        assert ([r[key] for r in faulty.trace]
                == [r[key] for r in clean.trace]), key
    assert np.array_equal(faulty.z, clean.z)
    assert faulty.n_respawns > 0
    assert (max(float(m.t_comp.max()) for m in faulty.history)
            > 5.0 * max(float(m.t_comp.max()) for m in clean.history))


def test_messages_and_master_step_match_jax(rows64):
    """At a random z: every task's message, and the master step from every
    one-straggler responder subset (each equal to the others bit for bit:
    the FRS twin carries the same message)."""
    z = np.random.RandomState(2).randn(32) * 0.1
    with reference():
        pj = j_problems.make("newton_sketch", **F64)
        msgs_j, iters_j = pj.round_messages_all(z, W)
        steps_j = []
        for drop in range(W):
            resp = np.array([i for i in range(W) if i != drop])
            steps_j.append(pj.master_step(z, msgs_j[resp], resp, W))
    p = port_problem("newton_sketch", F64, rows64)
    msgs, iters = p.round_messages_all(torch.as_tensor(z), W)
    assert iters.tolist() == iters_j.tolist() and len(msgs) == W
    scale = np.abs(msgs_j).max()
    for w in range(W):
        np.testing.assert_allclose(msgs[w].numpy(), msgs_j[w], rtol=RTOL,
                                   atol=RTOL * scale)
    first = None
    for drop, (zj, rj, sj) in enumerate(steps_j):
        resp = np.array([i for i in range(W) if i != drop])
        z_new, r, s = p.master_step(torch.as_tensor(z), msgs, resp, W)
        np.testing.assert_allclose(z_new.numpy(), zj, rtol=RTOL, atol=1e-14)
        np.testing.assert_allclose([r, s], [rj, sj], rtol=RTOL)
        if first is None:
            first = (z_new, r, s)
        assert torch.equal(z_new, first[0]) and (r, s) == first[1:]


def test_contract_matches_jax(rows64):
    """message_floats, task_iters, n_samples, objective, full_grad, h_value
    and the stubs, against the reference; the wire accounting of a built
    scheduler."""
    rng = np.random.RandomState(3)
    with reference():
        pj = j_problems.make("newton_sketch", **F64)
        zs = [rng.randn(32) * 0.2 for _ in range(3)]
        want = [(pj.objective(z), np.asarray(pj.full_grad(z)),
                 pj.h_value(z)) for z in zs]
        iters_j = {(s, w): j_problems.make(
            "newton_sketch", n_samples=512, n_features=32,
            redundancy=s).task_iters(w) for s in (0, 1, 2) for w in (4, 8)}
    p = port_problem("newton_sketch", F64, rows64)
    assert p.message_floats == pj.message_floats == 32 + 32 * 32
    assert p.n_samples(3, W) == pj.n_samples(3, W) == 512
    assert p.second_order and p.redundancy == 1
    for z, (f, g, h) in zip(zs, want):
        zt = torch.as_tensor(z)
        assert p.objective(zt) == pytest.approx(f, rel=RTOL)
        np.testing.assert_allclose(p.full_grad(zt).numpy(), g, rtol=RTOL,
                                   atol=RTOL * np.abs(g).max())
        assert p.h_value(zt) == pytest.approx(h, rel=RTOL)
        assert p.prox_h(zt, 0.5) is zt
    for (s, w), it in iters_j.items():
        assert t_problems.make("newton_sketch", device="cpu", n_samples=512,
                               n_features=32,
                               redundancy=s).task_iters(w) == it
    with pytest.raises(NotImplementedError, match="second-order"):
        p.solve(0, W, None, None, None, 1.0)
    _, sched = t_api.build(spec(TP, w=4), problem=p)
    assert sched.msg_bytes == 4 * (p.message_floats + 1)
    assert sched._second_order and sched.repl == 1 and sched.n_logical == 4


CONFIG_ERRORS = [
    (dict(mode="async_"), {}, "async_"),
    (dict(compress="topk"), {}, "compression"),
    (dict(kernel="cuda", engine="batched"), dict(kernel="pallas"),
     "fuses the FISTA"),
    (dict(mode="replicated", replication=4), {}, "redundancy"),
    (dict(mode="drop_slowest", drop_frac=0.5), {}, "over-provisions"),
]


@pytest.mark.parametrize("cfg,ref_cfg,msg", CONFIG_ERRORS,
                         ids=[m for _, _, m in CONFIG_ERRORS])
def test_config_errors_match_jax(cfg, ref_cfg, msg):
    """tests/test_newton.py's refusals, raised alike (the port's
    kernel="cuda" stands where the reference's kernel="pallas" does)."""
    kw = dict(n_samples=256, n_features=16)
    with reference(False), pytest.raises(ValueError, match=msg):
        JScheduler(j_problems.make("newton_sketch", **kw),
                   JCfg(n_workers=4, **dict(cfg, **ref_cfg)))
    with pytest.raises(ValueError, match=msg):
        Scheduler(t_problems.make("newton_sketch", device="cpu", **kw),
                  SchedulerConfig(n_workers=4, **cfg))


def test_batched_engine_needs_round_messages_all():
    class _Newton:
        second_order = True
        n_features = 4
        redundancy = 1
        dtype = torch.float32
    with pytest.raises(ValueError, match="round_messages_all"):
        Scheduler(_Newton(), SchedulerConfig(n_workers=2, engine="batched"))


# ---------------------------------------------------------------------------
# rounds to target, the API and the cluster
# ---------------------------------------------------------------------------


def rounds_to_target(P, problems, kw, pn, pa, grad_norm):
    """tests/test_newton.py::test_newton_beats_admm_twin_on_rounds: the
    rounds Newton (replicated, r=2) and its ADMM twin (sync) need to bring
    the true gradient norm to 1e-3 of its value at 0, at W=16."""
    api, Cfg, Admm, _ = P
    Wt = 16
    target = 1e-3 * grad_norm(pn, np.zeros(32))
    rs = []
    api.run(api.ExperimentSpec(
        problem="newton_sketch",
        problem_kwargs=dict(sketch_dim=256, redundancy=1, **kw),
        scheduler=Cfg(n_workers=Wt, mode="replicated", replication=2,
                      admm=Admm(eps_primal=-1.0)), max_rounds=40),
        problem=pn, on_round=lambda m: rs.append(m.r_norm))
    n_newton = next(i + 1 for i, r in enumerate(rs) if r <= target)
    _, sched = api.build(api.ExperimentSpec(
        problem="logreg_l2", problem_kwargs=kw,
        scheduler=Cfg(n_workers=Wt, admm=Admm(eps_primal=-1.0))), problem=pa)
    for k in range(1, 81):
        sched.step()
        if grad_norm(pn, sched.z) <= target:
            return n_newton, k
    return n_newton, None


def test_rounds_to_target_match_jax():
    kw = dict(n_samples=512, n_features=32, lam2=1e-3, seed=0)
    with reference(False):
        pn = j_problems.make("newton_sketch", sketch_dim=256, redundancy=1,
                             **kw)
        pa = j_problems.make("logreg_l2", **kw)
        want = rounds_to_target(JP, j_problems, kw, pn, pa, lambda p, z: float(
            np.linalg.norm(p.full_grad(np.asarray(z, np.float64)))))
        rows = ref_rows(pn)
        shards = {(w, 16): tuple(np.asarray(a) for a in pa._shard(w, 16))
                  for w in range(16)}
    got = rounds_to_target(
        TP, t_problems, kw,
        port_problem("newton_sketch", dict(kw, sketch_dim=256,
                                           redundancy=1), rows),
        port_problem("logreg_l2", kw, shards),
        lambda p, z: float(torch.linalg.vector_norm(
            p.full_grad(torch.as_tensor(z)))))
    assert got == want
    assert want[1] is not None and want[0] < want[1]


def test_api_on_a_newton_spec(rows64):
    """run defaults to the card; kernel="cuda" is refused; build, demand
    and submit take a newton_sketch spec as the reference's do."""
    s = spec(TP, w=4, rounds=2)
    if torch.cuda.is_available():
        assert t_api.run(s).problem.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            t_api.run(s)
    with pytest.raises(ValueError, match="kernel='cuda'"):
        t_api.run(spec(TP, w=4, kernel="cuda"), device="cpu")
    with reference():
        want = j_api.demand(spec(JP, w=4))
    assert t_api.demand(s) == want
    p = port_problem("newton_sketch", F64, rows64)
    job = t_api.submit(s, tenant="a", problem=p, device="cpu")
    res = t_api.run_all()
    solo = t_api.run(s, problem=port_problem("newton_sketch", F64, rows64))
    assert job.state == "done"
    assert [r["r_norm"] for r in job.result.trace] == [
        r["r_norm"] for r in solo.trace]
    assert res.report.n_jobs == 1 and res.report.n_rejected == 0


@pytest.mark.parametrize("engine", ["heap", "scan"])
def test_newton_job_in_cluster_matches_jax(engine):
    """One newton_sketch job beside two logreg_l2 jobs of another tenant on
    a DRF cluster: the same report, summaries and traces as the
    reference's, job for job (float64)."""
    l2_kw = dict(n_samples=256, n_features=32, density=0.2, dtype="float64")
    nw_kw = dict(l2_kw, redundancy=1)

    def submit(P, c, probs):
        for i, (name, kw, tenant, eng) in enumerate([
                ("newton_sketch", nw_kw, "alice", "batched"),
                ("logreg_l2", l2_kw, "bob", "batched"),
                ("logreg_l2", l2_kw, "bob", "loop")]):
            c.submit(P.Spec(problem=name, problem_kwargs=kw,
                            scheduler=P.Sched(
                                n_workers=4, engine=eng,
                                admm=P.Admm(max_iters=3, eps_dual=1e9),
                                pool=P.Pool(seed=30 + i,
                                            provider=P.Provider())),
                            max_rounds=3, label=f"{name}{i}"),
                     tenant=tenant, problem=probs[name])

    with reference():
        ref_probs = {"newton_sketch": j_problems.make("newton_sketch",
                                                     **nw_kw),
                     "logreg_l2": j_problems.make("logreg_l2", **l2_kw)}
        rows = ref_rows(ref_probs["newton_sketch"])
        shards = {(w, 4): tuple(np.asarray(a) for a in
                                ref_probs["logreg_l2"]._shard(w, 4))
                  for w in range(4)}
        rc = REF.cluster(policy="drf", engine=engine, max_concurrent_jobs=2,
                         max_active_workers=8)
        submit(REF, rc, ref_probs)
        ref = rc.run_all()
    port_probs = {"newton_sketch": port_problem("newton_sketch", nw_kw, rows),
                  "logreg_l2": port_problem("logreg_l2", l2_kw, shards)}
    pc = PORT.cluster(policy="drf", engine=engine, max_concurrent_jobs=2,
                      max_active_workers=8)
    submit(PORT, pc, port_probs)
    got = pc.run_all()
    assert all(j.state == "done" for j in got.jobs)
    assert fingerprint(got) == fingerprint(ref)
    assert_jobs_match(ref, got)


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 8, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_phase8_runs_on_the_cpu(monkeypatch, tmp_path, capsys):
    """Phase 8's whole flow at a tiny size on the CPU (the card's timers
    stubbed): three runs bitwise equal, the decoded Hessians against the
    oracle, the control; and its bounds at the paper's size, from the
    reckoning (the Grams 2·64·1 270·10⁸ FLOP in float32: 243 ms)."""
    from test_torch_slice import _chip_smoke
    from repro_torch import runtime as t_rt
    from repro_torch.kernels import logistic_vjp as t_lv
    from repro_torch.kernels import soft_threshold as t_st
    smoke = _chip_smoke()
    assert smoke.NEWTON_KW["sketch_dim"] == 8 * 10_000
    bounds = smoke.newton_bounds(
        type("Plan", (), dict(n_tasks=64, block_rows=1270,
                              blocks_per_task=lambda self: 2))(),
        600_000, 6_000_000, 10_000, 32, 2)
    assert bounds["grams"] == (pytest.approx(242.63, rel=1e-4),
                               "operations")
    assert bounds["solve"][1] == "operations"
    assert bounds["sketch"][1] == "bytes"
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda: 0)
    monkeypatch.setattr(smoke, "nvidia_smi", lambda q: "no card")
    monkeypatch.setattr(smoke, "ROOT", tmp_path)
    monkeypatch.setattr(smoke, "NEWTON_KW", dict(
        n_samples=3000, n_features=40, density=0.1, lam2=1e-3,
        sketch="count", sketch_dim=320, redundancy=1))
    monkeypatch.setattr(smoke, "NEWTON_W", 8)
    row = t_problems.RoundMessages.__getitem__
    smoke.phase_newton(torch, t_api, t_problems, t_rt, AdmmOptions, t_lv,
                       t_st, {}, device="cpu")
    assert t_problems.RoundMessages.__getitem__ is row
    out = capsys.readouterr().out
    assert "bitwise equal" in out and "control" in out
    assert not any((tmp_path / "build").glob("*"))
