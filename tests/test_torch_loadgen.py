"""The port's load generator (``repro_torch.runtime.loadgen``) against the
JAX package's, and a replayed trace through both clusters.

Generation is numpy on both sides, so every trace must equal the
reference's job for job (arrival instants, apps, crc32 tenants, templates,
fleets, rounds, durations, deadlines, pool seeds) and ``compare_to_model``
report for report.  The Azure CSV readers run on files the test writes in
the trace's published layout; nothing is fetched.

The replay uses ``tests/test_cluster_heap.py``'s tiny lasso template
(eps 1e-12, so no job stops early, and lasso's direct solve counts one
inner step a round): its schedule does not depend on the data, so the
port's report and job summaries equal the reference's although each side
draws its own float32 rows; the traces agree to float32 (1e-4 relative,
measured 1.1e-5 on r_norm and s_norm).
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax                                                    # noqa: E402

from repro import api as j_api                                # noqa: E402
from repro.runtime import Cluster as JCluster                 # noqa: E402
from repro.runtime import ClusterConfig as JClusterConfig     # noqa: E402
from repro.runtime import loadgen as j_lg                     # noqa: E402
from repro_torch import api as t_api                          # noqa: E402
from repro_torch.runtime import Cluster, ClusterConfig        # noqa: E402
from repro_torch.runtime import loadgen as t_lg               # noqa: E402


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


def trace_key(wl):
    return [dataclasses.astuple(j) for j in wl.jobs]


SPECS = {
    "poisson": dict(model="poisson", jobs=300, horizon_s=3600.0, seed=3),
    "onoff": dict(model="onoff", jobs=300, horizon_s=7200.0, seed=4),
    "azure": dict(model="azure", jobs=400, horizon_s=4 * 3600.0, seed=9),
    "poisson_rate": dict(model="poisson", horizon_s=1800.0, seed=5,
                         rate_per_min=4.0),
    "onoff_rate": dict(model="onoff", horizon_s=5400.0, seed=6,
                       n_tenants=3, fleet_choices=(1, 2),
                       fleet_weights=(0.5, 0.5)),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_trace_matches_reference(name):
    kw = SPECS[name]
    got = t_lg.generate(t_lg.LoadSpec(**kw))
    want = j_lg.generate(j_lg.LoadSpec(**kw))
    assert len(got) == len(want) > 0
    assert trace_key(got) == trace_key(want)
    assert [j.tenant for j in got.jobs] == [
        j_lg.tenant_of(j.app, got.spec.n_tenants) for j in got.jobs]
    assert got.compare_to_model() == want.compare_to_model()
    assert got.tenant_shares() == want.tenant_shares()
    np.testing.assert_array_equal(got.rate_histogram(),
                                  want.rate_histogram())


def test_experiment_spec_wiring_matches_reference():
    """The same spec field for field; the kernel default is each
    package's plain path ("torch" and "xla")."""
    got = t_lg.generate(t_lg.LoadSpec(**SPECS["azure"]))
    want = j_lg.generate(j_lg.LoadSpec(**SPECS["azure"]))
    for a, b in zip(got.jobs[:40], want.jobs[:40]):
        d_got = got.experiment_spec(a).to_dict()
        d_want = want.experiment_spec(b).to_dict()
        assert (d_got["scheduler"].pop("kernel"),
                d_want["scheduler"].pop("kernel")) == ("torch", "xla")
        assert d_got == d_want


def test_validation_errors():
    with pytest.raises(ValueError, match="model"):
        t_lg.LoadSpec(model="weibull")
    with pytest.raises(ValueError, match="same length"):
        t_lg.LoadSpec(fleet_choices=(1, 2), fleet_weights=(1.0,))
    with pytest.raises(ValueError, match="template"):
        t_lg.LoadSpec(templates=())
    with pytest.raises(ValueError, match="unknown template"):
        t_lg.generate(t_lg.LoadSpec(templates=("nope",)))


def _write_azure_csvs(tmp_path):
    minutes = ",".join(str(i) for i in range(1, 1441))
    inv = tmp_path / "invocations.csv"
    inv.write_text(
        f"HashOwner,HashApp,HashFunction,Trigger,{minutes}\n"
        "o1,appA,f1,http," + ",".join(["3"] * 1440) + "\n"
        "o1,appB,f2,timer," + ",".join(["1"] * 1440) + "\n"
        "o2,appA,f3,queue," + ",".join(str(i % 5) for i in range(1440))
        + "\n")
    dur = tmp_path / "durations.csv"
    dur.write_text(
        "HashOwner,HashApp,HashFunction,Average,Count,Minimum,Maximum\n"
        "o1,appA,f1,5000,100,1,10\n"
        "o1,appB,f2,60000,10,1,10\n"
        "o2,appA,f3,9000,20,1,10\n")
    return inv, dur


def test_azure_csv_readers_match_reference(tmp_path):
    inv, dur = _write_azure_csvs(tmp_path)
    counts, weights = t_lg.load_azure_invocations(inv)
    want_counts, want_weights = j_lg.load_azure_invocations(inv)
    np.testing.assert_array_equal(counts, want_counts)
    assert weights == want_weights
    assert t_lg.load_azure_durations(dur) == j_lg.load_azure_durations(dur)
    kw = dict(model="azure", jobs=200, horizon_s=3600.0, seed=2,
              azure_invocations_csv=str(inv), azure_durations_csv=str(dur))
    got = t_lg.generate(t_lg.LoadSpec(**kw))
    assert trace_key(got) == trace_key(j_lg.generate(j_lg.LoadSpec(**kw)))
    assert {j.app for j in got.jobs} <= {"appA", "appB"}
    with pytest.raises(FileNotFoundError):
        t_lg.generate(t_lg.LoadSpec(
            model="azure", jobs=10,
            azure_invocations_csv=str(tmp_path / "missing.csv")))


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

TINY = {"tiny": dict(problem="lasso",
                     problem_kwargs=dict(n_samples=64, n_features=8),
                     est_round_s=8.0,
                     admm=dict(eps_primal=1e-12, eps_dual=1e-12),
                     pool=dict(t_inner_floor_s=7.9))}
TINY_SPEC = dict(model="poisson", jobs=24, horizon_s=900.0, seed=11,
                 rate_per_min=2.0, rounds_min=1, rounds_max=3,
                 templates=("tiny",), fleet_choices=(2, 4),
                 fleet_weights=(.6, .4), n_tenants=3, slo_slack=3.0,
                 deadline_floor_s=20.0)


def fingerprint(res):
    return (res.report.to_dict(),
            [j.summary() for j in sorted(res.jobs, key=lambda j: j.job_id)])


@pytest.mark.parametrize("engine", ["heap", "scan"])
def test_replay_matches_reference(engine):
    cfg = dict(engine=engine, policy="fair_share", max_concurrent_jobs=4,
               max_active_workers=12)
    with jax_config(jax_threefry_partitionable=True):
        want = j_api.replay(j_lg.generate(j_lg.LoadSpec(**TINY_SPEC),
                                          templates=TINY),
                            cluster=JCluster(JClusterConfig(**cfg)))
    wl = t_lg.generate(t_lg.LoadSpec(**TINY_SPEC), templates=TINY)
    done = []
    got = t_api.replay(wl, cluster=Cluster(ClusterConfig(**cfg),
                                           device="cpu"),
                       on_job_done=done.append)
    assert len(done) == 24 and all(j.state == "done" for j in got.jobs)
    assert fingerprint(got) == fingerprint(want)
    for a, b in zip(want.jobs, got.jobs):
        for key in ("r_norm", "s_norm"):
            np.testing.assert_allclose([r[key] for r in b.result.trace],
                                       [r[key] for r in a.result.trace],
                                       rtol=1e-4, atol=1e-6, err_msg=key)
    # one problem per template, shared by every job of the trace
    assert len({id(j.problem) for j in got.jobs}) == 1


def test_replay_progress_and_device(capsys):
    wl = t_lg.generate(t_lg.LoadSpec(**dict(TINY_SPEC, jobs=12)),
                       templates=TINY)
    probs = wl.problem_instances(device="cpu")
    assert set(probs) == {"tiny"} and probs["tiny"].device.type == "cpu"
    res = t_api.replay(wl, device="cpu", progress_every=5)
    assert all(j.state == "done" for j in res.jobs)
    assert res.report.deadline_attainment is not None
    assert "[replay] 5/12" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            wl.problem_instances()
    c = Cluster(ClusterConfig(), device="cpu")
    job = t_api.submit_at(wl.experiment_spec(wl.jobs[0]), 42.0, cluster=c)
    assert job.submit_at == 42.0
