"""The port's tracer (``repro_torch.trace``) on the CPU: off it records
nothing and opens nothing; on, the scheduler's phases, FISTA's steps and
evaluations and the Newton master's parts are recorded where they run,
nested under their round in order; tracing changes no value the program
computes; under ``torch.profiler`` the tracer turns on by itself and its
records lie on the profiler's clock."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import api, trace                            # noqa: E402
from repro_torch.core import fista                            # noqa: E402
from repro_torch.core.admm import AdmmOptions                 # noqa: E402
from repro_torch.problems.newton_sketch import RoundMessages  # noqa: E402
from repro_torch.runtime import PoolConfig, SchedulerConfig   # noqa: E402

W = 4
ROUNDS = 3
ADMM_CHILDREN = ["round.respawn", "round.xupdate", "round.simulate",
                 "round.fanin", "round.zupdate", "round.simulate"]
NEWTON_CHILDREN = ["round.respawn", "newton.scatter", "round.simulate",
                   "newton.decode", "newton.solve", "newton.line_search",
                   "round.simulate"]


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def admm_spec(**cfg):
    return api.ExperimentSpec(
        problem="logreg", problem_kwargs=dict(n_samples=512, n_features=32),
        scheduler=SchedulerConfig(n_workers=W, engine="batched",
                                  pool=PoolConfig(seed=3), **cfg),
        max_rounds=ROUNDS)


def newton_spec(**cfg):
    return api.ExperimentSpec(
        problem="newton_sketch",
        problem_kwargs=dict(n_samples=512, n_features=32, redundancy=1),
        scheduler=SchedulerConfig(
            n_workers=W, engine="batched",
            admm=AdmmOptions(eps_primal=1e-9, eps_dual=1e9),
            pool=PoolConfig(seed=3), **cfg),
        max_rounds=ROUNDS)


def run(spec):
    return api.run(spec, device="cpu")


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tracer opened a range or an event while "
                             "off")
    monkeypatch.setattr(trace, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not trace.enabled()
    assert trace.span("round") is trace.span("solve")
    run(admm_spec())
    run(newton_spec())
    trace.count("fista.evals")
    assert trace.records() == []
    assert trace.rounds() == []


def _children(recs, parent):
    return [i for i, r in enumerate(recs) if r.parent == parent]


def _check_nesting(recs, want_children):
    rounds = [i for i, r in enumerate(recs) if r.name == "round"]
    assert len(rounds) == ROUNDS
    for k, i in enumerate(rounds, 1):
        rnd = recs[i]
        assert (rnd.solve, rnd.round) == (0, k)
        assert recs[rnd.parent].name == "solve"
        kids = _children(recs, i)
        assert [recs[j].name for j in kids] == want_children
        last = rnd.t0_ns
        for j in kids:
            kid = recs[j]
            assert last <= kid.t0_ns <= kid.t1_ns <= rnd.t1_ns
            last = kid.t1_ns
        # every record inside the round's interval belongs to the round
        inside = [r for r in recs if r.name != "round"
                  and rnd.t0_ns <= r.t0_ns <= rnd.t1_ns]
        assert inside and all((r.solve, r.round) == (0, k) for r in inside)
    assert all(r.t1_ns is not None for r in recs)


def test_admm_round_records_every_span_nested_in_order():
    trace.enable()
    run(admm_spec())
    recs = trace.records()
    names = {r.name for r in recs}
    assert names == {"solve", "round", "fista.step", "fista.backtrack",
                     *ADMM_CHILDREN}
    _check_nesting(recs, ADMM_CHILDREN)
    for r in recs:
        if r.name == "fista.step":
            assert recs[r.parent].name == "round.xupdate"
        if r.name == "fista.backtrack":
            assert recs[r.parent].name == "fista.step"
    summaries = trace.rounds()
    assert [s.round for s in summaries] == list(range(1, ROUNDS + 1))
    for s in summaries:
        assert s.counters["fista.evals"] > 0
        assert s.spans["round.simulate"].n == 2
        assert s.spans["round"].device_s is None
        # the round's own time is what its children leave
        kids = sum(s.spans[n].host_s for n in set(ADMM_CHILDREN))
        assert s.spans["round"].self_host_s == pytest.approx(
            s.spans["round"].host_s - kids, abs=1e-9)


def test_newton_round_records_every_span_nested_in_order():
    trace.enable()
    run(newton_spec())
    recs = trace.records()
    names = {r.name for r in recs}
    assert names == {"solve", "round", "newton.gram", *NEWTON_CHILDREN}
    _check_nesting(recs, NEWTON_CHILDREN)
    for r in recs:
        if r.name == "newton.gram":
            assert recs[r.parent].name == "newton.decode"
    for s in trace.rounds():
        dec, gram = s.spans["newton.decode"], s.spans["newton.gram"]
        assert dec.self_host_s == pytest.approx(dec.host_s - gram.host_s,
                                                abs=1e-9)
        assert "fista.evals" not in s.counters


def test_fista_evals_counts_every_call_of_the_loss():
    calls = []
    target = torch.linspace(-1.0, 2.0, 8).reshape(2, 4)
    scale = torch.tensor([[1.0], [30.0]])

    def vg(x):
        calls.append(1)
        diff = x - target
        return 0.5 * torch.sum(scale * diff * diff, dim=-1), scale * diff

    opts = fista.FistaOptions(min_iters=3, eps_grad=1e-6)
    trace.enable()
    with trace.span("round"):
        fista.solve_lanes(vg, torch.zeros(2, 4), opts)
    n_adaptive = len(calls)
    with trace.span("round"):
        fista.solve_lanes(vg, torch.zeros(2, 4), opts, fixed=4)
    with trace.span("solve"):
        trace.count("fista.evals")      # outside a round: not counted
    first, second = trace.rounds()
    assert first.counters["fista.evals"] > 10
    assert first.counters["fista.evals"] + second.counters["fista.evals"] \
        == len(calls)
    assert second.counters["fista.evals"] == len(calls) - n_adaptive
    assert first.spans["fista.backtrack"].n == first.spans["fista.step"].n


def test_newton_gram_records_equal_the_messages_read(monkeypatch):
    reads = []
    get = RoundMessages.__getitem__

    def counted(self, w):
        reads.append(int(w))
        return get(self, w)
    monkeypatch.setattr(RoundMessages, "__getitem__", counted)
    trace.enable()
    run(newton_spec(mode="replicated", replication=2))
    grams = [r for r in trace.records() if r.name == "newton.gram"]
    assert len(grams) == len(reads) > 0
    assert sum(s.spans["newton.gram"].n for s in trace.rounds()) == \
        len(reads)


def _same_history(a, b):
    assert len(a.scheduler.history) == len(b.scheduler.history)
    for m, n in zip(a.scheduler.history, b.scheduler.history):
        for field, x, y in zip(m._fields, m, n):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and np.array_equal(x, y), field
            else:
                assert x == y, field
    assert a.z.tobytes() == b.z.tobytes()


@pytest.mark.parametrize("make", [admm_spec, newton_spec],
                         ids=["logreg", "newton_sketch"])
def test_tracing_changes_no_value(make):
    off = run(make())
    trace.enable()
    on = run(make())
    assert trace.rounds()
    _same_history(off, on)


def test_profiler_turns_the_tracer_on_and_shares_its_clock():
    from torch.profiler import ProfilerActivity, profile
    trace.enable()
    run(admm_spec())                        # a buffer the profile replaces
    trace.disable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.enabled()
        run(admm_spec())
    assert not trace.enabled()
    recs = trace.records()
    assert {r.solve for r in recs} == {0}
    ranges = sorted((ev.start_ns(), ev.name()) for ev in
                    prof.profiler.kineto_results.events()
                    if ev.name().startswith("repro.round"))
    mine = [r for r in recs if r.name.startswith("round")]
    assert len(ranges) == len(mine) > ROUNDS
    for rec, (start, name) in zip(mine, ranges):
        assert name == trace.RANGE_PREFIX + rec.name
        assert abs(trace.epoch_ns(rec.t0_ns) - start) < 5e6
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert {"repro.fista.step", "repro.fista.backtrack",
            "repro.solve"} <= names
    # the buffer outlives the profile, and an untraced run adds nothing
    run(admm_spec())
    assert len(trace.records()) == len(recs)
    assert len(trace.rounds()) == ROUNDS


def test_records_past_the_cap_are_counted_and_not_kept(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 10)
    trace.enable()
    run(admm_spec())
    assert len(trace.records()) == 10
    assert trace.dropped() > 0
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_a_span_closes_when_its_body_raises():
    trace.enable()
    with pytest.raises(ValueError):
        with trace.span("round"):
            trace.count("fista.evals", 2)
            raise ValueError("inside a round")
    trace.count("fista.evals")          # the round is closed
    (rec,) = trace.records()
    assert rec.t1_ns is not None
    (s,) = trace.rounds()
    assert s.counters == {"fista.evals": 2}
