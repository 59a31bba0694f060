"""The per-layer metrics that read the program's own spans and counters
(``repro_torch.trace`` through ``harness/program_trace.py``), on whole
traced runs of the three cells at the small size: each reads a number in
exactly the cells its entry lists, the evaluations' yield is a share, the
round's phases fit in its wall, and a program without the tracer, or a
run without the profiler, reads as nothing."""
import json
import sys

import pytest

from perfbench.harness import bench, program_trace, spec
from perfbench.tests._small import run, small_root

CELLS = ["logreg_paper.w64", "newton_sketch_paper.w64", "logreg_paper.w256"]
NEW = ["xupdate_ms", "zupdate_ms", "fanin_ms", "loss_evals", "eval_yield",
       "sim_ms", "scatter_ms", "gram_ms", "decode_ms", "newton_solve_ms",
       "line_search_ms"]
PHASES = {"round.xupdate": "device", "round.zupdate": "device",
          "round.fanin": "host", "round.respawn": "host",
          "round.simulate": "host"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each cell's traced run, every new metric's reader called on it
    (whatever the cell's entry lists), and the program's round summaries,
    taken before the next run replaces them."""
    root = small_root(tmp_path_factory.mktemp("bench"))
    out = {}
    for cell in CELLS:
        res = run(root, cell, trace=True)
        ctx = bench.Context(spec=spec.cell_spec(cell, root=root),
                            cell=res["cell"], window=res["window"],
                            setup_s=0.0, setup_spans={})
        read = {name: spec.load_metric(name, root).read(ctx)
                for name in NEW}
        out[cell] = dict(result=res["result"], window=res["window"],
                         read=read, rounds=program_trace.rounds())
    return root, out


def _listed(root):
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    return {m["name"]: m["workloads"] for m in bench_json["per_layer"]
            if m["name"] in NEW}


def test_every_new_metric_reads_in_exactly_its_cells(runs):
    root, out = runs
    listed = _listed(root)
    assert sorted(listed) == sorted(NEW)
    for name, cells in listed.items():
        for cell in CELLS:
            assert out[cell]["result"]["correct"]
            reported = out[cell]["result"]["metrics"]
            found = out[cell]["read"][name] is not None
            assert found == (cell in cells), (name, cell)
            assert (name in reported) == (cell in cells), (name, cell)


def test_eval_yield_is_a_share(runs):
    _, out = runs
    for cell in ("logreg_paper.w64", "logreg_paper.w256"):
        y = out[cell]["result"]["metrics"]["eval_yield"]["value"]
        assert 0 < y <= 100
        assert out[cell]["result"]["metrics"]["loss_evals"]["value"] > 0


def test_the_round_phases_fit_in_the_rounds_wall(runs):
    _, out = runs
    for cell in CELLS:
        traced = [r for r in out[cell]["window"].rounds if r.traced]
        summaries = out[cell]["rounds"]
        assert len(summaries) == len(traced) > 0
        for s, rnd in zip(summaries, traced):
            parts = sum(program_trace._seconds(s.spans[n], clock, False)
                        for n, clock in PHASES.items() if n in s.spans)
            assert 0 < parts <= s.spans["round"].host_s <= rnd.wall_s


def test_an_untraced_run_leaves_no_rounds(runs):
    from repro_torch import trace
    root, _ = runs
    trace.reset()
    res = run(root, "logreg_paper.w64", max_solves=1)
    assert res["result"]["correct"]
    assert trace.rounds() == []
    assert program_trace.rounds() is None


def test_a_program_without_the_tracer_reads_nothing(runs, monkeypatch):
    root, _ = runs
    res = run(root, "logreg_paper.w64", trace=True, max_solves=1)
    assert program_trace.rounds() is not None
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    ctx = bench.Context(spec=spec.cell_spec("logreg_paper.w64", root=root),
                        cell=res["cell"], window=res["window"],
                        setup_s=0.0, setup_spans={})
    for name in NEW:
        assert spec.load_metric(name, root).read(ctx) is None, name
