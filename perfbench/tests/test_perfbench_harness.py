"""The harness's own arithmetic and plumbing on the CPU: the work counts
behind the roofline shares, the window's round accounting, the guard
against JAX, and a configuration, traffic mix, kind and metric added as
new files that the harness finds with no edit to a file it has."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from perfbench.harness import bench, peaks, spec, window
from perfbench.harness import rows as rows_mod
from perfbench.tests._small import ROOT, run, small_root


def _metric(name):
    return spec.load_metric(name, ROOT)


def test_work_counts_read_the_same_for_dense_and_sparse_rows():
    from repro_torch.problems.base import densify_sparse_rows
    idx, vals, b = rows_mod.draw(2048, 300, 0.02, 3, "cpu")
    dense = densify_sparse_rows(idx.view(4, 512, -1), vals.view(4, 512, -1),
                                300)
    nnz_sparse = int(idx.numel())
    nnz_dense = int(torch.count_nonzero(dense))
    assert nnz_sparse == nnz_dense
    margin = _metric("margin_roofline")
    for work in (margin.eval_work, margin.loss_work):
        a = work(nnz_sparse, 2048, 4, 300)
        c = work(nnz_dense, 2048, 4, 300)
        assert (a.bytes, a.flops) == (c.bytes, c.flops)
    # the paper's evaluation: about 55 MB, bound by bytes
    w = margin.eval_work(6_000_000, 600_000, 64, 10_000)
    assert 55e6 < w.bytes < 56e6
    assert peaks.least_seconds(w) == w.bytes / peaks.HBM_BYTES_PER_S


def test_round_work_counts_the_lanes_least_evaluations(tmp_path):
    """A round's work follows from its lanes' FISTA steps and the rows, so
    the dense path and the plain sparse path of the same rows are held to
    the same work for the same steps."""
    from perfbench.reference.simulator import shard_rows
    root = small_root(tmp_path)
    sparse = root / "perfbench/traffic/w64_r20_sparse.json"
    tr = json.loads((root / "perfbench/traffic/w64_r20.json").read_text())
    sparse.write_text(json.dumps(dict(tr, scheduler={"kernel": "torch"})))
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    bench_json["workloads"].append(
        {"name": "logreg_paper.sparse", "config": "logreg_paper",
         "traffic": "w64_r20_sparse", "chips": 1, "why": "a test's cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    dense = run(root, "logreg_paper.w64", max_solves=1)
    plain = run(root, "logreg_paper.sparse", max_solves=1)
    margin = _metric("margin_roofline")
    cell = dense["cell"]
    per_row = cell.nonzeros() // cell.N
    for rnd in dense["window"].rounds:
        want = peaks.Work({}, 12.0 * cell.d)
        for w, k in enumerate(rnd.metrics.inner_iters):
            lo, hi = shard_rows(cell.N, cell.W, w)
            n = hi - lo
            want = (want + margin.eval_work(per_row * n, n, 1, cell.d)
                    .scaled(int(k))
                    + margin.loss_work(per_row * n, n, 1, cell.d)
                    .scaled(int(k) + 1))
        for c in (cell, plain["cell"]):
            got = c.round_work(rnd)
            assert got.bytes == pytest.approx(want.bytes, rel=1e-12)
            assert got.flops["float32"] == pytest.approx(
                want.flops["float32"], rel=1e-12)
    # off the card the share of the card's peak is not read
    assert "round_mfu" not in run(root, "logreg_paper.w64", max_solves=1,
                                  trace=True)["result"]["metrics"]


def test_least_seconds_sums_precisions_and_takes_the_larger_bound():
    w = peaks.Work({"float32": 67e12, "float64": 67e12}, 3.35e12)
    assert peaks.least_seconds(w) == pytest.approx(2.0)
    w = peaks.Work({"float32": 67e9}, 3.35e12)
    assert peaks.least_seconds(w) == pytest.approx(1.0)
    assert peaks.least_seconds(w.scaled(3) + w) == pytest.approx(4.0)


class _Solves:
    """A solve of ``rounds`` rounds, each ``dt`` seconds long."""

    def __init__(self, rounds, dt):
        self.rounds, self.dt, self.calls = rounds, dt, 0

    def __call__(self, on_round):
        self.calls += 1
        for k in range(self.rounds):
            time.sleep(self.dt)
            on_round(k)


def test_window_ends_at_a_rounds_end_and_counts_every_round():
    spans = window.Spans()
    win = window.run(_Solves(5, 0.01), 0.12, lambda: None, spans)
    # the window closes at the end of the first round past its length
    assert win.rounds[-2].t_end < win.t0 + 0.12 <= win.rounds[-1].t_end
    assert win.t_end == win.rounds[-1].t_end
    # rounds partition the window: none is cut, none counted twice
    assert sum(r.wall_s for r in win.rounds) == pytest.approx(win.seconds)
    ks = [(r.solve, r.k) for r in win.rounds]
    assert ks == [(i // 5, i % 5 + 1) for i in range(len(ks))]
    # the solve the window closed in is not counted done
    assert win.solves_done == (len(win.rounds) - 1) // 5
    # whole solves only
    win = window.run(_Solves(3, 0.0), float("inf"), lambda: None, spans,
                     max_solves=2)
    assert len(win.rounds) == 6 and win.solves_done == 2


def test_spans_go_to_the_round_in_progress():
    spans = window.Spans()

    def solve(on_round):
        for k in range(3):
            with spans.span("part"):
                time.sleep(0.002)
            on_round(k)
    win = window.run(solve, float("inf"), lambda: None, spans, max_solves=1)
    assert all(0.002 <= r.spans["part"] <= r.wall_s for r in win.rounds)


def test_the_guard_compares_whole_top_level_names():
    names = ["repro_torch", "repro_torch.api", "jaxtyping", "numpy"]
    assert bench.forbidden_modules(names) == []
    assert bench.forbidden_modules(names + ["repro.api"]) == ["repro"]
    assert bench.forbidden_modules(["jax._src.core", "flax"]) == ["flax",
                                                                 "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole small run in a fresh process: no module named jax, jaxlib,
    flax or repro (whole top-level names) is loaded."""
    root = small_root(tmp_path)
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from perfbench.harness import bench, spec\n"
        "from perfbench.tests._small import run\n"
        f"out = run({str(root)!r}, 'logreg_paper.w64', max_solves=1,"
        " trace=True)\n"
        f"run({str(root)!r}, 'newton_sketch_paper.w64', max_solves=1)\n"
        "assert out['result']['attempted'] > 0\n"
        "print('LOADED', bench.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED []" in res.stdout


def test_run_py_refuses_without_a_card_or_the_program(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = ["--workload", "logreg_paper.w64", "--seed", "1",
            "--seconds", "1"]
    res = subprocess.run([sys.executable, "perfbench/run.py", *args],
                         cwd=ROOT, capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "perfbench/run.py", *args],
                         cwd=tmp_path, capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode != 0 and res.stdout == ""


def _digest(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "perfbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_with_no_edit(tmp_path):
    root = small_root(tmp_path)
    before = _digest(root)
    bench_json = json.loads((root / "BENCHMARK.json").read_text())
    # a configuration of an existing kind, a traffic mix, a metric
    cfg = json.loads((root / "perfbench/configs/logreg_paper.json")
                     .read_text())
    cfg.update(name="logreg_tiny", lam1=0.5)
    (root / "perfbench/configs/logreg_tiny.json").write_text(json.dumps(cfg))
    (root / "perfbench/traffic/w2_r3.json").write_text(json.dumps(
        {"workers": 2, "rounds_per_solve": 3}))
    (root / "perfbench/metrics/rounds_done.py").write_text(
        "def read(ctx):\n    return float(len(ctx.window.rounds))\n")
    bench_json["configs"].append(
        {"name": "logreg_tiny", "source": "https://arxiv.org/abs/1901.03161",
         "file": "perfbench/configs/logreg_tiny.json", "reduced": [],
         "why": "a test's configuration"})
    bench_json["workloads"].append(
        {"name": "logreg_tiny.w2", "config": "logreg_tiny",
         "traffic": "w2_r3", "chips": 1, "why": "a test's cell"})
    bench_json["per_layer"].append(
        {"name": "rounds_done", "unit": "rounds", "better": "higher",
         "source": "program_counter", "layer": "scheduler and simulators",
         "moves": "round_s", "workloads": ["logreg_tiny.w2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))
    out = run(root, "logreg_tiny.w2", trace=True, max_solves=2)
    assert out["result"]["correct"]
    assert out["result"]["metrics"]["rounds_done"]["value"] == 6.0
    assert "idle_share" not in out["result"]["metrics"]     # no card here
    # nothing that was there changed
    after = _digest(root)
    assert {k: after[k] for k in before} == before
    # the committed cells are unaffected by the new entries
    assert "rounds_done" not in run(root, "logreg_paper.w64", trace=True,
                                    max_solves=1)["result"]["metrics"]
