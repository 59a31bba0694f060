"""The controls and planted faults: each has to come out not correct.

The ADMM control (the reference in bfloat16 in the program's place) runs
here at a small size; the Newton control (its Grams in TF32) needs a
card.  The faults are planted under the timed path of a whole run whose
look for a card is skipped: a step that returns its state unchanged, half
of the batch left out of the mean, an answer altered where it is made,
and, for the ADMM solver, a local solve cut short of its stopping rule
(one step, or a gradient test a hundred times looser).  (One card: there is no
exchange between chips to leave out.)"""
import pytest
import torch

from perfbench.tests._small import numbers, run, small_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"))


def test_admm_control_is_not_correct(root):
    out = run(root, "logreg_paper.w64", control=True)
    assert not out["result"]["correct"], numbers(out)


@pytest.mark.cuda
def test_newton_control_is_not_correct_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the TF32 control needs a CUDA card")
    import time
    from perfbench.harness import bench, spec
    root = small_root(tmp_path)
    cell = spec.cell_spec("newton_sketch_paper.w64", root=root)
    out = bench.run_cell(cell, 5, float("inf"), False, "cuda",
                         time.perf_counter(), max_solves=1, control=True)
    assert not out["result"]["correct"], numbers(out)


def _admm_fault(monkeypatch, kind):
    import dataclasses
    from repro_torch.core import fista
    from repro_torch.problems import base
    from repro_torch.runtime import scheduler
    running = fista._running
    if kind == "one_step":
        monkeypatch.setattr(fista, "_running",
                            lambda st, opts: running(st, opts) & (st.k < 1))
    elif kind == "loose_tolerance":
        monkeypatch.setattr(fista, "_running", lambda st, opts: running(
            st, dataclasses.replace(opts, eps_grad=100 * opts.eps_grad)))
    elif kind == "unchanged":
        def solve_all(self, xs, us, z, rho, kernel="torch"):
            return xs.clone(), torch.ones(xs.shape[0], dtype=torch.int64)
        monkeypatch.setattr(base.BatchedShardProblem, "solve_all",
                            solve_all)
    elif kind == "half_batch":
        orig = scheduler.Scheduler._master_z_update

        def master(self, omega_bar, q_sum, n_eff, adapt_rho=True):
            half = self.omega_table[: self.omega_table.shape[0] // 2]
            return orig(self, half.mean(dim=0), q_sum, n_eff, adapt_rho)
        monkeypatch.setattr(scheduler.Scheduler, "_master_z_update", master)
    else:
        from repro_torch.kernels import ref

        orig = ref.soft_threshold_ref

        def altered(omega, z_old, thr):
            z, ssq, nnz = orig(omega, z_old, thr)
            z = z.clone()
            z[0] += 1.0
            return z, ssq, nnz
        monkeypatch.setattr(ref, "soft_threshold_ref", altered)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered",
                                   "one_step", "loose_tolerance"])
def test_admm_faults_are_not_correct(root, monkeypatch, fault):
    _admm_fault(monkeypatch, fault)
    out = run(root, "logreg_paper.w64")
    assert not out["result"]["correct"], numbers(out)


def _newton_fault(monkeypatch, kind):
    from repro_torch.problems import newton_sketch as ns
    if kind == "unchanged":
        orig = ns.NewtonSketchProblem.master_step

        def master(self, z, messages, responders, n_workers):
            _, r, s = orig(self, z, messages, responders, n_workers)
            return torch.as_tensor(z).double().clone(), r, s
        monkeypatch.setattr(ns.NewtonSketchProblem, "master_step", master)
    elif kind == "half_batch":
        orig = ns.NewtonSketchProblem.decode

        def decode(self, messages, responders, n_workers):
            total, n_used = orig(self, messages, responders, n_workers)
            d = self.n_features
            half = messages[int(responders[0])].clone()
            for w in responders[2: len(responders) // 2: 2]:
                half += messages[int(w)]
            total[d:] = half[d:] * 2.0
            return total, n_used
        monkeypatch.setattr(ns.NewtonSketchProblem, "decode", decode)
    else:
        orig = ns.NewtonSketchProblem.master_step

        def master(self, z, messages, responders, n_workers):
            z_new, r, s = orig(self, z, messages, responders, n_workers)
            z_new = z_new.clone()
            z_new[0] += 1e-3
            return z_new, r, s
        monkeypatch.setattr(ns.NewtonSketchProblem, "master_step", master)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_newton_faults_are_not_correct(root, monkeypatch, fault):
    _newton_fault(monkeypatch, fault)
    out = run(root, "newton_sketch_paper.w64")
    assert not out["result"]["correct"], numbers(out)
