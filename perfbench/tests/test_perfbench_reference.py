"""The benchmark's references against the program at a small size on the
CPU: the ADMM and Newton cells run through the harness (the program's
float32 path, plain kernels on the CPU) and come out correct under the
committed limits; the frozen simulator gives the program's simulated
seconds and dollars to the last bit; the rows follow their recipe."""
import numpy as np
import pytest
import torch

from perfbench.harness import rows as rows_mod
from perfbench.reference.simulator import (BillingParams, PoolParams,
                                           SyncSim, shard_rows)
from perfbench.tests._small import numbers, run, small_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["logreg_paper.w64",
                                      "newton_sketch_paper.w64"])
def test_program_is_correct_against_the_reference(root, workload):
    out = run(root, workload)
    assert out["result"]["correct"], numbers(out)
    assert out["result"]["failed"] == 0
    assert out["result"]["attempted"] == len(out["window"].rounds) >= 4
    assert numbers(out)["exact_mismatches"] == 0.0


def test_rows_follow_the_recipe():
    idx, vals, b = rows_mod.draw(3000, 500, 0.02, 2 ** 31 + 5, "cpu")
    again = rows_mod.draw(3000, 500, 0.02, 2 ** 31 + 5, "cpu")
    assert all(torch.equal(a, c) for a, c in zip((idx, vals, b), again))
    assert idx.shape == (3000, 10) and idx.dtype == torch.int64
    srt = torch.sort(idx, dim=1).values
    assert bool((srt[:, 1:] != srt[:, :-1]).all())      # distinct features
    assert set(b.unique().tolist()) == {-1.0, 1.0}
    # nonzeros ~ N(nu, 1), nu on the label's side of 0
    assert float((vals.mean(dim=1) * b).mean()) > 0.3
    other = rows_mod.draw(3000, 500, 0.02, 7, "cpu")
    assert not torch.equal(other[0], idx)


def test_simulator_gives_the_programs_clock_and_bill():
    from repro_torch.runtime.pool import LambdaPool, PoolConfig
    from repro_torch.runtime.scheduler import Scheduler, SchedulerConfig

    class Fake:
        n_features, dtype, device = 8, torch.float32, torch.device("cpu")
        h_l1_lam = None

        def n_samples(self, w, W):
            lo, hi = shard_rows(20000, W, w)
            return hi - lo

        def solve_all(self, xs, us, z, rho, kernel="torch"):
            return xs, self.iters

        def prox_h(self, v, t):
            return v

        def supports_batched(self):
            return True

    W, prob = 12, Fake()
    cfg = SchedulerConfig(n_workers=W, engine="batched",
                          pool=PoolConfig(seed=5, lifetime_s=40.0,
                                          fail_rate_per_round=0.05))
    sched = Scheduler(prob, cfg, pool=LambdaPool(cfg.pool))
    sim = SyncSim(PoolParams(seed=5, lifetime_s=40.0,
                             fail_rate_per_round=0.05), BillingParams(), W,
                  [prob.n_samples(w, W) for w in range(W)],
                  msg_bytes=4 * (8 + 1), wire_d=8)
    rng = np.random.RandomState(0)
    for _ in range(12):          # failures, then lifetimes: respawns
        prob.iters = rng.randint(1, 60, size=W)
        m = sched.run_round()
        assert (m.sim_time, m.cost_usd) == sim.round(prob.iters)
    assert sched.n_respawns > 0
