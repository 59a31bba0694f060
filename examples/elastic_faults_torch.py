"""Elasticity and fault tolerance on the PyTorch port: the twin of
``examples/elastic_faults.py``.

Runs the same optimization under four regimes and prints the reference
example's comparison:
  1. sync baseline (paper's setting),
  2. sync + worker failures and 15-min lifetimes (respawn + deterministic
     shard regeneration — nothing is lost),
  3. replicated workers (gradient-coding-style exactness under stragglers),
  4. bounded-staleness async ADMM (the paper's proposed improvement),
plus an elastic rescale (W doubles mid-run) and a checkpoint/restart of
(z, x, u, rho) into a new scheduler (``repro_torch.checkpoint``, the
reference's on-disk format).

The run is on the card unless ``--device cpu`` asks for the CPU; without
a card the default raises.

Run:  PYTHONPATH=src python examples/elastic_faults_torch.py
      PYTHONPATH=src python examples/elastic_faults_torch.py --device cpu
"""
import argparse
import tempfile

import numpy as np

from repro_torch import checkpoint as ck
from repro_torch import problems
from repro_torch.api import ExperimentSpec, build, run
from repro_torch.core.admm import AdmmOptions
from repro_torch.runtime import PoolConfig, SchedulerConfig

PROBLEM_KW = dict(n_samples=8_192, n_features=512, density=0.02, lam1=0.5,
                  fista=dict(min_iters=1))
ADMM = AdmmOptions(max_iters=40)


def regime(name, scfg, problem, rounds=40):
    res = run(ExperimentSpec(problem="logreg", problem_kwargs=PROBLEM_KW,
                             scheduler=scfg, max_rounds=rounds, label=name),
              problem=problem)
    obj = problem.objective(res.scheduler.z, res.scheduler.n_logical)
    print(f"{name:28s} rounds={res.rounds:3d} respawns="
          f"{res.n_respawns:3d} r={res.trace[-1]['r_norm']:8.4f} "
          f"obj={obj:10.3f} sim={res.sim_time_s:7.1f}s")
    return res


def main(device="cuda"):
    problem = problems.make("logreg", device=device, **PROBLEM_KW)

    print("== four regimes, same problem ==")
    regime("sync (paper baseline)", SchedulerConfig(
        n_workers=8, admm=ADMM, pool=PoolConfig(seed=0)), problem)
    regime("sync + failures/lifetimes", SchedulerConfig(
        n_workers=8, admm=ADMM,
        pool=PoolConfig(seed=1, fail_rate_per_round=0.04,
                        lifetime_s=60.0)), problem)
    regime("replicated r=2 (coded)", SchedulerConfig(
        n_workers=8, mode="replicated", replication=2, admm=ADMM,
        pool=PoolConfig(seed=2, straggler_frac=0.25,
                        straggler_slowdown=4.0)), problem)
    regime("async S=4, tau=4", SchedulerConfig(
        n_workers=8, mode="async_", async_batch=4, staleness_bound=4,
        admm=ADMM, pool=PoolConfig(seed=3)), problem)

    print("\n== elastic rescale: W=4 -> 8 mid-run ==")
    _, sched = build(ExperimentSpec(
        problem="logreg", problem_kwargs=PROBLEM_KW,
        scheduler=SchedulerConfig(n_workers=4, admm=ADMM,
                                  pool=PoolConfig(seed=4))),
        problem=problem)
    for _ in range(6):
        sched.run_round()
    r_before = sched.history[-1].r_norm
    sched.rescale(8)
    z = sched.solve(max_rounds=34)
    print(f"rescaled at round 6 (r={r_before:.4f}); finished at round "
          f"{len(sched.history)} with r={sched.history[-1].r_norm:.4f}, "
          f"obj={problem.objective(z, 8):.3f}")

    print("\n== checkpoint / restart ==")
    with tempfile.TemporaryDirectory() as td:
        _, sched = build(ExperimentSpec(
            problem="logreg", problem_kwargs=PROBLEM_KW,
            scheduler=SchedulerConfig(n_workers=8, admm=ADMM,
                                      pool=PoolConfig(seed=5))),
            problem=problem)
        for _ in range(5):
            sched.run_round()
        state = {"z": sched.z, "x": sched.x, "u": sched.u,
                 "rho": np.float32(sched.rho)}
        ck.save(state, td, sched.k, {"round": sched.k})
        # "the scheduler dies"; a new one restores and continues
        _, sched2 = build(ExperimentSpec(
            problem="logreg", problem_kwargs=PROBLEM_KW,
            scheduler=SchedulerConfig(n_workers=8, admm=ADMM,
                                      pool=PoolConfig(seed=6))),
            problem=problem)
        restored, meta = ck.restore(state, td)
        sched2.z, sched2.x, sched2.u = (restored["z"], restored["x"],
                                        restored["u"])
        sched2.rho = float(restored["rho"])
        sched2.k = meta["round"]
        z = sched2.solve(max_rounds=35)
        print(f"restored at round {meta['round']}; finished at round "
              f"{sched2.k} with r={sched2.history[-1].r_norm:.4f}, "
              f"obj={problem.objective(z, 8):.3f}")


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
