"""Quickstart on the PyTorch port: the twin of ``examples/quickstart.py``.

Solves the same l1-penalized logistic regression instance (Koh-Kim-Boyd
synthetic data, Section III of the paper) with synchronous parallel
consensus ADMM over a simulated serverless worker pool, through
``repro_torch.api``, and prints what the reference example prints: the
residual trace (the paper's Fig. 3), the utilization metrics (idle /
compute per worker, cold starts), the cost and the final objective.

The run is on the card unless ``--device cpu`` asks for the CPU; without
a card the default raises.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

from repro_torch.api import ExperimentSpec, run
from repro_torch.core.admm import AdmmOptions
from repro_torch.runtime import PoolConfig, SchedulerConfig

W = 8


def main(device="cuda"):
    # a 1/40-scale instance of the paper's problem (same density regime)
    spec = ExperimentSpec(
        problem="logreg",
        problem_kwargs=dict(n_samples=15_000, n_features=1_000,
                            density=0.01, lam1=1.0,
                            fista=dict(min_iters=1)),
        scheduler=SchedulerConfig(
            n_workers=W,
            admm=AdmmOptions(rho0=1.0, max_iters=100,
                             eps_primal=2e-2, eps_dual=2e-2),
            pool=PoolConfig(seed=0, straggler_frac=0.05)))

    header_shown = []

    def report(m):
        if not header_shown:
            header_shown.append(True)
            print(f"{'k':>3} {'r_norm':>10} {'s_norm':>10} {'rho':>8} "
                  f"{'avg comp':>9} {'avg idle':>9} {'sim time':>9}")
        print(f"{m.k:3d} {m.r_norm:10.4f} {m.s_norm:10.4f} {m.rho:8.3f} "
              f"{m.t_comp.mean():8.2f}s {m.t_idle.mean():8.2f}s "
              f"{m.sim_time:8.1f}s")

    result = run(spec, on_round=report, device=device)

    print(f"\nspawned {W} workers; cold starts: "
          + ", ".join(f"{c:.1f}s"
                      for c in result.scheduler.cold_starts.values()))
    summary = result.to_dict()
    print(f"converged in {result.rounds} rounds "
          f"(paper: <= 23 at full scale), cost=${result.cost_usd:.4f}")
    print(f"solution sparsity: {summary['z_nnz']}/1000 nonzeros "
          f"(l1 prox at the master, Eq. 6)")
    print(f"final objective phi(z) = "
          f"{result.problem.objective(result.scheduler.z, W):.4f}")
    return result


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
