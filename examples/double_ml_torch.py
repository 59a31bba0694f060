"""Double machine learning as a phase-structured (DAG) job on the PyTorch
port: the twin of ``examples/double_ml.py``.

Estimates the treatment effect theta0 in a partially linear model

    Y = theta0 * D + g0(X) + eps,      D = m0(X) + v

by K-fold cross-fitting: 2K nuisance lasso fits fan OUT (2 workers each),
one combine stage joins them (1 worker) through the cluster's
``StageResult`` handoff.  One ``DagSpec`` through ``api.submit_dag``; the
cluster gates, sizes, prices and joins the stages.  Prints what the
reference example prints, and asserts, as it does, that cross-fitting
reduces the naive estimate's confounding bias.

The run is on the card unless ``--device cpu`` asks for the CPU; without
a card the default raises.

Run:  PYTHONPATH=src python examples/double_ml_torch.py
      PYTHONPATH=src python examples/double_ml_torch.py --device cpu
"""
import argparse

from repro_torch import problems
from repro_torch.api import run_all, submit_dag
from repro_torch.problems.double_ml import double_ml_dag

N, P, K, THETA = 2048, 32, 4, 1.5


def main(device="cuda"):
    dag = double_ml_dag(n_samples=N, n_features=P, n_folds=K,
                        theta=THETA, confound=0.6, seed=7,
                        nuisance_workers=2, combine_workers=1,
                        label="dml")
    print(f"[double_ml] n={N} p={P} K={K}: {2 * K} nuisance stages "
          f"(2 workers each) -> 1 combine stage (1 worker)")

    h = submit_dag(dag, tenant="econ", device=device)   # one handle
    run_all()

    # the biased baseline: the SAME combine problem run standalone
    # (no handoff) keeps zero nuisance coefficients -> naive OLS of Y on D
    naive = problems.make("double_ml", n_samples=N, n_features=P,
                          n_folds=K, theta=THETA, confound=0.6, seed=7,
                          role="combine", device=device).closed_form_theta()

    theta_hat = float(h.stage_results["combine"].z[0])
    print(f"[double_ml] naive OLS        theta = {naive:.4f}   "
          f"(bias {naive - THETA:+.4f})")
    print(f"[double_ml] cross-fitted DML theta = {theta_hat:.4f}   "
          f"(bias {theta_hat - THETA:+.4f})   true = {THETA}")

    print(f"[double_ml] DAG latency {h.latency_s:.1f}s sim, "
          f"total ${h.total_cost_usd:.4f}; per stage:")
    for name, row in sorted(h.summary()["stages"].items()):
        print(f"    {name:10s} rounds={row['rounds']:2d} "
              f"exec={row['exec_s']:6.2f}s  ${row['cost_usd']:.5f}")

    assert abs(theta_hat - THETA) < abs(naive - THETA), \
        "cross-fitting failed to reduce the confounding bias"
    return h


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
