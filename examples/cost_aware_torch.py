"""Cost-aware elastic runs on the PyTorch port: the twin of
``examples/cost_aware.py``.

Runs the same problem four ways through ``repro_torch.api`` and prints
the dollar cost (runtime.billing) next to the sim time, as the reference
example does:

  1. cold baseline      — every spawn pays Fig 8,
  2. + warm keep-alive  — respawns after the (compressed) lifetime land
                          on the provider's idle-sandbox pool,
  3. + autoscale        — the per-job controller resizes the fleet
                          toward its efficiency band mid-run,
  4. manual vs warm rescale — the elasticity claim, priced
                          (``api.build`` for mid-run control).

The run is on the card unless ``--device cpu`` asks for the CPU; without
a card the default raises.

Run:  PYTHONPATH=src python examples/cost_aware_torch.py
      PYTHONPATH=src python examples/cost_aware_torch.py --device cpu
"""
import argparse

from repro_torch import problems
from repro_torch.api import ExperimentSpec, build, run
from repro_torch.core.admm import AdmmOptions
from repro_torch.runtime import (AutoscaleConfig, PoolConfig, ProviderConfig,
                                 SchedulerConfig)

LIFETIME_S = 10.0        # the 15-min limit, compressed to this instance
RESPAWN_MARGIN_S = 2.0   # respawn_before_deadline, scaled to match

PROBLEM_KW = dict(n_samples=8_192, n_features=512, density=0.02, lam1=0.5,
                  fista=dict(min_iters=1))
ADMM = AdmmOptions(max_iters=40)


def priced(name, scfg, problem, rounds=30):
    res = run(ExperimentSpec(problem="logreg", problem_kwargs=PROBLEM_KW,
                             scheduler=scfg, max_rounds=rounds, label=name),
              problem=problem)
    bill = res.cost_breakdown
    sched = res.scheduler
    print(f"{name:26s} W={sched.cfg.n_workers:3d} "
          f"r={res.trace[-1]['r_norm']:7.4f} "
          f"sim={res.sim_time_s:7.1f}s cost=${bill['total_usd']:.4f} "
          f"(compute ${bill['compute_usd']:.4f} / master "
          f"${bill['master_usd']:.4f}) respawns={res.n_respawns:3d} "
          f"warm={sched.pool.warm_frac():4.0%} "
          f"mean_start={sched.pool.mean_start_latency():.2f}s")
    return res


def main(device="cuda"):
    problem = problems.make("logreg", device=device, **PROBLEM_KW)

    print("== the same problem, priced ==")
    priced("cold baseline", SchedulerConfig(
        n_workers=8, admm=ADMM, respawn_before_deadline_s=RESPAWN_MARGIN_S,
        pool=PoolConfig(seed=0, lifetime_s=LIFETIME_S)), problem)
    warm = priced("warm keep-alive", SchedulerConfig(
        n_workers=8, admm=ADMM, respawn_before_deadline_s=RESPAWN_MARGIN_S,
        pool=PoolConfig(seed=0, lifetime_s=LIFETIME_S,
                        provider=ProviderConfig(enabled=True))), problem)
    st = warm.scheduler.pool.provider.stats
    print(f"   provider: {st.warm_hits} warm hits, {st.cold_misses} cold "
          f"misses, {st.evictions} evictions, {st.expirations} TTL reaps")

    auto = priced("warm + autoscale(eff)", SchedulerConfig(
        n_workers=16, admm=ADMM, respawn_before_deadline_s=RESPAWN_MARGIN_S,
        autoscale=AutoscaleConfig(policy="target_efficiency",
                                  min_workers=4, max_workers=16,
                                  cooldown_rounds=4),
        pool=PoolConfig(seed=0, lifetime_s=LIFETIME_S,
                        provider=ProviderConfig(enabled=True))), problem)
    scaler = auto.scheduler.autoscaler
    if scaler and scaler.decisions:
        for k, old, new, why in scaler.decisions:
            print(f"   autoscaler: round {k}: W {old} -> {new} ({why})")

    print("\n== elastic shrink W=8 -> 4, then grow back: cold vs warm ==")
    for name, prov in (("cold spawns", ProviderConfig()),
                       ("warm pool", ProviderConfig(enabled=True))):
        _, sched = build(ExperimentSpec(
            problem="logreg", problem_kwargs=PROBLEM_KW,
            scheduler=SchedulerConfig(
                n_workers=8, admm=ADMM,
                pool=PoolConfig(seed=4, provider=prov))), problem=problem)
        for _ in range(4):
            sched.run_round()
        sched.rescale(4)            # retirees' sandboxes stay warm
        for _ in range(2):
            sched.run_round()
        t0 = sched.sim_time
        sched.rescale(8)            # the grow wave
        print(f"{name:26s} grow-back stall {sched.sim_time - t0:5.2f}s "
              f"({'all 8 spawns hit the keep-alive pool' if prov.enabled else 'all cold starts'})")


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args(argv).device)


if __name__ == "__main__":
    cli()
