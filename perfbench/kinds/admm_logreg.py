"""Kind ``admm_logreg``: the paper's consensus ADMM on l1-regularised
logistic regression, through the program's ``api.run``.

Set-up takes the configuration's instance with the signs the run's seed
draws (``harness/rows.py``), writes
each worker's shard where the program's data cache reads it
(``REPRO_DATA_CACHE``, under the run's temporary directory), builds the
problem, stacks and stages the shards (the ``staging`` span), and warms
up with two rounds of the cell's own spec.  A solve is the spec run from
cold.  The benchmark's wrappers around the problem's ``solve_all`` and the
master's z-update (the fused kernel's wrapper, or ``prox_h``) take spans
and keep what each round started from and produced; after the window the
program is freed and ``reference/admm.py`` judges every round.

The configuration file gives the rows, ``lam1``, ``admm``, ``fista``,
``scheduler`` and ``limits``; the traffic file gives ``workers`` and
``rounds_per_solve``, and may override ``scheduler`` and ``fista`` keys.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import peaks
from perfbench.harness import rows as rows_mod
from perfbench.harness import spec as spec_mod
from perfbench.harness.window import Round, Window, attach
from perfbench.reference import admm as ref
from perfbench.reference.simulator import (BillingParams, PoolParams,
                                           SyncSim, shard_rows)



class Cell:
    def __init__(self, spec, *, seed: int, device: str, spans, log):
        cfg, tr = spec.config, spec.traffic
        self.spec = spec
        self.seed = int(seed)
        self.pseed = rows_mod.program_seed(seed)
        self.device = torch.device(device)
        self.spans = spans
        self.log = log
        self.W = int(tr["workers"])
        self.R = int(tr["rounds_per_solve"])
        r = cfg["rows"]
        self.N, self.d, self.density = (int(r["n_samples"]),
                                        int(r["n_features"]),
                                        float(r["density"]))
        self.instance_seed = int(r["instance_seed"])
        self.lam1 = float(cfg["lam1"])
        self.fista = dict(cfg["fista"], **tr.get("fista", {}))
        self.sched = dict(cfg["scheduler"], **tr.get("scheduler", {}))
        a = cfg["admm"]
        self.admm = ref.Admm(lam1=self.lam1, rho0=float(a["rho0"]),
                             eps_primal=float(a["eps_primal"]),
                             eps_dual=float(a["eps_dual"]))
        self.solves: List[List[dict]] = []
        self.problem = None
        self.rows = None
        self._data_dir = None
        self._restore = lambda: None

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch import api, problems
        from repro_torch.core.admm import AdmmOptions
        from repro_torch.runtime import PoolConfig, SchedulerConfig

        t0 = time.perf_counter()
        self.rows = rows_mod.instance(self.N, self.d, self.density,
                                      self.instance_seed, self.seed,
                                      self.device)
        self._data_dir = tempfile.mkdtemp(prefix="perfbench-rows-")
        n_bytes = rows_mod.write_shards(
            self.rows, self.W, self._data_dir, n_samples=self.N,
            n_features=self.d, density=self.density, seed=self.pseed)
        os.environ["REPRO_DATA_CACHE"] = self._data_dir
        t_rows = time.perf_counter() - t0
        self.problem = problems.make(
            "logreg", device=self.device, n_samples=self.N,
            n_features=self.d, density=self.density, lam1=self.lam1,
            seed=self.pseed, fista=dict(self.fista), dtype="float32")
        with self.spans.span("staging", setup=True):
            self.problem.batch_shards(self.W)
            if self.sched.get("kernel") == "cuda":
                self.problem.kernel_batch_shards(self.W)
        a = self.admm
        self.run_spec = api.ExperimentSpec(
            problem="logreg",
            scheduler=SchedulerConfig(
                n_workers=self.W, **self.sched,
                admm=AdmmOptions(rho0=a.rho0, eps_primal=a.eps_primal,
                                 eps_dual=a.eps_dual),
                pool=PoolConfig(seed=self.pseed)),
            max_rounds=self.R)
        self._api = api
        self._install()
        t1 = time.perf_counter()
        api.run(dataclasses.replace(self.run_spec, max_rounds=2),
                problem=self.problem)
        self.solves.clear()
        self.spans.take()
        self.log(f"set-up: rows drawn and written ({n_bytes / 1e6:.1f} MB) "
                 f"in {t_rows:.2f} s, staged in "
                 f"{self.spans.setup['staging']:.2f} s, warm-up "
                 f"{time.perf_counter() - t1:.2f} s")

    def _install(self) -> None:
        """The benchmark's wrappers around the problem's x-update and the
        master's z-update: a span, and a copy of what goes in and out."""
        from repro_torch.kernels import ops

        problem, spans, solves = self.problem, self.spans, self.solves
        solve_all, prox_h = problem.solve_all, problem.prox_h
        fused = ops.fused_z_update

        def wrapped_solve_all(xs, us, z, rho, *a, **kw):
            with spans.span("solve_all"):
                xs_new, iters = solve_all(xs, us, z, rho, *a, **kw)
            solves[-1].append(dict(
                x0=xs.clone(), us=us.clone(), z=z.clone(), rho=float(rho),
                x_new=xs_new.clone(), counts=np.array(iters, np.int64)))
            return xs_new, iters

        def wrapped_fused(omega_bar, z_old, thr):
            out = fused(omega_bar, z_old, thr)
            solves[-1][-1].update(omega=omega_bar.clone(),
                                  z_new=out[0].clone())
            return out

        def wrapped_prox(v, t):
            z = prox_h(v, t)
            solves[-1][-1].update(omega=v.clone(), z_new=z.clone())
            return z

        problem.solve_all = wrapped_solve_all
        problem.prox_h = wrapped_prox
        ops.fused_z_update = wrapped_fused
        self._restore = lambda: setattr(ops, "fused_z_update", fused)
        # the warm-up's records go to a solve of their own
        solves.append([])

    def solve(self, on_round) -> None:
        self.solves.append([])
        self._api.run(self.run_spec, problem=self.problem,
                      on_round=on_round)

    def close_program(self) -> None:
        self._restore()
        self.problem = None
        if self._data_dir:
            shutil.rmtree(self._data_dir, ignore_errors=True)
        os.environ.pop("REPRO_DATA_CACHE", None)

    # -- the check ----------------------------------------------------------
    def _sim(self) -> SyncSim:
        samples = [shard_rows(self.N, self.W, w)[1]
                   - shard_rows(self.N, self.W, w)[0] for w in range(self.W)]
        return SyncSim(PoolParams(seed=self.pseed), BillingParams(), self.W,
                       samples, msg_bytes=4 * (self.d + 1), wire_d=self.d)

    def _opts(self) -> ref.Fista:
        return ref.Fista(**{k: self.fista[k] for k in
                            ("min_iters", "max_iters", "eps_grad",
                             "eps_fval") if k in self.fista})

    def check(self, win: Window) -> List[Dict[str, float]]:
        lane_rows = ref.LaneRows(self.rows, self.W, self.d, torch.float64)
        solves = attach(self.solves, win)
        complete = [i < win.solves_done for i in range(len(solves))]
        return ref.judge(solves, lane_rows, self.admm, self._opts(), self.R,
                         self._sim, complete)

    def control_window(self) -> Window:
        """The control in the program's place: the reference run whole in
        bfloat16, one precision below the configuration's float32."""
        lane_rows = ref.LaneRows(self.rows, self.W, self.d, torch.bfloat16)
        recs = ref.run_solve(lane_rows, self.admm, self._opts(), self.R,
                             self._sim())
        self.solves[:] = [recs]
        t = time.perf_counter()
        rounds = [Round(solve=0, k=i + 1, t_end=t, wall_s=0.0,
                        metrics=r["metrics"], spans={}, traced=False)
                  for i, r in enumerate(recs)]
        return Window(t0=t, t_end=t, rounds=rounds, solves_done=1)

    # -- work and device ----------------------------------------------------
    def nonzeros(self) -> int:
        return int(self.rows[0].numel())

    def round_work(self, rnd: Round) -> peaks.Work:
        """The least work of a round, whatever implements it: each lane's
        FISTA over its own sparse rows, from its steps (the round's
        ``inner_iters``, which the check holds to the stopping rule), and
        the z-update (omega, z_old in, z out).  A step needs one loss and
        gradient (``margin_roofline.eval_work``) and one loss
        (``margin_roofline.loss_work``: the backtracking test, whose point
        is the step's result once it holds), and a solve one loss at its
        start.  Evaluations an implementation makes beyond these are its
        own cost: making fewer reads as a higher share."""
        margin = spec_mod.load_metric("margin_roofline", self.spec.root)
        per_row = self.nonzeros() // self.N
        work = peaks.Work({}, 3 * 4 * self.d)
        for w, k in enumerate(np.asarray(rnd.metrics.inner_iters, np.int64)):
            lo, hi = shard_rows(self.N, self.W, w)
            nnz, n = per_row * (hi - lo), hi - lo
            work = (work + margin.eval_work(nnz, n, 1, self.d).scaled(k)
                    + margin.loss_work(nnz, n, 1, self.d).scaled(k + 1))
        return work

