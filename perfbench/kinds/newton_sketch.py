"""Kind ``newton_sketch``: OverSketched Newton on the paper's rows, through
the program's ``api.run``.

Set-up takes the configuration's instance with the signs the run's seed
draws (``harness/rows.py``) and hands
them to the problem's row cache through the program's public
``problems.carry_shards`` (the problem reads no data cache of its own),
then warms up with two rounds of the cell's own spec.  The benchmark's
wrappers around the problem's ``round_messages_all`` (span ``sketch``),
``master_step`` (span ``master``) and ``decode`` keep, for every round,
the z it started from, the decoded gradient, the decoded Gram's diagonal
and a sample of its other entries drawn from the seed, and the new z; after
the window the program is freed and ``reference/newton.py`` judges each
round in float64 from the round's own z.

The configuration file gives the rows, ``lam2``, ``sketch``, ``admm``
(the tolerance), ``scheduler`` and ``limits``; the traffic file gives
``workers`` and ``rounds_per_solve``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench.harness import peaks
from perfbench.harness import rows as rows_mod
from perfbench.harness.window import Round, Window, attach
from perfbench.reference import newton as ref
from perfbench.reference.simulator import BillingParams, PoolParams, SyncSim

# off-diagonal entries of the decoded Gram compared in each round
GRAM_SAMPLES = 1 << 16



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
        self.lam2 = float(cfg["lam2"])
        self.sketch = dict(cfg["sketch"])
        self.sched = dict(cfg["scheduler"], **tr.get("scheduler", {}))
        self.eps = (float(cfg["admm"]["eps_primal"]),
                    float(cfg["admm"]["eps_dual"]))
        self.ls_max = int(cfg.get("line_search_max", 20))
        self.solves: List[List[dict]] = []
        self.problem = None
        self.rows = None

    # -- set-up -------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch import api, problems
        from repro_torch.core.admm import AdmmOptions
        from repro_torch.runtime import PoolConfig, SchedulerConfig

        t0 = time.perf_counter()
        self.rows = rows_mod.instance(self.N, self.d, self.density,
                                      self.instance_seed, self.seed,
                                      self.device)
        sk = self.sketch
        self.problem = problems.make(
            "newton_sketch", device=self.device, n_samples=self.N,
            n_features=self.d, density=self.density, lam2=self.lam2,
            seed=self.pseed, sketch=sk["method"],
            sketch_dim=int(sk["sketch_dim"]),
            redundancy=int(sk["redundancy"]), coded=bool(sk["coded"]),
            dtype="float32")
        problems.carry_shards(self.problem, {
            (0, 1): tuple(t.cpu().numpy() for t in self.rows)})
        t_rows = time.perf_counter() - t0
        i, j = ref.sample_positions(self.d, GRAM_SAMPLES, self.seed,
                                    self.device)
        self.pos = (i, j)
        d = self.d
        self._flat_off = d + i * d + j
        self._flat_diag = d + torch.arange(d, device=self.device) * (d + 1)
        self.run_spec = api.ExperimentSpec(
            problem="newton_sketch",
            scheduler=SchedulerConfig(
                n_workers=self.W, **self.sched,
                admm=AdmmOptions(eps_primal=self.eps[0],
                                 eps_dual=self.eps[1]),
                pool=PoolConfig(seed=self.pseed)),
            max_rounds=self.R)
        self._api = api
        self._install()
        t1 = time.perf_counter()
        api.run(dataclasses.replace(self.run_spec, max_rounds=2),
                problem=self.problem)
        self.solves.clear()
        self.spans.take()
        self.log(f"set-up: rows drawn and handed over in {t_rows:.2f} s, "
                 f"warm-up {time.perf_counter() - t1:.2f} s")

    def _install(self) -> None:
        problem, spans, solves = self.problem, self.spans, self.solves
        messages_all = problem.round_messages_all
        master_step = problem.master_step
        decode = problem.decode

        def wrapped_messages_all(z, n_workers):
            with spans.span("sketch"):
                return messages_all(z, n_workers)

        def wrapped_decode(messages, responders, n_workers):
            total, n_used = decode(messages, responders, n_workers)
            d = self.d
            solves[-1].append(dict(
                grad_sum=total[:d].clone(),
                gram_off=total[self._flat_off],
                gram_diag=total[self._flat_diag], n_used=int(n_used)))
            return total, n_used

        def wrapped_master(z, messages, responders, n_workers):
            with spans.span("master"):
                z_new, r, s = master_step(z, messages, responders,
                                          n_workers)
            solves[-1][-1].update(z=z.clone(), z_new=z_new.clone(),
                                  r_norm=float(r), s_norm=float(s))
            return z_new, r, s

        problem.round_messages_all = wrapped_messages_all
        problem.decode = wrapped_decode
        problem.master_step = wrapped_master
        solves.append([])

    def solve(self, on_round) -> None:
        self.solves.append([])
        self._api.run(self.run_spec, problem=self.problem,
                      on_round=on_round)

    def close_program(self) -> None:
        self.problem = None

    # -- the check ----------------------------------------------------------
    def _plan(self) -> ref.Sketch:
        sk = self.sketch
        return ref.Sketch(self.N, self.W, int(sk["sketch_dim"]),
                          min(int(sk["redundancy"]), self.W - 1),
                          self.pseed + 1, self.device)

    def _sim(self) -> SyncSim:
        d = self.d
        return SyncSim(PoolParams(seed=self.pseed), BillingParams(), self.W,
                       [self.N] * self.W, msg_bytes=4 * (d + d * d + 1),
                       wire_d=d)

    def check(self, win: Window) -> List[Dict[str, float]]:
        sk = self._plan()
        red = min(int(self.sketch["redundancy"]), self.W - 1)
        iters = ref.task_iters(self.N, self.d, sk, red)
        idx, vals, b = self.rows
        rows64 = (idx, vals.double(), b.double())
        out: List[Dict[str, float]] = []
        refs: Dict[int, tuple] = {}
        solves = attach(self.solves, win)
        for si, solve in enumerate(solves):
            sim = self._sim()
            prev = None
            for ki, rec in enumerate(solve):
                bad = 0
                z = rec["z"]
                cached = refs.get(ki)
                if cached is not None and torch.equal(cached[0], z):
                    rr = cached[1]
                else:
                    rr = ref.newton_round(rows64, z.double(), sk, self.lam2,
                                          self.ls_max)
                    rr = dict(rr, gram=None,
                              entries=ref.gram_entries(rr["gram"], self.pos))
                    refs[ki] = (z, rr)
                gram_gap, step_gap = _judge(rec, rr)
                m = rec["metrics"]
                # the state carried in: zero, then the last round's z
                if prev is None:
                    bad += int(bool(torch.count_nonzero(z)))
                else:
                    bad += int(not torch.equal(
                        z, prev["z_new"].to(z.dtype)))
                bad += int(rec["n_used"] != sk.n_tasks)
                its = np.asarray(m.inner_iters, np.int64)
                bad += int(bool((its != iters).any()))
                bad += int(float(m.r_norm) != rec["r_norm"]
                           or float(m.s_norm) != rec["s_norm"])
                sim_time, cost = sim.round(its)
                bad += int(float(m.sim_time) != sim_time)
                bad += int(float(m.cost_usd) != cost)
                met = (rec["r_norm"] <= self.eps[0]
                       and rec["s_norm"] <= self.eps[1])
                if ki < len(solve) - 1:
                    bad += int(met)
                elif si < win.solves_done:
                    bad += int(not met and len(solve) != self.R)
                out.append({"gram_gap": gram_gap, "step_gap": step_gap,
                            "exact_mismatches": float(bad)})
                prev = rec
        return out

    def control_window(self) -> Window:
        """The control in the program's place: the reference run whole with
        its sketched Grams in TF32, one precision below the configuration's
        float32 with TF32 off."""
        sk = self._plan()
        red = min(int(self.sketch["redundancy"]), self.W - 1)
        iters = np.full(self.W, ref.task_iters(self.N, self.d, sk, red))
        idx, vals, b = self.rows
        rows64 = (idx, vals.double(), b.double())
        sim = self._sim()
        z = torch.zeros(self.d, dtype=torch.float32, device=self.device)
        recs, rounds = [], []
        t = time.perf_counter()
        for k in range(1, self.R + 1):
            rr = ref.newton_round(rows64, z.double(), sk, self.lam2,
                                  self.ls_max, dtype=torch.float32,
                                  tf32=True)
            off, diag = ref.gram_entries(rr["gram"], self.pos)
            sim_time, cost = sim.round(iters)
            m = _Metrics(r_norm=rr["r_norm"], s_norm=rr["s_norm"],
                         inner_iters=iters, sim_time=sim_time,
                         cost_usd=cost)
            recs.append(dict(z=z, z_new=rr["z_new"], grad_sum=rr["grad_sum"],
                             gram_off=off, gram_diag=diag,
                             n_used=sk.n_tasks, r_norm=rr["r_norm"],
                             s_norm=rr["s_norm"]))
            rounds.append(Round(solve=0, k=k, t_end=t, wall_s=0.0,
                                metrics=m, spans={}, traced=False))
            z = rr["z_new"].to(torch.float32)
            if rr["r_norm"] <= self.eps[0] and rr["s_norm"] <= self.eps[1]:
                break
        self.solves[:] = [recs]
        return Window(t0=t, t_end=t, rounds=rounds, solves_done=1)

    # -- work and device ----------------------------------------------------
    def round_work(self, rnd: Round) -> peaks.Work:
        """The least work of a round.  float32: the count sketch (a
        multiply and an add per nonzero and block), the margins and the
        gradient (4 a nonzero), the summed block Grams counted as their
        symmetric half (rows x d (d + 1) / 2 multiply-adds over the
        n_tasks x block_rows sketched rows).  float64: the LU of H (2/3
        d^3) and its two triangular solves (2 d^2).  Bytes: the rows once
        (8 B a nonzero: a 4-byte index and value; 4 B a label), the Gram
        written once in float32 and the system read once in float64."""
        sk = self._plan_shape()
        nnz = int(self.rows[0].numel())
        d = self.d
        rows_sk = sk[0] * sk[1]
        f32 = 2.0 * nnz * sk[0] + 4.0 * nnz + rows_sk * d * (d + 1.0)
        f64 = 2.0 / 3.0 * d ** 3 + 2.0 * d * d
        n_bytes = 8.0 * nnz + 4.0 * self.N + 4.0 * d * d + 8.0 * d * d
        return peaks.Work({"float32": f32, "float64": f64}, n_bytes)

    def _plan_shape(self):
        red = min(int(self.sketch["redundancy"]), self.W - 1)
        n_blocks = self.W - red
        return self.W, -(-int(self.sketch["sketch_dim"]) // n_blocks)


@dataclasses.dataclass
class _Metrics:
    r_norm: float
    s_norm: float
    inner_iters: np.ndarray
    sim_time: float
    cost_usd: float


def _judge(rec: dict, rr: dict):
    off_r, diag_r = rr["entries"]
    gram_gap = max(ref.rel(rec["gram_off"], off_r),
                   ref.rel(rec["gram_diag"], diag_r))
    z = rec["z"].double()
    z_new = rec["z_new"].double()
    step = float(torch.linalg.vector_norm(rr["z_new"] - z))
    z_gap = float(torch.linalg.vector_norm(z_new - rr["z_new"]))
    z_gap = 0.0 if z_gap == 0.0 else z_gap / max(step, 1e-300)
    step_gap = max(z_gap, ref.rel(rec["grad_sum"], rr["grad_sum"]),
                   ref.scalar_rel(float(rec["r_norm"]), rr["r_norm"]),
                   ref.scalar_rel(float(rec["s_norm"]), rr["s_norm"]))
    return gram_gap, step_gap
