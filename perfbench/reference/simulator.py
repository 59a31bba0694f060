"""The serverless simulators' arithmetic, frozen for the benchmark.

Copied from the port's ``runtime/pool.py`` (``LambdaPool``: cold starts,
worker speeds, compute and wire times, ``master_drain``), ``runtime/
reduce.py`` (``fanin_drain``, flat path), ``runtime/billing.py``
(``BillingMeter``) and the per-round bookkeeping of ``runtime/
scheduler.py`` (``Scheduler.__init__``, ``_maybe_respawn``, ``run_round``,
``run_round_newton``), as they stood when the benchmark was written, and
cut to what the benchmark's cells run: the ``sync`` barrier, the flat
fan-in, no provider, no autoscaler, no compression, no replication.  Each
sum is taken in the order the port takes it, so the simulated seconds and
dollars of a round agree with the program's to the last bit when both are
handed the same inner-iteration counts.  A later change to the port's
simulators does not move this copy: the benchmark then reports it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class PoolParams:
    """``PoolConfig``'s defaults (the fields the cells read)."""
    cold_base_s: float = 2.2
    cold_per_request_s: float = 0.035
    cold_jitter_s: float = 0.4
    t_inner_per_sample_s: float = 6.0e-5
    t_inner_floor_s: float = 0.01
    speed_sigma: float = 0.05
    straggler_frac: float = 0.0
    straggler_slowdown: float = 2.0
    comm_alpha_s: float = 0.004
    comm_beta_s_per_byte: float = 1.0 / 120e6
    t_ingest_s: float = 0.008
    t_master_proc_s: float = 0.009
    workers_per_master: int = 16
    ingest_frac_fixed: float = 0.25
    ref_msg_bytes: int = 40_004
    lifetime_s: float = 900.0
    fail_rate_per_round: float = 0.0
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class BillingParams:
    """``BillingConfig``'s defaults."""
    mem_gb: float = 3.0
    gb_second_usd: float = 1.66667e-5
    per_request_usd: float = 2.0e-7
    egress_usd_per_gb: float = 0.01
    master_usd_per_s: float = 9.4e-5


# Scheduler's respawn margin before a worker's lifetime ends
RESPAWN_BEFORE_DEADLINE_S = 30.0


@dataclasses.dataclass
class _Worker:
    ready_at: float
    speed: float
    deadline: float
    cold_start_s: float


class SyncSim:
    """One solve's simulated clock and bill: the fleet spawns when the
    solve starts; ``round(iters)`` advances one synchronous round and
    returns (sim seconds at its end, dollars so far)."""

    def __init__(self, pool: PoolParams, billing: BillingParams,
                 n_workers: int, samples: Sequence[int], msg_bytes: int,
                 wire_d: int):
        self.p = pool
        self.b = billing
        self.W = n_workers
        self.samples = list(samples)
        self.msg_bytes = msg_bytes
        self.wire_d = wire_d
        self.rng = np.random.RandomState(pool.seed)
        self.workers: Dict[int, _Worker] = {}
        self.n_spawns = 0
        self.gb_seconds = 0.0
        self.requests = 0
        self.egress_bytes = 0.0
        self.master_seconds = 0.0
        self._billed = 0
        self._spawn(list(range(n_workers)), at=0.0)
        self.sim_time = max(w.ready_at for w in self.workers.values())
        self._bill_spawns()
        for w in self.workers.values():
            self.gb_seconds += self.b.mem_gb * (self.sim_time - w.ready_at) * 1
        self.master_seconds += self.sim_time - 0.0

    # -- the pool ----------------------------------------------------------
    def _spawn(self, wids: List[int], at: float) -> None:
        p = self.p
        cold_pos = 0
        for wid in wids:
            start = (p.cold_base_s + p.cold_per_request_s * cold_pos
                     + abs(self.rng.normal(0.0, p.cold_jitter_s)))
            cold_pos += 1
            speed = float(np.exp(self.rng.normal(0.0, p.speed_sigma)))
            if self.rng.rand() < p.straggler_frac:
                speed *= p.straggler_slowdown
            self.workers[wid] = _Worker(ready_at=at + start, speed=speed,
                                        deadline=at + start + p.lifetime_s,
                                        cold_start_s=start)
            self.n_spawns += 1

    def _comm(self, n_bytes: int) -> float:
        return self.p.comm_alpha_s + n_bytes * self.p.comm_beta_s_per_byte

    def _msg_cost(self, t_ref: float, n_bytes: int) -> float:
        p = self.p
        return t_ref * (p.ingest_frac_fixed + (1.0 - p.ingest_frac_fixed)
                        * n_bytes / p.ref_msg_bytes)

    def _maybe_respawn(self, wid: int) -> float:
        w = self.workers[wid]
        hit = self.sim_time > w.deadline - RESPAWN_BEFORE_DEADLINE_S
        failed = (not hit
                  and bool(self.rng.rand() < self.p.fail_rate_per_round))
        if not (hit or failed):
            return 0.0
        self._spawn([wid], at=self.sim_time)
        return self.workers[wid].cold_start_s

    def _bill_spawns(self) -> None:
        new = self.n_spawns - self._billed
        if new:
            self.requests += new
            self._billed = self.n_spawns

    def _drain(self, arrivals: List[Tuple[float, int]]) -> float:
        p = self.p
        t_ing = self._msg_cost(p.t_ingest_s, self.msg_bytes)
        t_proc = self._msg_cost(p.t_master_proc_s, self.msg_bytes)
        n_masters = -(-self.W // p.workers_per_master)
        router_free = 0.0
        free_at = [0.0] * max(n_masters, 1)
        done = {}
        for i, (t, wid) in enumerate(sorted(arrivals)):
            ingested = max(t, router_free) + t_ing
            router_free = ingested
            m = i % len(free_at)
            start = max(ingested, free_at[m])
            free_at[m] = start + t_proc
            done[wid] = free_at[m]
        return max(done.values())

    # -- one round ---------------------------------------------------------
    def round(self, iters: Sequence[int]) -> Tuple[float, float]:
        W = self.W
        round_start = self.sim_time
        extras = np.zeros(W)
        for wid in range(W):
            extras[wid] = self._maybe_respawn(wid)
        rx = self._comm(4 * self.wire_d)
        tx = self._comm(self.msg_bytes)
        arrivals = []
        for wid in range(W):
            w = self.workers[wid]
            per_iter = (self.p.t_inner_floor_s
                        + self.p.t_inner_per_sample_s * self.samples[wid])
            tc = float(int(iters[wid])) * per_iter * w.speed
            arrivals.append((round_start + extras[wid] + rx + tc + tx, wid))
        master_done = self._drain(arrivals)
        self.sim_time = master_done + self._comm(4 * self.wire_d)
        round_wall = self.sim_time - round_start
        self._bill_spawns()
        self.gb_seconds += (self.b.mem_gb
                            * (round_wall * W - float(extras.sum())) * 1)
        self.master_seconds += round_wall
        self.egress_bytes += W * (self.msg_bytes + 4 * self.wire_d)
        return self.sim_time, self.total_usd()

    def total_usd(self) -> float:
        b = self.b
        compute = self.gb_seconds * b.gb_second_usd
        request = self.requests * b.per_request_usd
        egress = (self.egress_bytes / 1e9) * b.egress_usd_per_gb
        master = self.master_seconds * b.master_usd_per_s
        return compute + request + egress + master


def shard_rows(n_samples: int, n_workers: int, w: int) -> Tuple[int, int]:
    """Rows [lo, hi) of worker w under the near-even split the port uses."""
    base, rem = divmod(n_samples, n_workers)
    lo = w * base + min(w, rem)
    return lo, lo + base + (1 if w < rem else 0)
