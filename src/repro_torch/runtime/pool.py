"""Serverless worker-pool simulator with a discrete event clock.

The optimization MATH runs for real (repro.core.admm on real shards); TIME
is simulated so the paper's systems experiments (cold start, stragglers,
15-minute lifetimes, scheduler queuing) are reproducible on one host.
Constants are calibrated against the paper's figures:

* **Cold start (Fig 8)** — bulk spawns through CURL's multi interface queue
  in a background thread, so the i-th request of a bulk sees
  ``base + i * per_request`` plus jitter; the paper's fastest worker comes
  up in ~2-3 s and the slowest degrades linearly beyond W≈64.
* **Compute (Figs 5-7)** — a worker's round time is
  ``inner_iters * t_inner(N_w) * speed_w`` where inner_iters is the REAL
  FISTA iteration count from the solve and speed_w is a lognormal
  per-worker multiplier (plus persistent stragglers at a configurable
  slowdown — Fig 9's tail).
* **Scheduler fan-in (Fig 5's efficiency cliff)** — masters ingest one
  ω-message per ``t_proc``; ``ceil(W / workers_per_master)`` masters drain
  the queue round-robin.  Queuing is negligible at W=64 and dominates by
  W=256, reproducing the paper's 74% -> 26% efficiency drop.
* **Lifetimes / failures** — workers die at their Lambda lifetime limit (or
  by failure injection); the scheduler respawns them (cold start) and the
  replacement regenerates its shard deterministically (data/logreg.py).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.runtime.provider import Provider, ProviderConfig


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    # cold start (calibrated to Fig 8)
    cold_base_s: float = 2.2
    cold_per_request_s: float = 0.035      # bulk-queue slope
    cold_jitter_s: float = 0.4
    # compute model
    t_inner_per_sample_s: float = 6.0e-5   # FISTA iteration cost per sample
    t_inner_floor_s: float = 0.01          # per-iteration overhead
    speed_sigma: float = 0.05              # lognormal worker speed spread
    # the paper's fleet showed NO persistent stragglers (Fig 9) — the
    # default is 0; the mitigation experiments inject them explicitly
    straggler_frac: float = 0.0
    straggler_slowdown: float = 2.0
    # communication (alpha-beta) — star network, d-vector messages
    comm_alpha_s: float = 0.004
    comm_beta_s_per_byte: float = 1.0 / 120e6    # ~120 MB/s per worker
    # scheduler fan-in: ONE router thread ingests every message (the ZMQ
    # fair-queue), then ceil(W/W-bar) master threads reduce in parallel.
    # The serial ingest is what produces the paper's W=256 cliff.
    t_ingest_s: float = 0.008              # router thread, per message
    t_master_proc_s: float = 0.009         # per ω-message reduce
    workers_per_master: int = 16           # the paper's W-bar
    # per-message costs are mostly deserialization, so they scale with the
    # wire size: cost(b) = t * (frac_fixed + (1-frac_fixed) * b/ref).
    # ref_msg_bytes is the paper's dense (q, ω) message at d=10 000, so
    # the calibrated constants above are reproduced EXACTLY for the
    # paper's message and compression buys cheaper ingest, not just
    # cheaper wire time (msg_cost()).
    ingest_frac_fixed: float = 0.25
    ref_msg_bytes: int = 40_004
    # lifetime / failure
    lifetime_s: float = 900.0              # Lambda 15-minute limit
    fail_rate_per_round: float = 0.0
    seed: int = 0
    # provider model (runtime.provider): warm-container keep-alive,
    # eviction policy, and the account-level cold-spawn throttle.
    # Disabled by default — the cold-only path is byte-identical to the
    # seed model (same RNG draw sequence; tests/test_provider.py anchors)
    provider: ProviderConfig = ProviderConfig()


@dataclasses.dataclass
class SimWorker:
    wid: int                    # stable worker slot (shard index)
    ready_at: float             # sim time when cold start completes
    speed: float                # compute-time multiplier (>1 = slower)
    deadline: float             # sim time of lifetime expiry
    spawned_at: float
    generation: int = 0         # how many times this slot was (re)spawned
    cold_start_s: float = 0.0   # start latency (cold OR warm)
    warm_start: bool = False    # landed on a keep-alive sandbox
    env_cid: int = -1           # provider sandbox id (-1: provider off)
    env_created_at: float = 0.0  # when the sandbox was first provisioned
    env_uses: int = 1           # invocations this sandbox has served


class LambdaPool:
    """Spawns/replaces simulated serverless workers; owns the RNG.

    ``provider`` injects a pre-built (possibly SHARED) keep-alive
    provider instead of the config-owned one — the multi-tenant cluster
    (``runtime/cluster.py``) backs many pools with one warm pool this
    way; ``tenant`` tags every sandbox lease and per-tenant stat this
    pool generates.  Both default to the historical single-pool
    behavior."""

    def __init__(self, cfg: PoolConfig, *,
                 provider: Optional[Provider] = None,
                 tenant: Optional[str] = None):
        self.cfg = cfg
        self.rng = np.random.RandomState(cfg.seed)
        self.workers: Dict[int, SimWorker] = {}
        self.total_spawns = 0
        self.tenant = tenant
        if provider is not None:
            self.provider: Optional[Provider] = provider
        else:
            self.provider = (Provider(cfg.provider,
                                      cold_base_s=cfg.cold_base_s)
                             if cfg.provider.enabled else None)
        # (start latency, was_warm) per spawn — benchmarks/bench_cost reads
        # this for the mean-start-latency axis; pure bookkeeping, no RNG
        self.spawn_log: List[Tuple[float, bool]] = []

    # -- spawning -----------------------------------------------------------

    def _speed(self) -> float:
        s = float(np.exp(self.rng.normal(0.0, self.cfg.speed_sigma)))
        if self.rng.rand() < self.cfg.straggler_frac:
            s *= self.cfg.straggler_slowdown
        return s

    def _cold_start(self, queue_pos: int) -> float:
        c = self.cfg
        return (c.cold_base_s + c.cold_per_request_s * queue_pos
                + abs(self.rng.normal(0.0, c.cold_jitter_s)))

    def _release_env(self, w: SimWorker, at: float):
        """Hand a finished worker's sandbox back to the keep-alive pool."""
        if self.provider is not None and w.env_cid >= 0:
            self.provider.release(cid=w.env_cid,
                                  created_at=w.env_created_at,
                                  uses=w.env_uses, speed=w.speed, at=at,
                                  tenant=self.tenant)

    def spawn_bulk(self, wids: List[int], at: float) -> List[SimWorker]:
        """Spawn workers for the given slots; POST requests queue in one
        background thread (the paper's CURL multi interface).

        With the provider enabled, sandboxes of slots being replaced go
        back to the keep-alive pool first, then each launch either hits a
        warm sandbox (sticky speed, sub-second start, skips the CURL
        provisioning queue) or cold-misses into the Fig 8 model — where
        the queue position counts COLD provisions only, and the account
        burst limit can add a throttle wait."""
        prov = self.provider
        if prov is not None:
            for wid in wids:
                if wid in self.workers:
                    self._release_env(self.workers[wid], at)
        out = []
        cold_pos = 0
        for wid in wids:
            warm = (prov.acquire(at, tenant=self.tenant)
                    if prov is not None else None)
            if warm is not None:
                start = prov.warm_start_s()
                speed = warm.speed
                cid, env_at, uses = warm.cid, warm.created_at, warm.uses
            else:
                start = self._cold_start(cold_pos)
                cold_pos += 1
                speed = self._speed()
                if prov is not None:
                    start += prov.throttle_wait(at)
                    cid, env_at, uses = prov.new_cid(self.tenant), at, 1
                else:
                    cid, env_at, uses = -1, at, 1
            gen = (self.workers[wid].generation + 1
                   if wid in self.workers else 0)
            w = SimWorker(wid=wid, ready_at=at + start, speed=speed,
                          deadline=at + start + self.cfg.lifetime_s,
                          spawned_at=at, generation=gen, cold_start_s=start,
                          warm_start=warm is not None, env_cid=cid,
                          env_created_at=env_at, env_uses=uses)
            self.workers[wid] = w
            self.total_spawns += 1
            self.spawn_log.append((start, warm is not None))
            out.append(w)
        return out

    def retire(self, wids: List[int], at: float):
        """Remove worker slots for good (elastic shrink): their sandboxes
        go back to the provider's keep-alive pool."""
        for wid in wids:
            w = self.workers.pop(wid, None)
            if w is not None:
                self._release_env(w, at)

    def crash(self, wid: int):
        """Mark a worker's sandbox as destroyed (failure injection): the
        provider tears down crashed environments, so the next spawn for
        this slot cannot land warm on it — and its lease ends without
        the sandbox ever reaching the idle pool."""
        w = self.workers.get(wid)
        if w is not None:
            if self.provider is not None and w.env_cid >= 0:
                self.provider.forfeit(w.env_cid)
            w.env_cid = -1

    def mean_start_latency(self) -> float:
        return (float(np.mean([s for s, _ in self.spawn_log]))
                if self.spawn_log else 0.0)

    def warm_frac(self) -> float:
        return (float(np.mean([w for _, w in self.spawn_log]))
                if self.spawn_log else 0.0)

    # -- per-round timing ---------------------------------------------------

    def compute_time(self, w: SimWorker, inner_iters: int,
                     n_samples: int) -> float:
        c = self.cfg
        per_iter = c.t_inner_floor_s + c.t_inner_per_sample_s * n_samples
        return float(inner_iters) * per_iter * w.speed

    def comm_time(self, n_bytes: int) -> float:
        c = self.cfg
        return c.comm_alpha_s + n_bytes * c.comm_beta_s_per_byte

    def msg_cost(self, t_ref: float, n_bytes: int) -> float:
        """Per-message ingest/reduce cost for an n_bytes message, scaled
        from the calibrated reference-message constant ``t_ref``."""
        c = self.cfg
        return t_ref * (c.ingest_frac_fixed + (1.0 - c.ingest_frac_fixed)
                        * n_bytes / c.ref_msg_bytes)

    def roll_failure(self) -> bool:
        return bool(self.rng.rand() < self.cfg.fail_rate_per_round)


def master_drain(arrivals: List[Tuple[float, int]], n_masters: int,
                 t_proc: float, t_ingest: float = 0.0) -> Dict[int, float]:
    """Fair-queued fan-in: one serial router thread ingests each message
    (``t_ingest``), then deals them round-robin to masters, each serial
    with ``t_proc`` per message.  Returns wid -> processing-finished time.
    The serial ingest stage is the M/D/1 queue behind the paper's Fig 5
    efficiency cliff (negligible at W=64, dominant at W=256)."""
    arrivals = sorted(arrivals)
    router_free = 0.0
    free_at = [0.0] * max(n_masters, 1)
    done: Dict[int, float] = {}
    for i, (t, wid) in enumerate(arrivals):
        ingested = max(t, router_free) + t_ingest
        router_free = ingested
        m = i % len(free_at)
        start = max(ingested, free_at[m])
        free_at[m] = start + t_proc
        done[wid] = free_at[m]
    return done
