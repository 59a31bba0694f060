"""Closed-loop autoscaler: a controller for ``Scheduler.rescale()``.

The paper's elasticity story ("Exploiting Inherent Elasticity of
Serverless in Irregular Algorithms" develops it further) is that a
serverless fleet can change size MID-RUN at the cost of one respawn
wave — with the provider's keep-alive pool, often a warm one.  The seed
repo exposed the mechanism (``Scheduler.rescale``) but nothing drove
it; this module closes the loop with two policies:

* ``target_efficiency`` — steer parallel efficiency (mean compute time
  over round wall time) into a band.  Above the band the run is
  compute-dominated: adding workers buys near-linear speedup, so GROW.
  Below it the fleet is mostly idling at the barrier or queued at the
  master — every idle GB-second is billed (runtime.billing) — so
  SHRINK.  This is the cost-aware policy: it trades time for dollars
  around the knee of the Fig 5 efficiency curve.
* ``queue_depth`` — steer on the master's fan-in queue directly: the
  drain wait (time between the last omega arrival and the reduce
  finishing) as a fraction of the round.  Past the paper's W=256 cliff
  this fraction explodes; the policy shrinks before the cliff and grows
  while the router has headroom.

Decisions are multiplicative (``factor``x grow / shrink), quantized to
the replication group size, bounded by ``[min_workers, max_workers]``,
and rate-limited by a cooldown so ADMM's warm restart after a rescale
(x re-seeded from z, duals reset) has rounds to settle before the next
resize.  Signals are averaged over a trailing ``window`` of rounds so
one straggler round does not trigger a resize.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

POLICIES = ("off", "target_efficiency", "queue_depth")


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    policy: str = "off"           # off | target_efficiency | queue_depth
    cooldown_rounds: int = 6      # min rounds between resizes
    window: int = 3               # rounds averaged per signal
    min_workers: int = 2
    max_workers: int = 64
    factor: int = 2               # grow/shrink multiplier
    # target_efficiency band
    eff_low: float = 0.45
    eff_high: float = 0.80
    # queue_depth band (fan-in drain wait / round wall time)
    queue_high: float = 0.30
    queue_low: float = 0.08

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")
        if self.factor < 2:
            raise ValueError(f"factor must be >= 2, got {self.factor}")


class Autoscaler:
    """Feed it one observation per round; it answers with a new worker
    count (or None).  ``quantum`` is the replication group size r — every
    proposed W keeps r | W so FRS groups stay intact."""

    def __init__(self, cfg: AutoscaleConfig, quantum: int = 1):
        self.cfg = cfg
        self.quantum = max(quantum, 1)
        self._eff = deque(maxlen=cfg.window)
        self._queue = deque(maxlen=cfg.window)
        self._since_change = 0
        self._last_change = None  # (old_w, new_w) of the previous resize
        self.decisions = []       # (round_idx, old_w, new_w, reason)
        self._round = 0

    def _quantize(self, w: int) -> int:
        """Nearest feasible W: a multiple of the quantum inside the
        bounds.  The floor rounds UP to a quantum multiple (never
        propose a fleet below min_workers); the ceiling rounds down."""
        q = self.quantum
        lo = -(-max(self.cfg.min_workers, q) // q) * q
        hi = max((self.cfg.max_workers // q) * q, lo)
        return min(max((w // q) * q, lo), hi)

    def observe(self, *, round_wall_s: float, t_comp_mean: float,
                t_fanin_wait: float):
        self._round += 1
        self._since_change += 1
        if round_wall_s > 0:
            self._eff.append(t_comp_mean / round_wall_s)
            self._queue.append(t_fanin_wait / round_wall_s)

    def decide(self, current_w: int) -> Optional[int]:
        """New worker count, or None to hold.  Call after observe()."""
        cfg = self.cfg
        if (cfg.policy == "off" or len(self._eff) < cfg.window
                or self._since_change < cfg.cooldown_rounds):
            return None
        eff = sum(self._eff) / len(self._eff)
        queue = sum(self._queue) / len(self._queue)
        grow = shrink = False
        if cfg.policy == "target_efficiency":
            grow, shrink = eff > cfg.eff_high, eff < cfg.eff_low
            reason = f"eff={eff:.2f}"
        else:                                     # queue_depth
            grow, shrink = queue < cfg.queue_low, queue > cfg.queue_high
            reason = f"queue_frac={queue:.2f}"
        if grow:
            new_w = self._quantize(current_w * cfg.factor)
        elif shrink:
            new_w = self._quantize(current_w // cfg.factor)
        else:
            return None
        if new_w == current_w:
            return None
        # anti-flap: undoing the previous resize (bang-bang oscillation at
        # a band edge) needs a doubled stabilization period first
        if (self._last_change is not None
                and (current_w, new_w) == self._last_change[::-1]
                and self._since_change < 2 * cfg.cooldown_rounds):
            return None
        self._since_change = 0
        self._eff.clear()
        self._queue.clear()
        self._last_change = (current_w, new_w)
        self.decisions.append((self._round, current_w, new_w, reason))
        return new_w


# ---------------------------------------------------------------------------
# Cluster-level elasticity: the worker-capacity controller
# ---------------------------------------------------------------------------

CLUSTER_POLICIES = ("off", "queue_depth")


@dataclasses.dataclass(frozen=True)
class ClusterAutoscaleConfig:
    """Controller for the CLUSTER's aggregate worker capacity.

    Where ``AutoscaleConfig`` resizes one job's fleet mid-run, this
    policy resizes the cluster's admission capacity — the total number
    of concurrently-active workers across all tenants (the account-level
    concurrency the operator reserves).  The signal is aggregate demand:
    how many admitted jobs are waiting in the queue because the current
    capacity cannot host their fleets."""
    policy: str = "off"           # off | queue_depth
    min_workers: int = 8          # capacity floor
    max_workers: int = 256        # capacity ceiling
    factor: int = 2               # grow/shrink multiplier
    grow_at_depth: int = 2        # queued jobs that trigger growth
    shrink_at_depth: int = 0      # queue depth at/below which to shrink
    cooldown_events: int = 4      # min observations between resizes
    # Vector (multi-resource) clusters only: count a queued job toward
    # the demand signal ONLY when workers are what blocks it (its
    # memory/egress demand fits the free vector capacity).  Without
    # this, a memory-saturated but worker-idle cluster reads its whole
    # backlog as worker demand and grows capacity that cannot admit
    # anything — the latent single-resource assumption of the original
    # controller.  Inert outside vector mode (scalar clusters have no
    # other resource to be blocked on), so pre-vector traces are
    # byte-identical.
    blocked_only: bool = True
    tick_s: float = 0.0           # heap engine: observe on periodic sim-time
    #                               ticks instead of after every job round
    #                               (0 = legacy per-round observation; the
    #                               cooldown then counts ticks, making the
    #                               control cadence independent of how many
    #                               rounds the cluster packs into a second)

    def __post_init__(self):
        if self.policy not in CLUSTER_POLICIES:
            raise ValueError(f"policy must be one of {CLUSTER_POLICIES}, "
                             f"got {self.policy!r}")
        if self.factor < 2:
            raise ValueError(f"factor must be >= 2, got {self.factor}")


class ClusterAutoscaler:
    """Feed it the queue depth at every cluster event (job step /
    completion / admission attempt); it answers with a new worker
    capacity, or None to hold.  Shrinking never cuts below the busiest
    currently-admitted load (``active_floor``) — capacity is reclaimed
    from IDLE headroom, never from running jobs."""

    def __init__(self, cfg: ClusterAutoscaleConfig):
        self.cfg = cfg
        self._since_change = 0
        self.decisions = []       # (event_idx, old_cap, new_cap, reason)
        self._event = 0

    def decide(self, *, cap: int, queue_depth: int,
               active_workers: int) -> Optional[int]:
        cfg = self.cfg
        self._event += 1
        self._since_change += 1
        if cfg.policy == "off" or self._since_change < cfg.cooldown_events:
            return None
        if queue_depth >= cfg.grow_at_depth:
            new_cap = min(cap * cfg.factor, cfg.max_workers)
        elif queue_depth <= cfg.shrink_at_depth:
            new_cap = max(cap // cfg.factor, cfg.min_workers,
                          active_workers)
        else:
            return None
        if new_cap == cap:
            return None
        self._since_change = 0
        self.decisions.append((self._event, cap, new_cap,
                               f"queue_depth={queue_depth}"))
        return new_cap
