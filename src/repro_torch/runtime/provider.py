"""Provider model: warm-container keep-alive, eviction, and spawn capacity.

The paper treats every worker launch as a cold start (Fig 8) and its
"limitations" section notes the account-level concurrency caps a real
fleet runs into.  Real FaaS providers behave differently on both counts:

* **Keep-alive** — when an invocation ends, its sandbox (container) is
  kept idle for a while; a later launch that lands on an idle sandbox is
  a *warm start* (hundreds of ms, not seconds).  For this repo's
  workload the effect is first-order: workers die at the 15-minute
  lifetime limit mid-run and are respawned, so a long ADMM run re-pays
  the Fig 8 cold start once per worker per lifetime — unless the
  respawn hits the warm pool.
* **Eviction** — idle sandboxes occupy provider memory, so the provider
  caps the pool and evicts under pressure.  Which sandbox to evict is a
  policy choice; FaasCache (ASPLOS'21) showed greedy-dual caching beats
  the fixed-TTL default.  The policy zoo here mirrors the keep-alive
  simulators built on that line of work.
* **Capacity** — bursts of cold provisions beyond the account burst
  limit are throttled (AWS refills cold-start capacity at a fixed rate
  per minute), which bounds how fast `spawn_bulk` can really fan out.

``Provider`` sits between ``LambdaPool`` and the scheduler: the pool
asks it for a sandbox per spawn, gets back either a warm container
(sticky speed, small start latency) or a cold-miss ticket (the Fig 8
cold-start model plus any throttle wait), and returns sandboxes to the
pool when workers die, are retired, or are replaced.

Everything is OFF by default (``ProviderConfig(enabled=False)``): the
disabled path is byte-identical to the seed cold-only model — same RNG
draw sequence, same constants — which is the regression anchor
(tests/test_provider.py).  The provider draws its jitter from its OWN
RNG so that enabling it with an empty warm pool also reproduces the
cold numbers exactly.

**Multi-tenancy** (``runtime/cluster.py``): one Provider instance can
back MANY pools at once — each pool tags its spawns with a tenant id,
and the provider keeps a *lease* per in-use sandbox (cid → tenant) plus
per-tenant hit/miss/eviction stats.  Leased sandboxes are, by
construction, never in the idle pool, so no eviction policy can reclaim
a container out from under a running invocation — the invariant the
property suite (tests/test_properties.py) hammers on.  A sandbox
released by one tenant's finished job is immediately acquirable by any
other tenant: warm capacity amortizes across the cluster, which is the
whole economic point of sharing the pool.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

POLICIES = ("fixed_ttl", "lru", "least_used", "greedy_dual")


@dataclasses.dataclass(frozen=True)
class ProviderConfig:
    enabled: bool = False
    # keep-alive / eviction policy for the idle-sandbox pool
    policy: str = "fixed_ttl"       # fixed_ttl | lru | least_used | greedy_dual
    keepalive_s: float = 600.0      # idle TTL — all policies reap beyond this
    max_env_age_s: float = 7200.0   # provider recycles sandboxes this old
    # warm start model (calibrated vs the ~2.5 s cold base: a warm start
    # skips provisioning + runtime init and reconnects in well under 1 s)
    warm_base_s: float = 0.45
    warm_jitter_s: float = 0.08
    # idle-pool memory capacity (eviction pressure)
    container_mb: int = 3008        # the paper's high-memory lambdas
    warm_capacity_mb: int = 64 * 3008   # idle sandboxes the provider keeps
    # cold-provision throttle: token bucket (the account burst limit);
    # requests beyond the bucket wait for the refill
    burst_concurrency: int = 1000
    refill_per_s: float = 8.33      # AWS's 500/min refill
    seed: int = 0

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {self.policy!r}")


@dataclasses.dataclass
class WarmContainer:
    """An idle sandbox in the keep-alive pool."""
    cid: int
    created_at: float       # when the sandbox was first provisioned
    released_at: float      # when it last went idle
    last_used: float        # last time an invocation ran on it
    uses: int               # invocations served so far
    speed: float            # sticky sandbox speed multiplier
    priority: float = 0.0   # greedy-dual priority (set on release/reuse)


@dataclasses.dataclass
class ProviderStats:
    warm_hits: int = 0
    cold_misses: int = 0
    releases: int = 0
    evictions: int = 0          # capacity-pressure victims
    expirations: int = 0        # TTL / max-age reaps
    throttle_wait_s: float = 0.0


class Provider:
    """Warm-sandbox cache with pluggable eviction and a cold-spawn
    throttle.  All sandboxes are interchangeable (one function kind —
    the ADMM worker), so the pool is a single free list; policies differ
    in WHICH idle sandbox is evicted under memory pressure."""

    def __init__(self, cfg: ProviderConfig, cold_base_s: float = 2.2):
        self.cfg = cfg
        # the cold-start base the pool is calibrated to (greedy-dual
        # prices a warm hit by the latency it saves against this)
        self.cold_base_s = cold_base_s
        self.rng = np.random.RandomState(cfg.seed)
        self.idle: List[WarmContainer] = []
        self.stats = ProviderStats()
        # multi-tenant accounting: cid → tenant for every sandbox
        # currently hosting an invocation (leased sandboxes are never in
        # the idle pool, so they are structurally un-evictable), plus a
        # per-tenant stats ledger.  Tenant None (single-experiment path)
        # is tracked under the lease map too, but gets no ledger entry.
        self.leased: Dict[int, Optional[str]] = {}
        self.tenant_stats: Dict[str, ProviderStats] = {}
        # idle sandbox-seconds the keep-alive pool has held so far: the
        # quantity a provider's keep-alive pricing bills (per-class
        # rollups in the cluster report).  Pure bookkeeping — accrued on
        # acquire / evict / reap, never consulted by any decision.
        self.idle_sandbox_s = 0.0
        self._next_cid = 0
        self._gd_clock = 0.0           # greedy-dual inflation clock
        # token bucket for cold provisions
        self._tokens = float(cfg.burst_concurrency)
        self._tokens_at = 0.0

    # -- sandbox identity / leasing -----------------------------------------

    def _tstats(self, tenant: Optional[str]) -> Optional[ProviderStats]:
        if tenant is None:
            return None
        if tenant not in self.tenant_stats:
            self.tenant_stats[tenant] = ProviderStats()
        return self.tenant_stats[tenant]

    def new_cid(self, tenant: Optional[str] = None) -> int:
        """Mint a sandbox id for a cold provision and lease it."""
        self._next_cid += 1
        cid = self._next_cid - 1
        self.leased[cid] = tenant
        return cid

    def forfeit(self, cid: int) -> None:
        """A leased sandbox was destroyed (invocation crash): the
        provider tears the container down, so the lease ends without the
        sandbox ever returning to the idle pool."""
        self.leased.pop(cid, None)

    def warm_hit_rate(self) -> float:
        """Fraction of launches that landed on a keep-alive sandbox."""
        total = self.stats.warm_hits + self.stats.cold_misses
        return self.stats.warm_hits / total if total else 0.0

    # -- keep-alive pool ----------------------------------------------------

    def _reap(self, at: float):
        """Expire sandboxes idle beyond the TTL or past the max age."""
        c = self.cfg
        alive = []
        for w in self.idle:
            if (at - w.released_at > c.keepalive_s
                    or at - w.created_at > c.max_env_age_s):
                self.stats.expirations += 1
                # the sandbox sat idle until its TTL (or max age) struck,
                # not until we noticed at ``at``
                self.idle_sandbox_s += max(
                    min(at - w.released_at, c.keepalive_s), 0.0)
            else:
                alive.append(w)
        self.idle = alive

    def _priority(self, w: WarmContainer) -> float:
        """FaasCache-style greedy-dual: clock + freq * cost / size, with
        freq = the sandbox's invocation count and cost = the cold-start
        latency a warm hit on it saves."""
        saved = max(self.cold_base_s - self.cfg.warm_base_s, 0.0)
        return self._gd_clock + w.uses * (saved / self.cfg.container_mb)

    def _evict_order(self) -> List[WarmContainer]:
        """Idle sandboxes sorted most-evictable first, per policy."""
        p = self.cfg.policy
        if p == "fixed_ttl":
            return sorted(self.idle, key=lambda w: w.released_at)
        if p == "lru":
            return sorted(self.idle, key=lambda w: w.last_used)
        if p == "least_used":
            return sorted(self.idle, key=lambda w: (w.uses, w.released_at))
        # greedy_dual: lowest priority first
        return sorted(self.idle, key=lambda w: w.priority)

    def release(self, *, cid: int, created_at: float, uses: int,
                speed: float, at: float,
                tenant: Optional[str] = None) -> bool:
        """An invocation ended: return its sandbox to the idle pool.
        Returns False if the sandbox was recycled instead (too old, or
        evicted immediately by capacity pressure on itself).  The lease
        ends either way — once idle, the sandbox is acquirable by ANY
        tenant."""
        c = self.cfg
        self.leased.pop(cid, None)
        self.stats.releases += 1
        ts = self._tstats(tenant)
        if ts is not None:
            ts.releases += 1
        if at - created_at > c.max_env_age_s:
            self.stats.expirations += 1
            return False
        self._reap(at)
        cap = c.warm_capacity_mb // c.container_mb
        while len(self.idle) >= max(cap, 0):
            order = self._evict_order()
            if not order:
                return False                      # zero-capacity pool
            victim = order[0]
            if c.policy == "greedy_dual":
                self._gd_clock = max(self._gd_clock, victim.priority)
            self.idle.remove(victim)
            self.stats.evictions += 1
            self.idle_sandbox_s += max(at - victim.released_at, 0.0)
        w = WarmContainer(cid=cid, created_at=created_at, released_at=at,
                          last_used=at, uses=uses, speed=speed)
        w.priority = self._priority(w)
        self.idle.append(w)
        return True

    def acquire(self, at: float,
                tenant: Optional[str] = None) -> Optional[WarmContainer]:
        """Pop a warm sandbox for a launch at ``at`` (most recently
        released first — the LIFO discipline real providers use, which
        also maximizes the TTL headroom of the rest of the pool).
        Returns None on a cold miss.  A hit leases the sandbox to
        ``tenant`` until release/forfeit."""
        self._reap(at)
        ts = self._tstats(tenant)
        if not self.idle:
            self.stats.cold_misses += 1
            if ts is not None:
                ts.cold_misses += 1
            return None
        w = max(self.idle, key=lambda c: c.released_at)
        self.idle.remove(w)
        self.idle_sandbox_s += max(at - w.released_at, 0.0)
        self.leased[w.cid] = tenant
        self.stats.warm_hits += 1
        if ts is not None:
            ts.warm_hits += 1
        w.uses += 1
        w.last_used = at
        w.priority = self._priority(w)
        return w

    def warm_start_s(self) -> float:
        """Warm-start latency: reconnect + handler re-entry, no
        provisioning.  Drawn from the provider's own RNG so the pool's
        cold-path draw sequence is untouched."""
        c = self.cfg
        return c.warm_base_s + abs(self.rng.normal(0.0, c.warm_jitter_s))

    # -- cold-provision throttle ---------------------------------------------

    def throttle_wait(self, at: float) -> float:
        """Seconds this cold provision waits for burst capacity.  Token
        bucket: ``burst_concurrency`` tokens, refilled at
        ``refill_per_s``; a request finding the bucket empty waits for
        the next token."""
        c = self.cfg
        # NOTE a request timestamped BEHIND _tokens_at (same-instant bulk
        # spawns, or a cluster job whose event clock trails the shared
        # pool's frontier) accrues negative refill — token debt — so the
        # i-th such request waits i slots.  That is the intended queue
        # semantics, and it degrades conservatively (never under-waits)
        # under the cluster's approximately-interleaved per-job clocks.
        self._tokens = min(
            float(c.burst_concurrency),
            self._tokens + (at - self._tokens_at) * c.refill_per_s)
        self._tokens_at = at
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return 0.0
        wait = (1.0 - self._tokens) / c.refill_per_s
        self._tokens = 0.0
        self._tokens_at = at + wait
        self.stats.throttle_wait_s += wait
        return wait


# ---------------------------------------------------------------------------
# Heterogeneous instance classes: memory size <-> $/GB-s <-> start latency
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InstanceClass:
    """One sandbox flavor the provider sells.

    Real FaaS fleets are not the single 3008 MB size the paper prices:
    memory tiers come with distinct $/GB-s (the effective rate the
    "Serverless architecture efficiency" study measures), distinct cold
    starts (provisioning scales with the sandbox image/memory footprint)
    and distinct warm reconnects (more memory buys more vCPU, so the
    handler re-enters faster), plus a keep-alive rate for the idle
    sandbox-seconds the warm pool holds."""
    name: str
    mem_mb: int
    gb_second_usd: float
    cold_base_s: float              # provisioning grows with the image
    warm_base_s: float              # reconnect shrinks with the vCPU share
    keepalive_usd_per_gb_s: float   # idle warm-pool memory rate

    @property
    def mem_gb(self) -> float:
        return self.mem_mb / 1024.0


# The 2019-era AWS Lambda tiers the paper's cost section brackets: the
# 1769 MB point (one full vCPU), the paper's own 3008 MB high-memory
# lambdas, and the 10240 MB top tier.
DEFAULT_CLASSES = (
    InstanceClass("s1769", mem_mb=1769, gb_second_usd=1.58e-5,
                  cold_base_s=2.0, warm_base_s=0.50,
                  keepalive_usd_per_gb_s=4.2e-6),
    InstanceClass("m3008", mem_mb=3008, gb_second_usd=1.66667e-5,
                  cold_base_s=2.2, warm_base_s=0.45,
                  keepalive_usd_per_gb_s=4.2e-6),
    InstanceClass("l10240", mem_mb=10240, gb_second_usd=1.82e-5,
                  cold_base_s=3.0, warm_base_s=0.40,
                  keepalive_usd_per_gb_s=4.2e-6),
)


class ClassedProvider:
    """A per-class family of warm pools: one independent ``Provider``
    per ``InstanceClass``, each with its own idle list, RNG (seeded
    ``base seed + class index`` so draw sequences never interleave
    across classes), stats ledger, and cold/warm latency constants.

    Sandboxes of different memory sizes are NOT interchangeable — a
    10 GB job cannot land on a 1.7 GB container — so warm capacity,
    eviction pressure and hit rates are all per class; the aggregate
    ``warm_hit_rate()`` is the launch-weighted mean the cluster report
    quotes."""

    def __init__(self, classes=DEFAULT_CLASSES,
                 base_cfg: ProviderConfig = ProviderConfig(enabled=True)):
        if not classes:
            raise ValueError("ClassedProvider needs at least one class")
        self.classes: Dict[str, InstanceClass] = {}
        self.providers: Dict[str, Provider] = {}
        for i, k in enumerate(classes):
            if k.name in self.classes:
                raise ValueError(f"duplicate instance class {k.name!r}")
            self.classes[k.name] = k
            cfg = dataclasses.replace(base_cfg, container_mb=k.mem_mb,
                                      warm_base_s=k.warm_base_s,
                                      seed=base_cfg.seed + i)
            self.providers[k.name] = Provider(cfg,
                                              cold_base_s=k.cold_base_s)

    def provider_for(self, name: str) -> Provider:
        return self.providers[name]

    def class_of(self, name: str) -> InstanceClass:
        return self.classes[name]

    def warm_hit_rate(self) -> float:
        hits = sum(p.stats.warm_hits for p in self.providers.values())
        total = hits + sum(p.stats.cold_misses
                           for p in self.providers.values())
        return hits / total if total else 0.0

    def warm_hit_rate_by_class(self) -> Dict[str, float]:
        return {n: p.warm_hit_rate() for n, p in self.providers.items()}

    def keepalive_cost_usd(self, at: Optional[float] = None
                           ) -> Dict[str, float]:
        """Idle warm-pool dollars per class: idle sandbox-seconds held
        so far x the class memory x its keep-alive rate.  ``at`` (the
        report instant) also bills the OPEN idle interval of sandboxes
        still sitting warm — without it, a pool whose sandboxes never
        expired mid-run would report zero keep-alive spend."""
        out = {}
        for n, p in self.providers.items():
            idle_s = p.idle_sandbox_s
            if at is not None:
                idle_s += sum(
                    max(min(at - w.released_at, p.cfg.keepalive_s), 0.0)
                    for w in p.idle)
            out[n] = (idle_s * self.classes[n].mem_gb
                      * self.classes[n].keepalive_usd_per_gb_s)
        return out
