"""Vector job demand, the Mesos DRF sorter, and class-aware placement.

The cluster's original fairness story is one-dimensional: `fair_share`
orders tenants by accumulated worker-seconds, and every capacity check
counts workers.  But a serverless optimization job consumes a VECTOR of
resources — sandbox count, the GB of memory each sandbox holds for its
whole wall time (the quantity billing prices), and the wire bandwidth
its fan-in pushes through the master — and tenants with different
demand *shapes* (memory-heavy lasso sweeps vs worker-heavy softmax
fleets) make scalar fairness systematically unfair: the scalar metric
under-counts whichever resource the other tenant saturates.

Three pieces live here:

* ``ResourceVector`` / ``spec_resource_vector`` — the demand model:
  workers from the spec's fleet (or per-job autoscale ceiling), memory
  as workers x the spec's billed GB per sandbox, egress as the
  ``wire_d``-scaled per-round wire footprint of the fleet (compressed
  uplink + dense z downlink, in Mbit per round — the master-side
  bandwidth the Fig 5 fan-in cliff is made of).
* ``DRFSorter`` — Dominant Resource Fairness accounting, after the
  Mesos sorter (SNIPPETS.md snippet 2): per-client allocated vectors
  against a cluster total, ``dominant_share`` = max over resources of
  allocated/total, ``allocate``/``unallocated`` with the recover-on-
  completion clamp at zero.  ``runtime/cluster.py`` mounts it as
  ``policy="drf"``: least dominant share dispatches first.
* ``PlacementConfig`` / ``choose_class`` — class-aware placement over
  the heterogeneous ``InstanceClass`` tiers (``runtime/provider.py``):
  ``cheapest_fit`` takes the lowest $/sandbox-second tier that fits the
  job's per-sandbox memory, ``latency_min`` the lowest expected start
  latency given each class's warm pool, ``cost_latency`` a normalized
  blend of the two.  All choices are deterministic in (cluster state,
  config) — the heap==scan differential contract extends to placement.

Everything is default-off: ``PlacementConfig(enabled=False)`` and the
scalar policies leave every existing trace byte-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.optim.compression import message_bytes
from repro_torch.runtime.provider import (DEFAULT_CLASSES,
                                          ClassedProvider, InstanceClass)

RESOURCES = ("workers", "mem_gb", "egress_mbps")

# wire-model fallback when neither the spec nor the problem kwargs pin a
# decision-vector size (matches the small test problems' typical d)
DEFAULT_WIRE_D = 64


def spec_worker_demand(spec) -> int:
    """The worker capacity admission must RESERVE for a spec: the
    starting fleet, or the per-job autoscaler's ceiling when the spec
    enables one (a mid-run rescale() never consults the cluster, so the
    worst case is budgeted up front)."""
    auto = spec.scheduler.autoscale
    if auto.policy != "off":
        return max(spec.scheduler.n_workers, auto.max_workers)
    return spec.scheduler.n_workers


@dataclasses.dataclass(frozen=True)
class ResourceVector:
    """One job's demand across the three cluster resources."""
    workers: float
    mem_gb: float
    egress_mbps: float

    def as_array(self) -> np.ndarray:
        return np.array([self.workers, self.mem_gb, self.egress_mbps],
                        dtype=np.float64)

    def to_dict(self) -> dict:
        return {"workers": self.workers, "mem_gb": self.mem_gb,
                "egress_mbps": self.egress_mbps}


def spec_wire_d(spec) -> int:
    """The decision-vector size the spec's WIRE model uses: the explicit
    ``wire_d`` override, else the problem kwargs' ``n_features`` (times
    ``n_classes`` for the flattened softmax stack — mirroring how the
    problems size their decision vectors), else a small default."""
    d = spec.scheduler.wire_d
    if d is not None:
        return int(d)
    kw = dict(getattr(spec, "problem_kwargs", None) or {})
    d = kw.get("n_features")
    if d is None:
        return DEFAULT_WIRE_D
    return int(d) * int(kw.get("n_classes", 1))


def spec_resource_vector(spec) -> ResourceVector:
    """Derive a spec's demand vector.

    * workers — ``spec_worker_demand`` (fleet or autoscale ceiling);
    * mem_gb — workers x the billed GB each sandbox holds
      (``scheduler.billing.mem_gb``: the paper's workers keep their
      memory while idling at the barrier, so demand is the full fleet
      footprint, not a utilization estimate);
    * egress_mbps — the fleet's per-round wire footprint in Mbit
      (compressed omega uplink + dense z downlink per worker, sized by
      ``wire_d``), i.e. the master-side bandwidth at the nominal one
      round per second.  Compression shrinks this coordinate, so a
      topk tenant genuinely demands less of the fan-in resource.
    """
    sc = spec.scheduler
    w = spec_worker_demand(spec)
    d = spec_wire_d(spec)
    up = message_bytes(sc.compress, d, topk_frac=sc.topk_frac,
                       qsgd_bits=sc.qsgd_bits)
    down = 4 * d                       # dense z downlink
    return ResourceVector(
        workers=float(w),
        mem_gb=float(w) * float(sc.billing.mem_gb),
        egress_mbps=float(w) * (up + down) * 8.0 / 1e6)


class DRFSorter:
    """Dominant Resource Fairness accounting, after the Mesos sorter.

    ``total`` is the cluster capacity vector; per-client ``allocate``
    adds a demand vector at dispatch and ``unallocated`` recovers it at
    completion (clamped at zero, exactly the Mesos recover-on-completion
    semantics — a stray double-release can never drive a share
    negative).  ``dominant_share(client)`` = max over resources of
    allocated_r / total_r; the DRF dispatch order serves the LOWEST
    dominant share first.  Resources with infinite (unmetered) or zero
    totals contribute no share."""

    def __init__(self, total: ResourceVector):
        self.total = (total.as_array()
                      if isinstance(total, ResourceVector)
                      else np.asarray(total, dtype=np.float64))
        # shares only over metered, non-degenerate resources
        self._mask = np.isfinite(self.total) & (self.total > 0)
        self.allocations: Dict[str, np.ndarray] = {}

    def add(self, client: str) -> None:
        if client not in self.allocations:
            self.allocations[client] = np.zeros(3, dtype=np.float64)

    def allocate(self, client: str, vec: np.ndarray) -> None:
        self.add(client)
        self.allocations[client] += np.asarray(vec, dtype=np.float64)

    def unallocated(self, client: str, vec: np.ndarray) -> None:
        """Recover resources on completion (Mesos ``unallocated``)."""
        self.add(client)
        cur = self.allocations[client]
        self.allocations[client] = np.maximum(
            cur - np.asarray(vec, dtype=np.float64), 0.0)

    def allocation_of(self, client: str) -> np.ndarray:
        return self.allocations.get(client,
                                    np.zeros(3, dtype=np.float64)).copy()

    def allocated_total(self) -> np.ndarray:
        if not self.allocations:
            return np.zeros(3, dtype=np.float64)
        return np.sum(list(self.allocations.values()), axis=0)

    def free(self) -> np.ndarray:
        return self.total - self.allocated_total()

    def dominant_share(self, client: str) -> float:
        alloc = self.allocations.get(client)
        if alloc is None or not self._mask.any():
            return 0.0
        return float(np.max(alloc[self._mask] / self.total[self._mask]))

    def shares(self) -> Dict[str, float]:
        return {c: self.dominant_share(c) for c in self.allocations}

    def sort(self) -> List[str]:
        """Clients by ascending dominant share (the DRF serve order);
        ties break on the client name for determinism."""
        return sorted(self.allocations,
                      key=lambda c: (self.dominant_share(c), c))


# ---------------------------------------------------------------------------
# Class-aware placement
# ---------------------------------------------------------------------------

PLACEMENTS = ("cheapest_fit", "latency_min", "cost_latency")


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Which sandbox tier each job lands on.

    Default-off: with ``enabled=False`` the cluster behaves exactly as
    before (one homogeneous pool at the spec's own billing constants).
    When enabled, every dispatch picks an ``InstanceClass`` whose memory
    fits the job's per-sandbox demand, the job's pool/billing constants
    are re-derived from the class, and its sandboxes live in that
    class's own warm pool.  ``class_caps`` optionally bounds the workers
    each class may host concurrently (the per-class slice of the
    account concurrency limit); the cluster autoscaler's aggregate cap
    binds each class too — effective cap_c = min(class cap, scaled
    cap)."""
    enabled: bool = False
    policy: str = "cheapest_fit"  # cheapest_fit | latency_min | cost_latency
    classes: Tuple[InstanceClass, ...] = DEFAULT_CLASSES
    latency_weight: float = 0.5   # cost_latency: 0 = pure cost, 1 = latency
    class_caps: Optional[Dict[str, int]] = None

    def __post_init__(self):
        if self.policy not in PLACEMENTS:
            raise ValueError(f"placement policy must be one of "
                             f"{PLACEMENTS}, got {self.policy!r}")
        if not self.classes:
            raise ValueError("placement needs at least one instance class")
        if not 0.0 <= self.latency_weight <= 1.0:
            raise ValueError("latency_weight must be in [0, 1]")

    def max_mem_gb(self) -> float:
        return max(k.mem_gb for k in self.classes)


def expected_start_s(klass: InstanceClass, workers: int,
                     warm_idle: int) -> float:
    """Expected per-sandbox start latency for a fleet of ``workers`` on
    ``klass``: the first ``warm_idle`` launches reconnect warm, the rest
    pay the class cold start."""
    w = max(int(workers), 1)
    warm = min(max(int(warm_idle), 0), w)
    return (warm * klass.warm_base_s
            + (w - warm) * klass.cold_base_s) / w


def choose_class(cfg: PlacementConfig, *, mem_gb_per_worker: float,
                 workers: int, warm_idle: Dict[str, int],
                 headroom: Dict[str, int]) -> Optional[InstanceClass]:
    """Pick the class for one job, or None when nothing fits right now.

    ``warm_idle`` maps class name -> idle warm sandboxes (the latency
    signal); ``headroom`` maps class name -> workers the class may still
    host (per-class cap minus current usage).  Deterministic: ties break
    on (smaller memory, name)."""
    fits = [k for k in cfg.classes
            if k.mem_gb + 1e-9 >= mem_gb_per_worker
            and headroom.get(k.name, 0) >= workers]
    if not fits:
        return None
    if cfg.policy == "cheapest_fit":
        score = {k.name: k.mem_gb * k.gb_second_usd for k in fits}
    elif cfg.policy == "latency_min":
        score = {k.name: expected_start_s(k, workers,
                                          warm_idle.get(k.name, 0))
                 for k in fits}
    else:                                           # cost_latency
        cost = {k.name: k.mem_gb * k.gb_second_usd for k in fits}
        lat = {k.name: expected_start_s(k, workers,
                                        warm_idle.get(k.name, 0))
               for k in fits}
        c_hi = max(cost.values())
        l_hi = max(lat.values())
        lw = cfg.latency_weight
        score = {n: ((1.0 - lw) * (cost[n] / c_hi if c_hi else 0.0)
                     + lw * (lat[n] / l_hi if l_hi else 0.0))
                 for n in cost}
    return min(fits, key=lambda k: (score[k.name], k.mem_mb, k.name))


__all__ = [
    "RESOURCES", "PLACEMENTS", "DEFAULT_WIRE_D",
    "ResourceVector", "spec_resource_vector", "spec_wire_d",
    "spec_worker_demand", "DRFSorter",
    "PlacementConfig", "choose_class", "expected_start_s",
    "InstanceClass", "DEFAULT_CLASSES", "ClassedProvider",
]
