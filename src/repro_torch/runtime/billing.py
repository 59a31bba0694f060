"""Serverless billing meter: GB-seconds + requests + egress, in dollars.

The paper's core claim is that serverless is a *cost-effective* way to
scale optimization, but it never prices a run.  This meter makes the
claim measurable: every spawn, every round of worker wall time, and
every byte through the master accrues dollars next to the simulator's
seconds, so a (policy, W, autoscale) configuration yields a point on a
cost-vs-time plane (benchmarks/bench_cost.py).

Billing model (the FaaS trinity, AWS Lambda pricing as defaults):

* **compute** — a worker invocation is billed for its full wall time at
  ``mem_gb`` x ``gb_second_usd``: the paper's workers hold their memory
  while they idle at the barrier, which is exactly why idle time is not
  just a speedup loss but a dollar loss.  Cold-start *init* time is not
  billed (Lambda's rule) unless ``bill_cold_init``.
* **requests** — a flat fee per invocation start (spawns + respawns).
* **egress** — per-GB charge on bytes crossing the worker boundary
  (omega uplink + z downlink); compression therefore shows up on the
  bill, not just on the clock.
* **master** — the always-on coordinator (the paper uses a VM) billed
  per second, so small-W runs are not spuriously free.

All constants live in ``BillingConfig`` — the README's "cost model
constants" table documents them next to the timing constants.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple


@dataclasses.dataclass(frozen=True)
class BillingConfig:
    mem_gb: float = 3.0                 # the paper's high-memory lambdas
    gb_second_usd: float = 1.66667e-5   # Lambda compute
    per_request_usd: float = 2.0e-7     # $0.20 / 1M requests
    egress_usd_per_gb: float = 0.01     # intra-region data processing
    master_usd_per_s: float = 9.4e-5    # c5.2xlarge-class coordinator
    bill_cold_init: bool = False        # Lambda does not bill init time


class CostBreakdown(NamedTuple):
    compute_usd: float
    request_usd: float
    egress_usd: float
    master_usd: float
    total_usd: float


class BillingMeter:
    """Accrues the raw billable quantities; prices them on demand."""

    def __init__(self, cfg: BillingConfig = BillingConfig()):
        self.cfg = cfg
        self.gb_seconds = 0.0
        self.requests = 0
        self.egress_bytes = 0.0
        self.master_seconds = 0.0

    # -- accrual ------------------------------------------------------------

    def record_duration(self, seconds: float, n_workers: int = 1):
        """Bill ``n_workers`` invocations for ``seconds`` of wall time."""
        self.gb_seconds += self.cfg.mem_gb * seconds * n_workers

    def record_requests(self, n: int):
        self.requests += n

    def record_bytes(self, n_bytes: float):
        self.egress_bytes += n_bytes

    def record_master(self, seconds: float):
        self.master_seconds += seconds

    def absorb(self, other: "BillingMeter"):
        """Fold another meter's raw accruals into this one (the cluster's
        per-tenant rollup: one ledger per tenant absorbs every finished
        job's meter).  Raw quantities add; pricing uses THIS meter's
        config, so roll up meters that share a BillingConfig."""
        self.gb_seconds += other.gb_seconds
        self.requests += other.requests
        self.egress_bytes += other.egress_bytes
        self.master_seconds += other.master_seconds

    # -- pricing ------------------------------------------------------------

    def cost(self) -> CostBreakdown:
        c = self.cfg
        compute = self.gb_seconds * c.gb_second_usd
        request = self.requests * c.per_request_usd
        egress = (self.egress_bytes / 1e9) * c.egress_usd_per_gb
        master = self.master_seconds * c.master_usd_per_s
        return CostBreakdown(compute, request, egress, master,
                             compute + request + egress + master)

    def total_usd(self) -> float:
        return self.cost().total_usd

    def summary(self) -> dict:
        b = self.cost()
        return {
            "gb_seconds": self.gb_seconds,
            "requests": self.requests,
            "egress_gb": self.egress_bytes / 1e9,
            "master_seconds": self.master_seconds,
            "compute_usd": b.compute_usd,
            "request_usd": b.request_usd,
            "egress_usd": b.egress_usd,
            "master_usd": b.master_usd,
            "total_usd": b.total_usd,
        }
