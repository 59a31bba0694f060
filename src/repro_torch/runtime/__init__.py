from repro_torch.runtime.autoscale import AutoscaleConfig, Autoscaler
from repro_torch.runtime.billing import (BillingConfig, BillingMeter,
                                         CostBreakdown)
from repro_torch.runtime.pool import LambdaPool, PoolConfig, SimWorker
from repro_torch.runtime.provider import Provider, ProviderConfig
from repro_torch.runtime.reduce import TreeConfig, fanin_drain, tree_drain
from repro_torch.runtime.scheduler import (RoundMetrics, Scheduler,
                                           SchedulerConfig)

__all__ = [
    "LambdaPool", "PoolConfig", "SimWorker",
    "Scheduler", "SchedulerConfig", "RoundMetrics",
    "TreeConfig", "fanin_drain", "tree_drain",
    "Provider", "ProviderConfig",
    "BillingConfig", "BillingMeter", "CostBreakdown",
    "AutoscaleConfig", "Autoscaler",
]
