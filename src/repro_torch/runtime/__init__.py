from repro_torch.problems.logreg import LogRegProblem
from repro_torch.runtime.autoscale import (
    AutoscaleConfig,
    Autoscaler,
    ClusterAutoscaleConfig,
    ClusterAutoscaler,
)
from repro_torch.runtime.billing import (BillingConfig, BillingMeter,
                                         CostBreakdown)
from repro_torch.runtime.cluster import (
    Cluster,
    ClusterConfig,
    ClusterReport,
    ClusterResult,
    DagRun,
    DagSpec,
    Job,
    StageResult,
    StageSpec,
)
from repro_torch.runtime.loadgen import (
    LoadSpec,
    TraceJob,
    TraceWorkload,
    generate,
)
from repro_torch.runtime.placement import (
    DRFSorter,
    PlacementConfig,
    ResourceVector,
    choose_class,
    spec_resource_vector,
    spec_worker_demand,
)
from repro_torch.runtime.pool import LambdaPool, PoolConfig, SimWorker
from repro_torch.runtime.provider import (
    DEFAULT_CLASSES,
    ClassedProvider,
    InstanceClass,
    Provider,
    ProviderConfig,
    WarmContainer,
)
from repro_torch.runtime.reduce import TreeConfig, fanin_drain, tree_drain
from repro_torch.runtime.scheduler import (RoundMetrics, Scheduler,
                                           SchedulerConfig)

__all__ = [
    "LambdaPool", "PoolConfig", "SimWorker",
    "LogRegProblem", "Scheduler", "SchedulerConfig", "RoundMetrics",
    "TreeConfig", "fanin_drain", "tree_drain",
    "Provider", "ProviderConfig", "WarmContainer",
    "InstanceClass", "DEFAULT_CLASSES", "ClassedProvider",
    "ResourceVector", "spec_resource_vector", "spec_worker_demand",
    "DRFSorter", "PlacementConfig", "choose_class",
    "BillingConfig", "BillingMeter", "CostBreakdown",
    "AutoscaleConfig", "Autoscaler",
    "ClusterAutoscaleConfig", "ClusterAutoscaler",
    "Cluster", "ClusterConfig", "ClusterReport", "ClusterResult", "Job",
    "DagRun", "DagSpec", "StageResult", "StageSpec",
    "LoadSpec", "TraceJob", "TraceWorkload", "generate",
]
