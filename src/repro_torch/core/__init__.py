"""EdgeRAG core of the port: the pruned IVF index with selective storage
(Alg. 1) and cost-aware caching (Alg. 2/3), on PyTorch."""
from repro_torch.core.cache_policy import (CostAwareLFUCache,  # noqa
                                           MinLatencyThresholdController)
from repro_torch.core.costs import EdgeCostModel, LatencyBreakdown  # noqa
from repro_torch.core.edgerag import EdgeCluster, EdgeRAGIndex  # noqa
from repro_torch.core.faults import (CorruptPayloadError,  # noqa
                                     DegradationPolicy, FaultInjector,
                                     IOOutcome)
from repro_torch.core.kmeans import kmeans  # noqa
from repro_torch.core.maintenance import (MaintenanceOp,  # noqa
                                          MaintenanceReport,
                                          MaintenanceScheduler)
from repro_torch.core.resolver import ClusterResolver, ResolutionPlan  # noqa
from repro_torch.core.storage import StorageBackend  # noqa
