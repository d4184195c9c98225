"""EdgeRAG core of the port, on PyTorch.

Index zoo (Table 4):
  FlatIndex              exhaustive baseline
  IVFIndex               two-level, all embeddings resident
  EdgeRAGIndex           pruned second level + selective storage (Alg. 1)
                         + cost-aware caching (Alg. 2/3); flags give the
                         IVF+Gen / IVF+Gen+Load ablations

Multi-tenancy:
  TenantRouter           many indexes on one shared storage / cache /
                         maintenance substrate, mixed batches fused into
                         one slab launch per storage representation

Durability:
  Durability             per-index WAL + atomic snapshots; ``recover`` /
                         ``recover_router`` restore a crashed root
"""
from repro_torch.core.cache_policy import (CostAwareLFUCache,  # noqa
                                           MinLatencyThresholdController)
from repro_torch.core.costs import EdgeCostModel, LatencyBreakdown  # noqa
from repro_torch.core.durability import (Durability,  # noqa
                                         IndexSnapshot, RecoveryError,
                                         RecoveryReport, WriteAheadLog,
                                         recover, recover_index,
                                         recover_router)
from repro_torch.core.edgerag import EdgeCluster, EdgeRAGIndex  # noqa
from repro_torch.core.faults import (CRASH_POINTS,  # noqa
                                     CorruptPayloadError, CrashInjector,
                                     DegradationPolicy, FaultInjector,
                                     IOOutcome, SimulatedCrash)
from repro_torch.core.flat_index import FlatIndex  # noqa
from repro_torch.core.ivf_index import IVFIndex  # noqa
from repro_torch.core.kmeans import kmeans  # noqa
from repro_torch.core.maintenance import (OP_CHECKPOINT,  # noqa
                                          MaintenanceOp,
                                          MaintenanceReport,
                                          MaintenanceScheduler)
from repro_torch.core.resolver import ClusterResolver, ResolutionPlan  # noqa
from repro_torch.core.storage import StorageBackend  # noqa
from repro_torch.core.tenant import TenantRouter  # noqa
