"""Coordination-free multi-tenant scheduler: a sharded, priority-class CMP
queue fabric.

  - :mod:`repro_torch.sched.classes` — :class:`QueueClass` (sharded CMP
    queues, dense class-cycle stamps, frontier drain, window-based
    admission) and :class:`Scheduler` (the fabric).
  - :mod:`repro_torch.sched.policy`  — strict-priority / weighted-fair /
    FIFO-across-classes drain policies.
  - :mod:`repro_torch.sched.stats`   — per-class occupancy/latency telemetry
    sampled from domain state, zero added atomics.
  - :mod:`repro_torch.sched.tenants` — hashed tenant->class-group routing,
    the active-set index, lazy per-tenant stats, and per-tenant KV page
    quotas.

Replicas, transports and stealing are not part of the port yet.
"""

from repro_torch.sched.classes import (Envelope, QueueClass, Scheduler,
                                       ShardSet, shard_for)
from repro_torch.sched.policy import (ClassFifo, DrainPolicy, HierarchicalWFQ,
                                      StrictPriority, WeightedFair,
                                      make_policy)
from repro_torch.sched.stats import (ClassStats, LatencyWindow,
                                     aggregate_class_snapshots)
from repro_torch.sched.tenants import (TIERS, ActiveSet, TenantMap,
                                       TenantQuotaLedger, TenantRouter,
                                       TenantStatsTable, group_class_name,
                                       split_class_name, tenant_hash)

__all__ = [
    "Envelope", "QueueClass", "Scheduler", "ShardSet", "shard_for",
    "DrainPolicy", "StrictPriority", "WeightedFair", "ClassFifo",
    "HierarchicalWFQ", "make_policy",
    "ClassStats", "LatencyWindow", "aggregate_class_snapshots",
    "TIERS", "ActiveSet", "TenantMap", "TenantQuotaLedger", "TenantRouter",
    "TenantStatsTable", "group_class_name", "split_class_name", "tenant_hash",
]
