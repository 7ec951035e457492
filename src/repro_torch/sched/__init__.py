"""Coordination-free multi-tenant scheduler: a sharded, priority-class CMP
queue fabric (DESIGN.md §8).

  - :mod:`repro_torch.sched.classes` — :class:`QueueClass` (sharded CMP queues,
    dense class-cycle stamps, frontier drain, window-based admission) and
    :class:`Scheduler` (the fabric).
  - :mod:`repro_torch.sched.policy`  — strict-priority / weighted-fair /
    FIFO-across-classes drain policies.
  - :mod:`repro_torch.sched.steal`   — work stealing between shards (a steal is a
    claim; window safety is inherited from the protection domain).
  - :mod:`repro_torch.sched.replica` — N scheduler replicas over one fabric
    (DESIGN.md §9): host-addressed seat ownership claimed by CAS,
    per-replica frontier merges, exact-seat checkpoint/restore, host-loss
    recovery.
  - :mod:`repro_torch.sched.transport` — the pluggable seat-protocol transport
    (DESIGN.md §11): `LocalTransport` (in-process, zero-copy) and
    `SimHostTransport` (N simulated hosts, serialized wire envelopes,
    injectable drop/delay/reorder chaos).
  - :mod:`repro_torch.sched.stats`   — per-class occupancy/latency/steal telemetry
    sampled from domain state, zero added atomics.
  - :mod:`repro_torch.sched.tenants` — O(active)-cost tenant scale (DESIGN.md
    §16): hashed tenant->class-group routing, the active-set index, lazy
    per-tenant stats, and per-tenant KV page quotas.
"""

from repro_torch.sched.classes import (Envelope, QueueClass, Scheduler, ShardSet,
                                 shard_for)
from repro_torch.sched.policy import (ClassFifo, DrainPolicy, HierarchicalWFQ,
                                StrictPriority, WeightedFair, make_policy)
from repro_torch.sched.replica import (ClassView, ReplicaSet, SchedulerReplica,
                                 ShardSeat)
from repro_torch.sched.stats import (ClassStats, LatencyWindow,
                               aggregate_class_snapshots)
from repro_torch.sched.steal import (ShardConsumer, claim_seat, queue_depth,
                               rebalance, steal_into)
from repro_torch.sched.tenants import (TIERS, ActiveSet, TenantMap,
                                 TenantQuotaLedger, TenantRouter,
                                 TenantStatsTable, group_class_name,
                                 split_class_name, tenant_hash)
from repro_torch.sched.transport import (HostAddr, LocalTransport,
                                   SimHostTransport, Transport,
                                   decode_owner, make_transport)

__all__ = [
    "Envelope", "QueueClass", "Scheduler", "ShardSet", "shard_for",
    "DrainPolicy", "StrictPriority", "WeightedFair", "ClassFifo",
    "HierarchicalWFQ", "make_policy",
    "ClassStats", "LatencyWindow", "aggregate_class_snapshots",
    "ShardConsumer", "queue_depth", "rebalance", "steal_into", "claim_seat",
    "ClassView", "ReplicaSet", "SchedulerReplica", "ShardSeat",
    "TIERS", "ActiveSet", "TenantMap", "TenantQuotaLedger", "TenantRouter",
    "TenantStatsTable", "group_class_name", "split_class_name", "tenant_hash",
    "HostAddr", "LocalTransport", "SimHostTransport", "Transport",
    "decode_owner", "make_transport",
]
