"""`repro_torch.fabric` — one declarative session API over queues, scheduler,
replicas, and serving (DESIGN.md §10).

  - :mod:`repro_torch.fabric.config`  — :class:`FabricConfig` / :class:`ClassSpec`
    (frozen, validated, JSON round-trip) + the standard
    :func:`tiered_classes` tenant set.
  - :mod:`repro_torch.fabric.session` — :class:`Fabric`: ``open`` / ``submit`` /
    ``step`` / ``drain`` / ``stats_view`` / ``snapshot`` / ``restore`` /
    ``resize`` (live elasticity) / ``close``, with an in-loop checkpoint
    cadence for a bounded recovery point, the versioned
    :class:`StatsView` telemetry surface, and the ``fabric.control``
    actuation handle (DESIGN.md §14).
  - :mod:`repro_torch.fabric.stats`   — the frozen, versioned stats schema read
    by the controller, serve.py and the exporters.
"""

from repro_torch.fabric.config import (ClassSpec, FabricConfig, FabricConfigError,
                                 TenantSpec, tenant_grid_classes,
                                 tiered_classes)
from repro_torch.fabric.session import Fabric
from repro_torch.fabric.stats import (SCHEMA_VERSION, ClassStatsView, SloView,
                                StatsView)

__all__ = ["ClassSpec", "ClassStatsView", "Fabric", "FabricConfig",
           "FabricConfigError", "SCHEMA_VERSION", "SloView", "StatsView",
           "TenantSpec", "tenant_grid_classes", "tiered_classes"]

_REMOVED = {
    "compat": "the repro_torch.fabric.compat shim module",
    "open_engine": "compat.open_engine",
    "open_replica_group": "compat.open_replica_group",
    "open_replica_set": "compat.open_replica_set",
}


def __getattr__(name):
    # The reference's removed deprecation shims fail loudly here too, with
    # the replacement instead of an opaque AttributeError.
    if name in _REMOVED:
        raise AttributeError(
            f"{_REMOVED[name]} was removed: construct sessions "
            f"with Fabric.open(FabricConfig(...)) (see DESIGN.md §10)")
    raise AttributeError(f"module 'repro_torch.fabric' has no attribute {name!r}")
