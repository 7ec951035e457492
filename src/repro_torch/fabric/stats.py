"""Versioned, typed fabric stats surface (DESIGN.md §14).

``Fabric.stats_view()`` returns one frozen :class:`StatsView` — the single
stats schema that the controller (``repro_torch.control``), ``serve.py``'s
heartbeat lines and the exporters all read. The raw dict that grew across
PRs 2–7 survives only as the deprecated ``Fabric.stats()`` alias (exactly
one ``DeprecationWarning`` per process), and is now *defined* as
``stats_view().to_json()`` — one schema, two spellings.

Schema rules:

  * ``schema_version`` bumps on any key rename/removal; additive optional
    sections do not bump it.
  * ``to_json()`` / ``from_json()`` are exact inverses
    (``StatsView.from_json(v.to_json()) == v``), and ``to_json()`` output
    is JSON-stable: plain types, string keys, no raw latency reservoirs
    (the §13 size convention — reservoirs are merge plumbing, not
    snapshot payload).
  * The typed core is the per-class counters and the SLO view; sections
    whose layout is owned elsewhere (``replicas``, ``transport``,
    ``checkpoint``, ``obs``, ``control``) pass through as dicts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

SCHEMA_VERSION = 1


def _json_safe(obj: Any) -> Any:
    """Deep-normalize a pass-through section to JSON-stable form: string
    keys, lists for tuples, no latency reservoirs."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()
                if k != "latency_samples"}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


@dataclasses.dataclass(frozen=True)
class ClassStatsView:
    """Fabric-wide aggregate for one queue class (continuous across
    resizes; merged exactly across replicas by pooling reservoirs)."""

    name: str
    pending: int
    submitted: int
    rejected: int
    delivered: int
    requeued: int
    gap_waits: int
    admit_p50_ms: Optional[float]
    admit_p99_ms: Optional[float]
    shard_depths: Tuple[int, ...] = ()
    # 429-style admission sheds (tenant fabrics, lowest tier only) —
    # additive optional field, no schema bump; 0 everywhere else.
    shed: int = 0

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shard_depths"] = list(self.shard_depths)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "ClassStatsView":
        d = dict(d)
        d["shard_depths"] = tuple(d.get("shard_depths") or ())
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class SloView:
    """Measured p99 admission latency against one class's ``slo_ms``
    target. ``ok``/``headroom_ms`` are None until both sides exist."""

    target_ms: Optional[float]
    admit_p99_ms: Optional[float]
    ok: Optional[bool]
    headroom_ms: Optional[float]

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "SloView":
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class StatsView:
    """One frozen fabric-wide telemetry snapshot (``schema_version`` 1)."""

    step: int
    num_replicas: int
    num_hosts: int
    resizes: int
    classes: Dict[str, ClassStatsView]
    slo: Dict[str, SloView]
    replicas: Dict[str, dict]
    transport: dict
    checkpoint: Optional[dict] = None
    obs: Optional[dict] = None
    control: Optional[dict] = None
    # tenant fabrics (DESIGN.md §16): declared/tracked/active counts,
    # shed totals, quota occupancy, top-K tenants by backlog. With this
    # section present, ``classes`` holds only the *active* grid classes —
    # the emitted view is O(active), never O(declared tenants).
    tenants: Optional[dict] = None
    schema_version: int = SCHEMA_VERSION

    def to_json(self) -> dict:
        out = {
            "schema_version": self.schema_version,
            "step": self.step,
            "num_replicas": self.num_replicas,
            "num_hosts": self.num_hosts,
            "resizes": self.resizes,
            "classes": {n: c.to_json() for n, c in self.classes.items()},
            "slo": {n: s.to_json() for n, s in self.slo.items()},
            "replicas": self.replicas,
            "transport": self.transport,
        }
        for key in ("checkpoint", "obs", "control", "tenants"):
            val = getattr(self, key)
            if val is not None:
                out[key] = val
        return out

    @classmethod
    def from_json(cls, d: dict) -> "StatsView":
        version = d.get("schema_version", SCHEMA_VERSION)
        if version != SCHEMA_VERSION:
            raise ValueError(
                f"StatsView schema_version {version} is not supported "
                f"(this build reads version {SCHEMA_VERSION})")
        return cls(
            step=d["step"],
            num_replicas=d["num_replicas"],
            num_hosts=d["num_hosts"],
            resizes=d["resizes"],
            classes={n: ClassStatsView.from_json(c)
                     for n, c in d["classes"].items()},
            slo={n: SloView.from_json(s) for n, s in d["slo"].items()},
            replicas=d["replicas"],
            transport=d["transport"],
            checkpoint=d.get("checkpoint"),
            obs=d.get("obs"),
            control=d.get("control"),
            tenants=d.get("tenants"),
            schema_version=version,
        )


def class_view_from_snapshot(name: str, snap: dict,
                             shed: int = 0) -> ClassStatsView:
    """Build the typed per-class view from a raw ``ClassStats`` aggregate
    (``aggregate_class_snapshots`` output), dropping the reservoir."""
    return ClassStatsView(
        name=name,
        pending=snap["pending"],
        submitted=snap["submitted"],
        rejected=snap["rejected"],
        delivered=snap["delivered"],
        requeued=snap["requeued"],
        gap_waits=snap["gap_waits"],
        admit_p50_ms=snap["admit_p50_ms"],
        admit_p99_ms=snap["admit_p99_ms"],
        shard_depths=tuple(snap["shard_depths"]),
        shed=shed,
    )
