"""Declarative fabric configuration (DESIGN.md §10).

The paper's thesis is that one mechanism — cycle clock + bounded window —
replaces a zoo of coordination schemes. The public API should read the same
way: standing up the whole serving fabric (class queues, scheduler replicas,
engine group, checkpoint cadence) is *one* frozen config handed to
:meth:`repro_torch.fabric.Fabric.open`, not hand-wired ``QueueClass`` /
``ReplicaSet`` / ``EngineReplicaGroup`` plumbing repeated in every driver.

Everything here is host-only plain data: no jax import, JSON round-trip via
:meth:`FabricConfig.to_json` / :meth:`FabricConfig.from_json` (the same dict
rides checkpoint aux channels, so a fabric restores from its own snapshot
without the caller re-declaring anything).

Validation is eager (``__post_init__``) and actionable: combinations that
the old flag-wired serve.py accepted silently — a cross-class policy with a
single class, a checkpoint cadence with nowhere to write, frontier snapshots
shadowing the params checkpoint — raise :class:`FabricConfigError` naming
the fix.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.control.config import ControlConfig
from repro_torch.obs.recorder import ObsConfig
from repro_torch.sched.tenants import TIERS, group_class_name

_POLICIES = ("strict", "wfq", "fifo", "hier")


class FabricConfigError(ValueError):
    """An invalid or self-contradictory :class:`FabricConfig`."""


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    """One tenant/priority class, declaratively.

    ``slo_ms`` is a per-class admission-latency target (p99, milliseconds):
    telemetry-only for now — :meth:`Fabric.stats` reports measured
    ``admit_p99_ms`` against it under the ``"slo"`` key (groundwork for the
    SLO-aware policy ROADMAP item; no policy behavior changes).
    """

    name: str
    priority: int = 0
    weight: float = 1.0
    admit_window: Optional[int] = None
    slo_ms: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """Tenant-scale knobs (DESIGN.md §16): declare O(10k) tenants, pay for
    the active ones.

    Setting ``tenants=TenantSpec(...)`` on a :class:`FabricConfig` derives
    the class grid — ``num_groups`` groups x 3 tiers (interactive / batch /
    background, the serve.py tier semantics) — and tenants hash onto the
    groups deterministically (FNV-1a with ``salt``; stable across
    resize / fail_host / snapshot-restore). The hot path then costs
    O(active classes): the scheduler's active-set index skips idle groups
    entirely.

    num_tenants: declared tenant population (capacity-planning input and
      the bench's churn universe; the grid size does NOT depend on it).
    num_groups: class-groups tenants hash onto. The real class count is
      ``3 * num_groups`` — bounded no matter how many tenants exist.
    salt: routing-hash salt (re-shuffles tenant->group placement).
    group_window: per-(group, tier) admission window — the window-pressure
      input to overload shedding; None = unbounded (disables pressure
      shedding, quota shedding still applies).
    page_quota: per-tenant KV page quota; None = no quota ledger.
    quota_total: fabric-wide aggregate page cap, carved per transport host
      with the host-first split. Defaults to ``num_pages`` on serving
      fabrics and ``num_groups * page_quota`` on scheduler-only ones.
    admit_pressure: group occupancy fraction (of the summed tier windows)
      beyond which lowest-tier submissions shed with a 429-style reject.
    quota_hosts: ledger host-cap split override; None = ``config.hosts``.
      Pin it when comparing layouts (``--verify-single-host``) so quota
      admission decisions stay identical at hosts=N and hosts=1.
    stats_capacity / stats_top_k: lazy per-tenant stats table bound and
      the top-K-by-backlog emitted in stats()/Prometheus.
    """

    num_tenants: int
    num_groups: int = 32
    salt: int = 0
    group_window: Optional[int] = 512
    page_quota: Optional[int] = None
    quota_total: Optional[int] = None
    admit_pressure: float = 0.85
    quota_hosts: Optional[int] = None
    stats_capacity: int = 1024
    stats_top_k: int = 8


def tenant_grid_classes(spec: TenantSpec) -> Tuple[ClassSpec, ...]:
    """The derived class grid for a tenant fabric: ``num_groups`` groups x
    the 3 standard tiers, group-major, named ``g{gid:03d}:{tier}`` (the
    group rides the class *name*, so every name-keyed path — snapshots,
    wire codec, seats, stats — works unchanged). Same priority/weight/SLO
    shape per tier as :func:`tiered_classes`."""
    tiers = (
        (TIERS[0], 2, 8.0, 50.0),
        (TIERS[1], 1, 3.0, 500.0),
        (TIERS[2], 0, 1.0, None),
    )
    return tuple(
        ClassSpec(group_class_name(g, tier), priority=pr, weight=w,
                  admit_window=spec.group_window, slo_ms=slo)
        for g in range(spec.num_groups)
        for tier, pr, w, slo in tiers)


@dataclasses.dataclass(frozen=True)
class FabricConfig:
    """Everything needed to open (or restore) a fabric session.

    Scheduler half (always active):
      classes: the tenant/priority classes (at least one).
      replicas: scheduler/engine replicas to start with.
      hosts: transport hosts the replicas spread over (round-robin,
        ``rid % hosts``). 1 = single-host; >1 requires the sim transport.
      transport: seat-protocol transport — local (in-process, zero-copy) |
        sim (N simulated hosts, serialized wire envelopes, chaos knobs) |
        wire (N real host worker processes over TCP sockets, DESIGN.md
        §15: framed wire codec, batched claim frames, prefetch credit).
      transport_drop / transport_delay / transport_reorder /
      transport_seed: transport chaos — message-drop and in-flight
        delay probabilities, batch reordering (sim only; TCP cannot
        reorder within a connection), and the deterministic seed.
        Order/exactness are transport-chaos-invariant (the seat cursor
        drives delivery); only latency pays.
      transport_rtt_ms: deterministic injected round-trip time charged to
        every seat-protocol op (sim: a sleep per op — the wire bench's
        sim-at-RTT baseline; wire: a server-side response delay that
        pipelined fetches overlap). 0 = no injection.
      transport_credit: wire-transport prefetch credit — fetches kept in
        flight per home shard (1 = synchronous fetch, no look-ahead).
      max_replicas: live-resize ceiling — seats are provisioned per class at
        open (one shard per potential replica), so ``Fabric.resize(n)`` up
        to this count needs no re-shard. Defaults to ``replicas``.
      shards_per_class: CMP shards per class; defaults to ``max_replicas``
        (every replica needs at least one seat per class).
      policy: cross-class drain policy — strict | wfq | fifo.
      queue_window / reclaim_period: each shard's CMPQueue protection
        window and reclaim cadence.
      min_steal: smallest backlog worth a seat steal.
      drain_k: per-replica drain batch size (scheduler-only fabrics).

    Serving half (``arch`` set -> a full engine group; ``None`` -> a
    scheduler-only fabric, e.g. for benchmarks):
      arch/smoke/param_seed: model config + deterministic init.
      params_dir: optional params checkpoint to restore weights from.
      max_batch / num_pages: fabric-wide lane and page budgets, partitioned
        across replicas (and re-partitioned on resize).
      page_size / max_seq / kv_window: paged-KV pool geometry + protection
        window.
      device_admission: route engine admission through the device-resident
        CMP ring (DESIGN.md §12) — ``False`` (host path), ``True`` (force
        the ring; on the CPU its plain version runs in place of the CUDA
        kernel), or ``"auto"`` (ring only when a CUDA device is attached).

    Checkpoint cadence:
      checkpoint_dir: frontier-snapshot directory (exact-seat resume).
      checkpoint_every_n_steps: write one snapshot via the async
        checkpointer every N ``Fabric.step`` calls — the running fabric's
        bounded recovery point. ``None`` = only on ``close()``.
      checkpoint_window: async writer's bounded retention (CMP window).
    """

    classes: Tuple[ClassSpec, ...] = (ClassSpec("default"),)
    replicas: int = 1
    max_replicas: Optional[int] = None
    shards_per_class: Optional[int] = None
    hosts: int = 1
    transport: str = "local"
    transport_drop: float = 0.0
    transport_delay: float = 0.0
    transport_reorder: bool = False
    transport_seed: int = 0
    transport_rtt_ms: float = 0.0
    transport_credit: int = 4
    policy: str = "strict"
    queue_window: int = 4096
    reclaim_period: int = 32
    min_steal: int = 1
    drain_k: int = 8
    # serving half
    arch: Optional[str] = None
    smoke: bool = True
    param_seed: int = 0
    params_dir: Optional[str] = None
    max_batch: int = 4
    page_size: int = 16
    num_pages: int = 64
    max_seq: int = 128
    kv_window: int = 4
    device_admission: object = False  # False | True | "auto"
    # checkpoint cadence
    checkpoint_dir: Optional[str] = None
    checkpoint_every_n_steps: Optional[int] = None
    checkpoint_window: int = 2
    # observability plane (repro_torch.obs): None = no hub, no recorders, zero
    # overhead; an ObsConfig stands up the fabric-wide MetricsHub + flight
    # recorders (stats_view().obs, Fabric.obs exporters)
    obs: Optional[ObsConfig] = None
    # control plane (repro_torch.control): None = no closed loop (the
    # fabric.control actuation handle still exists for manual typed
    # actions); a ControlConfig arms the SLO-driven autoscaler inside
    # Fabric.step (DESIGN.md §14). Requires obs (its sensor input).
    control: Optional[ControlConfig] = None
    # tenant scale (DESIGN.md §16): None = classes are what you declared;
    # a TenantSpec derives the bounded group x tier class grid, arms
    # hashed tenant routing + O(active) tracking + admission shedding in
    # Fabric, and auto-selects the hierarchical drain policy.
    tenants: Optional[TenantSpec] = None

    def __post_init__(self):
        # normalize: accept any iterable of ClassSpec (or spec dicts), then
        # resolve the replica/seat defaults so validation and JSON output
        # always see concrete numbers
        specs = tuple(c if isinstance(c, ClassSpec) else ClassSpec(**c)
                      for c in self.classes)
        object.__setattr__(self, "classes", specs)
        if isinstance(self.obs, dict):  # JSON round-trip form
            object.__setattr__(self, "obs", ObsConfig(**self.obs))
        if isinstance(self.control, dict):  # JSON round-trip form
            object.__setattr__(self, "control", ControlConfig(**self.control))
        if isinstance(self.tenants, dict):  # JSON round-trip form
            object.__setattr__(self, "tenants", TenantSpec(**self.tenants))
        if self.tenants is not None:
            # Derive the grid. A default classes field is replaced; a
            # snapshot round trip (to_json emits the derived grid) passes
            # the grid back in, which must match; anything else is a
            # contradiction caught by validate().
            if self.classes == (ClassSpec("default"),):
                object.__setattr__(self, "classes",
                                   tenant_grid_classes(self.tenants))
            if self.policy == "strict":
                # strict across 3*G grid classes would starve whole groups;
                # the tenant fabric's native policy is hierarchical WFQ
                object.__setattr__(self, "policy", "hier")
        if self.max_replicas is None:
            object.__setattr__(self, "max_replicas", self.replicas)
        if self.shards_per_class is None:
            object.__setattr__(self, "shards_per_class", self.max_replicas)
        self.validate()

    # ------------------------------------------------------------ validation
    def validate(self) -> None:
        def bad(msg: str) -> None:
            raise FabricConfigError(f"FabricConfig: {msg}")

        if not self.classes:
            bad("declare at least one class (classes=() serves nobody)")
        names = [c.name for c in self.classes]
        if len(set(names)) != len(names):
            bad(f"duplicate class names {names}: every class needs a "
                f"unique name (it is the policy and telemetry key)")
        for c in self.classes:
            if not c.name:
                bad("empty class name")
            if c.weight <= 0:
                bad(f"class {c.name!r}: weight must be > 0 "
                    f"(got {c.weight}); weights are fair-share ratios")
            if c.admit_window is not None and c.admit_window < 1:
                bad(f"class {c.name!r}: admit_window must be >= 1 or None "
                    f"(got {c.admit_window})")
            if c.slo_ms is not None and c.slo_ms <= 0:
                bad(f"class {c.name!r}: slo_ms must be > 0 or None "
                    f"(got {c.slo_ms})")
        if self.policy not in _POLICIES:
            bad(f"unknown policy {self.policy!r}; choose from "
                f"{list(_POLICIES)}")
        if self.tenants is not None:
            t = self.tenants
            if t.num_tenants < 1:
                bad(f"tenants.num_tenants must be >= 1 "
                    f"(got {t.num_tenants})")
            if not (1 <= t.num_groups <= 4096):
                bad(f"tenants.num_groups must be in [1, 4096] "
                    f"(got {t.num_groups}); the class grid is "
                    f"3*num_groups real queues")
            if t.group_window is not None and t.group_window < 1:
                bad(f"tenants.group_window must be >= 1 or None "
                    f"(got {t.group_window})")
            if t.page_quota is not None and t.page_quota < 1:
                bad(f"tenants.page_quota must be >= 1 or None "
                    f"(got {t.page_quota})")
            if t.quota_total is not None and t.page_quota is None:
                bad("tenants.quota_total without page_quota: the aggregate "
                    "cap only exists inside the quota ledger — set "
                    "page_quota or drop quota_total")
            if not (0.0 < t.admit_pressure <= 1.0):
                bad(f"tenants.admit_pressure must be in (0, 1] "
                    f"(got {t.admit_pressure})")
            if t.quota_hosts is not None and t.quota_hosts < 1:
                bad(f"tenants.quota_hosts must be >= 1 or None "
                    f"(got {t.quota_hosts})")
            if t.stats_capacity < 1 or t.stats_top_k < 0:
                bad(f"tenants stats bounds invalid (stats_capacity="
                    f"{t.stats_capacity}, stats_top_k={t.stats_top_k})")
            derived = tenant_grid_classes(t)
            if self.classes != derived:
                bad("tenants=TenantSpec(...) derives the class grid "
                    "(num_groups x 3 tiers) itself — drop the explicit "
                    "classes field (or keep the default) so the grid and "
                    "the tenant routing cannot disagree")
            if self.policy == "strict":
                bad("tenants with policy='strict': strict priority across "
                    "the whole grid starves entire groups — use 'hier' "
                    "(the default with tenants), 'wfq' or 'fifo'")
        if len(self.classes) == 1 and self.policy != "strict":
            bad(f"cross-class policy {self.policy!r} has no effect with the "
                f"single class {names[0]!r}: declare multiple classes "
                f"(serve.py: --multitenant) or drop the policy override")
        if self.replicas < 1:
            bad(f"replicas must be >= 1 (got {self.replicas})")
        if self.max_replicas < self.replicas:
            bad(f"max_replicas={self.max_replicas} < replicas="
                f"{self.replicas}: raise max_replicas (the resize ceiling) "
                f"or start with fewer replicas")
        if self.shards_per_class < self.max_replicas:
            bad(f"shards_per_class={self.shards_per_class} < max_replicas="
                f"{self.max_replicas}: every replica needs at least one "
                f"seat per class — raise shards_per_class or lower "
                f"max_replicas")
        if self.transport not in ("local", "sim", "wire"):
            bad(f"unknown transport {self.transport!r}; choose from "
                f"['local', 'sim', 'wire']")
        if self.hosts < 1:
            bad(f"hosts must be >= 1 (got {self.hosts})")
        if self.transport == "local" and self.hosts != 1:
            bad(f"hosts={self.hosts} with the local transport: the local "
                f"transport is single-host by definition — set "
                f"transport='sim' or 'wire' for multi-host layouts")
        if self.hosts > self.max_replicas:
            bad(f"hosts={self.hosts} > max_replicas={self.max_replicas}: "
                f"a host with no replica drains nothing — raise "
                f"max_replicas or lower hosts")
        if self.transport == "local" and (
                self.transport_drop or self.transport_delay
                or self.transport_reorder or self.transport_rtt_ms):
            bad("transport chaos knobs (transport_drop/delay/reorder/"
                "rtt_ms) require transport='sim' or 'wire': the local "
                "transport has no wire to be lossy on")
        if self.transport == "wire" and self.transport_reorder:
            bad("transport_reorder requires transport='sim': the wire "
                "transport's per-connection TCP framing delivers responses "
                "in order by construction")
        for knob in ("transport_drop", "transport_delay"):
            p = getattr(self, knob)
            if not (0.0 <= p < 1.0):
                bad(f"{knob} must be in [0, 1) (got {p})")
        if not (0.0 <= self.transport_rtt_ms < 10_000.0):
            bad(f"transport_rtt_ms must be in [0, 10000) "
                f"(got {self.transport_rtt_ms})")
        if self.transport_credit < 1:
            bad(f"transport_credit must be >= 1 "
                f"(got {self.transport_credit}); credit is the number of "
                f"fetches kept in flight — 1 means synchronous")
        for field, lo in (("queue_window", 1), ("reclaim_period", 1),
                          ("min_steal", 1), ("drain_k", 1),
                          ("checkpoint_window", 1)):
            if getattr(self, field) < lo:
                bad(f"{field} must be >= {lo} (got {getattr(self, field)})")
        if self.arch is not None:
            if self.max_batch < self.max_replicas:
                bad(f"lane budget max_batch={self.max_batch} cannot give "
                    f"every replica a lane at max_replicas="
                    f"{self.max_replicas}: raise max_batch or lower "
                    f"max_replicas")
            if self.num_pages < 2 * self.max_replicas:
                bad(f"page budget num_pages={self.num_pages} cannot give "
                    f"every replica a scratch page plus one live page at "
                    f"max_replicas={self.max_replicas}: raise num_pages")
            if self.page_size < 1 or self.max_seq < self.page_size:
                bad(f"need max_seq >= page_size >= 1 (got max_seq="
                    f"{self.max_seq}, page_size={self.page_size})")
            if self.kv_window < 1:
                bad(f"kv_window must be >= 1 (got {self.kv_window})")
            if self.device_admission not in (True, False, "auto"):
                bad(f"device_admission must be True, False or 'auto' "
                    f"(got {self.device_admission!r})")
        elif self.device_admission:
            bad("device_admission without arch: a scheduler-only fabric has "
                "no engine admission path — set arch or drop "
                "device_admission")
        elif self.params_dir is not None:
            bad("params_dir without arch: a scheduler-only fabric has no "
                "model params to restore — set arch or drop params_dir")
        if (self.checkpoint_every_n_steps is not None
                and self.checkpoint_every_n_steps < 1):
            bad(f"checkpoint_every_n_steps must be >= 1 or None "
                f"(got {self.checkpoint_every_n_steps})")
        if self.checkpoint_every_n_steps is not None \
                and self.checkpoint_dir is None:
            bad("checkpoint cadence with nowhere to write: set "
                "checkpoint_dir or drop checkpoint_every_n_steps")
        if self.checkpoint_dir is not None \
                and self.checkpoint_dir == self.params_dir:
            bad("checkpoint_dir (frontier snapshots) must differ from "
                "params_dir (model params): a frontier-only step would "
                "shadow the params checkpoint's `latest`")
        if self.obs is not None:
            try:
                self.obs.validate()
            except ValueError as e:
                bad(f"obs: {e}")
        if self.control is not None and self.control.enabled:
            try:
                self.control.validate()
            except ValueError as e:
                bad(f"control: {e}")
            if self.obs is None or not self.obs.enabled:
                bad("control=ControlConfig(...) needs the obs plane for "
                    "its signals (the rolling gauge window): also set "
                    "obs=ObsConfig() — serve.py --autoscale does this "
                    "automatically")
            if self.control.min_replicas > self.replicas:
                bad(f"control.min_replicas={self.control.min_replicas} > "
                    f"replicas={self.replicas}: the shrink floor cannot "
                    f"start above the opening replica count")
            if (self.control.replicas_per_host is not None
                    and self.transport != "sim"):
                bad("control.replicas_per_host (grow-a-host preference) "
                    "requires transport='sim': the local transport is "
                    "single-host by definition")

    # ------------------------------------------------------------------ JSON
    def to_json(self) -> dict:
        """Plain-dict encoding; ``from_json(to_json())`` reproduces the
        config exactly (asserted in tests). This dict rides checkpoint aux
        channels so a fabric restores from its own snapshot."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, data: dict) -> "FabricConfig":
        data = dict(data)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(data) - known)
        if unknown:
            raise FabricConfigError(
                f"FabricConfig.from_json: unknown keys {unknown} "
                f"(snapshot from a newer/older build?)")
        if "classes" in data:
            data["classes"] = tuple(
                c if isinstance(c, ClassSpec) else ClassSpec(**c)
                for c in data["classes"])
        return cls(**data)


def tiered_classes(*, background_window: Optional[int] = None,
                   interactive_slo_ms: float = 50.0,
                   batch_slo_ms: float = 500.0) -> Tuple[ClassSpec, ...]:
    """The standard 3-tier tenant set (interactive/batch/background) used by
    serve.py --multitenant, the examples, and the benchmarks: strict-priority
    ranks with 8:3:1 fair-share weights, SLO targets on the latency-sensitive
    tiers, and an optional admission window bounding background in-flight."""
    return (
        ClassSpec("interactive", priority=2, weight=8.0,
                  slo_ms=interactive_slo_ms),
        ClassSpec("batch", priority=1, weight=3.0, slo_ms=batch_slo_ms),
        ClassSpec("background", priority=0, weight=1.0,
                  admit_window=background_window),
    )
