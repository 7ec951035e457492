"""The fabric session handle (DESIGN.md §10).

One lifecycle object over the whole stack: ``Fabric.open(config)`` stands up
class queues, scheduler replicas and (when ``config.arch`` is set) the
engine replica group from a single declarative :class:`FabricConfig`;
``submit`` / ``step`` / ``drain`` run it; ``resize`` grows or shrinks the
replica count live (a batch of seat claims + a lane/page budget re-split,
no drain pause); a ``checkpoint_every_n_steps`` cadence writes exact-seat
frontier snapshots through the async checkpointer so a running fabric
always has a bounded recovery point; ``Fabric.restore(dir)`` resumes every
tenant at its exact FIFO seat.

Two modes, one protocol:

  * **serving** (``config.arch`` set) — a full
    :class:`~repro_torch.serving.engine.EngineReplicaGroup`: ``submit`` takes
    token prompts and returns uids, ``step`` returns completed requests.
  * **scheduler-only** (``config.arch is None``) — the class fabric +
    :class:`~repro_torch.sched.ReplicaSet` without engines (benchmarks, chaos
    tests, non-LLM consumers): ``submit`` takes arbitrary payloads and
    returns envelopes, ``step`` returns ``(view, envelope)`` deliveries.

The serving imports (torch, model configs, the engine) are lazy: a
scheduler-only fabric is plain host Python. A serving fabric runs its
engines on the card unless ``Fabric.open`` / ``from_snapshot`` /
``restore`` are given ``device="cpu"``; the device is a keyword of the
session, not a config field, so a snapshot taken by either package
restores in the other.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.control import ControlHandle
from repro_torch.fabric.config import FabricConfig, FabricConfigError
from repro_torch.fabric.stats import (SloView, StatsView, _json_safe,
                                class_view_from_snapshot)
from repro_torch.obs.recorder import FABRIC_STEP
from repro_torch.sched import QueueClass, ReplicaSet, Scheduler, make_transport
from repro_torch.sched.tenants import (TIERS, TenantMap, TenantQuotaLedger,
                                 TenantRouter, TenantStatsTable,
                                 group_class_name)

# Fabric.stats() (the raw-dict alias of stats_view()) warns once per
# process, not once per call site — the alias is a migration aid, not a
# supported surface.
_STATS_DICT_WARNED = False


def _build_classes(config: FabricConfig) -> List[QueueClass]:
    return [
        QueueClass(spec.name, priority=spec.priority, weight=spec.weight,
                   num_shards=config.shards_per_class,
                   admit_window=spec.admit_window,
                   window=config.queue_window,
                   reclaim_period=config.reclaim_period)
        for spec in config.classes]


def _build_transport(config: FabricConfig, codec=None):
    """Config -> seat-protocol transport. Serving fabrics carry Request
    payloads, so the sim transport's wire codec gets the request
    encode/decode hooks (the same pair the frontier checkpoint uses —
    DESIGN.md §11: the checkpoint format is the wire format). Scheduler-
    only fabrics default to the identity codec — cross-host envelopes take
    a plain JSON hop, so payloads must be JSON-stable (a tuple comes back
    a list); callers with richer payloads pass ``codec=(encode, decode)``
    to Fabric.open/from_snapshot/restore."""
    encode = decode = None
    if codec is not None:
        encode, decode = codec
    elif config.arch is not None and config.transport in ("sim", "wire"):
        from repro_torch.serving.engine import request_from_state, request_state
        encode, decode = request_state, request_from_state
    return make_transport(
        config.transport, config.hosts, drop=config.transport_drop,
        reorder=config.transport_reorder, delay=config.transport_delay,
        seed=config.transport_seed, rtt_ms=config.transport_rtt_ms,
        credit=config.transport_credit, encode=encode, decode=decode)


class Fabric:
    """A running fabric session. Construct via :meth:`open` /
    :meth:`restore` / :meth:`from_snapshot`; usable as a context manager
    (``close()`` on exit writes the final frontier checkpoint)."""

    def __init__(self, config: FabricConfig, *, replica_set=None, group=None,
                 model_cfg=None, params=None, step: int = 0,
                 tenant_state: Optional[dict] = None, device=None):
        assert (replica_set is None) != (group is None), \
            "exactly one of replica_set (sched-only) / group (serving)"
        self.config = config
        self._group = group
        self._replica_set = group.replica_set if group is not None \
            else replica_set
        self.model_cfg = model_cfg
        self.params = params
        self.device = device
        self.step_count = int(step)
        self._closed = False
        self._spec_by_name = {s.name: s for s in config.classes}
        # tenant scale (DESIGN.md §16): with config.tenants set, the
        # scheduler's hot paths switch to O(active classes) and submits
        # route through the tenant router (hashing, quotas, shedding).
        # Attached post-construction like the obs hub, so every
        # construction path (open / from_snapshot / replica rebuild)
        # works unchanged.
        self._tenants: Optional[TenantRouter] = None
        if config.tenants is not None:
            self._replica_set.scheduler.enable_active_tracking()
            self._tenants = self._build_router(config, tenant_state)
        self._ckpt = None
        if config.checkpoint_dir is not None:
            from repro_torch.checkpoint.checkpointer import AsyncCheckpointer
            self._ckpt = AsyncCheckpointer(config.checkpoint_dir,
                                           window=config.checkpoint_window)
        # observability plane (DESIGN.md §13): one MetricsHub over the whole
        # session — flight recorders attach to every emitting component by
        # walking the object graph (re-walked after resize/fail_host, which
        # rebuild engines). config.obs is None -> no hub, no recorders, and
        # every emit site stays a single `is None` check.
        self._obs_hub = None
        if config.obs is not None and config.obs.enabled:
            from repro_torch.obs import MetricsHub
            self._obs_hub = MetricsHub(config.obs)
            self._obs_hub.attach(self._replica_set, engines=self.engines)
        # control plane (DESIGN.md §14): the actuation surface is always
        # present (fabric.control.resize/set_weight/... are the typed way
        # to pull levers by hand); the closed-loop Controller inside it
        # exists only when config.control is set and enabled.
        self._control = ControlHandle(self, config.control)

    # ------------------------------------------------------------- lifecycle
    @classmethod
    def open(cls, config: FabricConfig, *, params=None,
             model_cfg=None, codec=None, device="cuda") -> "Fabric":
        """Stand up a fresh fabric from the declarative config. ``params`` /
        ``model_cfg`` are overrides for callers that already hold model
        state (tests, the compat shims); normally both derive from
        ``config.arch`` (+ ``params_dir``). ``codec=(encode, decode)``
        supplies the sim transport's payload wire hooks for scheduler-only
        fabrics with non-JSON-stable payloads. ``device`` is where a
        serving fabric's engines, pages and weights live (the card unless
        ``"cpu"``); a scheduler-only fabric ignores it."""
        config.validate()
        classes = _build_classes(config)
        if config.arch is None:
            transport = _build_transport(config, codec)
            sched = Scheduler(classes, policy=config.policy)
            rs = ReplicaSet(sched, config.replicas, policy=config.policy,
                            min_steal=config.min_steal, transport=transport)
            return cls(config, replica_set=rs)
        from repro_torch.serving.engine import EngineReplicaGroup, resolve_device
        device = resolve_device(device)  # before any weights or transport workers
        model_cfg, params = cls._model_state(config, model_cfg, params, device)
        transport = _build_transport(config, codec)
        group = EngineReplicaGroup(
            model_cfg, params, num_replicas=config.replicas,
            max_batch=config.max_batch, page_size=config.page_size,
            num_pages=config.num_pages, window=config.kv_window,
            max_seq=config.max_seq, classes=classes, policy=config.policy,
            min_steal=config.min_steal, transport=transport,
            device_admission=config.device_admission, device=device)
        return cls(config, group=group, model_cfg=model_cfg, params=params,
                   device=device)

    @classmethod
    def from_snapshot(cls, snapshot: dict, *, params=None, model_cfg=None,
                      checkpoint_dir: Optional[str] = None,
                      overrides: Optional[dict] = None,
                      codec=None, device="cuda") -> "Fabric":
        """Rebuild a fabric from a :meth:`snapshot` dict (JSON round-trip
        safe): the config rides inside it, every tenant resumes at its
        exact FIFO seat, and the replica count is whatever the snapshot
        recorded (resizes survive checkpoints).

        ``overrides`` replaces config fields that are safe to change across
        a restore — policy, engine geometry/budgets, checkpoint cadence,
        and the transport/host layout (owners are recorded by replica and
        re-addressed on restore, so a snapshot taken under LocalTransport
        restores onto a multi-host SimHostTransport and vice versa) — and
        is re-validated; class declarations and seat structure always come
        from the snapshot (they ARE the resume state). ``device`` as in
        :meth:`open`."""
        config = FabricConfig.from_json(snapshot["config"])
        if overrides:
            for key in ("classes", "shards_per_class", "replicas",
                        "tenants"):
                if key in overrides:
                    raise FabricConfigError(
                        f"from_snapshot: cannot override {key!r} — it is "
                        f"part of the seat structure being restored (open a "
                        f"fresh fabric, or resize() after restoring)")
            config = dataclasses.replace(config, **overrides)
        if checkpoint_dir is not None \
                and checkpoint_dir != config.checkpoint_dir:
            config = dataclasses.replace(config, checkpoint_dir=checkpoint_dir)
        step = int(snapshot.get("step", 0))
        tenant_state = snapshot.get("tenants")
        if config.arch is None:
            transport = _build_transport(config, codec)
            rs = ReplicaSet.from_state(snapshot["sched"],
                                       policy=config.policy,
                                       min_steal=config.min_steal,
                                       transport=transport)
            return cls(config, replica_set=rs, step=step,
                       tenant_state=tenant_state)
        from repro_torch.serving.engine import EngineReplicaGroup, resolve_device
        device = resolve_device(device)  # before any weights or transport workers
        model_cfg, params = cls._model_state(config, model_cfg, params, device)
        transport = _build_transport(config, codec)
        group = EngineReplicaGroup.from_sched_state(
            model_cfg, params, snapshot["sched"], policy=config.policy,
            min_steal=config.min_steal, window=config.kv_window,
            max_batch=config.max_batch, page_size=config.page_size,
            num_pages=config.num_pages, max_seq=config.max_seq,
            transport=transport,
            device_admission=config.device_admission, device=device)
        return cls(config, group=group, model_cfg=model_cfg, params=params,
                   step=step, tenant_state=tenant_state, device=device)

    @classmethod
    def restore(cls, checkpoint_dir: str, *, step: Optional[int] = None,
                params=None, model_cfg=None,
                overrides: Optional[dict] = None, codec=None,
                device="cuda") -> "Fabric":
        """Resume from the latest (or a specific) cadence checkpoint in
        ``checkpoint_dir``: the snapshot carries its own config, so no
        re-declaration is needed (``overrides`` and ``device`` as in
        :meth:`from_snapshot`)."""
        from repro_torch.checkpoint.checkpointer import restore_aux
        ck_step, aux = restore_aux(checkpoint_dir, step)
        if aux is None or "fabric" not in aux:
            raise FabricConfigError(
                f"checkpoint step {ck_step} in {checkpoint_dir!r} has no "
                f"fabric snapshot (aux['fabric']): was it written by "
                f"Fabric, or is this a params-only / pre-fabric directory?")
        return cls.from_snapshot(aux["fabric"], params=params,
                                 model_cfg=model_cfg,
                                 checkpoint_dir=checkpoint_dir,
                                 overrides=overrides, codec=codec,
                                 device=device)

    @staticmethod
    def _build_router(config: FabricConfig,
                      state: Optional[dict]) -> TenantRouter:
        t = config.tenants
        if state is not None:  # snapshot restore: routing/quotas/stats ride
            return TenantRouter.from_state(state, t.stats_capacity,
                                           t.stats_top_k)
        tmap = TenantMap(t.num_tenants, t.num_groups, t.salt)
        stats = TenantStatsTable(t.stats_capacity, t.stats_top_k)
        ledger = None
        if t.page_quota is not None:
            total = t.quota_total
            if total is None:
                # serving fabrics cap at the real page budget; scheduler-
                # only ones (no KV pool) at one full quota per group
                total = (config.num_pages if config.arch is not None
                         else t.num_groups * t.page_quota)
            ledger = TenantQuotaLedger(t.page_quota, total,
                                       t.quota_hosts or config.hosts)
        return TenantRouter(tmap, stats, ledger, t.admit_pressure)

    @staticmethod
    def _model_state(config: FabricConfig, model_cfg, params, device):
        import torch

        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        if model_cfg is None:
            try:
                model_cfg = get_config(config.arch, smoke=config.smoke)
            except (ImportError, AttributeError, KeyError) as e:
                raise FabricConfigError(
                    f"unknown arch {config.arch!r} ({e}); see "
                    f"repro_torch.configs.ARCHS") from None
        if params is None:
            # the same seed gives other weights than the JAX package's
            gen = torch.Generator(device).manual_seed(config.param_seed)
            params = init_params(model_cfg, gen, device)
            if config.params_dir is not None:
                from repro_torch.checkpoint import checkpointer as C
                _, state = C.restore(config.params_dir, {"params": params})
                params = state["params"]
        return model_cfg, params

    def close(self, *, final_checkpoint: bool = True) -> None:
        """End the session. With a checkpoint dir configured, drains the
        async writer and (by default) writes one final frontier snapshot so
        the recovery point is the exact close state."""
        if self._closed:
            return
        self._closed = True
        try:
            if self._ckpt is not None:
                try:
                    self._ckpt.drain()
                    if final_checkpoint:
                        from repro_torch.checkpoint.checkpointer import save
                        save(self.config.checkpoint_dir, self.step_count, {},
                             aux={"fabric": self.snapshot()})
                finally:
                    self._ckpt.close()
        finally:
            # transports that own external resources (the wire transport's
            # host worker processes + sockets) tear down last, after any
            # final snapshot has finished talking to them
            tclose = getattr(self._replica_set.transport, "close", None)
            if callable(tclose):
                tclose()

    def __enter__(self) -> "Fabric":
        return self

    def __exit__(self, *exc) -> None:
        self.close(final_checkpoint=exc[0] is None)

    # ----------------------------------------------------------------- intro
    @property
    def serving(self) -> bool:
        return self._group is not None

    @property
    def num_replicas(self) -> int:
        """Current replica count (tracks :meth:`resize`, unlike
        ``config.replicas`` which is the opening count)."""
        return self._replica_set.num_replicas

    @property
    def replicas(self):
        """The live :class:`~repro_torch.sched.SchedulerReplica` list — benchmark
        harnesses drive per-replica drains through this."""
        return self._replica_set.replicas

    @property
    def replica_set(self) -> ReplicaSet:
        return self._replica_set

    @property
    def engines(self):
        return self._group.engines if self._group is not None else []

    @property
    def completed(self) -> Dict[int, Any]:
        return self._group.completed if self._group is not None else {}

    def pending(self) -> int:
        """Accepted-but-undelivered items across the fabric."""
        return self._replica_set.pending()

    def idle(self) -> bool:
        if self._group is not None:
            return self._group.idle()
        return self._replica_set.pending() == 0

    # ---------------------------------------------------------------- client
    def submit(self, item, *, qclass: Optional[str] = None,
               tenant=None, tier: Optional[str] = None,
               max_new_tokens: int = 16):
        """Serving mode: ``item`` is a token prompt; returns its uid (None
        on admission-window rejection). Scheduler-only mode: ``item`` is an
        arbitrary payload; returns its Envelope (None on rejection).

        Tenant fabrics (``config.tenants``): pass ``tenant`` (any hashable
        id) and optionally ``tier`` (interactive | batch | background,
        default interactive) instead of ``qclass`` — routing, per-tenant
        quota accounting and overload shedding happen here. ``None`` also
        means a 429-style shed (lowest tier under group pressure or quota
        exhaustion — counted in ``StatsView.classes[...].shed``)."""
        self._check_open()
        if tenant is not None:
            if self._tenants is None:
                raise FabricConfigError(
                    "submit(tenant=...) needs a tenant fabric: set "
                    "tenants=TenantSpec(...) on the config")
            return self._submit_tenant(item, tenant, tier or TIERS[0],
                                       max_new_tokens)
        if self._group is not None:
            return self._group.submit(item, max_new_tokens=max_new_tokens,
                                      qclass=qclass)
        name = qclass or self._replica_set.scheduler.default_class
        return self._replica_set.submit(name, item)

    def _page_estimate(self, item, max_new_tokens: int) -> int:
        """Admission-time KV page estimate for the quota ledger: the pages
        the request will occupy at full length (serving), or 1 unit per
        item on scheduler-only fabrics (the ledger then meters items)."""
        if self._group is None:
            return 1
        tokens = len(item) + max_new_tokens
        return -(-tokens // self.config.page_size)

    def _group_pressure(self, gid: int) -> bool:
        """Group overload signal for admission shedding: summed window
        occupancy across the group's tier classes vs the summed windows
        (plain atomic loads of state that already exists — zero added
        atomics, O(tiers) per submit)."""
        router = self._tenants
        by_name = self._replica_set.scheduler.by_name
        occ = cap = 0
        for tier in router.map.tiers:
            qc = by_name[group_class_name(gid, tier)]
            if qc.admit_window:
                occ += qc._inflight.load()
                cap += qc.admit_window
        return cap > 0 and occ >= router.admit_pressure * cap

    def _submit_tenant(self, item, tenant, tier: str, max_new_tokens: int):
        """The tenant admission path: route -> shed check (lowest tier
        only) -> quota charge -> class submit; every deny leaves the
        ledger exactly where it was. Admission keys — (class, seq) for
        scheduler-only, uid for serving — are credited back in step()."""
        router = self._tenants
        gid, cls = router.route(tenant, tier)
        pages = self._page_estimate(item, max_new_tokens)
        sheddable = router.sheddable(tier)
        if sheddable and self._group_pressure(gid):
            router.note_shed(tenant, cls)
            self._replica_set.scheduler.by_name[cls].stats.add_rejected()
            return None
        if not router.try_charge(tenant, pages):
            if sheddable:
                router.note_shed(tenant, cls)
            else:
                router.note_reject(tenant)
            self._replica_set.scheduler.by_name[cls].stats.add_rejected()
            return None
        if self._group is not None:
            uid = self._group.submit(item, max_new_tokens=max_new_tokens,
                                     qclass=cls)
            if uid is None:  # window rejection inside the class
                router.cancel_charge(tenant, pages)
                if sheddable:
                    router.note_shed(tenant, cls)
                else:
                    router.note_reject(tenant)
                return None
            router.note_admit(tenant, uid, pages)
            return uid
        env = self._replica_set.submit(cls, item)
        if env is None:
            router.cancel_charge(tenant, pages)
            if sheddable:
                router.note_shed(tenant, cls)
            else:
                router.note_reject(tenant)
            return None
        router.note_admit(tenant, (cls, env.seq), pages)
        return env

    def submit_many(self, items: Sequence, *, qclass: Optional[str] = None,
                    max_new_tokens: int = 16) -> List:
        """Batched admission (one cycle-range fetch-add + one splice per
        shard for the burst); rejected entries come back as None."""
        self._check_open()
        if self._group is not None:
            return self._group.submit_many(
                list(items), max_new_tokens=max_new_tokens, qclass=qclass)
        name = qclass or self._replica_set.scheduler.default_class
        return self._replica_set.submit_many(name, list(items))

    # ------------------------------------------------------------------ loop
    def step(self) -> List:
        """One fabric iteration: every replica admits/decodes (serving) or
        drains one batch (scheduler-only), starved replicas steal, and the
        checkpoint cadence fires when due. Returns completed requests
        (serving) or ``(view, envelope)`` deliveries (scheduler-only).
        With the obs plane on, the iteration is a ``fabric.step`` span on
        the producer-side recorder: the engines' step spans nest in it."""
        self._check_open()
        hub = self._obs_hub
        if hub is None:
            return self._step()
        with hub.recorder().span(FABRIC_STEP):
            return self._step()

    def _step(self) -> List:
        self.step_count += 1
        if self._group is not None:
            out = self._group.step()
        else:
            out = []
            for r in self._replica_set.replicas:
                out.extend(r.drain(self.config.drain_k))
            self._replica_set.rebalance()
        router = self._tenants
        if router is not None and out:
            # credit quota charges + per-tenant delivery counts by the
            # admission key: uid (serving completions) or (class, seq)
            if self._group is not None:
                for req in out:
                    router.on_done(req.uid)
            else:
                for view, env in out:
                    router.on_done((view.name, env.seq))
        every = self.config.checkpoint_every_n_steps
        if (self._ckpt is not None and every is not None
                and self.step_count % every == 0):
            # Never blocks; dropped when the writer lags more than
            # checkpoint_window snapshots — the recovery point is bounded,
            # the step loop is not.
            self._ckpt.submit(self.step_count, {},
                              aux={"fabric": self.snapshot()})
        hub = self._obs_hub
        if (hub is not None and
                self.step_count % hub.config.sample_every_n_steps == 0):
            hub.sample(self._replica_set, self.engines)
            if hub.config.snapshot_path is not None:
                from repro_torch.obs import append_jsonl_snapshot, strip_samples
                append_jsonl_snapshot(
                    hub.config.snapshot_path,
                    {"step": self.step_count,
                     "obs": strip_samples(hub.snapshot())})
        # Closed loop last, so a decision sees this step's depths and the
        # freshest gauge sample (DESIGN.md §14: signals→decision→actions).
        ctrl = self._control
        if (ctrl.controller is not None and
                self.step_count % ctrl.config.decide_every_n_steps == 0):
            ctrl.step()
        return out

    def drain(self, max_steps: int = 1000):
        """Run until idle. Returns the completed-request dict (serving) or
        the list of deliveries made during this call (scheduler-only)."""
        if self._group is not None:
            for _ in range(max_steps):
                self.step()
                if self._group.idle():
                    break
            return self._group.completed
        out: List = []
        for _ in range(max_steps):
            got = self.step()
            out.extend(got)
            if not got and self._replica_set.pending() == 0:
                break
        return out

    # ------------------------------------------------------------ elasticity
    def resize(self, num_replicas: int) -> "Fabric":
        """Live replica elasticity: grow/shrink the running fabric to
        ``num_replicas`` with no drain pause — a batch of seat claims plus
        (in serving mode) a lane/page budget re-split. Bounded by
        ``config.max_replicas`` (seats are provisioned at open)."""
        self._check_open()
        n = int(num_replicas)
        if n < 1 or n > self.config.max_replicas:
            raise FabricConfigError(
                f"resize({n}): replica count must be in [1, max_replicas="
                f"{self.config.max_replicas}] — seats are provisioned at "
                f"open; raise max_replicas in the config to resize further")
        if self._group is not None:
            self._group.resize(n)
        else:
            self._replica_set.resize(n)
        if self._obs_hub is not None:  # engines were rebuilt: re-attach
            self._obs_hub.attach(self._replica_set, engines=self.engines)
        return self

    def fail_host(self, host: int) -> int:
        """Chaos/ops entry point: kill one simulated transport host mid-run
        and recover its seats into the survivors (serving mode first
        preempts the dead host's lanes to their exact seats). Per-class
        FIFO delivery is preserved exactly — the dead host's final frontier
        state replays through the wire codec. Returns the number of seats
        reassigned."""
        self._check_open()
        if self._group is not None:
            moved = self._group.fail_host(host)
        else:
            moved = self._replica_set.fail_host(host)
        if self._obs_hub is not None:  # survivor engines rebuilt: re-attach
            self._obs_hub.attach(self._replica_set, engines=self.engines)
        return moved

    def add_host(self) -> int:
        """Grow the simulated host fleet by one (sim transport only); the
        next :meth:`resize` / reseat spreads seats over the enlarged
        fleet. Returns the new host count. The control plane's
        ``GrowHost`` action is ``add_host()`` + ``resize(n)``."""
        self._check_open()
        t = self.transport
        if not hasattr(t, "add_host"):
            raise FabricConfigError(
                "add_host(): the local transport is single-host by "
                "definition — open with transport='sim' to grow hosts")
        n = t.add_host()
        if self._obs_hub is not None:
            self._obs_hub.attach(self._replica_set, engines=self.engines)
        return n

    @property
    def transport(self):
        return self._replica_set.transport

    @property
    def num_hosts(self) -> int:
        return self._replica_set.transport.num_hosts

    @property
    def control(self) -> ControlHandle:
        """The control plane's actuation surface (DESIGN.md §14): typed
        signal reads (``fabric.control.signals()``) and typed actions
        (``.resize/.grow_host/.set_weight/.set_priority/.apply``), plus
        the closed-loop controller when ``config.control`` is set."""
        return self._control

    @property
    def obs(self):
        """The session's :class:`~repro_torch.obs.MetricsHub` (None when
        ``config.obs`` is unset/disabled) — the exporters' entry point:
        ``perfetto_trace(fabric.obs.events())``,
        ``prometheus_text(fabric.stats_view())``."""
        return self._obs_hub

    @property
    def tenants(self) -> Optional[TenantRouter]:
        """The tenant router (None unless ``config.tenants`` is set):
        routing map, quota ledger, shed counters, lazy per-tenant stats."""
        return self._tenants

    # ------------------------------------------------------------ checkpoint
    def snapshot(self) -> dict:
        """JSON-able exact-seat frontier snapshot of the whole session:
        the config, the fabric step, and every class's cycle counters, seat
        cursors/owners and undelivered envelopes. Take it at a step
        boundary; restore with :meth:`from_snapshot`."""
        if self._group is not None:
            sched = self._group.sched_state()
        else:
            sched = self._replica_set.state()
        out = {"config": self.config.to_json(), "step": self.step_count,
               "sched": sched}
        if self._tenants is not None:
            out["tenants"] = self._tenants.state()
        return out

    def checkpoint(self, *, wait: bool = True) -> bool:
        """Write a frontier checkpoint now, outside the cadence. Returns
        False when the async writer's window was full and the snapshot was
        dropped (never blocks unless ``wait``)."""
        self._check_open()
        if self._ckpt is None:
            raise FabricConfigError(
                "checkpoint(): no checkpoint_dir configured")
        ok = self._ckpt.submit(self.step_count, {},
                               aux={"fabric": self.snapshot()})
        if wait:
            self._ckpt.drain()
        return ok

    def flush_checkpoints(self, timeout: float = 60.0) -> None:
        """Block until every cadence snapshot handed to the async writer is
        durably on disk (e.g. before a deliberate kill in tests/demos)."""
        if self._ckpt is not None:
            self._ckpt.drain(timeout)

    # ------------------------------------------------------------- telemetry
    def stats_view(self) -> StatsView:
        """The versioned fabric-wide telemetry snapshot (DESIGN.md §14):
        typed per-class aggregates (via ``aggregate_class_snapshots``
        across replicas, continuous across resizes) and the ``slo`` view —
        measured per-class ``admit_p99_ms`` against each class's configured
        ``slo_ms`` target — plus pass-through ``replicas`` / ``transport``
        / ``checkpoint`` / ``obs`` / ``control`` sections. This is the one
        schema the controller, serve.py heartbeat and exporters all read;
        ``view.to_json()`` is the JSON-stable raw form."""
        router = self._tenants
        # Tenant fabrics emit only the *active* grid classes: the view
        # stays O(active tenants), never O(declared) — idle groups cost
        # nothing to report, exactly like they cost nothing to drain.
        snap = self._replica_set.snapshot(active_only=router is not None)
        shed_by = router.shed_by_class if router is not None else {}
        classes = {}
        slo = {}
        for name, cs in snap["classes"].items():
            spec = self._spec_by_name[name]
            classes[name] = class_view_from_snapshot(
                name, cs, shed_by.get(name, 0))
            p99 = cs["admit_p99_ms"]
            ok = None if (spec.slo_ms is None or p99 is None) \
                else p99 <= spec.slo_ms
            slo[name] = SloView(
                target_ms=spec.slo_ms,
                admit_p99_ms=p99,
                ok=ok,
                headroom_ms=(None if spec.slo_ms is None or p99 is None
                             else spec.slo_ms - p99),
            )
        tenants = None
        if router is not None:
            tenants = router.snapshot()
            act = self._replica_set.scheduler.active
            tenants["active_classes"] = 0 if act is None else len(act)
        checkpoint = None
        if self._ckpt is not None:
            checkpoint = {"written": list(self._ckpt.written),
                          "dropped": self._ckpt.dropped}
        transport = _json_safe(snap["transport"])
        if self._obs_hub is not None:
            rtt = self._obs_hub.snapshot().get("rtt_ms")
            if rtt:
                transport["rtt_ms"] = _json_safe(rtt)
        return StatsView(
            step=self.step_count,
            num_replicas=self.num_replicas,
            num_hosts=self.num_hosts,
            resizes=self._replica_set.resizes,
            classes=classes,
            slo=slo,
            replicas=_json_safe(snap["replicas"]),
            transport=transport,
            checkpoint=checkpoint,
            obs=(_json_safe(self._obs_hub.snapshot())
                 if self._obs_hub is not None else None),
            control=self._control.snapshot(),
            tenants=_json_safe(tenants) if tenants is not None else None,
        )

    def stats(self) -> dict:
        """Deprecated raw-dict alias of :meth:`stats_view` — exactly
        ``stats_view().to_json()``. Warns once per process; new code reads
        the typed view. (Two schema-1 differences from the older dict:
        per-class blobs carry ``name`` instead of ``class`` and no longer
        ship raw ``latency_samples``, and nested section keys are
        strings.)"""
        global _STATS_DICT_WARNED
        if not _STATS_DICT_WARNED:
            _STATS_DICT_WARNED = True
            warnings.warn(
                "Fabric.stats() is deprecated: read the versioned "
                "Fabric.stats_view() (StatsView, schema_version "
                f"{StatsView.schema_version}); stats() now returns "
                "stats_view().to_json()", DeprecationWarning, stacklevel=2)
        return self.stats_view().to_json()

    # -------------------------------------------------------------- internal
    def _check_open(self) -> None:
        if self._closed:
            raise FabricConfigError("fabric session is closed")
