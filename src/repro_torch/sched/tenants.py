"""Tenant-scale routing for the scheduler fabric.

The fabric's class grid is bounded (groups x tiers) no matter how many
tenants are declared: tenants hash onto class-groups, and every hot path
(drain, pending, stats, gauges) walks only the *active* subset of that
grid.  The pieces here are plain host Python — no jax imports — because
scheduler-only fabrics must stay importable without an accelerator
runtime (see fabric/session.py).

Components:

- ``tenant_hash`` / ``TenantMap``: deterministic FNV-1a tenant->group
  routing.  Python's builtin ``hash()`` is process-salted, so it would
  break snapshot-restore across processes; FNV-1a over ``str(tenant)``
  with a config salt survives resize/fail_host/restore because the group
  id is a pure function of (tenant, num_groups, salt) — none of which
  change over fabric lifetime.
- ``ActiveSet``: the active-class index.  Classes enter on enqueue
  (mark AFTER the item is visible in the queue) and leave when a drain
  sweep observes them empty.  A stale mark costs one wasted scan; a
  missed retire is corrected by the next sweep; an item can never be
  stranded because its mark happens after its enqueue.
- ``TenantStatsTable``: lazy per-tenant counters — allocated on first
  traffic, evicted (merged into an aggregate) when idle and over
  capacity.  Plain ints only: the per-envelope path adds zero atomics.
- ``TenantQuotaLedger``: per-tenant page quotas with per-host aggregate
  caps carved with the same host-first split the engine uses for lane
  and page budgets.
- ``TenantRouter``: the composition Fabric.submit talks to — routing,
  admission verdicts (ok / shed / reject), charge-at-admission with
  credit-at-delivery, and JSON state for snapshots.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "TIERS",
    "tenant_hash",
    "group_class_name",
    "split_class_name",
    "split_hosted",
    "TenantMap",
    "ActiveSet",
    "TenantStatsTable",
    "TenantQuotaLedger",
    "TenantRouter",
]

# Tier order is highest-priority first; the LAST tier is the sheddable
# one (429 rejects under pressure hit only this tier).
TIERS: Tuple[str, ...] = ("interactive", "batch", "background")

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def tenant_hash(tenant: Any, salt: int = 0) -> int:
    """64-bit FNV-1a over ``str(tenant)``, stable across processes.

    Deliberately NOT Python ``hash()``: that is salted per process, and
    tenant->group routing must survive snapshot-restore into a new
    interpreter.
    """
    h = (_FNV_OFFSET ^ (salt & _MASK64)) * _FNV_PRIME & _MASK64
    for b in str(tenant).encode("utf-8"):
        h = ((h ^ b) * _FNV_PRIME) & _MASK64
    return h


def group_class_name(gid: int, tier: str) -> str:
    """Class name for (group, tier) — ``g017:interactive``.

    The group id is encoded in the NAME so tenant classes ride every
    name-keyed path (snapshots, wire codec, seat maps, stats) with zero
    serialization changes.
    """
    return f"g{gid:03d}:{tier}"


def split_class_name(name: str) -> Tuple[str, str]:
    """Inverse of group_class_name: -> (group_key, tier)."""
    group, _, tier = name.partition(":")
    return group, tier


def split_hosted(total: int, num_hosts: int, min_per: int = 0) -> List[int]:
    """Host-first even split of ``total`` units across ``num_hosts``.

    Mirrors the engine's ``_split_budget_hosted`` discipline: every host
    gets ``min_per`` up front, the remainder spreads one unit at a time
    so no host is more than one unit ahead.
    """
    if num_hosts <= 0:
        return []
    caps = [min_per] * num_hosts
    rest = max(0, total - min_per * num_hosts)
    base, extra = divmod(rest, num_hosts)
    for h in range(num_hosts):
        caps[h] += base + (1 if h < extra else 0)
    return caps


class TenantMap:
    """Deterministic tenant -> (group, class) routing onto a bounded grid.

    ``num_groups * len(tiers)`` real QueueClass objects serve any number
    of declared tenants; per-tenant strict FIFO inside a group follows
    from CMP's dense per-class cycle stamps (items of one tenant land in
    one class in submit order, and class drain is stamp-ordered no
    matter which shard or thief holds an item).
    """

    # Submit-path memo bound: tenant -> group results cached up to this
    # many distinct tenants, then dropped wholesale (heavy-tail traffic
    # re-fills the hot entries within one wave). Keeps routing O(1) per
    # repeat submit without O(declared) resident memory.
    CACHE_CAP = 4096

    def __init__(self, num_tenants: int, num_groups: int, salt: int = 0,
                 tiers: Tuple[str, ...] = TIERS):
        if num_groups < 1:
            raise ValueError("num_groups must be >= 1")
        self.num_tenants = int(num_tenants)
        self.num_groups = int(num_groups)
        self.salt = int(salt)
        self.tiers = tuple(tiers)
        # (group, tier) -> name is the whole bounded grid, precomputed so
        # class_of is two dict hits on the hot path (no f-string formats)
        self._names = {(g, t): group_class_name(g, t)
                       for g in range(self.num_groups) for t in self.tiers}
        self._group_memo: Dict[str, int] = {}

    def group_of(self, tenant: Any) -> int:
        key = str(tenant)
        gid = self._group_memo.get(key)
        if gid is None:
            gid = tenant_hash(key, self.salt) % self.num_groups
            if len(self._group_memo) >= self.CACHE_CAP:
                self._group_memo.clear()
            self._group_memo[key] = gid
        return gid

    def class_of(self, tenant: Any, tier: str) -> str:
        name = self._names.get((self.group_of(tenant), tier))
        if name is None:
            raise KeyError(f"unknown tier {tier!r}; expected one of {self.tiers}")
        return name

    def class_names(self) -> List[str]:
        """The full grid, group-major (bounded, independent of tenants)."""
        return [group_class_name(g, t)
                for g in range(self.num_groups) for t in self.tiers]

    def host_of(self, tenant: Any, num_hosts: int) -> int:
        """Quota-accounting host for a tenant (group-affine)."""
        return self.group_of(tenant) % max(1, num_hosts)

    def state(self) -> Dict[str, Any]:
        return {"num_tenants": self.num_tenants, "num_groups": self.num_groups,
                "salt": self.salt, "tiers": list(self.tiers)}

    @classmethod
    def from_state(cls, st: Dict[str, Any]) -> "TenantMap":
        return cls(st["num_tenants"], st["num_groups"], st["salt"],
                   tuple(st["tiers"]))


class ActiveSet:
    """Insertion-ordered set of class names with queued work.

    GIL-atomic dict ops only — no locks, no added atomics on the submit
    path.  The invariant that makes mark/retire races benign: producers
    mark AFTER their item is visible in the queue, so any retire sweep
    that observes pending()==0 and drops the name either ran before the
    enqueue (the following mark re-adds it) or after the item was
    drained (nothing stranded).
    """

    __slots__ = ("_names",)

    def __init__(self) -> None:
        self._names: Dict[str, None] = {}

    def mark(self, name: str) -> None:
        if name not in self._names:
            self._names[name] = None

    def discard(self, name: str) -> None:
        self._names.pop(name, None)

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __len__(self) -> int:
        return len(self._names)

    def names(self) -> List[str]:
        return list(self._names)

    def state(self) -> List[str]:
        return list(self._names)

    def restore(self, names: Iterable[str]) -> None:
        for n in names:
            self._names[n] = None


class _TenantRecord:
    __slots__ = ("submitted", "delivered", "shed", "rejected", "backlog")

    def __init__(self) -> None:
        self.submitted = 0
        self.delivered = 0
        self.shed = 0
        self.rejected = 0
        self.backlog = 0  # charged-not-yet-delivered items


class TenantStatsTable:
    """Lazy per-tenant counters, bounded by eviction of idle records.

    Records are plain-int and allocated on first traffic.  When the
    table exceeds ``capacity``, idle records (backlog == 0) are merged
    into a single aggregate in insertion order — tenant cardinality
    never leaks into memory or into stats() output.  Backlogged tenants
    are never evicted (they are active by definition, so the table stays
    O(active + capacity)).
    """

    def __init__(self, capacity: int = 1024, top_k: int = 8):
        self.capacity = int(capacity)
        self.top_k = int(top_k)
        self._records: Dict[str, _TenantRecord] = {}
        # Aggregate of evicted records so fabric totals stay exact.
        self._evicted = {"tenants": 0, "submitted": 0, "delivered": 0,
                         "shed": 0, "rejected": 0}

    def _record(self, tenant: Any) -> _TenantRecord:
        key = str(tenant)
        rec = self._records.get(key)
        if rec is None:
            if len(self._records) >= self.capacity:
                self._evict_idle()
            rec = self._records[key] = _TenantRecord()
        return rec

    def _evict_idle(self) -> None:
        ev = self._evicted
        for key in list(self._records):
            rec = self._records[key]
            if rec.backlog == 0:
                ev["tenants"] += 1
                ev["submitted"] += rec.submitted
                ev["delivered"] += rec.delivered
                ev["shed"] += rec.shed
                ev["rejected"] += rec.rejected
                del self._records[key]
                if len(self._records) < self.capacity:
                    return

    def note_submit(self, tenant: Any, items: int = 1) -> None:
        rec = self._record(tenant)
        rec.submitted += items
        rec.backlog += items

    def note_deliver(self, tenant: Any, items: int = 1) -> None:
        rec = self._record(tenant)
        rec.delivered += items
        rec.backlog = max(0, rec.backlog - items)

    def note_shed(self, tenant: Any, items: int = 1) -> None:
        self._record(tenant).shed += items

    def note_reject(self, tenant: Any, items: int = 1) -> None:
        self._record(tenant).rejected += items

    def tracked(self) -> int:
        return len(self._records)

    def totals(self) -> Dict[str, int]:
        out = dict(self._evicted)
        out["tenants"] = self._evicted["tenants"] + len(self._records)
        for rec in self._records.values():
            out["submitted"] += rec.submitted
            out["delivered"] += rec.delivered
            out["shed"] += rec.shed
            out["rejected"] += rec.rejected
        return out

    def top_by_backlog(self, k: Optional[int] = None) -> List[Dict[str, int]]:
        k = self.top_k if k is None else k
        busy = [(key, rec) for key, rec in self._records.items()
                if rec.backlog > 0]
        busy.sort(key=lambda kv: -kv[1].backlog)
        return [{"tenant": key, "backlog": rec.backlog,
                 "submitted": rec.submitted, "delivered": rec.delivered,
                 "shed": rec.shed}
                for key, rec in busy[:k]]

    def snapshot(self) -> Dict[str, Any]:
        totals = self.totals()
        return {"tracked": len(self._records),
                "active_backlog": sum(1 for r in self._records.values()
                                      if r.backlog > 0),
                "totals": totals,
                "top": self.top_by_backlog()}

    def state(self) -> Dict[str, Any]:
        return {
            "evicted": dict(self._evicted),
            "records": {key: [r.submitted, r.delivered, r.shed, r.rejected,
                              r.backlog]
                        for key, r in self._records.items()},
        }

    def restore(self, st: Dict[str, Any]) -> None:
        self._evicted = dict(st["evicted"])
        self._records = {}
        for key, (sub, dlv, shd, rej, bkl) in st["records"].items():
            rec = _TenantRecord()
            rec.submitted, rec.delivered = int(sub), int(dlv)
            rec.shed, rec.rejected, rec.backlog = int(shd), int(rej), int(bkl)
            self._records[key] = rec


class TenantQuotaLedger:
    """Per-tenant page quotas with per-host aggregate caps.

    ``charge`` is called at admission with a page estimate, ``credit``
    at delivery/completion.  A tenant is denied when it would exceed its
    own quota OR its host's aggregate cap — the caps are carved from the
    fabric page budget with the same host-first split the engine uses
    for lanes and pages, so quota pressure lands on the same host that
    would run the work.
    """

    def __init__(self, per_tenant: int, total: int, num_hosts: int = 1):
        self.per_tenant = int(per_tenant)
        self.num_hosts = max(1, int(num_hosts))
        self.host_caps = split_hosted(int(total), self.num_hosts)
        self._tenant_used: Dict[str, int] = {}
        self._host_used: List[int] = [0] * self.num_hosts

    def used(self, tenant: Any) -> int:
        return self._tenant_used.get(str(tenant), 0)

    def host_used(self, host: int) -> int:
        return self._host_used[host]

    def charge(self, tenant: Any, host: int, pages: int) -> bool:
        key = str(tenant)
        host = host % self.num_hosts
        cur = self._tenant_used.get(key, 0)
        if cur + pages > self.per_tenant:
            return False
        if self._host_used[host] + pages > self.host_caps[host]:
            return False
        self._tenant_used[key] = cur + pages
        self._host_used[host] += pages
        return True

    def credit(self, tenant: Any, host: int, pages: int) -> None:
        key = str(tenant)
        host = host % self.num_hosts
        cur = self._tenant_used.get(key, 0)
        nxt = max(0, cur - pages)
        if nxt:
            self._tenant_used[key] = nxt
        else:
            self._tenant_used.pop(key, None)
        self._host_used[host] = max(0, self._host_used[host] - pages)

    def rehost(self, num_hosts: int) -> None:
        """Re-carve host caps after resize/fail_host.

        Outstanding charges are re-attributed by re-running the group-
        affine host mapping at credit time, so we simply re-split the
        aggregate: totals are conserved, per-tenant usage is untouched.
        """
        num_hosts = max(1, int(num_hosts))
        total = sum(self.host_caps)
        used = sum(self._host_used)
        self.num_hosts = num_hosts
        self.host_caps = split_hosted(total, num_hosts)
        self._host_used = split_hosted(used, num_hosts)

    def state(self) -> Dict[str, Any]:
        return {"per_tenant": self.per_tenant, "num_hosts": self.num_hosts,
                "host_caps": list(self.host_caps),
                "host_used": list(self._host_used),
                "tenant_used": dict(self._tenant_used)}

    @classmethod
    def from_state(cls, st: Dict[str, Any]) -> "TenantQuotaLedger":
        led = cls(st["per_tenant"], 0, st["num_hosts"])
        led.host_caps = [int(x) for x in st["host_caps"]]
        led._host_used = [int(x) for x in st["host_used"]]
        led._tenant_used = {k: int(v) for k, v in st["tenant_used"].items()}
        return led


class TenantRouter:
    """Routing + admission + charge/credit accounting for Fabric.submit.

    The router never walks the class grid: every operation is O(1) dict
    work keyed by the tenant or by the admission key handed back from
    ``note_admit``.  Shed-vs-reject semantics: only the LAST tier (the
    sheddable background class) records 429-style ``shed``; pressure or
    quota denials on higher tiers count as ordinary rejects.
    """

    def __init__(self, tmap: TenantMap, stats: TenantStatsTable,
                 ledger: Optional[TenantQuotaLedger] = None,
                 admit_pressure: float = 0.85):
        self.map = tmap
        self.stats = stats
        self.ledger = ledger
        self.admit_pressure = float(admit_pressure)
        self.shed_total = 0
        self.shed_by_class: Dict[str, int] = {}
        # Outstanding admission charges: key -> (tenant_str, host, pages).
        # Sched-only fabrics key by (class_name, seq); serving keys by uid.
        self._charges: Dict[Any, Tuple[str, int, int]] = {}

    # -- admission ---------------------------------------------------------

    def sheddable(self, tier: str) -> bool:
        return tier == self.map.tiers[-1]

    def route(self, tenant: Any, tier: str) -> Tuple[int, str]:
        gid = self.map.group_of(tenant)
        name = self.map._names.get((gid, tier))
        if name is None:
            raise KeyError(f"unknown tier {tier!r}; expected one of "
                           f"{self.map.tiers}")
        return gid, name

    def try_charge(self, tenant: Any, pages: int) -> bool:
        if self.ledger is None or pages <= 0:
            return True
        host = self.map.host_of(tenant, self.ledger.num_hosts)
        return self.ledger.charge(tenant, host, pages)

    def cancel_charge(self, tenant: Any, pages: int) -> None:
        """Undo a ``try_charge`` that never reached admission (the class
        window rejected after the ledger said yes)."""
        if self.ledger is not None and pages > 0:
            host = self.map.host_of(tenant, self.ledger.num_hosts)
            self.ledger.credit(tenant, host, pages)

    def note_admit(self, tenant: Any, key: Any, pages: int,
                   items: int = 1) -> None:
        """Record an admission: per-tenant stats plus the key -> (tenant,
        host, pages) entry ``on_done`` resolves at delivery. The entry is
        recorded even without a ledger (pages=0) — it is how deliveries
        find their tenant."""
        self.stats.note_submit(tenant, items)
        if self.ledger is not None and pages > 0:
            host = self.map.host_of(tenant, self.ledger.num_hosts)
            self._charges[key] = (str(tenant), host, pages)
        else:
            self._charges[key] = (str(tenant), 0, 0)

    def note_shed(self, tenant: Any, cls_name: str, items: int = 1) -> None:
        self.shed_total += items
        self.shed_by_class[cls_name] = (
            self.shed_by_class.get(cls_name, 0) + items)
        self.stats.note_shed(tenant, items)

    def note_reject(self, tenant: Any, items: int = 1) -> None:
        self.stats.note_reject(tenant, items)

    def on_done(self, key: Any, tenant: Any = None, items: int = 1) -> None:
        """Credit a delivery/completion by its admission key."""
        charge = self._charges.pop(key, None)
        if charge is not None:
            t, host, pages = charge
            if self.ledger is not None and pages > 0:
                self.ledger.credit(t, host, pages)
            self.stats.note_deliver(t, items)
        elif tenant is not None:
            self.stats.note_deliver(tenant, items)

    def outstanding(self) -> int:
        return len(self._charges)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        out = {"declared": self.map.num_tenants,
               "groups": self.map.num_groups,
               "shed_total": self.shed_total}
        out.update(self.stats.snapshot())
        if self.ledger is not None:
            out["quota"] = {"per_tenant": self.ledger.per_tenant,
                            "host_caps": list(self.ledger.host_caps),
                            "host_used": [self.ledger.host_used(h)
                                          for h in range(self.ledger.num_hosts)],
                            "outstanding": len(self._charges)}
        return out

    def state(self) -> Dict[str, Any]:
        # JSON-safe: charge keys may be tuples -> encode as tagged lists.
        charges = []
        for key, (t, host, pages) in self._charges.items():
            if isinstance(key, tuple):
                charges.append(["t", list(key), t, host, pages])
            else:
                charges.append(["s", key, t, host, pages])
        return {"map": self.map.state(),
                "stats": self.stats.state(),
                "ledger": None if self.ledger is None else self.ledger.state(),
                "admit_pressure": self.admit_pressure,
                "shed_total": self.shed_total,
                "shed_by_class": dict(self.shed_by_class),
                "charges": charges}

    @classmethod
    def from_state(cls, st: Dict[str, Any],
                   stats_capacity: int = 1024,
                   stats_top_k: int = 8) -> "TenantRouter":
        tmap = TenantMap.from_state(st["map"])
        stats = TenantStatsTable(stats_capacity, stats_top_k)
        stats.restore(st["stats"])
        ledger = (None if st["ledger"] is None
                  else TenantQuotaLedger.from_state(st["ledger"]))
        router = cls(tmap, stats, ledger, st["admit_pressure"])
        router.shed_total = int(st["shed_total"])
        router.shed_by_class = {k: int(v)
                                for k, v in st["shed_by_class"].items()}
        for tag, key, t, host, pages in st["charges"]:
            k = tuple(key) if tag == "t" else key
            router._charges[k] = (t, int(host), int(pages))
        return router
