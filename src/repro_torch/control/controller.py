"""Deterministic SLO-driven controller + the ``Fabric.control`` handle.

Two halves, deliberately split:

  * :class:`Controller` is the *decision* function — pure policy over a
    :class:`~repro_torch.control.signals.ControlSignals` snapshot, returning a
    list of typed actions. It holds only its own hysteresis counters and
    cooldown clocks, so unit tests drive it with synthetic signals and
    never need a fabric.
  * :class:`ControlHandle` is the *actuation surface* — the one public
    object (``fabric.control``) through which anything, human or
    controller, pulls the levers. It dispatches typed actions onto the
    fabric, records every decision (dry-run records without dispatching),
    and emits each as an obs ``control`` event so the flight recorder
    shows *why* the fabric resized.

Flapping guard (DESIGN.md §14): with deadband ``shrink_backlog <
grow_backlog``, hysteresis ``h_up``/``h_down`` and cooldown ``c`` ticks,
a steady signal produces a monotone action sequence (grows only, or
shrinks only) that stops at a bound; any signal at all is limited to
``decisions / c`` resizes.
"""

from __future__ import annotations

from typing import List, Optional

from repro_torch.control.actions import (Action, GrowHost, Resize, SetPriority,
                                   SetWeight, action_to_json)
from repro_torch.control.config import ControlConfig
from repro_torch.control.signals import ClassSignal, ControlSignals, read_signals


class Controller:
    """signals → [actions], deterministically.

    Call :meth:`decide` once per decision tick. All state is small and
    explicit: two consecutive-breach counters (hysteresis) and one
    cooldown clock per action kind (flapping guard).
    """

    def __init__(self, config: ControlConfig):
        config.validate()
        self.config = config
        self.decisions = 0
        self._over = 0      # consecutive overloaded ticks
        self._under = 0     # consecutive idle ticks
        self._cooldown = {"resize": 0, "weights": 0}
        self._last_delivered: Optional[int] = None
        self._last_step: Optional[int] = None

    # ------------------------------------------------------------ signals
    def _breaching(self, sig: ControlSignals) -> List[ClassSignal]:
        """Classes whose measured p99 headroom is inside the SLO margin."""
        out = []
        for c in sig.classes:
            if c.slo_target_ms is None or c.headroom_ms is None:
                continue
            if c.headroom_ms < self.config.slo_margin_frac * c.slo_target_ms:
                out.append(c)
        return out

    def _overloaded(self, sig: ControlSignals,
                    breaching: List[ClassSignal]) -> bool:
        """Grow pressure. The latency reservoir is cumulative, so a breach
        with a drained queue is history, not load — a breach only counts
        while backlog sits above the shrink band (or is still climbing)."""
        cfg = self.config
        if sig.backlog_per_replica > cfg.grow_backlog:
            return True
        if breaching and sig.backlog_per_replica > cfg.shrink_backlog:
            return True
        if (breaching and sig.pending_trend is not None
                and sig.pending_trend > 0):
            return True
        return False

    def _delivery_rate(self, sig: ControlSignals) -> Optional[float]:
        """Deliveries per step since the previous decision tick (None on
        the first tick, or when the step clock has not advanced)."""
        last_d, last_s = self._last_delivered, self._last_step
        self._last_delivered = sig.delivered_total
        self._last_step = sig.step
        if last_d is None or last_s is None or sig.step <= last_s:
            return None
        return (sig.delivered_total - last_d) / (sig.step - last_s)

    def _fits_smaller(self, sig: ControlSignals,
                      rate: Optional[float]) -> bool:
        """Would the observed delivery rate fit comfortably in one fewer
        replica? End-of-step backlog is ~0 whenever capacity exceeds
        arrivals, so depth alone would shrink a fully-loaded fleet and
        regrow it next tick (capacity-level oscillation); this throughput
        guard is the other half of the deadband."""
        if rate is None:
            return False
        per_replica = sig.capacity_per_step / max(1, sig.num_replicas)
        smaller_cap = per_replica * (sig.num_replicas - 1)
        return rate <= self.config.shrink_fill_frac * smaller_cap

    # ------------------------------------------------------------- decide
    def decide(self, sig: ControlSignals) -> List[Action]:
        cfg = self.config
        self.decisions += 1
        for k in self._cooldown:
            if self._cooldown[k] > 0:
                self._cooldown[k] -= 1

        breaching = self._breaching(sig)
        rate = self._delivery_rate(sig)
        over = self._overloaded(sig, breaching)
        idle = (sig.backlog_per_replica < cfg.shrink_backlog and not over
                and self._fits_smaller(sig, rate))
        self._over = self._over + 1 if over else 0
        self._under = self._under + 1 if idle else 0

        actions: List[Action] = []
        actions.extend(self._decide_resize(sig, breaching))
        actions.extend(self._decide_weights(sig, breaching))
        return actions

    def _decide_resize(self, sig: ControlSignals,
                       breaching: List[ClassSignal]) -> List[Action]:
        cfg = self.config
        if self._cooldown["resize"] > 0:
            return []

        if self._over >= cfg.hysteresis_up and sig.num_replicas < sig.max_replicas:
            # Multiplicative grow: a burst that doubled the backlog wants
            # doubled drain bandwidth, and the ceiling bounds the walk.
            n_new = min(sig.max_replicas, max(sig.num_replicas + 1,
                                              sig.num_replicas * 2))
            why = (f"backlog/replica {sig.backlog_per_replica:.1f} > "
                   f"{cfg.grow_backlog:g}")
            if breaching:
                worst = min(breaching, key=lambda c: c.headroom_ms or 0.0)
                why += (f"; slo breach {worst.name} "
                        f"p99 {worst.admit_p99_ms:.2f}ms / "
                        f"target {worst.slo_target_ms:g}ms")
            self._cooldown["resize"] = cfg.resize_cooldown
            self._over = 0
            if (sig.transport_kind == "sim"
                    and cfg.replicas_per_host is not None
                    and n_new > cfg.replicas_per_host * sig.num_hosts):
                return [GrowHost(replicas=n_new, reason=(
                    f"{why}; {n_new} replicas would exceed "
                    f"{cfg.replicas_per_host}/host on {sig.num_hosts} "
                    f"host(s) — adding a host"))]
            return [Resize(replicas=n_new, reason=why)]

        if (self._under >= cfg.hysteresis_down
                and sig.num_replicas > cfg.min_replicas):
            # Additive shrink: cautious on the way down.
            self._cooldown["resize"] = cfg.resize_cooldown
            self._under = 0
            return [Resize(replicas=sig.num_replicas - 1, reason=(
                f"idle {cfg.hysteresis_down} ticks: backlog/replica "
                f"{sig.backlog_per_replica:.1f} < {cfg.shrink_backlog:g}"))]
        return []

    def _decide_weights(self, sig: ControlSignals,
                        breaching: List[ClassSignal]) -> List[Action]:
        """WFQ weight nudges: boost a breaching class toward its ``slo_ms``
        target, decay back toward the declared weight once comfortable.
        Always bounded to [base, base * weight_max_boost]."""
        cfg = self.config
        if (not cfg.nudge_weights or sig.policy != "wfq"
                or self._cooldown["weights"] > 0):
            return []
        breach_names = {c.name for c in breaching}
        drained = sig.backlog_per_replica < cfg.shrink_backlog

        actions: List[Action] = []
        for c in sig.classes:
            if c.slo_target_ms is None:
                continue
            lo, hi = c.base_weight, c.base_weight * cfg.weight_max_boost
            if c.name in breach_names and not drained and c.weight < hi:
                w = min(hi, c.weight * cfg.weight_step)
                actions.append(SetWeight(qclass=c.name, weight=w, reason=(
                    f"slo breach: p99 {c.admit_p99_ms:.2f}ms vs target "
                    f"{c.slo_target_ms:g}ms; weight {c.weight:g} -> {w:g} "
                    f"(cap {hi:g})")))
            elif c.name not in breach_names and c.weight > lo:
                w = max(lo, c.weight / cfg.weight_step)
                actions.append(SetWeight(qclass=c.name, weight=w, reason=(
                    f"headroom recovered; decaying weight {c.weight:g} -> "
                    f"{w:g} toward declared {lo:g}")))
        if actions:
            self._cooldown["weights"] = cfg.weight_cooldown
        return actions


class ControlHandle:
    """``fabric.control`` — the redesigned actuation surface.

    Always present on an open fabric. Typed reads via :meth:`signals`,
    typed writes via :meth:`resize` / :meth:`grow_host` /
    :meth:`set_weight` / :meth:`set_priority` (all funnel through
    :meth:`apply`), and — when ``FabricConfig.control`` is set — a
    :class:`Controller` that :meth:`step` runs on its configured cadence
    from inside ``Fabric.step``.
    """

    def __init__(self, fabric, config: Optional[ControlConfig] = None):
        self._fabric = fabric
        self.config = config
        self.controller = Controller(config) if (
            config is not None and config.enabled) else None
        self.decisions: List[dict] = []
        self.applied = {"resize": 0, "growhost": 0, "setweight": 0,
                        "setpriority": 0}

    # -------------------------------------------------------------- reads
    def signals(self) -> ControlSignals:
        return read_signals(self._fabric)

    # ------------------------------------------------------------- writes
    def resize(self, replicas: int, reason: str = "manual") -> bool:
        return self.apply(Resize(replicas=replicas, reason=reason))

    def grow_host(self, replicas: int, reason: str = "manual") -> bool:
        return self.apply(GrowHost(replicas=replicas, reason=reason))

    def set_weight(self, qclass: str, weight: float,
                   reason: str = "manual") -> bool:
        return self.apply(SetWeight(qclass=qclass, weight=weight,
                                    reason=reason))

    def set_priority(self, qclass: str, priority: int,
                     reason: str = "manual") -> bool:
        return self.apply(SetPriority(qclass=qclass, priority=priority,
                                      reason=reason))

    def apply(self, action: Action, *, actuate: Optional[bool] = None
              ) -> bool:
        """Dispatch one typed action onto the fabric.

        ``actuate=None`` follows the config (dry-run records only);
        explicit True/False overrides. Returns whether the action was
        actually dispatched. Every call — applied or not — lands in the
        decision log and the obs plane's control-event stream.
        """
        if actuate is None:
            actuate = not (self.config is not None and self.config.dry_run)
        if actuate:
            fab = self._fabric
            if isinstance(action, Resize):
                fab.resize(action.replicas)
            elif isinstance(action, GrowHost):
                fab.add_host()
                fab.resize(action.replicas)
            elif isinstance(action, SetWeight):
                qc = fab.replica_set.scheduler.by_name[action.qclass]
                qc.weight = float(action.weight)
            elif isinstance(action, SetPriority):
                qc = fab.replica_set.scheduler.by_name[action.qclass]
                qc.priority = int(action.priority)
            else:  # pragma: no cover - exhaustive over Action
                raise TypeError(f"unknown action {action!r}")
            self.applied[type(action).__name__.lower()] += 1

        decision = action_to_json(action)
        decision["step"] = self._fabric.step_count
        decision["applied"] = bool(actuate)
        self.decisions.append(decision)
        self._emit_obs(action, decision)
        return bool(actuate)

    def _emit_obs(self, action: Action, decision: dict) -> None:
        hub = getattr(self._fabric, "obs", None)
        if hub is None:
            return
        from repro_torch.obs.recorder import CONTROL, PRODUCER_RID
        rec = hub.recorder(PRODUCER_RID)
        rec.emit(CONTROL, cls=getattr(action, "qclass", ""),
                 seq=len(self.decisions), arg=dict(decision))

    # --------------------------------------------------------------- loop
    def step(self) -> List[Action]:
        """One closed-loop tick, called by ``Fabric.step`` every
        ``decide_every_n_steps`` steps. No-op without a controller."""
        if self.controller is None:
            return []
        actions = self.controller.decide(self.signals())
        for action in actions:
            self.apply(action)
        return actions

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        """The ``stats_view().control`` section."""
        out = {
            "enabled": self.controller is not None,
            "dry_run": bool(self.config.dry_run) if self.config else False,
            "decisions": len(self.decisions),
            "applied": dict(self.applied),
            "last": self.decisions[-8:],
        }
        if self.controller is not None:
            out["ticks"] = self.controller.decisions
            out["cooldowns"] = dict(self.controller._cooldown)
        return out
