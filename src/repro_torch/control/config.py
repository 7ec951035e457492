"""Closed-loop control-plane configuration (DESIGN.md §14).

Plain host-only data, exactly like :class:`~repro_torch.obs.recorder.ObsConfig`:
no fabric import, JSON round-trip through ``FabricConfig.to_json`` (the
controller's knobs ride checkpoint snapshots with everything else).

The controller is *pure policy* over mechanisms that already exist —
``Fabric.resize`` is a sub-ms batch of seat CASes, a sim host grow is one
transport counter bump plus a reseat, and WFQ weights are plain data read
live by every replica's drain policy. What this config tunes is therefore
only *when* to pull those levers:

  * **deadband** (``grow_backlog`` ≫ ``shrink_backlog``): the backlog band
    in which the controller does nothing. A steady signal inside the band
    can never cause an action; a steady signal outside it causes a
    monotone walk to the matching bound and then silence — the
    no-oscillation property tests/test_control.py asserts.
  * **hysteresis** (``hysteresis_up`` / ``hysteresis_down``): consecutive
    out-of-band decisions required before acting, so one noisy sample
    cannot trigger a resize.
  * **cooldowns** (``resize_cooldown`` / ``weight_cooldown``, in decision
    ticks): a floor on the spacing between actions of one kind — the
    flapping guard. Over a run of ``D`` decisions the resize count is
    bounded by ``D / resize_cooldown`` no matter what the signal does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Knobs for the SLO-driven autoscaler (``FabricConfig(control=...)``).

    Attributes:
      enabled: master switch; disabled configs wire nothing.
      dry_run: record every decision (obs control events + the decision
        log) but actuate nothing — the shadow-mode rollout path.
      decide_every_n_steps: decision cadence in ``Fabric.step`` calls.
      grow_backlog: pending items per replica above which the fabric is
        overloaded (grow pressure).
      shrink_backlog: pending items per replica below which shrinking is
        safe. Must be well under ``grow_backlog`` (the deadband).
      shrink_fill_frac: second shrink guard — shrink only when the
        observed delivery rate would fill at most this fraction of the
        *smaller* fleet's per-step drain budget. End-of-step backlog is
        ~0 whenever capacity exceeds arrivals, so depth alone would
        shrink a fully-loaded fleet and immediately regrow it; the
        throughput guard is what makes the deadband hold between
        capacity levels.
      hysteresis_up / hysteresis_down: consecutive overloaded / idle
        decisions required before a grow / shrink fires.
      resize_cooldown / weight_cooldown: minimum decision ticks between
        two actions of the same kind (the flapping guard).
      min_replicas: shrink floor; the grow ceiling is the fabric's
        ``max_replicas`` (seats are provisioned at open).
      replicas_per_host: past this many replicas per transport host, a
        grow prefers adding a sim host (capacity) over packing another
        replica onto the existing hosts. ``None`` = never grow hosts.
      slo_margin_frac: a class *breaches* when its measured p99 headroom
        drops under ``slo_margin_frac * slo_ms`` — i.e. the controller
        acts slightly before the target is actually missed.
      nudge_weights: under the ``wfq`` policy, multiplicatively boost a
        breaching class's weight (and relax it back toward the declared
        weight once it drains) instead of / in addition to resizing.
      weight_step: multiplicative nudge per weight action.
      weight_max_boost: hard bound — a nudged weight stays within
        ``[declared, declared * weight_max_boost]``.
    """

    enabled: bool = True
    dry_run: bool = False
    decide_every_n_steps: int = 2
    grow_backlog: float = 8.0
    shrink_backlog: float = 2.0
    shrink_fill_frac: float = 0.8
    hysteresis_up: int = 1
    hysteresis_down: int = 3
    resize_cooldown: int = 2
    weight_cooldown: int = 4
    min_replicas: int = 1
    replicas_per_host: Optional[int] = None
    slo_margin_frac: float = 0.1
    nudge_weights: bool = True
    weight_step: float = 1.25
    weight_max_boost: float = 4.0

    def validate(self) -> None:
        def bad(msg: str) -> None:
            raise ValueError(f"ControlConfig: {msg}")

        if self.decide_every_n_steps < 1:
            bad(f"decide_every_n_steps must be >= 1 "
                f"(got {self.decide_every_n_steps})")
        if self.grow_backlog <= 0:
            bad(f"grow_backlog must be > 0 (got {self.grow_backlog})")
        if not (0 <= self.shrink_backlog < self.grow_backlog):
            bad(f"need 0 <= shrink_backlog < grow_backlog (got "
                f"shrink_backlog={self.shrink_backlog}, grow_backlog="
                f"{self.grow_backlog}): the gap is the deadband that "
                f"prevents grow/shrink oscillation on a steady signal")
        for field in ("hysteresis_up", "hysteresis_down",
                      "resize_cooldown", "weight_cooldown", "min_replicas"):
            if getattr(self, field) < 1:
                bad(f"{field} must be >= 1 (got {getattr(self, field)})")
        if self.replicas_per_host is not None and self.replicas_per_host < 1:
            bad(f"replicas_per_host must be >= 1 or None "
                f"(got {self.replicas_per_host})")
        if not (0.0 < self.shrink_fill_frac <= 1.0):
            bad(f"shrink_fill_frac must be in (0, 1] "
                f"(got {self.shrink_fill_frac})")
        if not (0.0 <= self.slo_margin_frac < 1.0):
            bad(f"slo_margin_frac must be in [0, 1) "
                f"(got {self.slo_margin_frac})")
        if self.weight_step <= 1.0:
            bad(f"weight_step must be > 1 (got {self.weight_step}); it is "
                f"a multiplicative nudge")
        if self.weight_max_boost < 1.0:
            bad(f"weight_max_boost must be >= 1 "
                f"(got {self.weight_max_boost})")
