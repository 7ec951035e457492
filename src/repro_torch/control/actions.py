"""Typed actuation commands emitted by the controller.

Each action is a frozen record naming one lever the fabric already has —
the controller never reaches into scheduler internals directly. Actions
carry a human-readable ``reason`` that flows into the decision log and
the obs plane's control events, so a trace answers *why* the fabric
resized, not just when.

``ControlHandle.apply`` (controller.py) is the single dispatch point; in
dry-run mode the action is recorded but not dispatched.
"""

from __future__ import annotations

import dataclasses
from typing import Union


@dataclasses.dataclass(frozen=True)
class Resize:
    """Grow or shrink the live replica fan-out to ``replicas``."""

    replicas: int
    reason: str


@dataclasses.dataclass(frozen=True)
class GrowHost:
    """Add one simulated host, then resize to ``replicas`` so the reseat
    spreads seats over the enlarged fleet (sim transport only)."""

    replicas: int
    reason: str


@dataclasses.dataclass(frozen=True)
class SetWeight:
    """Set a class's live WFQ weight (read by every replica's next drain)."""

    qclass: str
    weight: float
    reason: str


@dataclasses.dataclass(frozen=True)
class SetPriority:
    """Set a class's live strict-drain priority."""

    qclass: str
    priority: int
    reason: str


Action = Union[Resize, GrowHost, SetWeight, SetPriority]


def action_kind(action: Action) -> str:
    return type(action).__name__.lower()


def action_to_json(action: Action) -> dict:
    out = {"kind": action_kind(action)}
    out.update(dataclasses.asdict(action))
    return out
