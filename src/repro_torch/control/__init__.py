"""Closed-loop control plane: SLO-driven autoscaling over fabric levers.

DESIGN.md §14. The package is pure policy — it imports nothing from
``repro_torch.fabric`` (the fabric passes itself in, duck-typed) and actuates
only through public surfaces: ``Fabric.resize``, ``Fabric.add_host`` and
the scheduler's live policy weights.
"""

from repro_torch.control.actions import (Action, GrowHost, Resize, SetPriority,
                                   SetWeight, action_to_json)
from repro_torch.control.config import ControlConfig
from repro_torch.control.controller import Controller, ControlHandle
from repro_torch.control.signals import ClassSignal, ControlSignals, read_signals

__all__ = [
    "Action",
    "ClassSignal",
    "ControlConfig",
    "ControlHandle",
    "ControlSignals",
    "Controller",
    "GrowHost",
    "Resize",
    "SetPriority",
    "SetWeight",
    "action_to_json",
    "read_signals",
]
