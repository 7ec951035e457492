"""Deprecated shim — the window arithmetic lives in :mod:`repro_torch.core.domain`
(the unified protection-domain core, DESIGN.md §1). Import from there."""

from __future__ import annotations

from repro_torch.core.domain import (  # noqa: F401  (re-exports)
    MIN_WINDOW,
    compute_window,
    max_reclaim_delay_cycles,
    retained_bytes,
)

__all__ = ["MIN_WINDOW", "compute_window", "max_reclaim_delay_cycles",
           "retained_bytes"]
