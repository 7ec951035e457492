"""CMP core: the paper's contribution.

Unified protection domain (single source of truth, DESIGN.md §1):
  - :mod:`repro.core.domain` — state constants, window arithmetic, monotone
    boundary publish, reclamation predicates, quiesced invariant checkers.

Host side (faithful shared-memory reproduction):
  - :class:`repro.core.cmp.CMPQueue` — Algorithms 1, 3, 4 + batched ops.
  - :mod:`repro.core.baselines` — M&S+hazard-pointers, segmented, mutex.

Device side (TPU-native adaptation, DESIGN.md §2):
  - :mod:`repro.core.slotpool` — cyclic slot pool with window reclamation.
"""

from repro_torch.core.cmp import CMPQueue
from repro_torch.core.domain import AVAILABLE, CLAIMED, FREE, compute_window

__all__ = ["CMPQueue", "FREE", "AVAILABLE", "CLAIMED", "compute_window"]
