"""Paged KV cache on the CMP slot pool.

Pages are the queue nodes of the paper, transplanted — the third
embodiment of the unified protection domain (:mod:`repro_torch.core.domain`):

  * a page is produced (allocated) with a monotone cycle — type-stable pool,
    never freed, only recycled;
  * a finishing/preempted request *retires* its pages (AVAILABLE->CLAIMED);
  * the engine's step counter is the cycle clock: each step unilaterally
    publishes ``deque_cycle = step``, and retired pages are reclaimed only
    when ``retire_cycle < step - W`` (``domain.reclaim_retired_mask``) — so
    any decode step launched in the last W steps can never see a recycled
    page (bounded-window UAF/ABA safety instead of refcounts).

The page tensors ``k_pages``/``v_pages`` [L, P, KV, page, hd] live on the
pool's device and are updated in place by the paged forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import slotpool as sp
from repro_torch.core.domain import (
    AVAILABLE,
    CLAIMED,
    FREE,
    compute_window,
    reclaim_retired_mask,
    safe_cycle,
)


class PagedKVPool:
    def __init__(self, cfg: ModelConfig, *, num_pages: int, page_size: int,
                 window: Optional[int] = None, dtype=None,
                 steps_per_sec: float = 100.0, resilience_s: float = 0.1,
                 device="cuda"):
        self.cfg = cfg
        self.page_size = page_size
        self.num_pages = num_pages
        self.device = torch.device(device)
        # Window sizing is the domain formula W = max(MIN_WINDOW, OPS x R)
        # with OPS = decode steps/s and R = max request-preemption latency
        # before its blocks may be recycled.
        self.window = int(window) if window is not None else compute_window(
            steps_per_sec, resilience_s)
        r = cfg.pattern_repeats
        n_attn = sum(1 for k in cfg.block_pattern if k in ("dense", "moe", "hymba"))
        self.layers = r * n_attn
        dt = dtype or getattr(torch, cfg.dtype)
        kv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        shape = (self.layers, num_pages, kv, page_size, hd)
        self.k_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.v_pages = torch.zeros(shape, dtype=dt, device=self.device)
        self.pool = sp.make(num_pages, self.device)
        # Optional tenant quota ledger (duck-typed: charge/credit, see
        # repro_torch.sched.tenants.TenantQuotaLedger). When attached,
        # alloc_for/retire_for meter per-tenant page occupancy against it;
        # the plain alloc/retire paths are untouched.
        self.ledger = None

    def attach_ledger(self, ledger, host: int = 0) -> None:
        """Attach a per-tenant page-quota ledger (any object with
        ``charge(tenant, host, pages) -> bool`` /
        ``credit(tenant, host, pages)``)."""
        self.ledger = ledger
        self._ledger_host = int(host)

    # ------------------------------------------------------------------
    def tick(self, step: int) -> None:
        """Unilateral monotone boundary publish + window reclamation."""
        self.pool = sp.advance(self.pool, step)
        self.pool, _ = sp.reclaim_retired(self.pool, self.window)

    def alloc(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Allocate n pages (FREE -> AVAILABLE/live). Returns (ids, valid)."""
        self.pool, ids, valid = sp.produce_with_reclaim(self.pool, n, self.window)
        return ids, valid

    def retire(self, ids: torch.Tensor) -> None:
        """Request done/preempted: pages become reclamation candidates after
        the window elapses. Never blocks; never coordinates."""
        ids = torch.as_tensor(ids, dtype=torch.int32, device=self.device)
        self.pool = sp.claim_ids(self.pool, ids, ids < self.num_pages)

    # ---------------------------------------------------- tenant metering
    def alloc_for(self, tenant, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tenant-metered ``alloc``: charge the attached ledger before
        touching the pool. Denials return (empty, empty). Without a ledger
        this is exactly ``alloc``."""
        if self.ledger is not None and n > 0:
            if not self.ledger.charge(tenant, self._ledger_host, n):
                empty = torch.zeros((0,), dtype=torch.int32, device=self.device)
                return empty, empty
        ids, valid = self.alloc(n)
        if self.ledger is not None and n > 0:
            granted = int(valid.sum())
            if granted < n:  # pool dry: give back the unfilled estimate
                self.ledger.credit(tenant, self._ledger_host, n - granted)
        return ids, valid

    def retire_for(self, tenant, ids: torch.Tensor) -> None:
        """Tenant-metered ``retire``: credit the ledger for every page
        actually returned. Without a ledger this is exactly ``retire``."""
        ids = torch.as_tensor(ids, dtype=torch.int32, device=self.device)
        pages = int((ids < self.num_pages).sum())
        self.retire(ids)
        if self.ledger is not None and pages > 0:
            self.ledger.credit(tenant, self._ledger_host, pages)

    # ------------------------------------------------------------------
    def free_pages(self) -> int:
        return int((self.pool.state == FREE).sum())

    def live_pages(self) -> int:
        return int(((self.pool.state == AVAILABLE)
                    | (self.pool.state == CLAIMED)).sum())

    def reclaimable_pages(self) -> int:
        """Pages whose retire cycle fell behind the window — exactly the
        domain predicate the next ``tick`` will recycle."""
        return int(reclaim_retired_mask(
            self.pool.state, self.pool.retire_cycle,
            self.pool.deque_cycle, self.window).sum())

    def protection_boundary(self) -> int:
        """Current safe cycle max(0, deque_cycle - W) (diagnostics)."""
        return int(safe_cycle(int(self.pool.deque_cycle), self.window))
