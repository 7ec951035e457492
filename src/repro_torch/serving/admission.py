"""Device-resident admission for the serving engine.

:class:`DeviceAdmissionRing` wraps the fused CMP ring kernel
(:mod:`repro_torch.kernels.cmp_ring`) for the engine's admission path: the
policy-drained batch is pushed into a bounded ring on the card and claim
lanes are filled in one fused kernel call — ring reclaim, batched enqueue,
the k-way earliest-cycle claim and the frontier publish — with one
device->host read per call (new meta and the claimed cycles together).

Claims amortize across engine steps via *claim look-ahead*: one call claims
up to ``claim_block >= k`` lanes into a host-side FIFO buffer that later
steps serve without touching the device. Ring claims are earliest-cycle
first, so look-ahead changes *when* claims commit, never their order.

The payload handle is the ring cycle number: the host keeps the
authoritative FIFO mirror of entries, and :meth:`flush` returns every
ring-resident entry (claim-buffered first, then unclaimed, both in cycle
order) so callers can requeue them at their original class seats.

``device_admission=True`` forces the ring path (its tensors on the engine's
device: the kernel on the card, its plain version on the CPU); ``"auto"``
enables it when a CUDA device is present; ``False`` keeps the host path.
"""

from __future__ import annotations

from typing import Any, List, Tuple

import torch

from repro_torch.kernels import ops as kernel_ops


def resolve_device_admission(flag) -> bool:
    """Map a config flag (False | True | "auto") to an enable decision."""
    if flag == "auto":
        return torch.cuda.is_available()
    return bool(flag)


class DeviceAdmissionRing:
    """Bounded CMP ring on the device feeding engine admission.

    Args:
      k: claim lanes the caller consumes per step (the engine's max_batch).
      claim_block: lanes claimed per fused call; >= k enables claim
        look-ahead. Defaults to ``2*k``.
      capacity: ring slots. Defaults to ``max(64, 2*claim_block)``.
      window: protection window W for ring-slot recycling (paper Alg 4);
        defaults to capacity // 4.
      device: where the ring's state lives (the kernel runs there).
    """

    def __init__(self, *, k: int, claim_block: int = 0, capacity: int = 0,
                 window: int = 0, device="cuda"):
        self.k = int(k)
        self.claim_block = int(claim_block) if claim_block else 2 * self.k
        assert self.claim_block >= self.k
        self.capacity = int(capacity) if capacity else max(
            64, 2 * self.claim_block)
        self.window = int(window) if window else self.capacity // 4
        dev = torch.device(device)
        self.state = torch.zeros((self.capacity,), dtype=torch.int32, device=dev)
        self.cycle = torch.zeros((self.capacity,), dtype=torch.int32, device=dev)
        # [enq_cycle, deque_cycle]
        self.meta = torch.zeros((2,), dtype=torch.int32, device=dev)
        self._enq = 0  # host mirror of meta[0]
        # Host mirror of the ring's unclaimed slots, FIFO by ring cycle —
        # claims always take the earliest cycles, so claimed entries leave
        # from the front.
        self._mirror: List[Any] = []
        self._claimed: List[Any] = []  # look-ahead buffer, cycle order
        self._served = 0  # consumed front of _claimed
        self.stats = {"steps": 0, "kernel_calls": 0, "pushed": 0,
                      "claimed": 0, "rejected": 0}

    # flight-recorder attachment (kernel calls and flushes are recorded
    # when a recorder is attached here)
    _obs = None

    @property
    def pending(self) -> int:
        """Entries resident in the admission path: unclaimed ring slots plus
        the claim look-ahead buffer (pushed, not yet handed to a lane)."""
        return len(self._mirror) + len(self._claimed) - self._served

    @property
    def buffered(self) -> int:
        """Claimed-ahead entries servable without a device call."""
        return len(self._claimed) - self._served

    @property
    def room(self) -> int:
        """How many pushes are guaranteed accepted next call (half the ring
        stays headroom for the claimed-but-windowed slots)."""
        return max(0, self.capacity // 2 - len(self._mirror))

    def step(self, entries: List[Any], want: int
             ) -> Tuple[List[Any], List[Any]]:
        """One engine admission step: push ``entries`` and take up to
        ``want`` claimed lanes. Serves from the look-ahead buffer when it
        can; otherwise ONE fused kernel call pushes the entries and claims
        the next ``claim_block`` earliest cycles. Returns ``(claimed,
        rejected)`` — claimed entries in exact ring-cycle (FIFO) order,
        rejected entries (ring full) for the caller to requeue."""
        self.stats["steps"] += 1
        rejected: List[Any] = []
        if entries or (self.buffered < want and self._mirror):
            self._claimed = self._claimed[self._served:]  # drop served front
            self._served = 0
            self.state, self.cycle, self.meta, claimed = kernel_ops.ring_step(
                self.state, self.cycle, self.meta,
                (len(entries), self.claim_block),
                k=self.claim_block, window=self.window)
            # single device->host read per call: new meta + claimed cycles
            host = torch.cat([self.meta, claimed]).tolist()
            accepted = host[0] - self._enq
            self._enq = host[0]
            if accepted:
                self._mirror.extend(entries[:accepted])
            # the kernel claims the n earliest cycles = the mirror's first n
            n_claimed = sum(1 for c in host[2:] if c >= 0)
            self._claimed.extend(self._mirror[:n_claimed])
            del self._mirror[:n_claimed]
            self.stats["kernel_calls"] += 1
            self.stats["pushed"] += accepted
            self.stats["rejected"] += len(entries) - accepted
            rejected = list(entries[accepted:])
            if self._obs is not None:
                self._obs.emit("claim_block", "_ring", self._enq,
                               arg={"pushed": accepted,
                                    "claimed": n_claimed})
        lo = self._served
        hi = min(lo + want, len(self._claimed))
        out = self._claimed[lo:hi]
        self._served = hi
        self.stats["claimed"] += len(out)
        return out, rejected

    def flush(self) -> List[Any]:
        """Return every ring-resident entry in exact cycle order — the claim
        look-ahead buffer first, then the unclaimed mirror — and reset the
        slot states in place (cycle counters stay monotone). Callers requeue
        the returned entries at their original class seats."""
        out = self._claimed[self._served:]
        out.extend(self._mirror)
        self._claimed = []
        self._served = 0
        self._mirror = []
        self.state.zero_()
        self.meta.fill_(self._enq)
        if self._obs is not None:
            self._obs.emit("flush", "_ring", self._enq, arg=len(out))
        return out
