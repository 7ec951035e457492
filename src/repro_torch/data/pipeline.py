"""Host data pipeline: producer threads -> CMP queue -> training batches.

This is the paper's queue in its natural production habitat (DESIGN.md §2):
multiple tokenizer/packer threads enqueue ready batches; the train loop
dequeues. The protection window bounds pipeline memory at W x batch_bytes and
a stalled producer can never block the consumer (nor vice versa) — the
coordination-free property the paper proves, applied to input pipelines.

Batch *content* is a pure function of (seed, batch_id): any batch can be
regenerated, so checkpointing the consumed-id frontier gives exact resume.

With ``num_shards > 1`` the single queue becomes a :class:`ShardSet` from the
scheduler fabric (DESIGN.md §8): producers shard by ``batch_id`` hash and the
consumer is a :class:`ShardConsumer` — home shard first, stealing from the
deepest sibling when the home runs dry (a steal is just a claim, so the
window-safety and no-loss properties are inherited unchanged).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.cmp import CMPQueue
from repro_torch.sched.classes import ShardSet
from repro_torch.sched.steal import ShardConsumer


def synth_batch(seed: int, batch_id: int, batch: int, seq: int, vocab: int) -> Dict:
    """Deterministic synthetic packed token batch (zipf-ish unigram docs with
    BOS-separated documents, mimicking packed pretraining sequences)."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, batch_id]))
    # zipf-like unigram distribution over the vocab
    ranks = np.arange(1, vocab + 1)
    probs = 1.0 / ranks ** 1.1
    probs /= probs.sum()
    tokens = rng.choice(vocab, size=(batch, seq + 1), p=probs).astype(np.int32)
    # sprinkle document boundaries (token 0 as BOS)
    doc_mask = rng.random((batch, seq + 1)) < (1.0 / 512)
    tokens[doc_mask] = 0
    return {"tokens": tokens, "batch_id": batch_id}


class DataPipeline:
    """num_producers threads generating batches into a CMPQueue.

    Producer p generates ids p, p+P, p+2P, ... starting from its cursor.
    ``state()``/restore give exact-resume cursors. A ``stall_producer`` hook
    simulates a straggler host (used by tests/benchmarks to demonstrate the
    window-bounded tolerance).
    """

    def __init__(self, batch: int, seq: int, vocab: int, *, seed: int = 0,
                 num_producers: int = 2, window: int = 64,
                 start_cursors: Optional[List[int]] = None,
                 max_queue_batches: int = 32, enqueue_batch: int = 4,
                 num_shards: int = 1):
        self.batch, self.seq, self.vocab, self.seed = batch, seq, vocab, seed
        self.num_producers = num_producers
        self.enqueue_batch = max(1, int(enqueue_batch))
        self.shards = ShardSet(num_shards, window=window, reclaim_period=16,
                               min_batch=2)
        self._consumer = ShardConsumer(self.shards, home=0)
        self._cursors = list(start_cursors) if start_cursors else list(range(num_producers))
        # Exact-resume frontier: per producer, the last id up to which
        # consumption is *contiguous*. Sharded delivery (stealing) can hand
        # the consumer ids out of order; ids ahead of the frontier wait in
        # _ooo until the gap closes, so resume can skip nothing (it may
        # regenerate a few already-consumed batches — the safe direction).
        self._frontier = dict((p, c - num_producers)
                              for p, c in enumerate(self._cursors))
        self._ooo: Dict[int, set] = {p: set() for p in range(num_producers)}
        self._stop = threading.Event()
        self._stalls: Dict[int, float] = {}
        self._max_q = max_queue_batches
        # _produced/_dequeued/_stalls/_cursors/_consumed are all guarded by
        # _lock: the backpressure check must not misread torn counter state
        # under free-threaded builds.
        self._produced = 0
        self._dequeued = 0
        self._lock = threading.Lock()
        self._threads = [
            threading.Thread(target=self._produce, args=(p,), daemon=True)
            for p in range(num_producers)
        ]
        self._started = False

    # -------------------------------------------------------------- producers
    def _produce(self, pid: int) -> None:
        while not self._stop.is_set():
            with self._lock:
                stall = self._stalls.pop(pid, None)
            if stall:
                time.sleep(stall)
            # Backpressure on *unconsumed depth* (produced - consumed), NOT
            # on live_nodes(): the CMP window retains ~W already-claimed
            # nodes, which must not count against producer throttle.
            with self._lock:
                depth = self._produced - self._dequeued
            if depth > self._max_q:
                time.sleep(0.0005)
                continue
            # Batched generation + one enqueue_many splice (DESIGN.md §3):
            # the cycle-range fetch-add and tail CAS amortize over the batch.
            n = min(self.enqueue_batch, max(1, self._max_q - depth + 1))
            with self._lock:
                bids = [self._cursors[pid] + j * self.num_producers
                        for j in range(n)]
                self._cursors[pid] = bids[-1] + self.num_producers
            # Shard by batch_id hash; one enqueue_many splice per shard hit.
            by_shard: Dict[int, List[Dict]] = {}
            for bid in bids:
                by_shard.setdefault(self.shards.shard_for(bid), []).append(
                    synth_batch(self.seed, bid, self.batch, self.seq,
                                self.vocab))
            for s, items in by_shard.items():
                self.shards.queues[s].enqueue_many(items)
            with self._lock:
                self._produced += n

    def stall_producer(self, pid: int, seconds: float) -> None:
        with self._lock:
            self._stalls[pid] = seconds

    # -------------------------------------------------------------- consumer
    def start(self) -> "DataPipeline":
        if not self._started:
            for t in self._threads:
                t.start()
            self._started = True
        return self

    @property
    def queue(self) -> CMPQueue:
        """Shard 0 (the whole queue when unsharded) — kept for diagnostics
        and backward compatibility."""
        return self.shards.queues[0]

    def __iter__(self) -> Iterator[Dict]:
        self.start()
        while not self._stop.is_set():
            got = self._consumer.take(1)  # home shard first, then steal
            if not got:
                time.sleep(0.0002)
                continue
            item = got[0]
            with self._lock:
                self._dequeued += 1
                bid = item["batch_id"]
                p = bid % self.num_producers
                self._ooo[p].add(bid)
                while self._frontier[p] + self.num_producers in self._ooo[p]:
                    self._frontier[p] += self.num_producers
                    self._ooo[p].discard(self._frontier[p])
            yield item

    def next_batch(self) -> Dict:
        return next(iter(self))

    # -------------------------------------------------------------- state
    def state(self) -> Dict:
        """Exact-resume frontier: next id each producer should generate is
        the last *contiguously* consumed id + P (regenerating any dropped or
        out-of-order in-flight batches, never skipping one)."""
        with self._lock:
            return {
                "cursors": [self._frontier[p] + self.num_producers
                            for p in range(self.num_producers)],
                "seed": self.seed,
            }

    @classmethod
    def from_state(cls, state: Dict, **kw) -> "DataPipeline":
        """Resume from `state()`. The producer count is implied by the
        cursor vector; a `num_producers` kwarg is deduped against it (an
        explicit mismatch is a config error, not a silent reshard — resharding
        producers would re-map every batch_id to a different producer)."""
        num_producers = kw.pop("num_producers", None)
        if num_producers is not None and num_producers != len(state["cursors"]):
            raise ValueError(
                f"from_state got num_producers={num_producers} but the "
                f"checkpoint has {len(state['cursors'])} producer cursors")
        pipe = cls(seed=state["seed"], start_cursors=state["cursors"],
                   num_producers=len(state["cursors"]), **kw)
        # Round-trip invariant: a freshly resumed pipeline checkpoints to
        # exactly the state it was built from.
        assert pipe.state() == {"cursors": list(state["cursors"]),
                                "seed": state["seed"]}, "resume round-trip"
        return pipe

    def steal_stats(self) -> Dict:
        """Consumer-side steal telemetry (zero added atomics)."""
        c = self._consumer
        return {"steals": c.steals, "stolen_items": c.stolen_items,
                "idle_polls": c.idle_polls,
                "shard_depths": self.shards.depths()}

    def close(self) -> None:
        self._stop.set()
