"""The one traffic generator: reads a mix file (``traffic/<mix>.json``) and
gives the cell its requests from ``--seed``.

A closed loop (``"loop": "closed"``): ``clients`` callers, each sending its
next request as soon as its last one completes, no think time. Requests
are handed out in one global order, the next to whichever client frees.

Lengths: every seed gets the same lengths in another order. The stream is
cut into blocks of ``block`` requests; each block holds the ``block``
quantile-stratified prompt lengths of the mix's distribution and, paired
at random, its ``block`` stratified output lengths, shuffled by the seed.
Any prefix of the stream therefore holds nearly the same lengths whatever
the seed. Prompt token ids are uniform over the vocabulary, drawn from
(seed, request index).

Distributions: ``{"dist": "loguniform" | "uniform", "min": a, "max": b}``
(integers, both ends included).

The first ``clients`` requests start the loop: they stand for callers
caught part way through a reply, as in a loop that has run for a while. A
lane of such a loop holds a request with a chance in proportion to its
output length, so their drawn lengths are the distribution's weighted by
length (stratified over the clients as above), and each asks for a share
of its drawn length, the shares stratified over the clients ((j + 0.5) /
clients, j in a seeded order). The loop then starts near its steady state
instead of finishing its short first requests together.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


def _stratified(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of the distribution."""
    lo, hi = int(spec["min"]), int(spec["max"])
    u = (np.arange(n) + 0.5) / n
    if spec["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
        return np.clip(np.floor(x), lo, hi).astype(np.int64)
    if spec["dist"] == "uniform":
        return (lo + np.floor(u * (hi - lo + 1))).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def _length_weighted(spec: dict, n: int) -> np.ndarray:
    """``n`` stratified lengths of the distribution weighted by length:
    the (i + 0.5) / n quantiles of 4,096 stratified lengths, each counted
    in proportion to itself."""
    x = _stratified(spec, 4096)
    cdf = np.cumsum(x) / x.sum()
    u = (np.arange(n) + 0.5) / n
    return x[np.minimum(np.searchsorted(cdf, u), len(x) - 1)]


def _seq(seed: int) -> int:
    return int(seed) % (2 ** 64)


class ClosedLoop:
    def __init__(self, mix: dict, vocab_size: int, seed: int):
        if mix["loop"] != "closed":
            raise ValueError(f"loop {mix['loop']!r}: this generator runs closed loops")
        self.mix, self.vocab, self.seed = mix, int(vocab_size), _seq(seed)
        self.clients = int(mix["clients"])
        self.block = int(mix["block"])
        self._prompts = _stratified(mix["prompt"], self.block)
        self._outputs = _stratified(mix["output"], self.block)
        self._blocks: dict = {}
        rng = np.random.default_rng([self.seed, 2])
        self._shares = rng.permutation(self.clients)
        self._first = rng.permutation(_length_weighted(mix["output"], self.clients))

    def _shape_block(self, b: int) -> Tuple[np.ndarray, np.ndarray]:
        if b not in self._blocks:
            rng = np.random.default_rng([self.seed, 1, b])
            self._blocks[b] = (rng.permutation(self._prompts),
                               rng.permutation(self._outputs))
        return self._blocks[b]

    def shape(self, i: int) -> Tuple[int, int]:
        """(prompt length, output length) of request ``i``."""
        p, o = self._shape_block(i // self.block)
        n_out = int(o[i % self.block])
        if i < self.clients:
            n_out = 1 + int((self._shares[i] + 0.5) / self.clients * int(self._first[i]))
        return int(p[i % self.block]), n_out

    def request(self, i: int) -> Tuple[List[int], int]:
        """(prompt token ids, output tokens to generate) of request ``i``."""
        n_prompt, n_out = self.shape(i)
        ids = np.random.default_rng([self.seed, 3, i]).integers(0, self.vocab, n_prompt)
        return ids.tolist(), n_out
