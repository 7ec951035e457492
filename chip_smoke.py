"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero, and no result line is printed):

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels under ``src/repro_torch/kernels/csrc`` are
   compiled with ``nvcc`` into ``build/`` (seconds printed);
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's full-width shapes (Yi-6B heads) and, for the claim
   kernel, at pool sizes up to 2**20 slots, with times of the kernel, the
   plain version and, where there is one, a PyTorch library call;
4. small-input reference: the port's ``Engine`` on the Yi-6B smoke config in
   float32, on the card (kernels) and on the CPU (plain versions), must give
   token-identical outputs;
5. main path: Yi-6B at full width and depth in bfloat16, random weights from
   ``--seed``, 16 requests through ``Engine(device_admission=True)`` with
   ``submit_many`` and ``run_until_idle``; the launch counts of the three
   serving kernels are read from this run alone;
6. device CMP queue: a seeded FIFO churn through ``repro_torch.core.slotpool``
   (produce, claim, advance, reclaim) on a 65,536-slot pool, the page pool
   of a card that holds Yi-6B, on the card and on the CPU, compared every
   round; strict FIFO and the pool invariants are checked, and the claim
   kernel's launch count is read from this run alone; then the claims/s of
   ``slotpool.claim`` on the card and a profile of 50 claims.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the ``kernels`` JSON line, and the card's name and power limit come earlier.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense
TOL_BF16 = 2e-2                # atol = rtol: f32 sums in another order + bf16 rounding


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = max_err(got, want)
    if not torch.allclose(got.float(), want.float(), atol=TOL_BF16, rtol=TOL_BF16):
        raise AssertionError(f"{name}: kernel disagrees with its plain version "
                             f"(max abs err {err})")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_ring(ring, rng) -> dict:
    n, k, window = 128, 64, 32  # the engine's ring at max_batch 8
    dev = "cuda"
    state = torch.zeros(n, dtype=torch.int32, device=dev)
    cycle = torch.zeros(n, dtype=torch.int32, device=dev)
    meta = torch.zeros(2, dtype=torch.int32, device=dev)
    steps, claimed_total = 240, 0
    for step in range(steps):
        req = (int(rng.integers(0, n // 2 + 1)), int(rng.integers(0, k + 1)))
        got = ring.cmp_ring_step(state, cycle, meta, req, k=k, window=window)
        want = ring.plain(state, cycle, meta, req, k=k, window=window)
        for nm, g, w in zip(("state", "cycle", "meta", "claimed"), got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"cmp_ring step {step}: {nm} differs")
        claimed_total += int((got[3] >= 0).sum())
        state, cycle, meta = got[0], got[1], got[2]
    if claimed_total == 0:
        raise AssertionError("cmp_ring trajectory never claimed")
    req = (n // 4, k)
    ms = cuda_ms(lambda: ring.cmp_ring_step(state, cycle, meta, req, k=k,
                                            window=window), 200)
    plain_ms = cuda_ms(lambda: ring.plain(state, cycle, meta, req, k=k,
                                          window=window), 50)
    moved = 4 * (4 * n + 2 + 2 + k)  # state, cycle in+out; meta in+out; claimed
    b_ms, b_by = bound(moved, 0)
    log(f"[kernels] cmp_ring N={n} k={k}: bit-exact over {steps} steps "
        f"({claimed_total} claims); kernel_ms={ms:.5f} plain_ms={plain_ms:.5f}")
    return dict(name="cmp_ring", source="src/repro_torch/kernels/csrc/cmp_ring.cu",
                replaces="src/repro/kernels/cmp_ring.py:111", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def _claim_cycles(rng, n: int) -> dict:
    """The cycle patterns the claim kernel is held on: unique, all tied, and
    repeated negative and positive values with some INT32_MAX among them."""
    mixed = rng.integers(-1000, 1000, size=n)
    mixed[rng.random(n) < 0.05] = np.iinfo(np.int32).max
    return {"permuted": rng.permutation(n), "tied": np.full(n, 7), "mixed": mixed}


def check_claim(claim, rng) -> dict:
    """The claim kernel against its plain version, bit-exact (``torch.equal``
    on new_state and ids), over pool sizes, k (k > N included), tiles and
    cycle patterns; a tile above what one CTA holds must be refused. Times
    at N = 2,048 (one tile), 4,096 and 65,536, k = 64."""
    from repro_torch.kernels import _build

    dev, imax = "cuda", np.iinfo(np.int32).max
    max_block = _build.lib().rt_cmp_claim_max_block()
    cases = refused = 0
    for n in (1, 7, 2047, 2048, 2049, 4096, 65536, 1 << 20):
        state = torch.from_numpy(rng.choice([0, 1, 2], size=n).astype(np.int32)).to(dev)
        ks = (1, 64, n + 3) if n <= 2049 else (1, 64)
        for cname, cyc in _claim_cycles(rng, n).items():
            cycle = torch.from_numpy(cyc.astype(np.int32)).to(dev)
            for k in ks:
                want = claim.plain(state, cycle, k=k)
                for bn in (None, 128, n):
                    if min(n, bn or claim.DEFAULT_BLOCK) > max_block:
                        try:
                            claim.cmp_claim(state, cycle, k=k, block_n=bn)
                        except ValueError:
                            refused += 1
                            continue
                        raise AssertionError(f"cmp_claim took block_n={bn} > {max_block}")
                    got = claim.cmp_claim(state, cycle, k=k, block_n=bn)
                    for nm, g, w in zip(("new_state", "ids"), got, want):
                        if not torch.equal(g, w):
                            raise AssertionError(f"cmp_claim N={n} k={k} block_n={bn} "
                                                 f"cycles {cname}: {nm} differs")
                    cases += 1
    log(f"[kernels] cmp_claim: bit-exact on {cases} (N, k, block_n, cycles) cases, "
        f"N from 1 to {1 << 20}; {refused} tiles above {max_block} refused")
    k, timed = 64, {}
    # the largest single tile; the JAX dev bench's pool; the full-card page pool
    for n in (2048, 4096, 65536):
        state = torch.from_numpy(rng.choice([0, 1, 2], size=n).astype(np.int32)).to(dev)
        cycle = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        key = torch.where(state == 1, cycle, imax)
        ms = cuda_ms(lambda: claim.cmp_claim(state, cycle, k=k), 200)
        plain_ms = cuda_ms(lambda: claim.plain(state, cycle, k=k), 50)
        lib_ms = cuda_ms(lambda: torch.topk(key, k, largest=False), 200)
        b_ms, b_by = bound(4 * (3 * n + k), 0)  # state, cycle in; new_state, ids out
        path = "tiled, default block" if n > claim.DEFAULT_BLOCK else "one tile"
        log(f"[kernels] cmp_claim N={n} k={k} ({path}): kernel_ms={ms:.5f} "
            f"plain_ms={plain_ms:.5f} topk_ms={lib_ms:.5f} (selection only, tie order "
            f"unspecified) bound_ms={b_ms:.7f} ({b_by})")
        timed[n] = (ms, plain_ms, lib_ms, b_ms, b_by)
    ms, plain_ms, lib_ms, b_ms, b_by = timed[65536]
    return dict(name="cmp_claim", source="src/repro_torch/kernels/csrc/cmp_claim.cu",
                replaces="src/repro/kernels/cmp_claim.py:95,137", max_abs_err=0.0,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def _sdpa_heads(q, k, v, H, KV):
    """Permute query heads so that SDPA's grouped GQA (query head h reads
    KV head h // (H/KV)) computes the port's r-major mapping (h % KV)."""
    rep = H // KV
    perm = torch.arange(H, device=q.device).view(rep, KV).t().reshape(-1)
    return q[:, perm], k, v


def check_paged(pa, gen) -> dict:
    B, H, KV, hd, page, pps = 8, 32, 4, 128, 16, 64
    P = B * pps + 1
    dev, dt = "cuda", torch.bfloat16
    q = torch.randn(B, H, hd, generator=gen, device=dev).to(dt)
    kp = torch.randn(P, KV, page, hd, generator=gen, device=dev).to(dt)
    vp = torch.randn(P, KV, page, hd, generator=gen, device=dev).to(dt)
    bt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * pps] + 1)
    bt = bt.view(B, pps).to(torch.int32).contiguous()
    sl = torch.tensor([0, 1, 17, 300, 511, 777, 1000, 1024], dtype=torch.int32,
                      device=dev)
    err = check_close("paged_attention", pa.paged_attention(q, kp, vp, bt, sl),
                      pa.plain(q, kp, vp, bt, sl))
    # time at the decode shape of a full batch near max_seq
    sl_t = torch.full((B,), 1024, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: pa.paged_attention(q, kp, vp, bt, sl_t), 200)
    plain_ms = cuda_ms(lambda: pa.plain(q, kp, vp, bt, sl_t), 20)
    # library yardstick: SDPA over the same K/V already gathered to dense
    # (the gather is not timed)
    T = pps * page
    kd = kp[bt.long()].movedim(2, 1).reshape(B, KV, T, hd)
    vd = vp[bt.long()].movedim(2, 1).reshape(B, KV, T, hd)
    qs, kd, vd = _sdpa_heads(q[:, :, None], kd, vd, H, KV)
    mask = (torch.arange(T, device=dev)[None, :] < sl_t[:, None])[:, None, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(lambda: sdpa(qs, kd, vd, attn_mask=mask, enable_gqa=True), 200)
    toks = int(sl_t.sum())
    moved = 2 * (2 * B * H * hd + 2 * toks * KV * hd) + 4 * (B * pps + B)
    b_ms, b_by = bound(moved, 4 * toks * H * hd)
    log(f"[kernels] paged_attention B={B} H={H} KV={KV} hd={hd} page={page} "
        f"pps={pps} bf16: max_abs_err={err:.3e} (atol=rtol={TOL_BF16}); at seq_len 1024: "
        f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} sdpa_ms={lib_ms:.5f} "
        f"bound_ms={b_ms:.5f} ({b_by})")
    return dict(name="paged_attention",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:102", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def check_flash(fa, gen) -> dict:
    B, H, KV, hd = 1, 32, 4, 128
    dev, dt = "cuda", torch.bfloat16
    errs = []
    cases = [(512, True, 0), (300, True, 0), (512, True, 128), (300, False, 0)]
    inputs = {}
    for S, causal, window in cases:
        q = torch.randn(B, H, S, hd, generator=gen, device=dev).to(dt)
        k = torch.randn(B, KV, S, hd, generator=gen, device=dev).to(dt)
        v = torch.randn(B, KV, S, hd, generator=gen, device=dev).to(dt)
        inputs[(S, causal, window)] = (q, k, v)
        err = check_close(f"flash_attention S={S} causal={causal} window={window}",
                          fa.flash_attention(q, k, v, causal=causal,
                                             sliding_window=window),
                          fa.plain(q, k, v, causal=causal, sliding_window=window))
        errs.append(err)
        log(f"[kernels] flash_attention B={B} H={H} KV={KV} hd={hd} S=T={S} "
            f"causal={causal} window={window} bf16: max_abs_err={err:.3e} "
            f"(atol=rtol={TOL_BF16})")
    S = 512
    q, k, v = inputs[(S, True, 0)]
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 100)
    plain_ms = cuda_ms(lambda: fa.plain(q, k, v, causal=True), 20)
    qs, ks, vs = _sdpa_heads(q, k, v, H, KV)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=True), 100)
    pairs = S * (S + 1) // 2
    moved = 2 * (2 * B * H * S * hd + 2 * B * KV * S * hd)
    b_ms, b_by = bound(moved, 4 * B * H * pairs * hd)
    log(f"[kernels] flash_attention causal S=T={S}: kernel_ms={ms:.5f} "
        f"plain_ms={plain_ms:.5f} sdpa_ms={lib_ms:.5f} bound_ms={b_ms:.5f} ({b_by})")
    return dict(name="flash_attention",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:112",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


# ---------------------------------------------------------------------------
# phases 4-5: the serving path
# ---------------------------------------------------------------------------


class TimedForward:
    """``paged_forward`` as the engine's forward callable, with CUDA events
    around each call (decode = one token per lane, prefill = a prompt) and
    a running on-device finiteness check of the logits."""

    def __init__(self, cfg, paged_forward):
        self.cfg, self.fwd = cfg, paged_forward
        self.events = {"decode": [], "prefill": []}
        self.finite = torch.ones((), dtype=torch.bool, device="cuda")

    def __call__(self, p, t, kp, vp, bt, sl):
        kind = "decode" if t.shape[1] == 1 else "prefill"
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fwd(p, t, self.cfg, kp, vp, bt, sl)
        end.record()
        self.events[kind].append((start, end))
        self.finite &= torch.isfinite(out[0]).all()
        return out

    def ms(self, kind: str) -> list:
        return [s.elapsed_time(e) for s, e in self.events[kind]]


def small_reference(seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine

    cfg = get_config("yi_6b", smoke=True)
    params_cpu = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    params_gpu = _to_device(params_cpu, "cuda")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(2, 40, size=6)]
    outs = {}
    for device, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        eng = Engine(cfg, params, max_batch=3, page_size=8, num_pages=40, window=2,
                     max_seq=64, device_admission=True, device=device)
        uids = eng.submit_many(prompts, max_new_tokens=8)
        done = eng.run_until_idle()
        outs[device] = [done[u].output for u in uids]
    if outs["cpu"] != outs["cuda"]:
        raise AssertionError(f"small-input engine: card {outs['cuda']} != "
                             f"CPU plain path {outs['cpu']}")
    log(f"[reference] yi-6b smoke f32 engine, 6 requests x 8 tokens: card "
        f"(kernels) token-identical to CPU (plain versions)")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def main_path(seed: int, kernels: dict) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.paged_model import paged_forward

    cfg = get_config("yi_6b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"H={cfg.num_heads} KV={cfg.num_kv_heads} hd={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}; "
        f"{param_count(params) / 1e9:.3f}B params made in "
        f"{time.perf_counter() - t0:.1f}s")
    fwd = TimedForward(cfg, paged_forward)
    eng = Engine(cfg, params, max_batch=8, page_size=16, num_pages=577, window=4,
                 max_seq=1024, device_admission=True, forward_fn=fwd)
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 513, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    new_tokens = 32
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in kernels.values():
        mod.launches = 0
    t0 = time.perf_counter()
    uids = eng.submit_many(prompts, max_new_tokens=new_tokens)
    done = eng.run_until_idle(max_steps=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in kernels.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if None in uids or any(u not in done for u in uids):
        raise AssertionError("a request was not admitted or not completed")
    for u in uids:
        out = done[u].output
        if len(out) != new_tokens or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"request {u}: bad output {out}")
    if not bool(fwd.finite):
        raise AssertionError("non-finite logits on the main path")
    decode_ms, prefill_ms = fwd.ms("decode"), fwd.ms("prefill")
    n_dec, n_pre = len(decode_ms), len(prefill_ms)
    if launches["paged_attention"] != n_dec * cfg.num_layers:
        raise AssertionError(f"paged launches {launches['paged_attention']} != "
                             f"{n_dec} decode steps x {cfg.num_layers}")
    if launches["flash_attention"] != n_pre * cfg.num_layers:
        raise AssertionError(f"flash launches {launches['flash_attention']} != "
                             f"{n_pre} prefills x {cfg.num_layers}")
    if launches["cmp_ring"] < 1 or eng._dev_admit.stats["kernel_calls"] < 1:
        raise AssertionError("the admission ring kernel never ran")
    gen_tokens = sum(len(done[u].output) for u in uids)
    log(f"[serve] 16 requests (prompts {int(lens.min())}-{int(lens.max())} tokens, "
        f"{int(lens.sum())} total) x {new_tokens} new tokens: all completed, "
        f"{sum(done[u].preemptions for u in uids)} preemptions")
    log(f"[serve] wall {wall:.3f}s, {gen_tokens / wall:.2f} generated tokens/s, "
        f"{(int(lens.sum()) + gen_tokens) / wall:.2f} prompt+generated tokens/s")
    log(f"[serve] {n_dec} decode steps, mean {sum(decode_ms) / n_dec:.3f} ms device "
        f"time each (min {min(decode_ms):.3f}, max {max(decode_ms):.3f}); "
        f"{n_pre} prefills, mean {sum(prefill_ms) / n_pre:.3f} ms; "
        f"{eng.step_count} engine steps; ring calls "
        f"{eng._dev_admit.stats['kernel_calls']}")
    log(f"[serve] peak device memory {peak_gb:.3f} GB; launches {launches}")
    profile_decode(eng, cfg, rng)
    return launches


# ---------------------------------------------------------------------------
# phase 6: the device CMP queue
# ---------------------------------------------------------------------------


def device_queue(seed: int, kernels: dict) -> dict:
    """FIFO churn on a 65,536-slot pool, card against CPU every round; then
    the rate of ``slotpool.claim`` on the card."""
    from repro_torch.core import slotpool
    from repro_torch.kernels import cmp_claim

    n, window, rounds = 65536, 128, 500
    rng = np.random.default_rng(seed)
    pools = {"cuda": slotpool.make(n, "cuda"), "cpu": slotpool.make(n, "cpu")}
    for dev in pools:  # a backlog of half the pool
        pools[dev], _, _ = slotpool.produce(pools[dev], n // 2)
    torch.cuda.synchronize()
    for mod in kernels.values():
        mod.launches = 0
    claimed = []
    for r in range(rounds):
        kp, kc, delta = (int(x) for x in rng.integers(1, 65, size=3))
        outs = {}
        for dev, pool in pools.items():
            pool, pids, pvalid = slotpool.produce(pool, kp)
            cycle = pool.cycle
            pool, ids, valid = slotpool.claim(pool, kc)
            pool = slotpool.advance(pool, torch.minimum(pool.deque_cycle + delta,
                                                        pool.enq_cycle))
            pool, nrec = slotpool.reclaim(pool, window)
            pools[dev] = pool
            outs[dev] = (cycle, pids, pvalid, ids, valid, nrec, *pool)
        for i, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"device queue round {r}: output {i} differs "
                                     f"between card and CPU")
        cycle, ids, valid = (outs["cpu"][i] for i in (0, 3, 4))
        claimed += cycle[ids[valid].long()].tolist()
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in kernels.items()}
    # N > the default tile, so every claim is tiled: two launches each
    if launches["cmp_claim"] != 2 * rounds:
        raise AssertionError(f"cmp_claim launches {launches['cmp_claim']} != 2 x "
                             f"{rounds} tiled claims")
    if len(claimed) < rounds or any(b <= a for a, b in zip(claimed, claimed[1:])):
        raise AssertionError("claimed cycles are not strictly ascending (FIFO)")
    pool = pools["cuda"]
    slotpool.check_invariants(pool, window)
    log(f"[queue] N={n} window={window}: {rounds} rounds of produce/claim/advance/"
        f"reclaim (k in [1, 64]), card == CPU every round; {len(claimed)} claims in "
        f"strictly ascending cycle order; invariants hold; {slotpool.counts(pool)}")
    calls, k = 200, 64
    got = torch.zeros((), dtype=torch.int64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        pool, ids, valid = slotpool.claim(pool, k)
        got += valid.sum()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_claims = int(got)
    if n_claims != calls * k:
        raise AssertionError(f"{n_claims} of {calls * k} claims were valid")
    kernel_ms = cuda_ms(lambda: cmp_claim.cmp_claim(pool.state, pool.cycle, k=k), 200)
    log(f"[queue] slotpool.claim k={k} on the card: {n_claims / wall:.1f} claims/s "
        f"({wall / calls * 1e3:.5f} ms a call, host clock); cmp_claim kernel "
        f"{kernel_ms:.5f} ms a call (CUDA events); launches {launches}")
    held = [pool]

    def one_claim():
        held[0], _, _ = slotpool.claim(held[0], k)

    profile_steps(one_claim, 50, f"50 slotpool.claim calls (k={k}, N={n})")
    return launches


def _self_device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def profile_steps(step, steps: int, what: str) -> None:
    """Run ``step`` ``steps`` times under ``torch.profiler``; print the
    device's busy share of the window and the largest device kernels and
    host ops, per step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    # kernels only: an op's own entry repeats the device time of its kernels
    dev = sorted((e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
                  and _self_device_us(e) > 0), key=_self_device_us, reverse=True)
    busy_ms = sum(_self_device_us(e) for e in dev) / 1e3
    log(f"[profile] {what} under the profiler: wall {wall_ms / steps:.3f} ms/step, "
        f"device busy {busy_ms / steps:.4f} ms/step, busy share {busy_ms / wall_ms:.4f}")
    for e in dev[:8]:
        log(f"[profile] device {_self_device_us(e) / 1e3 / steps:9.4f} ms/step "
            f"x{e.count // steps:5d}  {e.key[:90]}")
    host = sorted((e for e in avgs if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host[:8]:
        log(f"[profile] host   {e.self_cpu_time_total / 1e3 / steps:9.4f} ms/step "
            f"x{e.count // steps:5d}  {e.key[:90]}")


def profile_decode(eng, cfg, rng, steps: int = 4) -> None:
    """Where a decode step's time goes: a full batch of 8 lanes (64-token
    prompts) decodes ``steps`` steps under ``torch.profiler``. Runs after
    the launch counts were read."""
    prompts = [rng.integers(0, cfg.vocab_size, size=64).tolist()
               for _ in range(eng.max_batch)]
    eng.submit_many(prompts, max_new_tokens=steps + 2)
    eng.step()  # admit (prefill) every lane, decode once
    profile_steps(eng.step, steps, f"{steps} decode steps x {eng.max_batch} lanes")
    eng.run_until_idle()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import cmp_claim, cmp_ring, flash_attention, paged_attention

    # phase 1: card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f"[build] {lib_path.relative_to(_build.ROOT)} ready in "
        f"{time.perf_counter() - t0:.2f}s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # phase 3: kernels against their plain versions
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = [check_ring(cmp_ring, rng), check_paged(paged_attention, gen),
            check_flash(flash_attention, gen), check_claim(cmp_claim, rng)]

    # phase 4: small-input reference
    small_reference(args.seed)

    # phase 5: the main path
    kernels = {"cmp_ring": cmp_ring, "paged_attention": paged_attention,
               "flash_attention": flash_attention, "cmp_claim": cmp_claim}
    launches = main_path(args.seed, kernels)

    # phase 6: the device CMP queue
    launches["cmp_claim"] = device_queue(args.seed, kernels)["cmp_claim"]
    for row in rows:
        row["route"] = "cuda"
        row["launches"] = launches[row["name"]]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
