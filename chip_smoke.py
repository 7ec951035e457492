"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero, and no result line is printed):

1. card: ``nvidia-smi`` name and power limit, ``torch.cuda.get_device_name``;
2. build: the CUDA kernels under ``src/repro_torch/kernels/csrc`` are
   compiled with ``nvcc`` into ``build/`` (seconds printed);
3. kernels: each kernel against its plain PyTorch version on the card at
   the serving path's full-width shapes (the attention kernels at the heads
   of every attention config: Yi-6B's, granite-moe's, glm4-9b's, phi3's,
   command-r's, llama4's, llava's and musicgen's; the paged kernel at page
   sizes 8-256, on its scalar path (bf16 head_dim 8 and 72, 32 query heads
   a KV head), over a chunked prefill's B*S rows; both kernels with a
   softcap of 30), the admission ring at the engine's rings of max_batch 8,
   256, 1,024, 2,048 and 4,096 (N = 128 to 65,536; above 16,384 its grid
   path) and on states that break its enqueue invariant, and the claim
   kernel and its fused slot-pool entry at pool sizes up to 2**20 slots,
   with times of the kernel, the plain version and, where there is one, a
   PyTorch library call: each kernel and library call timed as device time
   from a CUDA graph of back-to-back calls, and as the eager loop of
   earlier runs; beside the ring, its general path and a launch floor;
   then the xLSTM time loops (the reference's two ``lax.scan`` sites):
   the mLSTM and sLSTM forward kernels (with the tensors they save) and
   backward kernels against ``ref.py``'s plain forward and backward at
   xlstm-125m's width (4 heads of 192) and phase 9's train shape (B=2 x
   512), in bf16 and float32, and the decode step from the 512-step state;
   each timed by graph in bf16 beside its plain version, its bound and its
   chain floor (S x its step latency, the kernel's own and not a floor of
   the card; the mLSTM kernels' steps are chunks of 32, their "step" a
   token's share of one), each backward's two launches also timed apart
   (the graph replayed under ``torch.profiler``); then SSD's chunk loop (the third
   ``lax.scan`` site) and decode step: the forward kernel (with the states
   it saves) and backward kernels against ``ref.py``'s plain forward and
   backward at hymba-1.5b's width (25 heads, P = 64, N = 16, chunks of
   256) at B=2 x S=512 (phase 9's train shape), B=4 x S=1,024 (its
   prefill) and B=2 x S=300 (a padded last chunk, a carried state), in
   bf16 and float32, and the decode kernel from the prefill's state; each
   timed by graph in bf16 beside its plain version and its bound, the chunk
   kernels' calls also by launch, with each SSD kernel's registers and
   spills from ``ptxas -v``; then
   ``chunked_cache_attention``'s KV-block scan (the fourth ``lax.scan``
   site): its kernel against the plain loop at llava-next's prefill (B=2,
   2,880 patch embeddings + 64 tokens into a ring of 2,976; bf16), at its
   heads in float32 and at hymba-1.5b's heads and window over a wrapped
   ring, timed by graph beside the plain loop, SDPA and its bound;
4. small-input reference: the port's ``Engine`` on the Yi-6B and
   granite-moe smoke configs in float32, on the card (kernels) and on the
   CPU (plain versions), must give token-identical outputs;
5. main path: Yi-6B, then granite-moe-3b-a800m (MoE: 40 experts, top-8), at
   full width and depth in bfloat16, random weights from ``--seed``, 16
   requests each through ``Engine(device_admission=True)`` with
   ``submit_many`` and ``run_until_idle``; the launch counts of the three
   serving kernels and of the paged block's two fused chains are read from
   each model's run alone (``rms_norm`` held to 2L + 1 launches a forward
   of L layers, ``rope_write`` to L), and a decode step of each is
   profiled;
6. device CMP queue: seeded FIFO churns through ``repro_torch.core.slotpool``
   (produce, claim, advance, reclaim) on a 2,048-slot pool (the JAX
   package's claim tile) and on a 65,536-slot pool (the page pool of a
   card that holds Yi-6B), on the card and on the CPU, compared every
   round; strict FIFO and the pool invariants are checked, and the claim
   kernel's launch count (one a claim) is read from each churn alone; then
   the claims/s of ``slotpool.claim`` on the card and a profile of 50
   claims (at most 2 ``cudaLaunchKernel`` a claim);
7. the serve driver: ``repro_torch.launch.serve`` at glm4-9b's full width
   and depth in bfloat16 (random weights from the config's seed) with 2
   replicas over 2 simulated hosts, device admission, 3 classes under wfq
   and ``--verify-single-host`` (each layout's fabric closed and its
   weights freed before the next is made); a crash and resume through the
   port's ``Fabric`` (a cadence checkpoint every 4 steps, the session
   dropped after step 10, ``Fabric.restore`` with the same weights):
   every admitted request completes once, token-identical to an
   uninterrupted run; one driver run at ``--page-size 128``. The serving
   kernels' launches are read from each of the three runs alone and held
   to that run's forward calls.
8. training: the port's ``Trainer`` on the Yi-6B and granite-moe smoke
   configs in float32, 6 steps on the card and on the CPU from the same
   params (losses and params compared), and an exact resume on the card (a
   checkpoint at step 4, a fresh trainer restores it and runs 2 more
   steps: the uninterrupted run's params); a bf16 model with Yi-6B's heads
   and vocabulary at d_model 1,024 and 4 layers, card against CPU; then
   the port's train driver (``repro_torch.launch.train.main(argv)``
   in-process) at Yi-6B's full width and depth in bfloat16, 8 steps of 2 x
   512 tokens at lr 1e-5: finite losses that start near ln(vocab) and
   fall, step ms, trained tokens/s, peak device memory, the optimizer's
   time a step and the model FLOP utilisation. No serving kernel may
   launch in this phase: the reference's training path calls no Pallas
   kernel.
9. the SSM, hybrid and frontend families: (a) the xlstm, hymba, llava-next
   (3 vision patch embeddings) and musicgen (audio frame tokens) smoke
   configs in float32, card against CPU: ``apply`` logits, the loss and
   every gradient, ``prefill`` + 4 ``decode_step`` logits and the final
   cache; (b) xlstm-125m and (c) hymba-1.5b at full width and depth in
   bfloat16, each trained by the train driver (8 steps of B=2 x 512, xlstm
   at lr 1e-4 through the scan kernels, hymba at lr 1e-5; the loss falls) and
   decoded on fresh weights (xlstm: 8 lanes,
   a 512-token prefill, 64 steps; hymba: 4 lanes, a ring of its 1,024-token
   window, a one-window prefill, 64 steps past it), each decode logit held
   to ``apply``'s at its position (hymba's Mamba branch through the SSD
   kernels: the chunked scan forward and backward, the decode step);
   hymba's ``apply`` through the flash
   kernel (``attention_impl="pallas"``, one launch a layer) held to the
   plain attention, each launch's output held to the kernel's plain
   version on that launch's inputs (atol = rtol = 2e-2), and the reference's two-chunk prefill of 2,048 tokens
   into its ring measured; (d) llava-next-mistral-7b decoded after a
   prefill of 2,880 patch embeddings + 64 tokens through
   ``chunked_cache_attention`` (its kernel once a layer, the first launch
   held to the plain loop on its own inputs), 32 steps, held to
   ``apply``, and a second prefill profiled. Per model: step ms and
   trained tokens/s, prefill ms and the prefill's own peak memory, decode
   step ms, generated tokens/s, peak memory, and the ``cudaLaunchKernel``
   of one profiled decode step. Of the serving kernels only flash may
   launch here, once a hymba layer; xlstm's layers launch the scan
   kernels, hymba's the SSD kernels and llava's prefills the cache
   attention kernel, each exactly as many times as the layers, remat and
   decode steps imply (no SSD or cache attention kernel launches outside
   phase 9).
10. the parallel layer and the launch tooling: (a) Yi-6B at full width and
   depth in bfloat16 split into 4 stages of 8 layers and run through
   ``repro_torch.parallel.pipeline.PipelineRunner`` on 6 microbatches of
   1 x 512 tokens: the forward (no graph) through the flash kernel
   (``attention_impl="pallas"``, 32 x 6 launches), the last stage's logits
   equal to ``apply``'s; ``train_grads`` on the plain attention, every
   gradient within a relative L2 of 1e-2 of the non-pipelined sum (one
   ``autograd.grad`` of ``loss_fn`` a microbatch), the runner's stats;
   (b) NCCL at world size 1 on a 1x1 (data, model) mesh: the sharded train
   step (DTensor params, moments and batch) on Yi-6B at full width cut to 4
   layers, on granite-moe-3b-a800m at full width and depth (2 x 512: MoE
   routing on each rank's tokens, TP expert products) and on xlstm-125m at
   full width and depth (2 x 64: the time loops on each batch shard), each
   held bit for bit to the plain step (loss, every gradient, every updated
   param), and ``compressed_psum`` and ``ring_ag_matmul`` on the card held
   to their single-process results; (c) ``python -m
   repro_torch.launch.dryrun`` of yi-6b, granite-moe, llama4-maverick and
   xlstm-125m at train_4k, four subprocesses on the host (started first),
   each cell's per-GPU counts and three roofline terms under the H100
   constants (estimates for a 256-GPU mesh), yi's FLOPs a GPU beside PR
   19's, the xlstm and llama4 cells' all-gather and all-reduce wire bytes
   beside torch 2.13's on a host CPU (the loss is vocab-parallel), and
   yi's analytic memory against 80 GB. Of the serving kernels only flash
   may launch here: the pipeline's launches and ``apply``'s; the scan
   kernels launch as (b)'s four xlstm-125m passes imply.
11. the examples (``examples/torch_*.py``, each ``main()`` in-process as it
   stands, with its own assertions): the four serve examples (glm4-9b
   smoke in float32 through ``Fabric``: quickstart, batched with
   preemption, multi-tenant, and replicated with a live resize, cadence
   checkpoints under ``build/``, a crash and ``Fabric.restore``), each a
   counted run on the card whose paged and flash launches are held to its
   forward calls (device admission is off, so the ring may not run), each
   kernel call held to the plain version on its own inputs (atol = rtol =
   2e-5 in float32), and each example run again on the CPU (plain
   versions): every drain token-identical, in the same completion order;
   then the data-pipeline demo, and ``torch_train_lm.py`` at the
   reference's CI scale (20 steps of 4 x 64 at a quarter of xlstm-125m's
   width; the loss falls) and at full published width (4 steps of 8 x 64;
   finite losses). No serving kernel may launch in the last two; the scan
   kernels launch as ``torch_train_lm.py``'s layers imply.

Each phase's wall is printed on a line of its own (``[wall]``), and all of
them on one line after phase 11.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the ``kernels`` JSON line (five rows for the five ``pallas_call`` sites, the
claim kernel serving two, then eight for the four ``lax.scan`` sites: four
xLSTM kernels, three SSD kernels, the decode step's among them, and the
cache attention kernel; then two for the paged block's fused chains,
``rms_norm`` and ``rope_write``, whose ``of`` is ``fusion``: they replace
no TPU kernel; each row's ``of`` naming which), and the card's name and
power limit come before that. Phase 3 ends with those two kernels against
their plain versions at yi-6b's and granite-moe's heads and widths over
the benchmark's decode, prefill and chunk calls, each timed by graph.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12       # H100 SXM data sheet, dense
F32_FLOP_PER_S = 67e12         # H100 SXM data sheet, f32 outside the tensor cores
TOL_BF16 = 2e-2                # atol = rtol: f32 sums in another order + bf16 rounding
SERVED = ("yi_6b", "granite_moe")  # phase 5's models, dense then MoE
# the attention configs the serve driver reaches, besides those of phase 5
DRIVER_ARCHS = ("glm4_9b", "phi3_mini", "command_r_35b", "llama4_maverick", "llava_next",
                "musicgen_large")


def log(msg: str) -> None:
    print(msg, flush=True)


def _graph(fn, iters: int):
    """``iters`` calls of ``fn`` captured in a CUDA graph after a warm-up
    call outside it, replayed once."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, iters: int, reps: int = 5) -> float:
    """Mean device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph (after a warm-up call outside it), replayed ``reps`` times
    between CUDA events. Measures the device, not the host's launch loop."""
    graph = _graph(fn, iters)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def graph_split_ms(fn, iters: int, reps: int = 5) -> dict:
    """The device time of each kernel a call of ``fn`` launches: the graph of
    ``graph_ms`` replayed ``reps`` times under ``torch.profiler``, which
    sees the graph's kernels; {kernel: ms a call} (kernels whose names cut
    alike summed), empty where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    graph = _graph(fn, iters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and _self_device_us(e) > 0:
            name = _demangled_kernel(e.key)
            split[name] = split.get(name, 0.0) + _self_device_us(e) / 1e3 / (iters * reps)
    return split


def kernels_launched(fn) -> dict:
    """The kernels one eager call of ``fn`` runs on the device, as
    ``torch.profiler`` sees them: {kernel: launches}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0:
            name = _demangled_kernel(e.key)
            out[name] = out.get(name, 0) + e.count
    return out


def _demangled_kernel(key: str) -> str:
    """A profiler's kernel name cut to the identifier ending in ``_kernel``
    and its template arguments."""
    m = re.search(r"(\w+_kernel)(<[^()]*>)?", key)
    return m.group(1) + (m.group(2) or "") if m else key[:60]


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


def bound(bytes_moved: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _kernel_name(ptxas_line: str) -> str:
    """The kernel's name out of a mangled symbol in a ptxas line (the
    length-prefixed identifier that ends in ``_kernel``), with its template
    arguments."""
    for m in re.finditer(r"\d+", ptxas_line):
        for i in range(m.start(), m.end()):  # the run may end a hash: try its tails
            name = ptxas_line[m.end():m.end() + int(ptxas_line[i:m.end()])]
            if name[:1].isalpha() and name.endswith("_kernel"):
                tail = re.match(r"I(\w*?)EE", ptxas_line[m.end() + len(name):])
                return name + (f"<{tail.group(1)}>" if tail else "")
    return "?"


def ptxas_lines() -> list:
    """(kernel, line) for each of ``ptxas -v``'s register and spill lines in
    the build log of the kernel library."""
    from repro_torch.kernels import _build

    kernel, out = "?", []
    for line in (_build.build().parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            kernel = _kernel_name(line)
        elif "registers" in line or "spill" in line:
            out.append((kernel, line.replace("ptxas info    :", "").strip()))
    return out


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


# the engine's ring at max_batch 8, 256, 1,024 (one CTA), 2,048 and 4,096 (grid path)
RING_SIZES = (128, 4096, 16384, 32768, 65536)


def time_ring(ring, n: int = 128) -> tuple:
    """The ring kernel at the engine's ring of N slots (k = N/2, window
    N/4), a quarter of the ring pushed onto a half-full ring: (graph ms,
    eager ms) of one call."""
    k, window = n // 2, n // 4
    state = torch.zeros(n, dtype=torch.int32, device="cuda")
    cycle, meta = torch.zeros_like(state), torch.zeros(2, dtype=torch.int32, device="cuda")
    state, cycle, meta, _ = ring.cmp_ring_step(state, cycle, meta, (n // 2, 0), k=k,
                                               window=window)
    req = (n // 4, k)

    def call():
        ring.cmp_ring_step(state, cycle, meta, req, k=k, window=window)

    return graph_ms(call, 200), cuda_ms(call, 200)


def _broken_ring(rng, n: int) -> tuple:
    """A ring state the engine never makes: random states and permuted
    cycles, so the kernel takes its general path (a sort of the keys)."""
    state = torch.from_numpy(rng.integers(0, 3, size=n).astype(np.int32)).to("cuda")
    cycle = torch.from_numpy(rng.permutation(n).astype(np.int32)).to("cuda")
    meta = torch.tensor([n // 2, 0], dtype=torch.int32, device="cuda")
    return state, cycle, meta


def check_ring(ring, rng) -> dict:
    """The ring kernel against its plain version, bit-exact: a trajectory
    of the engine's ring at each of RING_SIZES, then states that break the
    enqueue invariant (random states; permuted, duplicate and wrapped
    cycles). Times by graph at each size, of the general path at 16,384
    (one CTA) and 65,536 (grid), and of a launch floor (a one-element
    fill_)."""
    dev = "cuda"
    for n in RING_SIZES:
        k, window = n // 2, n // 4
        state = torch.zeros(n, dtype=torch.int32, device=dev)
        cycle = torch.zeros(n, dtype=torch.int32, device=dev)
        meta = torch.zeros(2, dtype=torch.int32, device=dev)
        steps, claimed_total = (240 if n <= 128 else 60 if n <= 16384 else 30), 0
        for step in range(steps):
            req = (int(rng.integers(0, n // 2 + 1)), int(rng.integers(0, k + 1)))
            got = ring.cmp_ring_step(state, cycle, meta, req, k=k, window=window)
            want = ring.plain(state, cycle, meta, req, k=k, window=window)
            for nm, g, w in zip(("state", "cycle", "meta", "claimed"), got, want):
                if not torch.equal(g, w):
                    raise AssertionError(f"cmp_ring N={n} step {step}: {nm} differs")
            claimed_total += int((got[3] >= 0).sum())
            state, cycle, meta = got[0], got[1], got[2]
        if claimed_total == 0:
            raise AssertionError(f"cmp_ring N={n} trajectory never claimed")
        log(f"[kernels] cmp_ring N={n} k={k}: bit-exact over {steps} engine steps "
            f"({claimed_total} claims)")
    imax = np.iinfo(np.int32).max
    cases = 0
    for n in RING_SIZES:
        for kind in ("random", "duplicate", "wrapped"):
            state, cycle, meta = _broken_ring(rng, n)
            if kind == "duplicate":
                cycle = cycle % 7
            elif kind == "wrapped":  # cycles just below INT32_MAX, the frontier past it
                cycle = (imax - cycle.long()).to(torch.int32)
                meta = torch.tensor([-imax - 1 + n // 3, imax - n], dtype=torch.int32,
                                    device=dev)
            for k, req in ((n // 2, (n // 4, n // 2)), (n, (n, n)), (n // 2, (0, 0))):
                got = ring.cmp_ring_step(state, cycle, meta, req, k=k, window=n // 4)
                want = ring.plain(state, cycle, meta, req, k=k, window=n // 4)
                for nm, g, w in zip(("state", "cycle", "meta", "claimed"), got, want):
                    if not torch.equal(g, w):
                        raise AssertionError(f"cmp_ring N={n} {kind} k={k} req={req}: "
                                             f"{nm} differs")
                cases += 1
    log(f"[kernels] cmp_ring: bit-exact on {cases} invariant-breaking cases (random "
        f"states, duplicate and wrapped cycles; k up to N, want 0, push_n N)")
    floor = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = graph_ms(lambda: floor.fill_(1), 200)
    rows = {}
    for n in RING_SIZES:
        k = n // 2
        ms, eager_ms = time_ring(ring, n)
        state = torch.zeros(n, dtype=torch.int32, device=dev)
        cycle, meta = torch.zeros_like(state), torch.zeros(2, dtype=torch.int32, device=dev)
        state, cycle, meta, _ = ring.plain(state, cycle, meta, (n // 2, 0), k=k,
                                           window=n // 4)
        plain_ms = cuda_ms(lambda: ring.plain(state, cycle, meta, (n // 4, k), k=k,
                                              window=n // 4), 50)
        moved = 4 * (4 * n + 2 + 2 + k)  # state, cycle in+out; meta in+out; claimed
        b_ms, b_by = bound(moved, 0)
        path = "one CTA" if n <= 16384 else "grid path, 4 launches"
        log(f"[kernels] cmp_ring N={n} k={k} ({path}): kernel_ms={ms:.5f} (graph) "
            f"eager_ms={eager_ms:.5f} plain_ms={plain_ms:.5f} bound_ms={b_ms:.7f} "
            f"({b_by}) launch_floor_ms={floor_ms:.5f} (graph of fill_)")
        rows[n] = (ms, plain_ms, b_ms, b_by)
    for n in (16384, 65536):  # the one-CTA kernel's sort; the grid path's claim kernel
        state, cycle, meta = _broken_ring(rng, n)
        general_ms = graph_ms(lambda: ring.cmp_ring_step(state, cycle, meta, (n // 4, n // 2),
                                                         k=n // 2, window=n // 4),
                              20 if n <= 16384 else 1)
        log(f"[kernels] cmp_ring N={n} k={n // 2} general path (random states, permuted "
            f"cycles): kernel_ms={general_ms:.5f} (graph)")
    ms, plain_ms, b_ms, b_by = rows[128]
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


JAX_TILE = 2048  # the JAX package's claim tile: one block up to it, tiled above
CLAIM_TIMED = (JAX_TILE, 4096, 65536)  # the JAX tile; the JAX dev bench's pool; the page pool


def time_claim(claim, rng, n: int, k: int = 64) -> tuple:
    """The claim kernel at N slots (random states, permuted cycles), k = 64:
    (graph ms, eager ms, topk graph ms, topk eager ms) of one call;
    ``torch.topk`` selects from the key precomputed outside the timing."""
    state = torch.from_numpy(rng.choice([0, 1, 2], size=n).astype(np.int32)).to("cuda")
    cycle = torch.from_numpy(rng.permutation(n).astype(np.int32)).to("cuda")
    key = torch.where(state == 1, cycle, np.iinfo(np.int32).max)

    def kernel():
        claim.cmp_claim(state, cycle, k=k)

    def library():
        torch.topk(key, k, largest=False)

    return (graph_ms(kernel, 200), cuda_ms(kernel, 200), graph_ms(library, 200),
            cuda_ms(library, 200))


def check_claim(claim, rng) -> list:
    """The claim kernel against its plain version, bit-exact (``torch.equal``
    on new_state and ids), over pool sizes, k (k > N included), ``block_n``
    (which does not change the result) and cycle patterns; the fused
    slot-pool entry ``claim_pool`` on all five outputs. Times at N = 2,048,
    4,096 and 65,536, k = 64: device time from a CUDA graph, and the eager
    wrapper loop of earlier runs. Two rows: the JAX package's single-block
    kernel's pools (N = 2,048) and its tiled kernel's (N = 65,536), both
    served by the one claim kernel."""
    dev = "cuda"
    cases = pool_cases = 0
    for n in (1, 7, 2047, 2048, 2049, 4096, 65536, 1 << 20):
        state = torch.from_numpy(rng.choice([0, 1, 2], size=n).astype(np.int32)).to(dev)
        retire = torch.from_numpy(rng.integers(-9, 9, size=n).astype(np.int32)).to(dev)
        ks = (1, 64, n + 3) if n <= 2049 else (1, 64)
        for cname, cyc in _claim_cycles(rng, n).items():
            cycle = torch.from_numpy(cyc.astype(np.int32)).to(dev)
            for k in ks:
                want = claim.plain(state, cycle, k=k)
                for bn in (None, 128, n):
                    got = claim.cmp_claim(state, cycle, k=k, block_n=bn)
                    for nm, g, w in zip(("new_state", "ids"), got, want):
                        if not torch.equal(g, w):
                            raise AssertionError(f"cmp_claim N={n} k={k} block_n={bn} "
                                                 f"cycles {cname}: {nm} differs")
                    cases += 1
                for dq in (-5, 3, n + 100):
                    deque = torch.tensor(dq, dtype=torch.int32, device=dev)
                    got = claim.claim_pool(state, cycle, retire, deque, k=k)
                    want_pool = claim.plain_pool(state, cycle, retire, deque, k=k)
                    for nm, g, w in zip(("new_state", "ids", "valid", "retire_cycle",
                                         "deque_cycle"), got, want_pool):
                        if not torch.equal(g, w):
                            raise AssertionError(f"claim_pool N={n} k={k} deque={dq} "
                                                 f"cycles {cname}: {nm} differs")
                    pool_cases += 1
    log(f"[kernels] cmp_claim: bit-exact on {cases} (N, k, block_n, cycles) cases and "
        f"claim_pool on {pool_cases} (N, k, deque_cycle, cycles) cases, N from 1 to "
        f"{1 << 20}; one launch a call")
    k, timed = 64, {}
    for n in CLAIM_TIMED:
        ms, eager_ms, lib_ms, lib_eager = time_claim(claim, rng, n, k)
        state = torch.from_numpy(rng.choice([0, 1, 2], size=n).astype(np.int32)).to(dev)
        cycle = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
        plain_ms = cuda_ms(lambda: claim.plain(state, cycle, k=k), 50)
        b_ms, b_by = bound(4 * (3 * n + k), 0)  # state, cycle in; new_state, ids out
        log(f"[kernels] cmp_claim N={n} k={k}: kernel_ms={ms:.5f} (graph) "
            f"eager_ms={eager_ms:.5f} plain_ms={plain_ms:.5f} topk_ms={lib_ms:.5f} "
            f"(graph; selection only, tie order unspecified) topk_eager_ms={lib_eager:.5f} "
            f"bound_ms={b_ms:.7f} ({b_by}); kernel/topk {ms / lib_ms:.3f}")
        timed[n] = (ms, plain_ms, lib_ms, b_ms, b_by)
    n = 65536
    state = torch.from_numpy(rng.choice([0, 1, 2], size=n).astype(np.int32)).to(dev)
    cycle = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)
    retire, deque = torch.zeros_like(state), torch.zeros((), dtype=torch.int32, device=dev)

    def pool_call():
        claim.claim_pool(state, cycle, retire, deque, k=k)

    pool_ms, pool_eager = graph_ms(pool_call, 200), cuda_ms(pool_call, 200)
    pool_plain = cuda_ms(lambda: claim.plain_pool(state, cycle, retire, deque, k=k), 50)
    b_ms, b_by = bound(4 * (5 * n + k) + k + 8, 0)  # + retire in/out, valid, deque
    log(f"[kernels] claim_pool N={n} k={k}: kernel_ms={pool_ms:.5f} (graph) "
        f"eager_ms={pool_eager:.5f} plain_ms={pool_plain:.5f} bound_ms={b_ms:.7f} ({b_by})")
    out = []
    for name, n, line in (("cmp_claim", JAX_TILE, 137), ("cmp_claim_tiled", 65536, 95)):
        ms, plain_ms, lib_ms, b_ms, b_by = timed[n]
        out.append(dict(name=name, source="src/repro_torch/kernels/csrc/cmp_claim.cu",
                        replaces=f"src/repro/kernels/cmp_claim.py:{line}", max_abs_err=0.0,
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=lib_ms))
    return out


def _sdpa_heads(q, k, v, H, KV):
    """Permute query heads so that SDPA's grouped GQA (query head h reads
    KV head h // (H/KV)) computes the port's r-major mapping (h % KV)."""
    rep = H // KV
    perm = torch.arange(H, device=q.device).view(rep, KV).t().reshape(-1)
    return q[:, perm], k, v


def served_heads() -> dict:
    """(H, KV, hd) of each model that phase 5 serves, then of each
    attention config the serve driver reaches, from its config."""
    from repro_torch.configs import get_config

    cfgs = {arch: get_config(arch) for arch in SERVED + DRIVER_ARCHS}
    return {arch: (c.num_heads, c.num_kv_heads, c.resolved_head_dim)
            for arch, c in cfgs.items()}


def check_paged(pa, gen) -> dict:
    """The split-K paged kernel against its plain version at the decode
    shape of each attention config (B=8, pps=64; the heads of Yi-6B,
    granite-moe and the serve driver's configs): mixed seq_lens, then every
    lane at 256 (the main path's contexts) and at 1024 (max_seq). Times at Yi-6B's heads: the kernel's
    device time from a CUDA graph of back-to-back calls that rotate over 4
    disjoint page sets (67 MB, more than the 50 MB L2), SDPA the same way on
    dense copies, and the eager wrapper loop of earlier runs (warm L2)."""
    B, page, pps, sets = 8, 16, 64, 4
    P = sets * B * pps + 1
    dev, dt = "cuda", torch.bfloat16
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    bts = [perm[i * B * pps:(i + 1) * B * pps].view(B, pps).to(torch.int32).contiguous()
           for i in range(sets)]
    bt = bts[0]
    lens = {"mixed": torch.tensor([0, 1, 17, 300, 511, 777, 1000, 1024], dtype=torch.int32,
                                  device=dev)}
    for n in (256, 1024):
        lens[n] = torch.full((B,), n, dtype=torch.int32, device=dev)
    err, inputs, heads = 0.0, {}, served_heads()
    for arch, (H, KV, hd) in heads.items():
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(dt)
        kp = torch.randn(P, KV, page, hd, generator=gen, device=dev).to(dt)
        vp = torch.randn(P, KV, page, hd, generator=gen, device=dev).to(dt)
        if arch == SERVED[0]:
            inputs[arch] = (q, kp, vp)
        arch_err = max(check_close(f"paged_attention {arch} heads seq_lens {name}",
                                   pa.paged_attention(q, kp, vp, bt, sl),
                                   pa.plain(q, kp, vp, bt, sl))
                       for name, sl in lens.items())
        log(f"[kernels] paged_attention B={B} H={H} KV={KV} hd={hd} page={page} pps={pps} "
            f"bf16 ({arch}'s heads; seq_lens mixed 0-1024, all 256, all 1024): "
            f"max_abs_err={arch_err:.3e} (atol=rtol={TOL_BF16})")
        err = max(err, arch_err)
    q, kp, vp = inputs[SERVED[0]]
    H, KV, hd = heads[SERVED[0]]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    T = pps * page
    timed = {}
    for n in (256, 1024):
        sl_t = lens[n]
        rot = [0]

        def kernel():
            rot[0] = (rot[0] + 1) % sets
            pa.paged_attention(q, kp, vp, bts[rot[0]], sl_t)

        ms = graph_ms(kernel, 4 * sets)
        eager_ms = cuda_ms(lambda: pa.paged_attention(q, kp, vp, bt, sl_t), 200)
        plain_ms = cuda_ms(lambda: pa.plain(q, kp, vp, bt, sl_t), 20)
        # library yardstick: SDPA over the same K/V already gathered to dense
        # (the gather is not timed), one dense copy per page set
        dense = [[x[b.long()].movedim(2, 1).reshape(B, KV, T, hd) for x in (kp, vp)]
                 for b in bts]
        qs, _, _ = _sdpa_heads(q[:, :, None], None, None, H, KV)
        mask = (torch.arange(T, device=dev)[None, :] < sl_t[:, None])[:, None, None]

        def library():
            rot[0] = (rot[0] + 1) % sets
            kd, vd = dense[rot[0]]
            sdpa(qs, kd, vd, attn_mask=mask, enable_gqa=True)

        lib_ms = graph_ms(library, 4 * sets)
        lib_eager = cuda_ms(lambda: sdpa(qs, *dense[0], attn_mask=mask, enable_gqa=True),
                            200)
        del dense
        toks = int(sl_t.sum())
        moved = 2 * (2 * B * H * hd + 2 * toks * KV * hd) + 4 * (B * pps + B)
        b_ms, b_by = bound(moved, 4 * toks * H * hd)
        log(f"[kernels] paged_attention B={B} H={H} KV={KV} hd={hd} page={page} "
            f"pps={pps} bf16 seq_len {n}: kernel_ms={ms:.5f} (graph, cold L2) "
            f"eager_ms={eager_ms:.5f} plain_ms={plain_ms:.5f} sdpa_ms={lib_ms:.5f} "
            f"(graph) sdpa_eager_ms={lib_eager:.5f} bound_ms={b_ms:.7f} ({b_by}); "
            f"{pa.launches_per_call(pps, page)} launches a call")
        timed[n] = (ms, plain_ms, b_ms, b_by, lib_ms)
    ms, plain_ms, b_ms, b_by, lib_ms = timed[1024]
    return dict(name="paged_attention",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:102", max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def check_flash(fa, gen) -> dict:
    """The flash kernel (bf16: wgmma tiles) against its plain version, B=1
    unless a case says otherwise: at Yi-6B's heads, then at granite-moe's (hd 64, 3 query heads a KV head)
    and each serve-driver config's in the model layout the prefill passes
    ([B, S, H, hd] viewed as [B, H, S, hd]) at prompt lengths of the main
    paths (64-512, and 3-7 at the serve driver's configs), and at
    hymba-1.5b's heads and window of 1,024 up to S=2,048, and at B=4,
    S=2,048, the shape phase 9's ``attention_impl="pallas"`` forward gives
    it. Times at
    Yi-6B's heads, S=T=512 (the yardstick of earlier runs) and 128 (a
    prefill length of the main path): device time from a CUDA graph, SDPA
    the same way, and the eager wrapper loop of earlier runs."""
    from repro_torch.configs import get_config

    dev, dt = "cuda", torch.bfloat16
    heads = served_heads()
    errs = []
    cases = {SERVED[0]: [(512, True, 0), (300, True, 0), (512, True, 128), (300, False, 0),
                         (128, True, 0)],
             SERVED[1]: [(512, True, 0), (300, True, 0), (77, True, 0), (64, True, 0)]}
    # the serve driver's prefills too: one tile with 3-7 live rows (phase 7's prompts)
    cases.update({arch: [(512, True, 0), (300, True, 0)] + [(S, True, 0) for S in range(3, 8)]
                  for arch in DRIVER_ARCHS})
    # phase 9's pallas route: hymba-1.5b's heads (25 over 5, hd 64) and window
    hymba = get_config("hymba_1_5b")
    heads["hymba_1_5b"] = (hymba.num_heads, hymba.num_kv_heads, hymba.resolved_head_dim)
    cases["hymba_1_5b"] = [(S, True, hymba.sliding_window) for S in (300, 1100, 2048)] + [
        (2048, True, hymba.sliding_window, 4)]  # (S, causal, window[, batch])
    inputs = {}
    for arch, arch_cases in cases.items():
        H, KV, hd = heads[arch]
        model_layout = arch != SERVED[0]

        def rand(b, n_heads, S):
            if model_layout:
                x = torch.randn(b, S, n_heads, hd, generator=gen, device=dev)
                return x.to(dt).transpose(1, 2)
            return torch.randn(b, n_heads, S, hd, generator=gen, device=dev).to(dt)

        for S, causal, window, *batch in arch_cases:
            b = batch[0] if batch else 1
            q, k, v = rand(b, H, S), rand(b, KV, S), rand(b, KV, S)
            if arch == SERVED[0]:
                inputs[(S, causal, window)] = (q, k, v)
            err = check_close(f"flash_attention {arch} heads B={b} S={S} causal={causal} "
                              f"window={window}",
                              fa.flash_attention(q, k, v, causal=causal,
                                                 sliding_window=window),
                              fa.plain(q, k, v, causal=causal, sliding_window=window))
            errs.append(err)
            log(f"[kernels] flash_attention B={b} H={H} KV={KV} hd={hd} S=T={S} "
                f"causal={causal} window={window} bf16 ({arch}'s heads"
                f"{', model layout' if model_layout else ''}): max_abs_err={err:.3e} "
                f"(atol=rtol={TOL_BF16})")
    B, (H, KV, hd) = 1, heads[SERVED[0]]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    timed = {}
    for S in (128, 512):
        q, k, v = inputs[(S, True, 0)]
        ms = graph_ms(lambda: fa.flash_attention(q, k, v, causal=True), 20)
        eager_ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=True), 100)
        plain_ms = cuda_ms(lambda: fa.plain(q, k, v, causal=True), 20)
        qs, ks, vs = _sdpa_heads(q, k, v, H, KV)
        lib_ms = graph_ms(lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=True), 20)
        lib_eager = cuda_ms(lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=True), 100)
        pairs = S * (S + 1) // 2
        moved = 2 * (2 * B * H * S * hd + 2 * B * KV * S * hd)
        b_ms, b_by = bound(moved, 4 * B * H * pairs * hd)
        log(f"[kernels] flash_attention causal S=T={S}: kernel_ms={ms:.5f} (graph) "
            f"eager_ms={eager_ms:.5f} plain_ms={plain_ms:.5f} sdpa_ms={lib_ms:.5f} "
            f"(graph) sdpa_eager_ms={lib_eager:.5f} bound_ms={b_ms:.7f} ({b_by}); "
            f"kernel/sdpa {ms / lib_ms:.3f}")
        timed[S] = (ms, plain_ms, b_ms, b_by, lib_ms)
    ms, plain_ms, b_ms, b_by, lib_ms = timed[512]
    return dict(name="flash_attention",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:112",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def check_attention_repairs(pa, fa, gen) -> dict:
    """The shapes the attention kernels took on in this slice, each against
    its plain version in bf16 (atol = rtol = 2e-2): the paged kernel's
    64-token splits at page sizes 8-256 (Yi-6B's heads, 1,024 tokens), its
    scalar path (bf16 head_dim 8 and 72, 32 query heads a KV head at hd
    128), a chunked prefill's B*S query rows (glm4-9b's heads, 256 rows past
    position 256), a softcap of 30 in both kernels (scores scaled so the
    cap bites), and the serve driver's decode shapes (glm4-9b's heads, 2
    and 4 lanes, pages of 16 and 128, contexts of 3-15). Times by graph (warm L2) of the page-128 split and of
    the scalar path beside their bounds. Returns the largest error of each
    kernel."""
    dev, dt = "cuda", torch.bfloat16
    heads = served_heads()
    B, tokens = 8, 1024
    errs = {"paged": 0.0, "flash": 0.0}

    def paged_case(H, KV, hd, page, n_tok=tokens):
        pps = -(-n_tok // page)
        P = B * pps + 1
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(dt)
        kp = torch.randn(P, KV, page, hd, generator=gen, device=dev).to(dt)
        vp = torch.randn(P, KV, page, hd, generator=gen, device=dev).to(dt)
        bt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * pps] + 1).view(B, pps)
        sl = torch.tensor([1, page, 64, 65, 300, n_tok - page - 1, n_tok - 1, n_tok],
                          dtype=torch.int32, device=dev)
        return q, kp, vp, bt.to(torch.int32).contiguous(), sl

    def timed(name, H, KV, hd, page, args):
        q, kp, vp, bt, _ = args
        sl = torch.full((B,), tokens, dtype=torch.int32, device=dev)
        ms = graph_ms(lambda: pa.paged_attention(q, kp, vp, bt, sl), 50)
        plain_ms = cuda_ms(lambda: pa.plain(q, kp, vp, bt, sl), 10)
        moved = 2 * (2 * B * H * hd + 2 * B * tokens * KV * hd) + 4 * (bt.numel() + B)
        b_ms, b_by = bound(moved, 4 * B * tokens * H * hd)
        log(f"[kernels] paged_attention {name} B={B} H={H} KV={KV} hd={hd} page={page} "
            f"bf16 seq_len {tokens}: kernel_ms={ms:.5f} (graph, warm L2) "
            f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.7f} ({b_by}); "
            f"{pa.launches_per_call(bt.shape[1], page)} launches a call")

    H, KV, hd = heads[SERVED[0]]
    for page in (8, 24, 32, 48, 128, 256):
        args = paged_case(H, KV, hd, page)
        err = check_close(f"paged_attention page={page}", pa.paged_attention(*args),
                          pa.plain(*args))
        errs["paged"] = max(errs["paged"], err)
        log(f"[kernels] paged_attention page={page} ({pa.num_splits(args[3].shape[1], page)} "
            f"splits of {pa.SPLIT_TOKENS} tokens) B={B} H={H} KV={KV} hd={hd} bf16: "
            f"max_abs_err={err:.3e}")
        if page == 128:
            timed("64-token splits of a 128-token page", H, KV, hd, page, args)
    for sH, sKV, shd in ((32, 4, 8), (32, 4, 72), (32, 1, 128)):
        args = paged_case(sH, sKV, shd, 16)
        err = check_close(f"paged_attention scalar path H={sH} KV={sKV} hd={shd}",
                          pa.paged_attention(*args), pa.plain(*args))
        errs["paged"] = max(errs["paged"], err)
        log(f"[kernels] paged_attention scalar path (bf16 heads past the mma tiles) B={B} "
            f"H={sH} KV={sKV} hd={shd} page=16: max_abs_err={err:.3e}")
    timed("scalar path", 32, 1, 128, 16, args)
    for sH, sKV, shd in (heads[SERVED[0]], (32, 1, 128)):
        q, kp, vp, bt, sl = paged_case(sH, sKV, shd, 16)
        q = (q.float() * 20).to(dt)
        err = check_close(f"paged_attention softcap 30 H={sH} KV={sKV} hd={shd}",
                          pa.paged_attention(q, kp, vp, bt, sl, softcap=30.0),
                          pa.plain(q, kp, vp, bt, sl, softcap=30.0))
        errs["paged"] = max(errs["paged"], err)
        log(f"[kernels] paged_attention softcap=30 H={sH} KV={sKV} hd={shd}: "
            f"max_abs_err={err:.3e}")
    for arch in (SERVED[0], SERVED[1]):
        fH, fKV, fhd = heads[arch]
        for S in (512, 77):
            q = (torch.randn(1, fH, S, fhd, generator=gen, device=dev) * 20).to(dt)
            k = torch.randn(1, fKV, S, fhd, generator=gen, device=dev).to(dt)
            v = torch.randn(1, fKV, S, fhd, generator=gen, device=dev).to(dt)
            err = check_close(f"flash_attention softcap 30 {arch} S={S}",
                              fa.flash_attention(q, k, v, causal=True, softcap=30.0),
                              fa.plain(q, k, v, causal=True, softcap=30.0))
            errs["flash"] = max(errs["flash"], err)
            log(f"[kernels] flash_attention softcap=30 H={fH} KV={fKV} hd={fhd} S=T={S} "
                f"causal: max_abs_err={err:.3e}")
    # a chunked prefill: 256 query rows of one lane at positions 256..511,
    # row s with the lane's block table and seq_len 257 + s
    cH, cKV, chd = heads["glm4_9b"]
    S, page, pps = 256, 16, 64
    P = pps + 1
    q = torch.randn(S, cH, chd, generator=gen, device=dev).to(dt)
    kp = torch.randn(P, cKV, page, chd, generator=gen, device=dev).to(dt)
    vp = torch.randn(P, cKV, page, chd, generator=gen, device=dev).to(dt)
    bt = (torch.randperm(P - 1, generator=gen, device=dev) + 1).view(1, pps).to(torch.int32)
    rows_bt = bt.repeat_interleave(S, dim=0).contiguous()
    rows_sl = torch.arange(257, 257 + S, dtype=torch.int32, device=dev)
    err = check_close("paged_attention chunked-prefill rows",
                      pa.paged_attention(q, kp, vp, rows_bt, rows_sl),
                      pa.plain(q, kp, vp, rows_bt, rows_sl))
    errs["paged"] = max(errs["paged"], err)
    log(f"[kernels] paged_attention chunked prefill: {S} rows (positions 256-511) "
        f"H={cH} KV={cKV} hd={chd} bf16: max_abs_err={err:.3e} (atol=rtol={TOL_BF16})")
    # the serve driver's decode (phase 7): 2 lanes a replica (4 in one), max_seq
    # 256 as 16 pages of 16 or 2 of 128, contexts of 3-15 tokens
    for dB in (2, 4):
        for page, pps in ((16, 16), (128, 2)):
            P = dB * pps + 1
            q = torch.randn(dB, cH, chd, generator=gen, device=dev).to(dt)
            kp = torch.randn(P, cKV, page, chd, generator=gen, device=dev).to(dt)
            vp = torch.randn(P, cKV, page, chd, generator=gen, device=dev).to(dt)
            bt = (torch.randperm(P - 1, generator=gen, device=dev) + 1).view(dB, pps)
            bt = bt.to(torch.int32).contiguous()
            err = 0.0
            for n in range(13):  # lane b at 3 + (n + 3b) % 13: every lane sees 3..15
                sl = torch.tensor([3 + (n + 3 * b) % 13 for b in range(dB)],
                                  dtype=torch.int32, device=dev)
                err = max(err, check_close(f"paged_attention driver decode B={dB} "
                                           f"page={page} seq_lens {sl.tolist()}",
                                           pa.paged_attention(q, kp, vp, bt, sl),
                                           pa.plain(q, kp, vp, bt, sl)))
            errs["paged"] = max(errs["paged"], err)
            log(f"[kernels] paged_attention serve-driver decode B={dB} H={cH} KV={cKV} "
                f"hd={chd} page={page} pps={pps} bf16, seq_lens 3-15: max_abs_err={err:.3e} "
                f"(atol=rtol={TOL_BF16})")
    return errs


XL_B, XL_S = 2, 512  # xlstm-125m's train step in phase 9 (b): B x S
XL_REL_L2 = 1e-4      # float32 kernel vs plain: the same arithmetic, sums in another order
XL_FLOPS = {"mlstm_fwd": 4, "mlstm_bwd": 12, "slstm_fwd": 8, "slstm_bwd": 16}  # x d^2 a token
# The rate those FLOPs run at where the kernel does them in bf16: the mLSTM's
# products on the tensor cores as three bf16 products each (hi hi + lo hi +
# hi lo), the sLSTM's matvecs on the CUDA cores in f32.
XL_FLOP_RATE = {"mlstm_fwd": BF16_FLOP_PER_S / 3, "mlstm_bwd": BF16_FLOP_PER_S / 3,
                "slstm_fwd": F32_FLOP_PER_S, "slstm_bwd": F32_FLOP_PER_S}
XL_SITE = {"mlstm": "src/repro/models/ssm.py:90", "slstm": "src/repro/models/ssm.py:170"}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _xl_hold(what: str, got: list, want: list, dtype) -> float:
    """Each of ``got`` against ``want``: infinities (a fresh stabiliser) in
    the same places, the rest within atol = rtol = TOL_BF16 in bf16 or a
    relative L2 of XL_REL_L2 in float32; the largest abs error."""
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        fin = torch.isfinite(w)
        if not (torch.equal(torch.isfinite(g), fin) and torch.equal(g[~fin], w[~fin])):
            raise AssertionError(f"{what}: tensor {i} has its infinities elsewhere")
        g, w = g[fin].float(), w[fin].float()
        if dtype == torch.bfloat16:
            err = max(err, check_close(f"{what} tensor {i}", g, w))
            continue
        rel = float((g - w).norm() / w.norm().clamp(min=1e-30))
        if rel > XL_REL_L2:
            raise AssertionError(f"{what}: tensor {i} off its plain version by a relative "
                                 f"L2 of {rel} > {XL_REL_L2}")
        err = max(err, max_err(g, w))
    return err


def xl_inputs(seed: int, dtype, B: int, S: int) -> tuple:
    """The two recurrences' inputs as xlstm-125m's blocks make them, from
    fresh weights at the model's init and unit-RMS activations [B, S, 768]:
    (mLSTM q, k scaled, v, log_i, log_f and a fresh state; sLSTM zx, ix, fx,
    ox, r and a fresh state)."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks, ssm

    cfg = dataclasses.replace(get_config("xlstm_125m"),
                              dtype="float32" if dtype == torch.float32 else "bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pm = blocks.init_mlstm(cfg, gen, "cuda")["mlstm"]
    ps = blocks.init_slstm(cfg, gen, "cuda")["slstm"]
    x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda").to(dtype)
    H, D = cfg.ssm_heads, cfg.d_model
    hd = D // H
    q, k, v = ((x @ pm[w]).view(B, S, H, hd).transpose(1, 2) for w in ("wq", "wk", "wv"))
    k = k / torch.tensor(hd ** 0.5, dtype=torch.float32).to(k.dtype)
    log_i = (x @ pm["wi"]).transpose(1, 2).float()
    log_f = torch.nn.functional.logsigmoid((x @ pm["wf"]).transpose(1, 2).float())
    mst = ssm.mlstm_init_state(B, H, hd, "cuda")[:3]
    pre = [(x @ ps[w]).view(B, S, H, hd) for w in ("wz", "wi", "wf", "wo")]
    r = torch.cat([ps[w].float() for w in ("rz", "ri", "rf", "ro")], dim=-1)
    return (q, k, v, log_i, log_f, *mst), (*pre, r, *ssm.slstm_init_state(B, H, hd, "cuda"))


def check_xlstm(xs, seed: int) -> list:
    """Phase 3, the xLSTM time loops (the reference's two ``lax.scan``
    sites): each recurrence's forward kernel (with its saves) and backward
    kernels against ``ref.py``'s plain forward-with-saves and backward (the
    backward on the kernel's own saves) at xlstm-125m's width (4 heads of
    192) and phase 9's train shape, B=2 x S=512, in bf16 and float32; the
    S=1 decode step from the 512-step state. Timed by CUDA graph at B=2 x
    512 in bf16 (the plain versions eagerly, two calls), with a bound, and a
    chain floor: S x the step latency, (t(S) - t(1)) / (S - 1), the time a
    call of this design spends in its dependent steps (the chunkwise mLSTM
    kernels' are S / 32 chunks: their "step" is a token's share of one);
    each backward's two launches (the reverse loop, then the reduction or
    dr product) also apart, by ``graph_split_ms``."""
    from repro_torch.kernels import ref

    rows, worst = [], dict.fromkeys(xs.KERNELS, 0.0)
    every = xs.kernel_chunk()
    for dtype in (torch.bfloat16, torch.float32):
        errs = dict.fromkeys(xs.KERNELS, 0.0)
        margs, sargs = xl_inputs(seed, dtype, XL_B, XL_S)
        g = torch.Generator(device="cuda").manual_seed(seed + 1)
        rnd = lambda t: torch.randn(t.shape, generator=g, device="cuda").to(t.dtype)  # noqa
        tag = f"B={XL_B} S={XL_S} {str(dtype)[6:]}"
        # mLSTM
        h, C, n, m, saved = xs.mlstm_fwd(*margs, save=True)
        want = ref.ref_mlstm_fwd_saved(*margs, every)
        errs["mlstm_fwd"] = max(errs["mlstm_fwd"], _xl_hold(
            f"mlstm_fwd {tag}", [h, C, n, m, *saved], [*want[:4], *want[4]], dtype))
        cots = [rnd(t) for t in (h, C, n, m)]
        got = xs.mlstm_bwd(*margs[:5], saved, *cots)
        want = ref.ref_mlstm_bwd(*margs[:5], saved, *cots, every)
        errs["mlstm_bwd"] = max(errs["mlstm_bwd"], _xl_hold(f"mlstm_bwd {tag}", got, want,
                                                            dtype))
        step = [t[:, :, -1:] for t in margs[:5]]
        errs["mlstm_fwd"] = max(errs["mlstm_fwd"], _xl_hold(
            f"mlstm_fwd decode step {str(dtype)[6:]}", list(xs.mlstm(*step, C, n, m)),
            list(ref.ref_mlstm_scan(*step, C, n, m)), dtype))
        # sLSTM
        out = xs.slstm_fwd(*sargs, save=True)
        want = ref.ref_slstm_fwd_saved(*sargs)
        errs["slstm_fwd"] = max(errs["slstm_fwd"], _xl_hold(
            f"slstm_fwd {tag}", [*out[:5], *out[5]], [*want[:5], *want[5]], dtype))
        cots = [rnd(t) for t in out[:5]]
        got = xs.slstm_bwd(sargs[4], out[5], *cots)
        want = ref.ref_slstm_bwd(sargs[4], out[5], *cots)
        errs["slstm_bwd"] = max(errs["slstm_bwd"], _xl_hold(f"slstm_bwd {tag}", got, want,
                                                            dtype))
        step = [t[:, -1:] for t in sargs[:4]]
        errs["slstm_fwd"] = max(errs["slstm_fwd"], _xl_hold(
            f"slstm_fwd decode step {str(dtype)[6:]}", list(xs.slstm(*step, sargs[4],
                                                                     *out[1:5])),
            list(ref.ref_slstm_scan(*step, sargs[4], *out[1:5])), dtype))
        log(f"[kernels] xlstm scans {tag} and the decode step from its state, max_abs_err: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + (f" (atol=rtol={TOL_BF16})" if dtype == torch.bfloat16
               else f" (relative L2 <= {XL_REL_L2})"))
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
    margs, sargs = xl_inputs(seed, torch.bfloat16, XL_B, XL_S)
    one_m, one_s = ([t[..., :1, :] if t.dim() == 4 else t[..., :1] for t in margs[:5]],
                    [t[:, :1] for t in sargs[:4]])
    _, _, _, _, msaved = xs.mlstm_fwd(*margs, save=True)
    _, _, _, _, msaved1 = xs.mlstm_fwd(*one_m, *margs[5:], save=True)
    mh = torch.zeros_like(margs[0])
    mst = [torch.zeros_like(t) for t in margs[5:]]
    sout = xs.slstm_fwd(*sargs, save=True)
    sout1 = xs.slstm_fwd(*one_s, *sargs[4:], save=True)
    sst = [torch.zeros_like(t) for t in sout[1:5]]
    calls = {
        "mlstm_fwd": (lambda: xs.mlstm_fwd(*margs, save=True),
                      lambda: xs.mlstm_fwd(*one_m, *margs[5:], save=True),
                      lambda: ref.ref_mlstm_fwd_saved(*margs, every)),
        "mlstm_bwd": (lambda: xs.mlstm_bwd(*margs[:5], msaved, mh, *mst),
                      lambda: xs.mlstm_bwd(*one_m, msaved1, mh[:, :, :1], *mst),
                      lambda: ref.ref_mlstm_bwd(*margs[:5], msaved, mh, *mst, every)),
        "slstm_fwd": (lambda: xs.slstm_fwd(*sargs, save=True),
                      lambda: xs.slstm_fwd(*one_s, *sargs[4:], save=True),
                      lambda: ref.ref_slstm_fwd_saved(*sargs)),
        "slstm_bwd": (lambda: xs.slstm_bwd(sargs[4], sout[5], sout[0], *sst),
                      lambda: xs.slstm_bwd(sargs[4], sout1[5], sout1[0], *sst),
                      lambda: ref.ref_slstm_bwd(sargs[4], sout[5], sout[0], *sst)),
    }
    B, H, S, d = margs[0].shape
    with torch.no_grad():
        mout = xs.mlstm_fwd(*margs, save=True)
        mgrads = xs.mlstm_bwd(*margs[:5], msaved, mh, *mst)
        sgrads = xs.slstm_bwd(sargs[4], sout[5], sout[0], *sst)
    moved = {"mlstm_fwd": nbytes(*margs, *mout[:4], *mout[4]),
             "mlstm_bwd": nbytes(*margs[:5], *msaved, mh, *mst, *mgrads),
             "slstm_fwd": nbytes(*sargs, *sout[:5], *sout[5]),
             "slstm_bwd": nbytes(sargs[4], *sout[5], sout[0], *sst, *sgrads)}
    for name, (kernel, one, plain) in calls.items():
        ms, one_ms = graph_ms(kernel, 3), graph_ms(one, 20)
        plain_ms = cuda_ms(plain, 2)
        step_ms = (ms - one_ms) / (S - 1)
        flops = XL_FLOPS[name] * d * d * B * H * S
        b_ms, b_by = bound(moved[name], flops, XL_FLOP_RATE[name])
        log(f"[kernels] {name} B={B} H={H} S={S} d={d} bf16: kernel_ms={ms:.5f} (graph) "
            f"one_step_call_ms={one_ms:.5f} step_latency_ms={step_ms:.6f} "
            f"chain_floor_ms={S * step_ms:.5f} plain_ms={plain_ms:.5f} bound_ms={b_ms:.7f} "
            f"({b_by}: {flops / 1e6:.1f} MFLOP at {XL_FLOP_RATE[name] / 1e12:.0f} TFLOP/s, "
            f"{moved[name] / 1e6:.2f} MB; at 67 TFLOP/s f32 "
            f"{bound(moved[name], flops, F32_FLOP_PER_S)[0]:.7f} ms)"
            f" launches_per_call={xs.LAUNCHES_PER_CALL[name]}")
        if name.endswith("_bwd"):  # where a backward's two launches spend the call
            split = graph_split_ms(kernel, 3)
            log(f"[kernels] {name} B={B} H={H} S={S} d={d} bf16 by launch (graph, profiler): "
                + (", ".join(f"{k} {v:.5f} ms" for k, v in split.items()) or "not measured")
                + f"; the whole call {ms:.5f} ms")
        rows.append(dict(name=name, of="lax.scan",
                         source=f"src/repro_torch/kernels/csrc/{name[:5]}_scan.cu",
                         replaces=XL_SITE[name[:5]], max_abs_err=worst[name], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         chain_floor_ms=S * step_ms))
    return rows


SSD_SITE = {"ssd_fwd": "src/repro/models/ssm.py:236", "ssd_bwd": "src/repro/models/ssm.py:236",
            "ssd_decode": "src/repro/models/ssm.py:241"}
# (B, S, a carried state): phase 9's train step, its 1,024-token prefill (4
# lanes), and a padded last chunk (300 = 256 + 44) from a carried state
SSD_SHAPES = ((2, 512, False), (4, 1024, False), (2, 300, True))


def ssd_inputs(seed: int, dtype, B: int, S: int, carried: bool) -> tuple:
    """SSD's inputs as hymba-1.5b's Mamba branch makes them (25 heads, P =
    64, N = 16), from fresh weights at the model's init and unit-RMS
    activations [B, S, 1,600]: x * dt in the model's dtype, the strided b
    and c views of the fused projection, log_a float32 and a state (zeros,
    or a normal one x 0.1); the decode step's x * dt (float32), b, c and
    log_a at the last position."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks

    cfg = dataclasses.replace(get_config("hymba_1_5b"),
                              dtype="float32" if dtype == torch.float32 else "bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pm = blocks.init_hymba(cfg, gen, "cuda")["mamba"]
    x = torch.randn(B, S, cfg.d_model, generator=gen, device="cuda").to(dtype)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xin, _, bc, dt = (x @ pm["win"]).split([H * P, H * P, 2 * H * N, H], dim=-1)
    b, c = (t.view(B, S, H, N) for t in bc.chunk(2, dim=-1))
    dt = torch.nn.functional.softplus(dt.float())
    log_a = -dt * torch.exp(pm["a_log"].float())
    x_dt = xin.float().view(B, S, H, P) * dt[..., None]
    state = (torch.randn(B, H, P, N, generator=gen, device="cuda") * 0.1 if carried
             else torch.zeros(B, H, P, N, device="cuda"))
    step = (x_dt[:, -1], b[:, -1], c[:, -1], log_a[:, -1])
    return (x_dt.to(dtype), b, c, log_a, state), step


# FLOPs of SSD's recurrence, x P * N a token and head (a multiply-add is
# 2), what the function needs whatever the algorithm: forward h' = a * h +
# x (x) b (3) and y = h' . c (2); backward the state recomputed from a
# chunk's start (3), dh += dy (x) c (2), dc, dx, db and d a (2 each), dh
# carried back by a (1). The decode step is one forward token a lane.
SSD_FLOPS = {"ssd_fwd": 5, "ssd_bwd": 14, "ssd_decode": 5}
# The rate those FLOPs run at where the kernel does them: the chunk kernels'
# products on the bf16 tensor cores as three products each (hi hi + lo hi +
# hi lo, float32 accuracy), the decode step's on the CUDA cores in f32.
SSD_FLOP_RATE = {"ssd_fwd": BF16_FLOP_PER_S / 3, "ssd_bwd": BF16_FLOP_PER_S / 3,
                 "ssd_decode": F32_FLOP_PER_S}


def ssd_pair_flops(S: int, chunk: int, B: int, H: int, P: int, N: int) -> dict:
    """The FLOPs the chunk kernels do on these shapes, counting the 16 x 16
    tiles on and below each chunk's diagonal that they form (a tile is 256
    pairs (t, s)): the forward's C_t . B_s (once per 32 value columns) and
    its product with x_s a pair, and a row's inter-chunk readout and state
    update; the backward's row pass (C . B, dy . x, dc) and column pass (C
    . B, dy . x, dx, db) a pair, C . B and the N-wide products once per 64
    value columns, and a row's four [P, N] products. Logged beside the
    bound, which counts the recurrence (``SSD_FLOPS``)."""
    pairs = rows = 0
    for t0 in range(0, S, chunk):
        ns = -(-min(chunk, S - t0) // 16)
        pairs, rows = pairs + 256 * ns * (ns + 1) // 2, rows + 16 * ns
    fwd_blocks, bwd_blocks = -(-P // 32), -(-P // 64)
    return {"ssd_fwd": B * H * (pairs * 2 * (fwd_blocks * N + P) + rows * 4 * P * N),
            "ssd_bwd": B * H * (pairs * 2 * (bwd_blocks * 4 * N + 3 * P) + rows * 8 * P * N)}


def check_ssd(ss, seed: int) -> list:
    """Phase 3, SSD's chunk loop (the reference's third ``lax.scan`` site)
    and decode step: the forward kernel (with its saved chunk-start states)
    and the backward kernels against ``ref.py``'s plain forward-with-saves
    and backward (on the kernel's saves) at hymba-1.5b's width, chunks of
    256, at each of SSD_SHAPES, in bf16 and float32; the decode kernel from
    the prefill shape's final state. Timed by CUDA graph in bf16 at the
    train shape (the decode at phase 9's 4 lanes; the plain versions
    eagerly), with a bound at 3.35 TB/s or the recurrence's FLOPs
    (``SSD_FLOPS``) at the rate the kernel runs them (``SSD_FLOP_RATE``),
    whichever is longer; the recurrence at 67 TFLOP/s f32 (the chunk
    kernels' bound before they ran on the tensor cores) logged beside."""
    from repro_torch.kernels import ref

    worst = dict.fromkeys(ss.KERNELS, 0.0)
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    for dtype in (torch.bfloat16, torch.float32):
        errs = dict.fromkeys(ss.KERNELS, 0.0)
        for B, S, carried in SSD_SHAPES:
            args, step = ssd_inputs(seed, dtype, B, S, carried)
            chunk = min(256, S)
            tag = f"B={B} S={S}{' carried' if carried else ''} {str(dtype)[6:]}"
            y, h, saved = ss.ssd_fwd(*args, chunk=chunk, save=True)
            want = ref.ref_ssd_fwd_saved(*args, chunk)
            errs["ssd_fwd"] = max(errs["ssd_fwd"], _xl_hold(f"ssd_fwd {tag}", [y, h, saved],
                                                            list(want), dtype))
            dy = torch.randn(y.shape, generator=g, device="cuda").to(y.dtype)
            dh = torch.randn(h.shape, generator=g, device="cuda")
            got = ss.ssd_bwd(*args[:4], saved, dy, dh, chunk=chunk)
            want = ref.ref_ssd_bwd(*args[:4], saved, dy, dh, chunk)
            errs["ssd_bwd"] = max(errs["ssd_bwd"], _xl_hold(f"ssd_bwd {tag}", list(got),
                                                            list(want), dtype))
            if B == 4:
                xt, bt, ct, lat = step
                got = ss.decode(xt, bt, ct, lat, h)
                want = ref.ref_ssd_decode_step(xt, bt, ct, lat, h)
                errs["ssd_decode"] = max(errs["ssd_decode"], _xl_hold(
                    f"ssd_decode B=4 {str(dtype)[6:]}", list(got), list(want), dtype))
        log(f"[kernels] ssd at hymba-1.5b's width (25 heads, P=64, N=16, chunks of 256), "
            f"{', '.join(f'B={B} S={S}' + (' carried' if c else '') for B, S, c in SSD_SHAPES)}"
            f" {str(dtype)[6:]}, and the decode step from the B=4 state, max_abs_err: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
            + (f" (atol=rtol={TOL_BF16})" if dtype == torch.bfloat16
               else f" (relative L2 <= {XL_REL_L2})"))
        worst = {k: max(v, errs[k]) for k, v in worst.items()}
    B, S = XL_B, XL_S
    args, _ = ssd_inputs(seed, torch.bfloat16, B, S, False)
    _, (xt, bt, ct, lat) = ssd_inputs(seed, torch.bfloat16, 4, 8, False)
    _, H, P = xt.shape
    N = bt.shape[-1]
    st = torch.randn(4, H, P, N, generator=g, device="cuda") * 0.1
    y, h, saved = ss.ssd_fwd(*args, chunk=256, save=True)
    dy, dh = torch.randn_like(y), torch.randn_like(h)
    with torch.no_grad():
        grads = ss.ssd_bwd(*args[:4], saved, dy, dh, chunk=256)
        dec = ss.decode(xt, bt, ct, lat, st)
    calls = {
        "ssd_fwd": (lambda: ss.ssd_fwd(*args, chunk=256, save=True),
                    lambda: ref.ref_ssd_fwd_saved(*args, 256),
                    nbytes(*args, y, h, saved)),
        "ssd_bwd": (lambda: ss.ssd_bwd(*args[:4], saved, dy, dh, chunk=256),
                    lambda: ref.ref_ssd_bwd(*args[:4], saved, dy, dh, 256),
                    nbytes(*args[:4], saved, dy, dh, *grads)),
        "ssd_decode": (lambda: ss.decode(xt, bt, ct, lat, st),
                       lambda: ref.ref_ssd_decode_step(xt, bt, ct, lat, st),
                       nbytes(xt, bt, ct, lat, st, *dec)),
    }
    pair_flops = ssd_pair_flops(S, 256, B, H, P, N)
    rows = []
    for name, (kernel, plain, moved) in calls.items():
        ms, plain_ms = graph_ms(kernel, 20), cuda_ms(plain, 3)
        tokens = 4 if name == "ssd_decode" else B * S
        flops = SSD_FLOPS[name] * P * N * H * tokens
        rate = SSD_FLOP_RATE[name]
        b_ms, b_by = bound(moved, flops, rate)
        shape = "B=4 (one token)" if name == "ssd_decode" else f"B={B} S={S} chunk=256"
        chunked = (f", the kernels' tiles {pair_flops[name] / 1e6:.2f} MFLOP; the recurrence "
                   f"at 67 TFLOP/s f32 {bound(moved, flops, F32_FLOP_PER_S)[0]:.7f} ms"
                   if name in pair_flops else "")
        log(f"[kernels] {name} {shape} H={H} P={P} N={N} bf16: kernel_ms={ms:.5f} (graph) "
            f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.7f} ({b_by}: the recurrence's "
            f"{flops / 1e6:.2f} MFLOP at {rate / 1e12:.0f} TFLOP/s, {moved / 1e6:.3f} MB"
            f"{chunked}) launches_per_call={ss.LAUNCHES_PER_CALL[name]}")
        # the call's device time by launch
        split = graph_split_ms(kernel, 5)
        log(f"[kernels] {name} {shape} bf16 by launch (graph, profiler): "
            + (", ".join(f"{k} {v:.5f} ms" for k, v in split.items()) or "not measured")
            + f"; the whole call {ms:.5f} ms")
        if name == "ssd_decode":  # hymba's strided views read in place: one kernel
            seen = kernels_launched(kernel)
            log(f"[kernels] ssd_decode on strided x {tuple(xt.stride())}, b {tuple(bt.stride())}"
                f", c {tuple(ct.stride())}, log_a {tuple(lat.stride())}: the kernels of one "
                f"call {seen}")
            if list(seen.values()) != [1] or not next(iter(seen)).startswith("ssd_decode"):
                raise AssertionError(f"ssd_decode on strided inputs ran {seen}, not one "
                                     f"decode kernel")
        rows.append(dict(name=name, of="lax.scan",
                         source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                         replaces=SSD_SITE[name], max_abs_err=worst[name], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None))
    for kernel, line in ptxas_lines():
        if kernel.startswith("ssd_"):
            log(f"[kernels] {kernel} (ptxas): {line}")
    return rows


def ssd_expected(cfg, fwd: int, bwd: int, decode: int) -> dict:
    """The SSD kernels' launches of ``fwd`` forward passes over a sequence,
    ``bwd`` backward passes and ``decode`` decode steps through ``cfg``'s
    hymba layers."""
    from repro_torch.kernels import ssd_scan as ss

    per = cfg.block_pattern.count("hymba") * cfg.pattern_repeats
    return {name: per * n * ss.LAUNCHES_PER_CALL[name]
            for name, n in (("ssd_fwd", fwd), ("ssd_bwd", bwd), ("ssd_decode", decode))}


def xl_expected(cfg, fwd: int, bwd: int) -> dict:
    """The scan kernels' launches of ``fwd`` forward and ``bwd`` backward
    passes through ``cfg``'s layers (a remat'd training step is two
    forward passes and one backward)."""
    per = {kind: cfg.block_pattern.count(kind) * cfg.pattern_repeats
           for kind in ("mlstm", "slstm")}
    from repro_torch.kernels import xlstm_scan as xs

    return {f"{kind}_{way}": per[kind] * n * xs.LAUNCHES_PER_CALL[f"{kind}_{way}"]
            for kind in per for way, n in (("fwd", fwd), ("bwd", bwd))}


def xl_moved(xs, before: dict) -> dict:
    """The launches of a scan module (``xlstm_scan``, ``ssd_scan``) since
    ``before``, by kernel."""
    return {k: xs.launches[k] - before[k] for k in xs.KERNELS}


def xl_add(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0) for k in set(total) | set(more)}


CACHE_SITE = "src/repro/models/layers.py:203"  # the reference's scan over KV blocks
LLAVA_EXTRA, LLAVA_PROMPT, LLAVA_STEPS = 2880, 64, 32  # phase 9 (d)'s prefill and decode


def ring_inputs(gen, dtype, B: int, S: int, T: int, H: int, KV: int, hd: int,
                start: int = 0) -> tuple:
    """q [B,S,H,hd] and a ring k, v [B,T,KV,hd] (random, from ``gen``),
    with the positions a model's ring holds after positions 0..start+S-1
    were written to slots p % T (slot t the latest p, -1 if none): queries
    at start..start+S-1. ``start`` 0 and S <= T is a prefill into an empty
    ring (llava-next's: positions follow the slots); start + S > T wraps."""
    n = start + S
    t = torch.arange(T, device="cuda")
    p = n - 1 - (n - 1 - t) % T
    k_pos = torch.where(p >= 0, p, -1).to(torch.int32).expand(B, T).contiguous()
    q_pos = torch.arange(start, n, dtype=torch.int32, device="cuda").expand(B, S).contiguous()
    q = torch.randn(B, S, H, hd, generator=gen, device="cuda").to(dtype)
    k = torch.randn(B, T, KV, hd, generator=gen, device="cuda").to(dtype)
    v = torch.randn(B, T, KV, hd, generator=gen, device="cuda").to(dtype)
    return q, k, v, q_pos, k_pos


def ring_mask(q_pos, k_pos, window: int = 0):
    """[B, S, T]: which slots each query sees (the plain version's mask)."""
    mask = (k_pos[:, None, :] >= 0) & (q_pos[:, :, None] >= k_pos[:, None, :])
    if window > 0:
        mask &= q_pos[:, :, None] - k_pos[:, None, :] < window
    return mask


# the bf16 kernel against the plain loop run in float32 on its (bf16)
# inputs: each output row's relative L2 error. Its only roundings are P's
# and the output's to bf16 (unit roundoff 2**-8), each about 2.3e-3 a row;
# a 64-slot tile dropped or counted twice moves a row that sees 46 tiles by
# 0.05-0.17 (both emulated on the CPU at llava's shape)
TOL_ROW_BF16 = 1e-2


def row_rel_err(got: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """|got - exact| / |exact| over each row of the last dim (0 where both are 0)."""
    exact = exact.float()
    return (got.float() - exact).norm(dim=-1) / exact.norm(dim=-1).clamp_min(1e-30)


def check_cache_attention(ca, gen) -> dict:
    """Phase 3, ``chunked_cache_attention``'s KV-block scan (the reference's
    fourth ``lax.scan`` site): the kernel against its plain loop (KV blocks
    of 1,024, as the configs set ``attn_chunk_kv``) at llava-next's
    prefill (B 2, 2,880 patch embeddings + 64 tokens into a ring of 2,976;
    H/KV 32/8, hd 128) in bf16; at its heads in float32 (a 300-token chunk
    after 2,600 positions, the CUDA-core path); at hymba-1.5b's heads (25
    over 5, hd 64) with its 1,024 window over a wrapped 1,536-slot ring in
    bf16. In bf16 each case is also held, row by row, to the plain loop in
    float32 on the same inputs (a relative L2 of ``TOL_ROW_BF16``): the bf16
    loop rounds its scores to bf16, and the outputs of late rows (std ~0.03)
    sit well inside atol. Timed at llava's shape: the kernel and SDPA (the same boolean
    mask, ``enable_gqa``) by CUDA graph, the plain loop eagerly; the bound
    counts the pairs this run's positions make visible, 4 hd FLOPs a pair
    and head at 989 TFLOP/s, against q, k, v, the positions and the output
    once at 3.35 TB/s."""
    from repro_torch.configs import get_config

    llava, hymba = get_config("llava_next"), get_config("hymba_1_5b")
    H, KV, hd = llava.num_heads, llava.num_kv_heads, llava.resolved_head_dim
    B, S = 2, LLAVA_EXTRA + LLAVA_PROMPT
    T = S + LLAVA_STEPS
    cases = [("llava-next prefill", torch.bfloat16, B, S, T, H, KV, hd, 0, 0),
             ("llava-next heads, a chunk after 2,600", torch.float32, 1, 300, T, H, KV, hd,
              2600, 0),
             ("hymba-1.5b heads, wrapped ring", torch.bfloat16, 2, 200, 1536,
              hymba.num_heads, hymba.num_kv_heads, hymba.resolved_head_dim, 2800,
              hymba.sliding_window)]
    err = 0.0
    for what, dt, b, s, t, h, kv, d, start, window in cases:
        q, k, v, q_pos, k_pos = ring_inputs(gen, dt, b, s, t, h, kv, d, start)
        before = ca.launches
        got = ca.cache_attention(q, k, v, q_pos, k_pos, sliding_window=window)
        if ca.launches != before + 1:
            raise AssertionError(f"cache_attention {what}: {ca.launches - before} launches")
        want = ca.plain(q, k, v, q_pos, k_pos, sliding_window=window, block_k=1024)
        tol = TOL_BF16 if dt == torch.bfloat16 else 2e-5
        e = max_err(got, want)
        if not torch.isfinite(got).all() or not torch.allclose(got.float(), want.float(),
                                                               atol=tol, rtol=tol):
            raise AssertionError(f"cache_attention {what}: kernel disagrees with its plain "
                                 f"version (max abs err {e})")
        err = max(err, e)
        rows = ""
        if dt == torch.bfloat16:
            exact = ca.plain(q.float(), k.float(), v.float(), q_pos, k_pos,
                             sliding_window=window, block_k=1024)
            r = row_rel_err(got, exact)
            if not r.max() <= TOL_ROW_BF16:
                raise AssertionError(f"cache_attention {what}: a row {r.max().item():.3e} off "
                                     f"the plain loop in float32 (relative L2), over "
                                     f"{TOL_ROW_BF16}")
            rows = (f"; against the loop in f32, row relative L2 max {r.max().item():.3e} mean "
                    f"{r.mean().item():.3e} (tol {TOL_ROW_BF16}), max abs "
                    f"{max_err(got, exact):.3e}; the bf16 loop's own row max "
                    f"{row_rel_err(want, exact).max().item():.3e}")
            del exact, r
        log(f"[kernels] cache_attention {what}: B={b} S={s} T={t} H={h} KV={kv} hd={d} "
            f"window={window} {str(dt)[6:]}: max_abs_err={e:.3e} (atol=rtol={tol}){rows}")
    q, k, v, q_pos, k_pos = ring_inputs(gen, torch.bfloat16, B, S, T, H, KV, hd)
    mask = ring_mask(q_pos, k_pos)
    pairs = int(mask.sum())
    ms = graph_ms(lambda: ca.cache_attention(q, k, v, q_pos, k_pos), 20)
    plain_ms = cuda_ms(lambda: ca.plain(q, k, v, q_pos, k_pos, block_k=1024), 3)
    qs, ks, vs = _sdpa_heads(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), H, KV)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = graph_ms(lambda: sdpa(qs, ks, vs, attn_mask=mask[:, None], enable_gqa=True), 20)
    moved = nbytes(q, k, v, q_pos, k_pos, q)  # the output is q's size
    b_ms, b_by = bound(moved, 4 * hd * H * pairs)
    split = graph_split_ms(lambda: ca.cache_attention(q, k, v, q_pos, k_pos), 5)
    log(f"[kernels] cache_attention llava-next prefill B={B} S={S} T={T} H={H} KV={KV} "
        f"hd={hd} bf16: kernel_ms={ms:.5f} (graph) plain_ms={plain_ms:.5f} sdpa_ms={lib_ms:.5f}"
        f" (graph, boolean mask) bound_ms={b_ms:.7f} ({b_by}: {pairs:,} visible pairs, "
        f"{4 * hd * H * pairs / 1e9:.2f} GFLOP, {moved / 1e6:.2f} MB); one launch a call; by "
        f"launch (graph, profiler): "
        + (", ".join(f"{k} {v:.5f} ms" for k, v in split.items()) or "not measured"))
    for kernel, line in ptxas_lines():
        if kernel.startswith("cache_"):
            log(f"[kernels] {kernel} (ptxas): {line}")
    return dict(name="cache_attention", of="lax.scan",
                source="src/repro_torch/kernels/csrc/cache_attention.cu", replaces=CACHE_SITE,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


NR_SITE = "src/repro/serving/paged_model.py::_paged_block (XLA's fusions; no pallas_call)"


def check_norm_rope(nr, gen) -> list:
    """Phase 3, the paged block's fused chains (``kernels/norm_rope.py``,
    replacing no TPU kernel): ``rope_write`` and ``rms_norm`` (with the
    residual add) against their plain versions at yi-6b's and granite-moe's
    heads and widths over the benchmark's calls (decode steps of 320 and
    512 lanes, a 4,000-token prefill, a 2 x 64 chunk at position 100), in
    bf16 and float32: q, k, the K pages and the norm within one bf16 ulp
    (float32 1e-6), the V pages bit for bit but for scratch page 0, where
    idle lanes race. Timed in bf16: the kernel by CUDA graph, the plain
    chain eagerly, ``F.rms_norm`` by graph as the norm's yardstick; the
    bound each byte in and out once at 3.35 TB/s. Returns the two rows (each
    kernel at yi-6b's prefill)."""
    from torch_norm_rope_cases import NR_CALLS, NR_MODELS, norm_case, rope_case, within_one_ulp

    sdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    err = {"rope_write": 0.0, "rms_norm": 0.0}
    ulps = dict(err)
    rows = {}
    for model in NR_MODELS:
        for call in NR_CALLS:
            for dname, dt in sdt.items():
                q, k, v, pos, inv, bt, kp, vp = rope_case(gen, "cuda", model, call, dt)
                x, r, sc = norm_case(gen, "cuda", model, call, dt)
                want_kp, want_vp = kp.clone(), vp.clone()
                want = nr.plain_rope_write(q, k, v, pos, inv, bt, want_kp, want_vp)
                got = nr.rope_write(q, k, v, pos, inv, bt, kp, vp)
                what = f"rope_write {model} {call} {dname}"
                ulps["rope_write"] = max(ulps["rope_write"],
                                         within_one_ulp(what + " q", got[0], want[0]),
                                         within_one_ulp(what + " k", got[1], want[1]),
                                         within_one_ulp(what + " k pages", kp[1:], want_kp[1:]))
                e = max(max_err(got[0], want[0]), max_err(got[1], want[1]),
                        max_err(kp[1:], want_kp[1:]))  # page 0: the idle lanes' race
                if not (torch.equal(vp[1:], want_vp[1:])
                        and torch.equal(vp[0, :, 1:], want_vp[0, :, 1:])):
                    raise AssertionError(f"{what}: V pages differ from the plain version's")
                err["rope_write"] = max(err["rope_write"], e)
                s, y = nr.rms_norm(x, sc, residual=r)
                want_s, want_y = nr.plain_rms_norm(x, sc, residual=r)
                if not torch.equal(s, want_s):
                    raise AssertionError(f"rms_norm {model} {call} {dname}: the residual sum "
                                         "differs from the plain add")
                y1, want_y1 = nr.rms_norm(x, sc), nr.plain_rms_norm(x, sc)
                ulps["rms_norm"] = max(ulps["rms_norm"],
                                       within_one_ulp(f"rms_norm {model} {call} {dname}", y,
                                                      want_y),
                                       within_one_ulp(f"rms_norm {model} {call} {dname} (no "
                                                      f"residual)", y1, want_y1))
                err["rms_norm"] = max(err["rms_norm"], max_err(y, want_y), max_err(y1, want_y1))
            q, k, v, pos, inv, bt, kp, vp = rope_case(gen, "cuda", model, call, torch.bfloat16)
            x, r, sc = norm_case(gen, "cuda", model, call, torch.bfloat16)
            args = (q, k, v, pos, inv, bt, kp, vp)
            B, S = pos.shape
            moved = nbytes(q, q, k, k, v, pos, inv) + 2 * nbytes(k) + 4 * B * S  # + a table entry
            ms = graph_ms(lambda: nr.rope_write(*args), 20)
            plain_ms = cuda_ms(lambda: nr.plain_rope_write(*args), 5)
            b_ms, b_by = bound(moved, 0)
            log(f"[kernels] rope_write {model} {call} bf16: kernel_ms={ms:.5f} (graph) "
                f"plain_ms={plain_ms:.5f} bound_ms={b_ms:.7f} ({b_by}: {moved / 1e6:.3f} MB); "
                f"{ms / plain_ms:.4f} of the plain chain's time, {100 * b_ms / ms:.1f}% of the "
                f"bound")
            if (model, call) == ("yi_6b", "prefill4000"):
                rows["rope_write"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                          bound_by=b_by, library_ms=None)
            D = x.shape[-1]
            moved = nbytes(x, r, sc, x, x)
            ms = graph_ms(lambda: nr.rms_norm(x, sc, residual=r), 20)
            plain_ms = cuda_ms(lambda: nr.plain_rms_norm(x, sc, residual=r), 5)
            lib_ms = graph_ms(lambda: torch.nn.functional.rms_norm(x + r, (D,), sc, 1e-6), 20)
            b_ms, b_by = bound(moved, 0)
            log(f"[kernels] rms_norm (+ residual) {model} {call} bf16 D={D}: kernel_ms="
                f"{ms:.5f} (graph) plain_ms={plain_ms:.5f} F.rms_norm_ms={lib_ms:.5f} (graph, "
                f"the add and the norm) bound_ms={b_ms:.7f} ({b_by}: {moved / 1e6:.3f} MB); "
                f"{100 * b_ms / ms:.1f}% of the bound")
            if (model, call) == ("yi_6b", "prefill4000"):
                rows["rms_norm"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                        library_ms=lib_ms)
    log(f"[kernels] norm_rope: largest difference from the plain versions in bf16 ulps "
        f"(float32: 1e-6 of the largest value) {ulps}; max abs err {err}")
    for kernel, line in ptxas_lines():
        if kernel.startswith(("rms_norm", "rope_write")):
            log(f"[kernels] {kernel} (ptxas): {line}")
    return [dict(name=name, of="fusion", source="src/repro_torch/kernels/csrc/norm_rope.cu",
                 replaces=NR_SITE, max_abs_err=err[name], **rows[name])
            for name in ("rms_norm", "rope_write")]


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


def small_reference(seed: int, arch: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine

    cfg = get_config(arch, smoke=True)
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
    log(f"[reference] {cfg.name} f32 engine, 6 requests x 8 tokens: card "
        f"(kernels) token-identical to CPU (plain versions)")


def _to_device(tree, device, dtype=None):
    """A copy of a tree of dicts, tuples and NamedTuples on ``device``;
    with ``dtype``, its floating leaves in that dtype."""
    from repro_torch.tree import tree_map

    def leaf(x):
        if dtype is not None and x.is_floating_point():
            return x.to(device, dtype)
        return x.to(device)

    return tree_map(leaf, tree)


def main_path(seed: int, kernels: dict, nr, arch: str) -> dict:
    """Serve 16 requests on ``arch`` at full width and depth; return the
    kernels' launch counts of this run alone, the paged block's fused
    chains (``nr``, ``kernels/norm_rope.py``) among them."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.paged_model import paged_forward

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    moe = (f" experts={cfg.num_experts}x{cfg.expert_d_ff} top-{cfg.num_experts_per_tok}"
           if "moe" in cfg.block_pattern else "")
    log(f"[serve] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"H={cfg.num_heads} KV={cfg.num_kv_heads} hd={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff}{moe} vocab={cfg.vocab_size} {cfg.dtype}; "
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
    nr.launches.update(dict.fromkeys(nr.KERNELS, 0))
    t0 = time.perf_counter()
    uids = eng.submit_many(prompts, max_new_tokens=new_tokens)
    done = eng.run_until_idle(max_steps=2000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: mod.launches for name, mod in kernels.items()} | nr.launches
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
    per_call = kernels["paged_attention"].launches_per_call(eng.pps, eng.page_size)
    if launches["paged_attention"] != per_call * n_dec * cfg.num_layers:
        raise AssertionError(f"paged launches {launches['paged_attention']} != "
                             f"{per_call} a call x {n_dec} decode steps x "
                             f"{cfg.num_layers} layers")
    if launches["flash_attention"] != n_pre * cfg.num_layers:
        raise AssertionError(f"flash launches {launches['flash_attention']} != "
                             f"{n_pre} prefills x {cfg.num_layers}")
    calls, n_layers = n_dec + n_pre, cfg.num_layers
    if (launches["rms_norm"], launches["rope_write"]) != ((2 * n_layers + 1) * calls,
                                                          n_layers * calls):
        raise AssertionError(f"rms_norm/rope_write launches {launches['rms_norm']}/"
                             f"{launches['rope_write']} != (2 x {n_layers} + 1)/{n_layers} "
                             f"a forward x {calls} forwards")
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
    steps = 4
    avgs = profile_decode(eng, cfg, rng, steps)
    per_step = sum(e.count for e in avgs if e.key == "cudaLaunchKernel") / steps
    log(f"[profile] cudaLaunchKernel per decode step: {per_step:.1f}")
    if moe:
        # the expert products are the block's torch.bmm calls (nothing else
        # on the serving path runs bmm); a decode step reads every expert
        bmm_ms = sum(_device_us(e) for e in avgs if e.key == "aten::bmm") / 1e3 / steps
        weights = 3 * cfg.num_experts * cfg.d_model * cfg.expert_d_ff * 2 * cfg.num_layers
        log(f"[profile] expert products (aten::bmm) {bmm_ms:.4f} ms a decode step; "
            f"expert weights {weights / 1e9:.3f} GB a step, bound "
            f"{weights / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return launches


# ---------------------------------------------------------------------------
# phase 6: the device CMP queue
# ---------------------------------------------------------------------------


def fifo_churn(seed: int, kernels: dict, n: int, rounds: int):
    """FIFO churn on an n-slot pool, card against CPU every round; strict
    FIFO and the pool invariants checked. Returns the card's pool and the
    kernels' launches of this churn alone (one claim launch a round)."""
    from repro_torch.core import slotpool

    window = 128
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
                raise AssertionError(f"device queue N={n} round {r}: output {i} differs "
                                     f"between card and CPU")
        cycle, ids, valid = (outs["cpu"][i] for i in (0, 3, 4))
        claimed += cycle[ids[valid].long()].tolist()
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in kernels.items()}
    if launches["cmp_claim"] != rounds:  # one launch a claim
        raise AssertionError(f"cmp_claim launches {launches['cmp_claim']} != "
                             f"{rounds} claims at N={n}")
    if len(claimed) < rounds or any(b <= a for a, b in zip(claimed, claimed[1:])):
        raise AssertionError(f"N={n}: claimed cycles are not strictly ascending (FIFO)")
    pool = pools["cuda"]
    slotpool.check_invariants(pool, window)
    log(f"[queue] N={n} window={window}: {rounds} rounds of produce/claim/advance/"
        f"reclaim (k in [1, 64]), card == CPU every round; {len(claimed)} claims in "
        f"strictly ascending cycle order; invariants hold; {slotpool.counts(pool)}; "
        f"launches {launches}")
    return pool, launches


def device_queue(seed: int, kernels: dict) -> dict:
    """FIFO churns at the JAX package's claim tile (2,048 slots: its
    single-block kernel) and on a 65,536-slot pool (its tiled kernel and
    merge), card against CPU every round; then the rate of
    ``slotpool.claim`` on the card at 65,536. Returns the claim kernel's
    launches of each churn, by the JAX call site its pool size reaches."""
    from repro_torch.core import slotpool
    from repro_torch.kernels import cmp_claim

    _, small = fifo_churn(seed, kernels, JAX_TILE, 200)
    n = 65536
    pool, large = fifo_churn(seed, kernels, n, 500)
    launches = {"cmp_claim": small["cmp_claim"], "cmp_claim_tiled": large["cmp_claim"]}
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
    def pool_claim():
        cmp_claim.claim_pool(pool.state, pool.cycle, pool.retire_cycle,
                             pool.deque_cycle, k=k)

    kernel_ms, eager_ms = graph_ms(pool_claim, 200), cuda_ms(pool_claim, 200)
    log(f"[queue] slotpool.claim k={k} on the card: {n_claims / wall:.1f} claims/s "
        f"({wall / calls * 1e3:.5f} ms a call, host clock); its kernel (claim_pool) "
        f"{kernel_ms:.5f} ms a call (graph), {eager_ms:.5f} eager")
    held = [pool]

    def one_claim():
        held[0], _, _ = slotpool.claim(held[0], k)

    steps = 50
    avgs = profile_steps(one_claim, steps, f"{steps} slotpool.claim calls (k={k}, N={n})")
    per_call = sum(e.count for e in avgs if e.key == "cudaLaunchKernel") / steps
    log(f"[profile] cudaLaunchKernel per slotpool.claim: {per_call:.2f}")
    if per_call > 2:
        raise AssertionError(f"slotpool.claim issues {per_call} kernel launches a call")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the serve driver at glm4-9b's full width
# ---------------------------------------------------------------------------

DRIVER_FLAGS = ["--arch", "glm4-9b", "--multitenant", "--policy", "wfq", "--replicas", "2",
                "--device-admission", "--requests", "9", "--max-new", "8"]


class ForwardCounts:
    """Counts the forward calls of the engines that phase 7 makes, by the
    kernel each one runs: a prompt from position 0 runs flash, a decode or
    a prefill past position 0 runs the paged kernel. The driver's and
    ``Fabric``'s engines take no ``forward_fn``, so their default forward
    calls ``repro_torch.serving.engine.paged_forward``; while in use, that
    name is a counting wrapper of it."""

    def __init__(self, kernels: dict):
        from repro_torch.serving import engine

        self.engine, self.real, self.kernels = engine, engine.paged_forward, kernels
        self.calls = []  # (kind, pps, page, attention layers) a forward call

    def __enter__(self):
        def counted(p, t, cfg, kp, vp, bt, sl):
            flash = t.shape[1] > 1 and not bool(sl.any())
            self.calls.append(("flash" if flash else "paged", bt.shape[1], kp.shape[3],
                               kp.shape[0]))
            return self.real(p, t, cfg, kp, vp, bt, sl)

        self.engine.paged_forward = counted
        return self

    def __exit__(self, *exc):
        self.engine.paged_forward = self.real

    def check(self, what: str, launches: dict, ring: bool = True) -> None:
        """The paged and flash launches of this run against its forward
        calls: launches_per_call(pps, page) x layers a paged call, one
        flash launch a layer a prompt; with ``ring``, the admission ring
        ran, else it did not (device admission off)."""
        per_call = self.kernels["paged_attention"].launches_per_call
        want_paged = sum(per_call(pps, page) * layers
                         for kind, pps, page, layers in self.calls if kind == "paged")
        want_flash = sum(layers for kind, _, _, layers in self.calls if kind == "flash")
        n_paged = sum(kind == "paged" for kind, *_ in self.calls)
        if (launches["paged_attention"], launches["flash_attention"]) != (want_paged,
                                                                          want_flash):
            raise AssertionError(f"{what}: paged/flash launches "
                                 f"{launches['paged_attention']}/"
                                 f"{launches['flash_attention']} != {want_paged}/"
                                 f"{want_flash} from {n_paged} paged and "
                                 f"{len(self.calls) - n_paged} flash forward calls")
        if (launches["cmp_ring"] >= 1) != ring:
            raise AssertionError(f"{what}: the admission ring kernel ran "
                                 f"{launches['cmp_ring']} times (device admission "
                                 f"{'on' if ring else 'off'})")
        log(f"[driver] {what}: launches {launches} = {n_paged} paged forward calls x "
            f"launches_per_call x layers and {len(self.calls) - n_paged} flash prompts "
            f"x layers")


def counted_run(what: str, kernels: dict, run, ring: bool = True):
    """``run()`` with the kernels' counts set to 0 just before it and read
    just after, held to its forward calls (``ring`` as in
    :meth:`ForwardCounts.check`); returns (its result, launches)."""
    torch.cuda.synchronize()
    for mod in kernels.values():
        mod.launches = 0
    with ForwardCounts(kernels) as counts:
        out = run()
    torch.cuda.synchronize()
    launches = {name: mod.launches for name, mod in kernels.items()}
    counts.check(what, launches, ring)
    return out, launches


def _driver_run(serve, argv: list, card: str, vocab: int) -> dict:
    """One call of the port's serve driver on the card: wall seconds,
    generated tokens and peak device memory around it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = serve.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    runs = out["layouts"] if "layouts" in out else {"run": out["run"]}
    steps = out["steps"] if "layouts" in out else {"run": out["steps"]}
    completed = gen_tokens = 0
    for uids, _, done, _ in runs.values():
        if any(u not in done for u in uids) or len(uids) != 9:
            raise AssertionError(f"driver {' '.join(argv)}: a request was not admitted "
                                 f"or not completed")
        for u in uids:
            toks = done[u].output
            if len(toks) != 8 or not all(0 <= t < vocab for t in toks):
                raise AssertionError(f"driver: request {u} has a bad output {toks}")
        completed += len(uids)
        gen_tokens += sum(len(done[u].output) for u in uids)
    log(f"[driver] {' '.join(argv)}: {completed} requests completed, group steps "
        f"{steps}; wall {wall:.3f}s, {gen_tokens / wall:.2f} generated tokens/s; peak "
        f"device memory {peak_gb:.3f} GB ({card})")
    return dict(out=out, peak_gb=peak_gb)


def serve_driver(seed: int, kernels: dict, card: str) -> dict:
    """Phase 7: the port's serve driver and Fabric at glm4-9b's full width
    and depth; returns the serving kernels' launches of this phase, the sum
    of its three runs, each held to its own forward calls."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve

    cfg = get_config("glm4-9b")
    params_gb = 2 * 9.4  # glm4-9b in bf16: 9.40B parameters, 18.8 GB
    total = dict.fromkeys(kernels, 0)
    # the layout check: 2 replicas over 2 simulated hosts against one host
    argv = DRIVER_FLAGS + ["--hosts", "2", "--verify-single-host"]
    run, launches = counted_run("--verify-single-host", kernels,
                                lambda: _driver_run(serve, argv, card, cfg.vocab_size))
    if run["peak_gb"] > 1.5 * params_gb:
        raise AssertionError(f"peak {run['peak_gb']:.1f} GB: the replicas or the two "
                             f"layouts held more than one copy of the weights")
    for name, n in launches.items():
        total[name] += n
    argv = DRIVER_FLAGS + ["--page-size", "128"]
    _, launches = counted_run("--page-size 128", kernels,
                              lambda: _driver_run(serve, argv, card, cfg.vocab_size))
    for name, n in launches.items():
        total[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    _, launches = counted_run("crash/resume", kernels, lambda: crash_resume(seed, cfg, serve))
    for name, n in launches.items():
        total[name] += n
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"[driver] serving kernels' launches in phase 7: {total} ({card})")
    return total


def crash_resume(seed: int, cfg, serve) -> None:
    """Crash and resume through the Fabric API at glm4-9b's full width: an
    uninterrupted run, then a run with a cadence checkpoint every 4 steps
    dropped after step 10 and restored with the same weights; every
    admitted request completes once, token-identical to the first run."""
    import dataclasses
    import shutil

    from repro_torch.fabric import Fabric
    from repro_torch.models import init_params, param_count

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    torch.cuda.synchronize()
    log(f"[driver] {cfg.name}: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"H={cfg.num_heads} KV={cfg.num_kv_heads} hd={cfg.resolved_head_dim} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}; "
        f"{param_count(params) / 1e9:.3f}B params made in {time.perf_counter() - t0:.1f}s")
    args = serve.build_parser().parse_args(DRIVER_FLAGS)
    config = serve.config_from_args(args)
    ck = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase7_ckpt")
    shutil.rmtree(ck, ignore_errors=True)

    def submit_wave(fab):
        uids = []
        for i in range(9):
            prompt = [(7 * i + j) % (cfg.vocab_size - 1) + 1 for j in range(3 + i % 5)]
            uids.append(fab.submit(prompt, max_new_tokens=8, qclass=serve.TENANTS[i % 3]))
        if None in uids:
            raise AssertionError("a request of the wave was not admitted")
        return uids

    fab = Fabric.open(config, params=params)
    uids = submit_wave(fab)
    ref = {u: r.output for u, r in fab.drain(max_steps=500).items()}
    fab.close()
    fab = Fabric.open(dataclasses.replace(config, checkpoint_dir=ck,
                                          checkpoint_every_n_steps=4), params=params)
    if submit_wave(fab) != uids:
        raise AssertionError("the two runs gave the wave different uids")
    at_ckpt = {}  # step of each cadence checkpoint -> requests completed by then
    for _ in range(10):
        fab.step()
        if fab.step_count % 4 == 0:
            at_ckpt[fab.step_count] = {u: r.output for u, r in fab.completed.items()}
    fab.flush_checkpoints()
    del fab  # the crash: the session is dropped without close()
    gc.collect()
    fab = Fabric.restore(ck, params=params)
    step = fab.step_count
    if step not in at_ckpt:
        raise AssertionError(f"restored at step {step}, not at a cadence checkpoint")
    before = at_ckpt[step]
    after = {u: r.output for u, r in fab.drain(max_steps=500).items()}
    fab.close()
    if set(before) & set(after) or set(before) | set(after) != set(uids):
        raise AssertionError(f"crash/resume: completed {sorted(before)} by the checkpoint, "
                             f"{sorted(after)} after restore, of {uids}")
    for u in uids:
        got = before.get(u, after.get(u))
        if got != ref[u]:
            raise AssertionError(f"crash/resume: request {u} gave {got}, uninterrupted "
                                 f"{ref[u]}")
    log(f"[driver] crash/resume (cadence 4, dropped after step 10, restored at step "
        f"{step}): {len(before)} requests completed by the checkpoint, {len(after)} after "
        f"restore, each once; all {len(uids)} token-identical to an uninterrupted run")
    shutil.rmtree(ck, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

# lr 1e-5, not the driver's default 1e-3: with 5 warmup steps the first AdamW
# steps move every weight by about lr, and at Yi-6B's width that outgrows its
# scaled output projections (0.02 / 8); the loss rose over 8 steps at 1e-3,
# 3e-4, 1e-4 and 3e-5 and fell at 1e-5 and 3e-6 (PERF.md). The same
# arithmetic in bf16 falls at 1e-3 on the narrower model of train_reference_bf16.
TRAIN_FLAGS = ["--arch", "yi-6b", "--steps", "8", "--batch", "2", "--seq", "512",
               "--producers", "2", "--lr", "1e-5", "--device", "cuda"]
MID = dict(d_model=1024, num_layers=4, num_heads=8, num_kv_heads=1, d_ff=2752)
TRAIN_BF16_TOL = 2e-2   # atol on bf16 losses: a last-bit f32 difference can round
                        # a bf16 param the other way (measured <= 3e-3 at 8 layers)
TRAIN_LOSS_TOL = 1e-5   # atol = rtol, card against CPU in f32: sums in another order
TRAIN_PARAM_TOL = 1e-4  # AdamW's per-element division carries a last-bit difference
                        # to a few ulps of lr (1e-3) a step; a wrong update moves ~lr


class TimedStep:
    """CUDA events and host-clock stamps around the forward (``loss_fn``)
    and the update (``apply_updates``) of each train step run while in use;
    ``train_loop`` calls both through their modules, so the driver's
    trainer calls these wrappers. The backward runs between the two."""

    def __init__(self):
        from repro_torch.models import model
        from repro_torch.training import optimizer

        self.targets = [(model, "loss_fn"), (optimizer, "apply_updates")]
        self.real = [getattr(mod, name) for mod, name in self.targets]
        self.stamps = [[], []]  # a step's (event, host s) at each call's start and end

    def _stamp(self, i: int) -> None:
        evt = torch.cuda.Event(enable_timing=True)
        evt.record()
        self.stamps[i].append((evt, time.perf_counter()))

    def __enter__(self):
        def stamped(i, fn):
            def call(*args, **kwargs):
                self._stamp(i)
                out = fn(*args, **kwargs)
                self._stamp(i)
                return out
            return call

        for i, ((mod, name), fn) in enumerate(zip(self.targets, self.real)):
            setattr(mod, name, stamped(i, fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.real):
            setattr(mod, name, fn)

    def split(self) -> dict:
        """Per step after the first: the forward, backward and optimizer's
        device ms (events) and the host's ms to enqueue each (clock)."""
        fwd, opt = self.stamps
        out = {k: [] for k in ("forward", "backward", "optimizer", "host forward",
                               "host backward", "host optimizer")}
        for i in range(1, len(fwd) // 2):
            f0, f1, o0, o1 = fwd[2 * i], fwd[2 * i + 1], opt[2 * i], opt[2 * i + 1]
            for name, (a, b) in (("forward", (f0, f1)), ("backward", (f1, o0)),
                                 ("optimizer", (o0, o1))):
                out[name].append(a[0].elapsed_time(b[0]))
                out["host " + name].append((b[1] - a[1]) * 1e3)
        return {k: sum(v) / len(v) for k, v in out.items()}


def _trainer_from(cfg, opt, params, device, **kw):
    """A Trainer on ``device`` that starts from a copy of ``params``."""
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_loop import Trainer

    tr = Trainer(cfg, opt, device=device, **kw)
    tr.params = O.tree_unflatten(params, iter([p.to(device, copy=True)
                                               for p in O.tree_leaves(params)]))
    tr.opt_state = O.init(tr.params, opt)
    return tr


def train_reference(seed: int, arch: str) -> None:
    """Phase 8 (a): 6 steps of the smoke config in float32 on the card and
    on the CPU from the same params; then 4 steps with a checkpoint at step
    4, a fresh trainer (another seed) restored from it and 2 more steps on
    the card, equal to the uninterrupted card run."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_loop import Trainer

    cfg = get_config(arch, smoke=True)
    opt = O.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    batches = [synth_batch(seed, i, 2, 16, cfg.vocab_size) for i in range(6)]
    init = Trainer(cfg, opt, seed=seed, device="cpu").params
    cpu, gpu = (_trainer_from(cfg, opt, init, device) for device in ("cpu", "cuda"))
    for tr in (cpu, gpu):
        tr.fit(iter(batches), 6)
    loss_err = max(abs(a - b) for a, b in zip(gpu.history, cpu.history))
    param_err = max(max_err(a.cpu(), b) for a, b in zip(O.tree_leaves(gpu.params),
                                                        O.tree_leaves(cpu.params)))
    if not np.allclose(gpu.history, cpu.history, atol=TRAIN_LOSS_TOL, rtol=TRAIN_LOSS_TOL):
        raise AssertionError(f"{cfg.name} training: card losses {gpu.history} != CPU "
                             f"{cpu.history}")
    for a, b in zip(O.tree_leaves(gpu.params), O.tree_leaves(cpu.params)):
        if not torch.allclose(a.cpu(), b, atol=TRAIN_PARAM_TOL, rtol=TRAIN_PARAM_TOL):
            raise AssertionError(f"{cfg.name} training: card params differ from the CPU's "
                                 f"(max abs err {param_err})")
    ck = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "phase8_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    part = _trainer_from(cfg, opt, init, "cuda", ckpt_dir=ck, ckpt_every=4)
    part.fit(iter(batches[:4]), 4)
    part.async_ckpt.close()
    resumed = Trainer(cfg, opt, ckpt_dir=ck, ckpt_every=100, seed=seed + 999, device="cuda")
    if not resumed.try_restore() or resumed.step != 4:
        raise AssertionError(f"{cfg.name}: no checkpoint at step 4 to resume from")
    resumed.fit(iter(batches[4:]), 2)
    resumed.async_ckpt.close()
    resume_err = max(max_err(a, b) for a, b in zip(O.tree_leaves(resumed.params),
                                                   O.tree_leaves(gpu.params)))
    if resume_err > 1e-6 or resumed.history != gpu.history[4:]:
        raise AssertionError(f"{cfg.name}: resumed run differs from the uninterrupted one "
                             f"(params max abs err {resume_err}, losses {resumed.history} "
                             f"vs {gpu.history[4:]})")
    shutil.rmtree(ck, ignore_errors=True)
    log(f"[train] {cfg.name} f32, 6 steps: card losses {[round(x, 6) for x in gpu.history]} "
        f"within {TRAIN_LOSS_TOL} of the CPU's (max abs err {loss_err:.3e}), params within "
        f"{TRAIN_PARAM_TOL} (max abs err {param_err:.3e}); resumed at step 4 on the card: "
        f"params max abs err {resume_err:.3e} to the uninterrupted run, losses equal")


def train_reference_bf16(seed: int) -> None:
    """Phase 8 (a), bf16: Yi-6B's heads (hd 128) and vocabulary at d_model
    1,024 and 4 layers in bfloat16 with remat, 6 steps at the driver's lr
    1e-3 on the card and on the CPU from the same params: the losses agree
    within TRAIN_BF16_TOL and fall."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import Trainer

    cfg = dataclasses.replace(get_config("yi-6b"), name="yi-6b-mid", **MID)
    opt = OptConfig(lr=1e-3, warmup_steps=5, total_steps=6)
    batches = [synth_batch(seed, i, 2, 128, cfg.vocab_size) for i in range(6)]
    t0 = time.perf_counter()
    cpu = Trainer(cfg, opt, seed=seed, device="cpu")
    gpu = _trainer_from(cfg, opt, cpu.params, "cuda")
    for tr in (gpu, cpu):
        tr.fit(iter(batches), 6)
    err = max(abs(a - b) for a, b in zip(gpu.history, cpu.history))
    log(f"[train] {cfg.name} bf16 (d_model {cfg.d_model}, {cfg.num_layers} layers, vocab "
        f"{cfg.vocab_size}), 6 steps at lr 1e-3: card {[round(x, 4) for x in gpu.history]}, "
        f"CPU {[round(x, 4) for x in cpu.history]}, max abs err {err:.3e} "
        f"(atol {TRAIN_BF16_TOL}); {time.perf_counter() - t0:.1f}s")
    if err > TRAIN_BF16_TOL:
        raise AssertionError(f"{cfg.name}: bf16 training on the card differs from the CPU")
    if sum(gpu.history[-2:]) / 2 >= gpu.history[0]:
        raise AssertionError(f"{cfg.name}: the bf16 loss did not fall ({gpu.history})")


def train_driver(card: str, flags: list) -> list:
    """Phase 8 (b): the port's train driver at Yi-6B's full width and depth
    in bfloat16 (remat as its config has it), 8 steps of 2 x 512 tokens;
    prints what the steps took and returns the losses."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config("yi-6b")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    total = torch.cuda.get_device_properties(0).total_memory
    with TimedStep() as timed:
        t0 = time.perf_counter()
        out = train.main(flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses, secs = out["losses"], out["step_seconds"]
    B, S, L = 2, 512, cfg.num_layers
    tokens = B * S
    # parameters that take part in products: all but the embedding table (a
    # gather) and the norm scales
    n_mm = out["params"] - cfg.vocab_size * cfg.d_model - (2 * L + 1) * cfg.d_model
    attn = 12 * L * cfg.num_heads * cfg.resolved_head_dim * S * S * B  # fwd + bwd, S x T
    flops = 6 * n_mm * tokens + attn
    step_s = sum(secs[1:]) / len(secs[1:])
    split = timed.split()
    log(f"[train] {cfg.name}: {L} layers d_model={cfg.d_model} H={cfg.num_heads} "
        f"KV={cfg.num_kv_heads} d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.dtype}, "
        f"remat={cfg.remat}; {out['params']:,} params; {' '.join(flags)}; driver wall "
        f"{wall:.3f}s")
    log(f"[train] losses {[round(x, 4) for x in losses]} (ln V = {np.log(cfg.vocab_size):.4f})")
    log(f"[train] steps 2-8: {step_s * 1e3:.3f} ms a step (min {min(secs[1:]) * 1e3:.3f}, "
        f"max {max(secs[1:]) * 1e3:.3f}; step 1 {secs[0] * 1e3:.3f}), {tokens / step_s:.2f} "
        f"trained tokens/s")
    log("[train] a step's device ms (CUDA events) and the host's ms to enqueue it: " +
        ", ".join(f"{k} {split[k]:.3f} (host {split['host ' + k]:.3f})"
                  for k in ("forward", "backward", "optimizer")))
    log(f"[train] model FLOPs a step {flops:.4e} (6 x {n_mm:,} x {tokens} + attention "
        f"{attn:.4e}, no remat recompute): {flops / step_s / 1e12:.2f} TFLOP/s, "
        f"{flops / step_s / BF16_FLOP_PER_S:.4f} of the {BF16_FLOP_PER_S / 1e12:.0f} "
        f"TFLOP/s bf16 peak")
    log(f"[train] peak device memory {peak / 1e9:.3f} GB of {total / 1e9:.3f} GB ({card})")
    if len(losses) != 8 or not all(np.isfinite(losses)):
        raise AssertionError(f"full-width training: losses {losses}")
    return losses


def check_falls(losses: list, vocab: int) -> None:
    """The first loss near ln(vocab) (0.02-scaled heads on unit-RMS inputs
    give logits of std ≈ 0.02·sqrt(d_model)), and the mean of the last two
    below it."""
    if abs(losses[0] - np.log(vocab)) > 1.5:
        raise AssertionError(f"full-width training: first loss {losses[0]:.4f} is not "
                             f"within 1.5 of ln({vocab})")
    if sum(losses[-2:]) / 2 >= losses[0]:
        raise AssertionError(f"full-width training: the loss did not fall ({losses})")


def profile_train_step(seed: int) -> None:
    """Where a full-width step's time goes: a fresh Yi-6B trainer (weights
    from ``seed``) takes one step, then one under ``torch.profiler``."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.train_loop import Trainer

    cfg = get_config("yi-6b")
    gc.collect()
    torch.cuda.empty_cache()
    tr = Trainer(cfg, OptConfig(lr=1e-5, warmup_steps=5, total_steps=8), seed=seed)
    batches = iter([synth_batch(seed, i, 2, 512, cfg.vocab_size) for i in range(2)])
    tr.fit(batches, 1)
    avgs = profile_steps(lambda: tr.fit(batches, 1), 1, f"one {cfg.name} train step")
    launches = sum(e.count for e in avgs if e.key == "cudaLaunchKernel")
    log(f"[profile] cudaLaunchKernel a train step: {launches}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()


def training(seed: int, kernels: dict, card: str) -> None:
    """Phase 8: the smoke references, then the full-width driver; the
    serving kernels' launch counters may not move."""
    before = {name: mod.launches for name, mod in kernels.items()}
    for arch in SERVED:
        train_reference(seed, arch)
    train_reference_bf16(seed)
    from repro_torch.configs import get_config

    check_falls(train_driver(card, TRAIN_FLAGS), get_config("yi-6b").vocab_size)
    default_lr = [f for f in TRAIN_FLAGS if f not in ("--lr", "1e-5")]
    log("[train] the same at the driver's default lr 1e-3 (its loss is not checked to "
        "fall; see TRAIN_FLAGS):")
    train_driver(card, default_lr)
    profile_train_step(seed)
    after = {name: mod.launches for name, mod in kernels.items()}
    log(f"[train] serving kernels' launch counters before phase 8 {before}, after {after}")
    if after != before:
        raise AssertionError("a serving kernel launched on the training path")
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 9: the SSM, hybrid and frontend families
# ---------------------------------------------------------------------------

FAMILIES = ("xlstm_125m", "hymba_1_5b", "llava_next", "musicgen_large")
FAMILY_TOL = 1e-5  # atol = rtol, card against CPU in f32: sums in another order
# each family's train-driver run: 8 steps of B=2 x (seq, lr); xlstm-125m's
# time loops run as the scan kernels, and at lr 1e-5 its loss moves less
# than its step-to-step noise, so it trains at lr 1e-4
FAMILY_TRAIN = {"xlstm_125m": (512, "1e-4"), "hymba_1_5b": (512, "1e-5")}
TRAIN_STEPS = 8
DECODE_NOISE = 2  # decode vs apply, in units of apply's own bf16 error (family_decode)


def _hold(what: str, got, want, tol: float) -> float:
    """Every leaf of ``got`` (card) within atol = rtol = ``tol`` of
    ``want`` (CPU), infinities in the same places; the largest error."""
    from repro_torch.tree import tree_leaves

    errs = [0.0]
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        a = a.detach().cpu()
        if not torch.allclose(a.float(), b.detach().float(), atol=tol, rtol=tol):
            raise AssertionError(f"{what}: card differs from the CPU "
                                 f"(max abs err {max_err(a, b.detach())})")
        fin = torch.isfinite(b.detach().float())
        if fin.any():
            errs.append(max_err(a[fin], b.detach()[fin]))
    return max(errs)


def family_reference(seed: int, arch: str) -> None:
    """Phase 9 (a): the smoke config in float32 from the same weights on
    the card and on the CPU: ``apply`` logits, the loss and every gradient,
    ``prefill`` + 4 ``decode_step`` logits and the final cache."""
    from repro_torch.configs import get_config
    from repro_torch.models import apply, decode_step, init_cache, init_params, loss_fn, prefill
    from repro_torch.models.frontends import audio_frame_tokens, vision_patch_embeds
    from repro_torch.training import optimizer as O

    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(seed)
    params = {"cpu": init_params(cfg, gen, "cpu")}
    params["cuda"] = _to_device(params["cpu"], "cuda")
    B, S = 2, 12
    if cfg.frontend == "audio":
        tokens = audio_frame_tokens(cfg, B, S + 1, gen, device="cpu")
    else:
        tokens = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen,
                               dtype=torch.int32)
    extra = (vision_patch_embeds(cfg, B, 3, gen, device="cpu")
             if cfg.frontend == "vision" else None)
    out = {}
    for dev in ("cpu", "cuda"):
        p = params[dev]
        t = tokens.to(dev)
        x = None if extra is None else extra.to(dev)
        with torch.no_grad():
            logits, _ = apply(p, t[:, :S], cfg, extra_embeds=x)
        live = [leaf.detach().requires_grad_(True) for leaf in O.tree_leaves(p)]
        batch = {"tokens": t} if x is None else {"tokens": t, "extra_embeds": x}
        loss, _ = loss_fn(O.tree_unflatten(p, iter(live)), batch, cfg)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            cache = init_cache(cfg, B, (0 if x is None else 3) + S + 4, device=dev)
            steps, cache = prefill(p, t[:, :8], cfg, cache, extra_embeds=x)
            steps = [steps]
            for i in range(8, S):
                lg, cache = decode_step(p, t[:, i:i + 1], cfg, cache)
                steps.append(lg)
        out[dev] = dict(logits=logits, loss=loss.detach(), grads=grads, decode=steps,
                        cache=cache)
    errs = {k: _hold(f"{cfg.name} {k}", out["cuda"][k], out["cpu"][k], FAMILY_TOL)
            for k in ("logits", "loss", "grads", "decode", "cache")}
    log(f"[family] {cfg.name} f32 card vs CPU (atol=rtol={FAMILY_TOL}), max abs err: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" ({len(out['cpu']['grads'])} gradient leaves"
        + (", 3 vision_patch_embeds" if extra is not None else "")
        + (", audio_frame_tokens" if cfg.frontend == "audio" else "") + ")")


def family_train(card: str, arch: str) -> None:
    """The port's train driver at ``arch``'s full width and depth in bf16,
    8 steps of 2 x ``FAMILY_TRAIN[arch]`` (seq, lr): the loss starts near
    ln(vocab) and falls."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    seq, lr = FAMILY_TRAIN[arch]
    out = train.main(["--arch", arch, "--steps", str(TRAIN_STEPS), "--batch", "2",
                      "--seq", str(seq), "--lr", lr])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses, secs = out["losses"], out["step_seconds"]
    step_s = sum(secs[1:]) / len(secs[1:])
    log(f"[family] {cfg.name} train driver: {out['params']:,} params, {cfg.dtype}, "
        f"remat={cfg.remat}; losses {[round(x, 4) for x in losses]} (ln V = "
        f"{np.log(cfg.vocab_size):.4f}); steps 2-8 {step_s * 1e3:.3f} ms a step (step 1 "
        f"{secs[0] * 1e3:.3f}), {2 * seq / step_s:.2f} trained tokens/s at B=2, S={seq}, "
        f"lr {lr}; wall {wall:.3f}s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({card})")
    if len(losses) != 8 or not all(np.isfinite(losses)):
        raise AssertionError(f"{cfg.name} training: losses {losses}")
    check_falls(losses, cfg.vocab_size)


def _events_ms(fn) -> tuple:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def family_decode(seed: int, arch: str, B: int, prompt: int, steps: int, ca,
                  n_extra: int = 0, check_pallas: bool = False,
                  two_chunks: bool = False) -> int:
    """Phase 9 (b)-(d): fresh bf16 weights at full width and depth; a
    ``prefill`` of ``n_extra`` vision_patch_embeds + ``prompt`` tokens, then
    ``steps`` ``decode_step``s fed the next tokens of the same sequence.
    Each decode logit is held to ``apply``'s at its position within
    DECODE_NOISE x the forward's own bf16 error, ``noise``: the largest
    |bf16 apply - f32 apply| over the same positions, the f32 model being
    the bf16 weights cast up: two bf16 computations of one function, each
    that far from the f32 one, are up to 2 x noise apart. A wrong position
    or slot moves a logit by several times its own scale (0.02 *
    sqrt(d_model), 0.55-1.3), well above it. With ``check_pallas`` the
    full forward through the flash kernel (``attention_impl="pallas"``) is
    held to the plain one the same way, over all positions, and each of its
    launches to the kernel's plain version on that launch's own inputs at
    phase 3's atol = rtol = 2e-2. ``ca`` is the ``cache_attention``
    module: the prefill's launches of its kernel are held to one a layer
    where the prefill takes ``chunked_cache_attention`` (``n_extra``: a
    ring longer than ``attn_chunk_kv``), else to none, and the first
    launch's output to the plain loop on that launch's own inputs at 2e-2.
    The prefill's own peak memory is read beside the run's. Returns the
    flash kernel's launches there (0 without)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention
    from repro_torch.models import apply, decode_step, init_cache, init_params, prefill
    from repro_torch.models import layers
    from repro_torch.models.frontends import vision_patch_embeds

    cfg = get_config(arch)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, "cuda")
    extra = vision_patch_embeds(cfg, B, n_extra, gen, device="cuda") if n_extra else None
    total = prompt + steps
    n_full = 2 * prompt if two_chunks else total  # the positions apply runs over
    tokens = torch.randint(0, cfg.vocab_size, (B, max(n_full, total)), generator=gen,
                           dtype=torch.int32, device="cuda")
    first = n_extra + prompt - 1  # the prefill's logit position
    with torch.no_grad():
        full, _ = apply(params, tokens[:, :n_full], cfg, extra_embeds=extra)
        ref = full[:, first:first + steps + 1]
        p32 = _to_device(params, "cuda", torch.float32)
        x32 = None if extra is None else extra.float()
        ref32, _ = apply(p32, tokens[:, :n_full], dataclasses.replace(cfg, dtype="float32"),
                         extra_embeds=x32)
        noise = max_err(ref, ref32[:, first:first + steps + 1])
        noise_all = max_err(full, ref32)
        del p32, x32, ref32
        gc.collect()
        torch.cuda.empty_cache()
        cache = init_cache(cfg, B, n_extra + total, device="cuda")
        chunked, kept = [], []
        real = layers.chunked_cache_attention
        layers.chunked_cache_attention = lambda *a, **k: chunked.append(1) or real(*a, **k)
        real_ca = layers.kops.chunked_cache_attention

        def keep(*a, **kw):  # the first launch keeps its inputs and output
            out = real_ca(*a, **kw)
            if not kept:
                kept.append((a, kw, out))
            return out

        layers.kops.chunked_cache_attention = keep
        ca0 = ca.launches
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            (lg, cache), prefill_ms = _events_ms(
                lambda: prefill(params, tokens[:, :prompt], cfg, cache, extra_embeds=extra))
        finally:
            layers.chunked_cache_attention = real
            layers.kops.chunked_cache_attention = real_ca
        prefill_peak = torch.cuda.max_memory_allocated()
        launched = ca.launches - ca0
        got, dec_ms = [lg], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            (lg, cache), ms = _events_ms(
                lambda: decode_step(params, tokens[:, prompt + i:prompt + i + 1], cfg, cache))
            got.append(lg)
            dec_ms.append(ms)
        torch.cuda.synchronize()
        dec_wall = time.perf_counter() - t0
    got = torch.stack(got, dim=1)
    err = max_err(got, ref)
    tol = DECODE_NOISE * noise
    log(f"[family] {cfg.name} decode: {cfg.num_layers} layers d_model={cfg.d_model} "
        f"{cfg.dtype}, B={B}, prefill of {n_extra} embeds + {prompt} tokens "
        f"({len(chunked)} chunked_cache_attention calls, {launched} cache_attention kernel "
        f"launches), {steps} decode steps; "
        f"max |decode - apply| {err:.4e} over {got.numel():,} logits, bf16 apply vs f32 "
        f"{noise:.4e}, tolerance {DECODE_NOISE}x that {tol:.4e}")
    log(f"[family] {cfg.name}: prefill {prefill_ms:.3f} ms, decode step mean "
        f"{sum(dec_ms) / steps:.3f} ms (min {min(dec_ms):.3f}, max {max(dec_ms):.3f}; CUDA "
        f"events), {B * steps / dec_wall:.2f} generated tokens/s; peak device memory "
        f"{max(peak, torch.cuda.max_memory_allocated()) / 1e9:.3f} GB (the prefill's own "
        f"{prefill_peak / 1e9:.3f} GB)")
    if not torch.isfinite(got).all() or err > tol:
        raise AssertionError(f"{cfg.name}: decode differs from apply by {err} > {tol}")
    if cfg.sliding_window:  # hymba: the ring holds its window, not the sequence
        ring = cache["blocks"]["0"][0].k.shape[2]
        log(f"[family] {cfg.name}: KV ring of {ring} slots after {n_extra + total} positions")
        if ring != cfg.sliding_window:
            raise AssertionError(f"{cfg.name}: a ring of {ring}, not its window")
    if n_extra and len(chunked) != cfg.num_layers:
        raise AssertionError(f"{cfg.name}: the prefill took chunked_cache_attention "
                             f"{len(chunked)} times, not once a layer")
    if launched != len(chunked):
        raise AssertionError(f"{cfg.name}: the prefill launched the cache_attention kernel "
                             f"{launched} times over {len(chunked)} chunked calls")
    if kept:
        # the plain loop in f32 on the launch's own (bf16) inputs: in bf16 it
        # rounds each block's scores to bf16 too, which at a model's score
        # scale moves its output by more than the kernel's f32 scores do
        (a, kw, out), = kept
        with torch.no_grad():
            exact = ca.plain(*(x.float() for x in a[:3]), *a[3:], **kw)
            loop = max_err(ca.plain(*a, **kw), exact)
        err0 = check_close(f"cache_attention {cfg.name} layer 0", out, exact)
        log(f"[family] {cfg.name}: the prefill's first cache_attention launch (q "
            f"{tuple(a[0].shape)}, ring {tuple(a[1].shape)}, block_k {kw['block_k']}) against "
            f"the plain loop in f32 on its own inputs: max_abs_err {err0:.4e} (atol=rtol="
            f"{TOL_BF16}); the plain loop in bf16 {loop:.4e}")
        del kept, a, kw, out, exact
    with torch.no_grad():
        avgs = profile_steps(lambda: decode_step(params, tokens[:, -1:], cfg, cache), 1,
                             f"one {cfg.name} decode step x {B} lanes")
    log(f"[profile] cudaLaunchKernel a {cfg.name} decode step: "
        f"{sum(e.count for e in avgs if e.key == 'cudaLaunchKernel')}")
    if n_extra:  # where a prefill's time goes: a second one, into a fresh cache
        with torch.no_grad():
            avgs = profile_steps(lambda: prefill(params, tokens[:, :prompt], cfg, init_cache(
                cfg, B, n_extra + total, device="cuda"), extra_embeds=extra), 1,
                f"one {cfg.name} prefill of {n_extra} embeds + {prompt} tokens x {B} lanes")
        dev = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(_self_device_us(e) for e in dev) / 1e3
        cache_ms = sum(_self_device_us(e) for e in dev if "cache_" in e.key) / 1e3
        log(f"[family] {cfg.name} prefill of {n_extra} embeds + {prompt} tokens x {B} lanes: "
            f"device busy {busy:.4f} ms (the profiled second prefill; the first took "
            f"{prefill_ms:.3f} ms by CUDA events), of it the cache attention kernel "
            f"{cache_ms:.4f} ms")
    flash = 0
    if two_chunks:
        # the reference's chunked prefill of a prompt twice the window into a
        # ring of the window: the second chunk's queries find the keys they
        # need overwritten (ROADMAP Queue 3), so it is measured, not held
        with torch.no_grad():
            ring0 = init_cache(cfg, B, prompt, device="cuda")
            lg1, ring0 = prefill(params, tokens[:, :prompt], cfg, ring0)
            lg2, _ = prefill(params, tokens[:, prompt:2 * prompt], cfg, ring0)
        log(f"[family] {cfg.name} two-chunk prefill of {2 * prompt} into a ring of "
            f"{prompt}: first chunk max |prefill - apply| {max_err(lg1, full[:, prompt - 1]):.4e}"
            f", second chunk {max_err(lg2, full[:, -1]):.4e} (the reference's ring drops "
            f"keys the second chunk needs)")
    if check_pallas:
        # each layer's launch keeps its inputs and output, to be held to the
        # plain version on those inputs below (no launch of its own)
        seen, real_fa = [], layers.kops.flash_attention

        def kept(q, k, v, **kw):
            out = real_fa(q, k, v, **kw)
            seen.append((q, k, v, kw, out))
            return out

        before = flash_attention.launches
        layers.kops.flash_attention = kept
        try:
            with torch.no_grad():
                fast, _ = apply(params, tokens[:, :n_full], dataclasses.replace(
                    cfg, attention_impl="pallas"))
        finally:
            layers.kops.flash_attention = real_fa
        flash = flash_attention.launches - before
        if flash != cfg.num_layers or len(seen) != flash:
            raise AssertionError(f"{cfg.name}: flash launched {flash} times over "
                                 f"{len(seen)} calls, not once a layer")
        layer_err = 0.0
        with torch.no_grad():
            for i, (q, k, v, kw, out) in enumerate(seen):
                want = flash_attention.plain(q.transpose(1, 2), k.transpose(1, 2),
                                             v.transpose(1, 2), **kw).transpose(1, 2)
                layer_err = max(layer_err, check_close(
                    f"flash_attention {cfg.name} layer {i} at B={B}, S={n_full}", out, want))
        log(f"[family] {cfg.name}: each of the {len(seen)} flash launches of the forward "
            f"below (q {tuple(seen[0][0].shape)}, k/v {tuple(seen[0][1].shape)}, model "
            f"layout) against the plain version on its own inputs: max_abs_err "
            f"{layer_err:.4e} (atol=rtol={TOL_BF16})")
        del seen
        err, tol = max_err(fast, full), DECODE_NOISE * noise_all
        log(f"[family] {cfg.name} apply at S={n_full}, B={B}: attention_impl='pallas' vs "
            f"'ref' max abs err {err:.4e}, bf16 apply vs f32 {noise_all:.4e} over the same "
            f"{full.numel():,} logits, tolerance {DECODE_NOISE}x that {tol:.4e}; flash "
            f"launches {flash} (window {cfg.sliding_window}, H/KV "
            f"{cfg.num_heads}/{cfg.num_kv_heads}, hd {cfg.resolved_head_dim})")
        if not torch.isfinite(fast).all() or err > tol:
            raise AssertionError(f"{cfg.name}: apply through flash differs from the plain "
                                 f"attention by {err} > {tol}")
    del params, cache, full
    gc.collect()
    torch.cuda.empty_cache()
    return flash


def families(seed: int, kernels: dict, xs, ss, ca, card: str) -> tuple:
    """Phase 9: the smoke configs card vs CPU; xlstm-125m and hymba-1.5b
    trained and decoded at full width and depth, llava-next-mistral-7b
    decoded after its 2,880 image embeddings. Returns the flash kernel's
    launches, which only hymba's pallas check may make, the cache
    attention kernel's (``ca``), once a layer of llava's prefill and of its
    profiled second one and nowhere else, the xLSTM scan kernels' (``xs``)
    and the SSD kernels' (``ss``), each exactly what the layers, remat and
    decode steps imply: a smoke reference makes 7
    forward passes (apply, the loss, the prefill, 4 decode steps) and 1
    backward, of which SSD runs 3 over the sequence and 4 as decode steps;
    a remat'd training step 2 forward passes and 1 backward; an xlstm
    decode run 68 forward passes (apply in bf16 and in f32, the prefill,
    64 steps, the profiled step); hymba's 6 over a sequence (apply in bf16
    and in f32, the prefill, the two-chunk prefill's two, the pallas
    apply) and 65 decode steps (64 and the profiled one)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    before = {name: mod.launches for name, mod in kernels.items()}
    xl0, want = dict(xs.launches), {}
    ssd0, ssd_want = dict(ss.launches), {}
    ca0 = ca.launches
    for arch in FAMILIES:
        family_reference(seed, arch)
        want = xl_add(want, xl_expected(get_config(arch, smoke=True), 7, 1))
        ssd_want = xl_add(ssd_want, ssd_expected(get_config(arch, smoke=True), 3, 1, 4))
    cfg = get_config("xlstm_125m")
    family_train(card, "xlstm_125m")
    want = xl_add(want, xl_expected(cfg, TRAIN_STEPS * (1 + cfg.remat), TRAIN_STEPS))
    family_decode(seed, "xlstm_125m", B=8, prompt=512, steps=64, ca=ca)
    want = xl_add(want, xl_expected(cfg, 64 + 4, 0))
    cfg = get_config("hymba_1_5b")
    family_train(card, "hymba_1_5b")
    ssd_want = xl_add(ssd_want, ssd_expected(cfg, TRAIN_STEPS * (1 + cfg.remat), TRAIN_STEPS,
                                             0))
    flash = family_decode(seed, "hymba_1_5b", B=4, prompt=1024, steps=64,
                          check_pallas=True, two_chunks=True, ca=ca)
    ssd_want = xl_add(ssd_want, ssd_expected(cfg, 6, 0, 64 + 1))
    family_decode(seed, "llava_next", B=2, prompt=LLAVA_PROMPT, steps=LLAVA_STEPS,
                  n_extra=LLAVA_EXTRA, ca=ca)
    # once a layer of llava's prefill, and of the profiled second prefill
    cached, cache_want = ca.launches - ca0, 2 * get_config("llava_next").num_layers
    after = {name: mod.launches for name, mod in kernels.items()}
    moved = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    scans = xl_moved(xs, xl0)
    ssd = xl_moved(ss, ssd0)
    log(f"[family] kernels' launches in phase 9: {moved}; cache_attention's {cached} "
        f"(implied {cache_want}); the scan kernels' {scans} "
        f"(implied {want}); the SSD kernels' {ssd} (implied {ssd_want}); phase 9 took "
        f"{time.perf_counter() - t0:.1f}s ({card})")
    if moved != ({"flash_attention": flash} if flash else {}):
        raise AssertionError(f"phase 9: a kernel launched off its path ({moved})")
    if scans != want or not all(scans.values()):
        raise AssertionError(f"phase 9: scan launches {scans}, not the {want} its layers, "
                             f"remat and decode steps imply")
    if ssd != ssd_want or not all(ssd.values()):
        raise AssertionError(f"phase 9: SSD launches {ssd}, not the {ssd_want} hymba's "
                             f"layers, remat and decode steps imply")
    if cached != cache_want:
        raise AssertionError(f"phase 9: cache_attention launched {cached} times, not once "
                             f"a layer of llava's two prefills ({cache_want})")
    return flash, scans, ssd, cached


# ---------------------------------------------------------------------------
# phase 10: the parallel layer and the launch tooling
# ---------------------------------------------------------------------------

PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 6, 512  # window 4, 6 slots a boundary: 8 micros
                                               # would exhaust them (ROADMAP Queue 3)
PIPE_GRAD_TOL = 1e-2  # relative L2 a leaf, pipelined vs non-pipelined sum in bf16: the
                      # same products but the embedding's backward, whose atomic
                      # scatter adds in another order each run
# the sharded step at NCCL world size 1: (arch, config cut, batch, seq); full width
NCCL_STEPS = (("yi_6b", {"num_layers": 4}, 2, PIPE_SEQ),
              ("granite_moe", {}, 2, 512),
              ("xlstm_125m", {}, 2, 64))
DRYRUN_CELLS = (("yi-6b", "train_4k"), ("granite-moe", "train_4k"),
                ("llama4-maverick", "train_4k"), ("xlstm-125m", "train_4k"))
DRYRUN_OUT = "build/dryrun"
# (all-gather, all-reduce) wire bytes a GPU of two train_4k cells on 16x16, traced on a
# host CPU with torch 2.13.0+cpu, to sit beside this machine's torch's
DRYRUN_WIRE_2_13 = {"xlstm-125m": (1.7019e10, 3.6408e9),
                    "llama4-maverick": (1.3090e12, 4.0467e12)}
DRYRUN_TIMEOUT = 600
H100_HBM_BYTES = 80e9


def lm_stage_params(params, bounds):
    """Stage s's params: its slice of the stacked dense blocks (views), the
    embedding on the first stage, the final norm and head on the last."""
    def part(tree, l0, l1):
        if isinstance(tree, dict):
            return {k: part(v, l0, l1) for k, v in tree.items()}
        return tree[l0:l1]

    out = []
    for s, (l0, l1) in enumerate(bounds):
        p = {"blocks": {"0": part(params["blocks"]["0"], l0, l1)}}
        if s == 0:
            p["embed"] = params["embed"]
        if s == len(bounds) - 1:
            p["final_norm"] = params["final_norm"]
            p["lm_head"] = params["lm_head"]
        out.append(p)
    return out


def lm_stage(cfg, s: int, n_stages: int, n_layers: int):
    """stage_s((tokens or hidden, targets), params) -> (hidden or logits,
    targets) from the port's ``_unstack`` and ``B.APPLY``, each layer
    recomputed in the backward when ``cfg.remat`` (as ``apply``)."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import blocks as B
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    def layer(h, p):
        return B.APPLY["dense"](h, p, cfg)[0]

    def f(x, p):
        h, targets = x
        if s == 0:
            h = p["embed"][h.long()]
        for lp in M._unstack(p["blocks"]["0"], n_layers):
            h = checkpoint(layer, h, lp, use_reentrant=False) if cfg.remat else layer(h, lp)
        if s == n_stages - 1:
            return M._logits(L.norm(h, p["final_norm"], cfg.norm), p, cfg), targets
        return h, targets

    return f


def lm_loss(y):
    """``loss_fn``'s mean next-token cross-entropy of a (logits, targets) pair."""
    logits, targets = y
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.gather(logp, -1, targets.long()[..., None])[..., 0])


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    want = want.float()
    return ((got.float() - want).norm() / want.norm().clamp_min(1e-30)).item()


def pipeline_yi(seed: int, kernels: dict, card: str) -> int:
    """Phase 10 (a): Yi-6B at full width and depth in 4 stages of 8 layers
    through ``PipelineRunner``, 6 microbatches of 1 x 512 tokens. The
    forward (no graph) through the flash kernel, the last stage's logits
    equal to ``apply``'s (tolerance 0: the same kernels on the same inputs);
    ``train_grads`` on the plain attention, every leaf's gradient within
    PIPE_GRAD_TOL (relative L2) of the non-pipelined sum, the mean loss
    equal to it. Returns the flash kernel's launches in the forward."""
    from repro_torch.configs import get_config
    from repro_torch.models import apply, init_params, loss_fn
    from repro_torch.parallel.pipeline import PipelineRunner
    from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

    cfg = get_config("yi_6b")
    n_layers = cfg.num_layers // PIPE_STAGES
    bounds = [(s * n_layers, (s + 1) * n_layers) for s in range(PIPE_STAGES)]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, "cuda")
    toks = torch.randint(0, cfg.vocab_size, (PIPE_MICRO, 1, PIPE_SEQ + 1), generator=gen,
                         dtype=torch.int32, device="cuda")
    mb = [(t[:, :-1], t[:, 1:]) for t in toks]
    stage_params = lm_stage_params(params, bounds)

    pcfg = dataclasses.replace(cfg, attention_impl="pallas")
    fns = [lambda x, s=s, f=lm_stage(pcfg, s, PIPE_STAGES, n_layers): f(x, stage_params[s])
           for s in range(PIPE_STAGES)]
    runner = PipelineRunner(fns, PIPE_MICRO)
    flash = kernels["flash_attention"]
    with torch.no_grad():
        torch.cuda.synchronize()
        n0, t0 = flash.launches, time.perf_counter()
        outs = runner.forward(mb)
        torch.cuda.synchronize()
        fwd_s, launches = time.perf_counter() - t0, flash.launches - n0
        if launches != cfg.num_layers * PIPE_MICRO:
            raise AssertionError(f"pipeline forward: {launches} flash launches, want "
                                 f"{cfg.num_layers} x {PIPE_MICRO}")
        for m, (logits, _) in enumerate(outs):
            want, _ = apply(params, mb[m][0], pcfg)
            if not torch.equal(logits, want):
                raise AssertionError(f"pipeline forward, micro {m}: logits differ from "
                                     f"apply's (max abs err {max_err(logits, want)})")
    log(f"[pipeline] yi-6b 4 x 8 layers, {PIPE_MICRO} micros of 1 x {PIPE_SEQ}: forward "
        f"{fwd_s * 1e3:.1f} ms, {launches} flash launches, logits == apply's; stats "
        f"{runner.stats}, window {runner.window} ({card})")
    if not (runner.stats["reclaimed"] > 0 and runner.stats["peak_slots"] <= runner.window + 2):
        raise AssertionError(f"pipeline forward stats {runner.stats}")
    del outs

    runner = PipelineRunner([lm_stage(cfg, s, PIPE_STAGES, n_layers)
                             for s in range(PIPE_STAGES)], PIPE_MICRO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grads, loss = runner.train_grads(stage_params, mb, lm_loss)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    stats = runner.stats
    if not (stats["fwd"] == stats["bwd"] == PIPE_STAGES * PIPE_MICRO
            and stats["reclaimed"] > 0 and stats["peak_slots"] <= runner.window + 2):
        raise AssertionError(f"pipeline train stats {stats}")
    full = {"embed": grads[0]["embed"], "final_norm": grads[-1]["final_norm"],
            "lm_head": grads[-1]["lm_head"],
            "blocks": {"0": tree_unflatten(grads[0]["blocks"]["0"], iter(
                [torch.cat(parts) for parts in zip(*(tree_leaves(g["blocks"]["0"])
                                                     for g in grads))]))}}
    del grads
    peak_pipe = torch.cuda.max_memory_allocated() / 1e9

    leaves = tree_leaves(params)
    ref, losses = None, []
    for t in toks:  # the non-pipelined sum, one autograd.grad of loss_fn a micro
        live = [x.detach().requires_grad_(True) for x in leaves]
        l_m, _ = loss_fn(tree_unflatten(params, iter(live)), {"tokens": t}, cfg)
        g = torch.autograd.grad(l_m, live)
        if ref is None:
            ref = list(g)
        else:
            for acc, gm in zip(ref, g):
                acc.add_(gm)
        losses.append(l_m.detach())
        del live, g, l_m
    loss_ref = torch.stack(losses).mean()
    errs = {path: rel_l2(g, r) for (path, g), r in zip(tree_paths(full), ref, strict=True)}
    worst = max(errs, key=errs.get)
    if errs[worst] > PIPE_GRAD_TOL or not torch.isclose(loss, loss_ref, rtol=1e-6):
        raise AssertionError(f"pipeline grads: {worst} at relative L2 {errs[worst]}; loss "
                             f"{loss.item()} vs {loss_ref.item()}")
    log(f"[pipeline] train_grads {train_s * 1e3:.1f} ms (6 micros fwd+bwd); stats {stats}; "
        f"loss {loss.item():.6f} == non-pipelined {loss_ref.item():.6f}; largest relative L2 "
        f"{errs[worst]:.3e} ({worst}), embed {errs['embed']:.3e}, "
        f"{sum(e == 0.0 for e in errs.values())}/{len(errs)} leaves bit-equal; peak memory "
        f"{peak_pipe:.1f} GB in the pipeline, {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
        f"with the reference ({card})")
    del params, stage_params, full, ref
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _loss_grads(params, tokens, cfg):
    from repro_torch.models import loss_fn
    from repro_torch.tree import tree_leaves, tree_unflatten

    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = loss_fn(tree_unflatten(params, iter(live)), {"tokens": tokens}, cfg)
    return loss.detach(), list(torch.autograd.grad(loss, live))


def _bit_equal(what: str, got: list, want: list) -> None:
    """Each of ``got`` (DTensors) equal to ``want``'s, bit for bit."""
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        g = g.full_tensor().to(w.device)
        if not torch.equal(g, w):
            raise AssertionError(f"{what}: leaf {i} of {len(want)} differs from the plain "
                                 f"step's (max abs err {max_err(g, w)})")


def sharded_step(seed: int, mesh, arch: str, over: dict, batch: int, seq: int,
                 card: str) -> None:
    """``arch`` at full width (``over`` cuts its depth) through the sharded
    train step on ``mesh``, held to the plain step bit for bit: the loss
    and every gradient of ``loss_fn``, then every param ``make_train_step``
    updates. The plain side runs first on a copy of the weights, and each
    side's gradients and moments are freed before the next is made; the
    plain step's params wait in host memory (granite-moe at full depth:
    the sharded step's f32 moments and the optimizer's f32 copies of a
    whole DTensor leaf leave no room for them on the card)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.parallel import sharding as S
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import tree_leaves, tree_unflatten

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), **over)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = init_params(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                           dtype=torch.int32, device="cuda")
    opt_cfg = O.OptConfig(lr=1e-5, warmup_steps=1, total_steps=10)
    plain = tree_unflatten(params, iter([p.clone() for p in tree_leaves(params)]))
    loss_p, grads_p = _loss_grads(plain, tokens, cfg)

    sharded = S.param_shardings(params, mesh)
    del params
    batch_d = S.distribute({"tokens": tokens}, S.batch_specs_for(mesh, {"tokens": tokens}),
                           mesh)
    with implicit_replication():
        loss_d, grads_d = _loss_grads(sharded, batch_d["tokens"], cfg)
    _bit_equal(f"{arch} sharded loss", [loss_d], [loss_p])
    _bit_equal(f"{arch} sharded gradients", grads_d, grads_p)
    del grads_d, grads_p
    torch.cuda.synchronize()
    t1 = time.perf_counter()

    new_p, opt_p, m_p = make_train_step(cfg, opt_cfg)(plain, O.init(plain, opt_cfg),
                                                     {"tokens": tokens})
    want = [x.cpu() for x in tree_leaves(new_p)]
    del opt_p, new_p, plain  # before the sharded step makes its own moments
    new_d, _, m_d = make_train_step(cfg, opt_cfg, mesh)(sharded, O.init(sharded, opt_cfg),
                                                       batch_d)
    _bit_equal(f"{arch} sharded step", tree_leaves(new_d), want)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in want)
    placements = sorted({str(p) for x in tree_leaves(new_d) for p in x.placements})
    log(f"[nccl] {arch} ({cfg.num_layers} layers, d_model {cfg.d_model}, {n / 1e9:.3f}B "
        f"params), batch {batch} x {seq}: loss {loss_d.full_tensor().item():.6f} == plain "
        f"{loss_p.item():.6f}; {len(want)} gradients and updated params "
        f"bit-equal to the plain step's (placements {placements}); step losses "
        f"{m_d['loss'].full_tensor().item():.6f} / {m_p['loss'].item():.6f}; loss and "
        f"gradients {t1 - t0:.1f}s, the two steps {time.perf_counter() - t1:.1f}s, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB ({card})")
    del sharded, new_d, want


def nccl_world1(seed: int, card: str) -> None:
    """Phase 10 (b): NCCL at world size 1 on a 1x1 (data, model) mesh: the
    sharded train step (``param_shardings``, ``batch_specs_for``,
    ``make_train_step(..., mesh)``) held to the plain step on each of
    NCCL_STEPS (:func:`sharded_step`); ``compressed_psum`` and
    ``ring_ag_matmul`` on the card held to their single-process results.
    The group is torn down at the end."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import collectives as COL

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        t0 = time.perf_counter()
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        log(f"[nccl] world 1, mesh {tuple(mesh.mesh_dim_names)} {tuple(mesh.shape)} on "
            f"{mesh.device_type}")
        for arch, over, batch, seq in NCCL_STEPS:
            sharded_step(seed, mesh, arch, over, batch, seq, card)
        gc.collect()
        torch.cuda.empty_cache()

        gen = torch.Generator(device="cuda").manual_seed(seed)
        g = torch.randn(4096, 4096, generator=gen, device="cuda") * 0.01
        err = torch.randn(4096, 4096, generator=gen, device="cuda") * 1e-4
        out, new_err = COL.compressed_psum(g, err)
        q, scale = COL.quantize_int8((g + err).cpu())
        deq = COL.dequantize_int8(q, scale)
        if not (torch.equal(out.cpu(), deq) and torch.equal(new_err.cpu(), (g + err).cpu() - deq)):
            raise AssertionError("compressed_psum at world 1 differs from its single-process "
                                 f"result (max abs err {max_err(out.cpu(), deq)})")
        x = torch.randn(512, 4096, generator=gen, device="cuda")
        w = torch.randn(4096, 1024, generator=gen, device="cuda")
        if not torch.equal(COL.ring_ag_matmul(x, w), x @ w):
            raise AssertionError("ring_ag_matmul at world 1 differs from x @ w")
        torch.cuda.synchronize()
        log(f"[nccl] compressed_psum (4096^2 f32, int8 error feedback) and ring_ag_matmul "
            f"(512 x 4096 @ 4096 x 1024) equal their single-process results; (b) took "
            f"{time.perf_counter() - t0:.1f}s ({card})")
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()


def start_dryrun(here: str) -> list:
    """Phase 10 (c), started first: the dry run of each of DRYRUN_CELLS on
    the 16x16 fake mesh, each in a process of its own (it needs its own
    default process group) on the host CPU (meta tensors, no card)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(here, "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                              "--shape", shape, "--out", DRYRUN_OUT], cwd=here, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for arch, shape in DRYRUN_CELLS]


def stop(procs: list) -> None:
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def finish_dryrun(procs: list, here: str, card: str) -> None:
    """Phase 10 (c): each cell's per-GPU counts and its three terms under
    the H100 constants, and yi-6b's analytic memory against the card's 80
    GB. Estimates for a 256-GPU mesh, not measurements."""
    from repro_torch.launch import roofline as R

    deadline = time.monotonic() + DRYRUN_TIMEOUT
    try:
        outs = [proc.communicate(timeout=max(1.0, deadline - time.monotonic()))[0]
                for proc in procs]
    finally:
        stop(procs)
    for (arch, shape), proc, out in zip(DRYRUN_CELLS, procs, outs):
        if proc.returncode != 0:
            raise AssertionError(f"dry run of {arch} x {shape} exited {proc.returncode}:\n"
                                 f"{out[-3000:]}")
        name = f"{arch.replace('-', '_')}__{shape}__pod16x16.json"
        with open(os.path.join(here, DRYRUN_OUT, name)) as f:
            row = json.load(f)
        t, mem = row["roofline"], row["memory_analytic"]
        log(f"[dryrun] {arch} {shape} on 16x16 (256 GPUs; estimates, not measurements): per "
            f"GPU {t['flops_per_chip']:.4e} FLOPs, {t['bytes_per_chip']:.4e} bytes (unfused: "
            f"an over-count), {t['wire_bytes_per_chip']:.4e} wire bytes "
            f"{ {k: float(f'{v:.4g}') for k, v in t['wire_breakdown'].items()} } in "
            f"{t['collective_ops']} collectives; compute {t['compute_s']:.4f}s (at "
            f"{R.PEAK_FLOPS:.3g} FLOP/s), memory {t['memory_s']:.4f}s (at {R.HBM_BW:.3g} B/s), "
            f"collective {t['collective_s']:.4f}s (at {R.LINK_BW:.3g} B/s, InfiniBand), "
            f"dominant {t['dominant']}; useful FLOPs {t['useful_flops_ratio']:.3f}; analytic "
            f"memory {mem['total'] / 1e9:.2f} GB of {H100_HBM_BYTES / 1e9:.0f} GB; notes "
            f"{row['notes'][2:]}; traced in {row['compile_seconds']:.1f}s on the host ({card})")
        if arch in DRYRUN_WIRE_2_13:
            w, (ag, ar) = t["wire_breakdown"], DRYRUN_WIRE_2_13[arch]
            log(f"[dryrun] {arch} {shape} wire bytes a GPU, torch {torch.__version__}: "
                f"all-gather {w['all-gather']:.4e}, all-reduce {w['all-reduce']:.4e}; torch "
                f"2.13.0+cpu on a host CPU: {ag:.4e}, {ar:.4e} ({card})")
        if arch == "yi-6b":
            log(f"[dryrun] yi-6b train_4k flops_per_chip {t['flops_per_chip']:.4e}, useful "
                f"FLOPs {t['useful_flops_ratio']:.3f}; PR 19 (heads replicated over 'model', "
                f"torch 2.11 on this machine): 1.0969e15, 0.136")
            if mem["total"] > H100_HBM_BYTES:
                raise AssertionError(f"yi-6b train_4k does not fit one H100: {mem['total']:.4e} B")


def parallel_layer(seed: int, kernels: dict, xs, card: str, here: str) -> tuple:
    """Phase 10: the dry run started in the background, the Yi-6B
    pipeline, NCCL at world size 1, then the dry run's result. Returns the
    flash kernel's launches in the pipeline forward; besides those, only
    the flash launches of ``apply`` it is held to may happen here; and the
    scan kernels' launches, those of xlstm-125m's four remat'd passes in
    (b): the plain and the sharded loss and gradients, the plain and the
    sharded train step."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    before = {name: mod.launches for name, mod in kernels.items()}
    xl0 = dict(xs.launches)
    dry = start_dryrun(here)
    try:
        flash = pipeline_yi(seed, kernels, card)
        nccl_world1(seed, card)
    except BaseException:
        stop(dry)
        raise
    finish_dryrun(dry, here, card)
    moved = {k: mod.launches - before[k] for k, mod in kernels.items()
             if mod.launches != before[k]}
    log(f"[parallel] kernels' launches in phase 10: {moved} (the pipeline's {flash}, the "
        f"rest apply's to hold it); phase 10 took {time.perf_counter() - t0:.1f}s ({card})")
    if moved != {"flash_attention": 2 * flash}:
        raise AssertionError(f"phase 10: a kernel launched off its path ({moved})")
    scans, want = xl_moved(xs, xl0), {}
    for arch, over, _, _ in NCCL_STEPS:
        cfg = dataclasses.replace(get_config(arch), **over)
        want = xl_add(want, xl_expected(cfg, 4 * (1 + cfg.remat), 4))
    log(f"[parallel] the scan kernels' launches in phase 10: {scans} (implied {want})")
    if scans != want:
        raise AssertionError(f"phase 10: scan launches {scans}, not the implied {want}")
    return flash, scans


# ---------------------------------------------------------------------------
# phase 11: the examples
# ---------------------------------------------------------------------------

SERVE_EXAMPLES = ("torch_quickstart", "torch_serve_batched", "torch_serve_multitenant",
                  "torch_serve_replicated")
TOL_F32 = 2e-5                 # atol = rtol in float32: sums in another order
# the reference's documented CI scale (its loss falls), then the full
# published width at the example's batch of 8 for a few steps at 64 tokens
# (its time loops through the scan kernels)
TRAIN_LM_RUNS = (["--steps", "20", "--scale", "0.25", "--batch", "4", "--seq", "64"],
                 ["--steps", "4", "--scale", "1.0", "--seq", "64"])


def load_example(here: str, name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  os.path.join(here, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class KernelCalls:
    """Keeps the inputs (copied: the pages change after the call) and the
    output of each paged and flash call the serving path makes through
    ``repro_torch.kernels.ops`` while in use, to be held to the kernels'
    plain versions afterwards (no launch of its own)."""

    def __init__(self):
        from repro_torch.kernels import ops

        self.ops, self.real = ops, (ops.paged_attention, ops.flash_attention)
        self.calls = []  # (kernel, args, kwargs, output)

    def __enter__(self):
        real_pa, real_fa = self.real

        def keep(name, real):
            def call(*args, **kw):
                kept = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
                out = real(*args, **kw)
                self.calls.append((name, kept, kw, out.clone()))
                return out
            return call

        self.ops.paged_attention = keep("paged_attention", real_pa)
        self.ops.flash_attention = keep("flash_attention", real_fa)
        return self

    def __exit__(self, *exc):
        self.ops.paged_attention, self.ops.flash_attention = self.real

    def hold(self, what: str, paged, flash) -> dict:
        """Each kept call against its kernel's plain version on its own
        inputs (atol = rtol = 2e-5 in float32, 2e-2 in bfloat16); the
        largest error and the shapes seen, a kernel."""
        errs, shapes = {"paged_attention": 0.0, "flash_attention": 0.0}, {}
        with torch.no_grad():
            for name, args, kw, out in self.calls:
                if name == "paged_attention":
                    want = paged.plain(*args, **kw)
                else:
                    q, k, v = (t.transpose(1, 2) for t in args)
                    want = flash.plain(q, k, v, **kw).transpose(1, 2)
                tol = TOL_F32 if out.dtype == torch.float32 else TOL_BF16
                err = max_err(out, want)
                if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
                    raise AssertionError(f"{what}: {name} at q {tuple(args[0].shape)} "
                                         f"disagrees with its plain version (max abs err {err})")
                errs[name] = max(errs[name], err)
                shapes.setdefault(name, set()).add(tuple(args[0].shape))
        return errs, shapes


def _drains(fabric_cls, log_to: list):
    """``fabric_cls.drain`` recording each drain's (uid, qclass, output)
    in completion order; returns the real one."""
    real = fabric_cls.drain

    def recorded(self, *a, **kw):
        done = real(self, *a, **kw)
        log_to.append([(u, r.qclass, list(r.output)) for u, r in done.items()])
        return done

    fabric_cls.drain = recorded
    return real


def serve_example(here: str, name: str, kernels: dict, card: str) -> tuple:
    """One serve example's ``main()`` on the card as it stands (its own
    assertions), counted, each kernel call held to the plain version; then
    the same on the CPU (plain versions) from the same weights (drawn on
    the CPU for both): every drain token-identical and in the same
    completion order. Returns (launches, errors a kernel)."""
    from repro_torch.fabric import Fabric
    from repro_torch.fabric import session
    from repro_torch.kernels import flash_attention, paged_attention

    mod = load_example(here, name)
    runs, real, real_state = {}, Fabric.drain, session.Fabric._model_state

    def cpu_seeded(config, model_cfg, params, device):
        # the same weights on both devices: the card's generator would draw others
        if params is None:
            model_cfg, params = real_state(config, model_cfg, None, "cpu")
            params = _to_device(params, device)
        return real_state(config, model_cfg, params, device)

    session.Fabric._model_state = staticmethod(cpu_seeded)
    try:
        for device in ("cuda", "cpu"):
            argv = ["--device", device]
            if name == "torch_serve_replicated":
                ck = os.path.join(here, "build", "phase11_ckpt", device)
                shutil.rmtree(ck, ignore_errors=True)
                argv += ["--ckpt-dir", ck]
            runs[device] = []
            _drains(Fabric, runs[device])
            t0 = time.perf_counter()
            if device == "cuda":
                with KernelCalls() as calls:
                    _, launches = counted_run(f"examples/{name}.py", kernels,
                                              lambda: mod.main(argv), ring=False)
            else:
                mod.main(argv)
            Fabric.drain = real
            log(f"[examples] {name}.py --device {device}: {time.perf_counter() - t0:.2f}s")
    finally:
        Fabric.drain = real
        session.Fabric._model_state = staticmethod(real_state)
    if runs["cuda"] != runs["cpu"] or not runs["cuda"]:
        raise AssertionError(f"examples/{name}.py: the card's drains {runs['cuda']} differ "
                             f"from the CPU's {runs['cpu']}")
    errs, shapes = calls.hold(f"examples/{name}.py", paged_attention, flash_attention)
    if launches["cmp_claim"]:
        raise AssertionError(f"examples/{name}.py: the claim kernel ran off its path")
    served = sum(len(d) for d in runs["cuda"])
    log(f"[examples] {name}.py: {served} requests drained, card token-identical to the CPU "
        f"in the same order; launches {launches}; each of its {len(calls.calls)} kernel calls "
        f"held to the plain version on its inputs: max_abs_err {errs} (q shapes "
        f"{ {k: sorted(v) for k, v in shapes.items()} }; {card})")
    return launches, errs


def train_lm(here: str, card: str, flags: list) -> tuple:
    """``examples/torch_train_lm.py`` on the card at ``flags``, from a
    fresh checkpoint directory; its losses (all finite) and the scan
    launches its layers imply (the example trains without remat: one
    forward and one backward pass a step)."""
    mod = load_example(here, "torch_train_lm")
    ck = os.path.join(here, "build", "phase11_train_ckpt")
    shutil.rmtree(ck, ignore_errors=True)
    runs, real = [], mod.Trainer

    class Kept(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runs.append(self)

    mod.Trainer = Kept
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.main(flags + ["--device", "cuda", "--ckpt-dir", ck])
    wall = time.perf_counter() - t0
    (tr,) = runs
    losses = tr.history
    if len(losses) != int(flags[1]) or not all(np.isfinite(losses)):
        raise AssertionError(f"examples/torch_train_lm.py {' '.join(flags)}: losses {losses}")
    times = tr.step_times
    log(f"[examples] torch_train_lm.py {' '.join(flags)}: {tr.cfg.name} d_model "
        f"{tr.cfg.d_model} x {tr.cfg.num_layers} layers, {tr.cfg.dtype}; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step s {times[0]:.3f} first, "
        f"{np.median(times[1:] or times):.3f} median after; wall {wall:.2f}s; stragglers "
        f"{tr.stragglers} ({card})")
    steps = len(losses)
    return losses, xl_expected(tr.cfg, steps * (1 + tr.cfg.remat), steps)


def examples(here: str, kernels: dict, xs, card: str) -> dict:
    """Phase 11: the port's six examples on the card. Returns the serving
    kernels' launches of the serve examples (each its own counted run) and
    the largest error of their kernel calls; the pipeline demo and
    ``torch_train_lm.py`` may launch no serving kernel, and
    ``torch_train_lm.py`` launches the scan kernels as its layers imply
    (returned too)."""
    t0 = time.perf_counter()
    total = dict.fromkeys(kernels, 0)
    errs = {"paged_attention": 0.0, "flash_attention": 0.0}
    for name in SERVE_EXAMPLES:
        launches, err = serve_example(here, name, kernels, card)
        for k, n in launches.items():
            total[k] += n
        for k, e in err.items():
            errs[k] = max(errs[k], e)
    if not (total["paged_attention"] and total["flash_attention"]):
        raise AssertionError(f"phase 11: a serving kernel never launched ({total})")
    before = {name: mod.launches for name, mod in kernels.items()}
    t1 = time.perf_counter()
    load_example(here, "torch_data_pipeline_demo").main(["--device", "cuda"])
    log(f"[examples] torch_data_pipeline_demo.py --device cuda: "
        f"{time.perf_counter() - t1:.2f}s")
    from repro_torch.configs import get_config

    xl0 = dict(xs.launches)
    ci, want = train_lm(here, card, TRAIN_LM_RUNS[0])
    check_falls(ci, get_config("xlstm-125m").vocab_size)
    want = xl_add(want, train_lm(here, card, TRAIN_LM_RUNS[1])[1])
    after = {name: mod.launches for name, mod in kernels.items()}
    if after != before:
        raise AssertionError(f"a serving kernel launched in the pipeline demo or in "
                             f"torch_train_lm.py ({before} -> {after})")
    scans = xl_moved(xs, xl0)
    log(f"[examples] the scan kernels' launches in torch_train_lm.py: {scans} (implied "
        f"{want})")
    if scans != want:
        raise AssertionError(f"phase 11: torch_train_lm.py's scan launches {scans}, not "
                             f"the implied {want}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[examples] serving kernels' launches in phase 11: {total}; phase 11 took "
        f"{time.perf_counter() - t0:.1f}s ({card})")
    return {"launches": total, "errs": errs, "scans": scans}


def _self_device_us(evt) -> float:
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def _device_us(evt) -> float:
    """Device time of the kernels an op launched (its children's included)."""
    return getattr(evt, "device_time_total", getattr(evt, "cuda_time_total", 0.0))


KERNEL_KEYS = ("paged", "flash", "cache_bf16", "cache_scalar")  # the attention kernels


def profile_steps(step, steps: int, what: str):
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
    # the top 8, and the port's attention kernels wherever they rank
    for e in dev[:8] + [e for e in dev[8:] if any(n in e.key for n in KERNEL_KEYS)]:
        log(f"[profile] device {_self_device_us(e) / 1e3 / steps:9.4f} ms/step "
            f"x{e.count // steps:5d}  {e.key[:90]}")
    host = sorted((e for e in avgs if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host[:8]:
        log(f"[profile] host   {e.self_cpu_time_total / 1e3 / steps:9.4f} ms/step "
            f"x{e.count // steps:5d}  {e.key[:90]}")
    return avgs


def profile_decode(eng, cfg, rng, steps: int = 4):
    """Where a decode step's time goes: a full batch of 8 lanes (64-token
    prompts) decodes ``steps`` steps under ``torch.profiler``. Runs after
    the launch counts were read."""
    prompts = [rng.integers(0, cfg.vocab_size, size=64).tolist()
               for _ in range(eng.max_batch)]
    eng.submit_many(prompts, max_new_tokens=steps + 2)
    eng.step()  # admit (prefill) every lane, decode once
    avgs = profile_steps(eng.step, steps, f"{steps} decode steps x {eng.max_batch} lanes")
    eng.run_until_idle()
    return avgs


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
    sys.path.insert(0, os.path.join(here, "tests"))  # torch_norm_rope_cases
    from repro_torch.kernels import _build
    from repro_torch.kernels import cache_attention, cmp_claim, cmp_ring, flash_attention
    from repro_torch.kernels import norm_rope, paged_attention, ssd_scan, xlstm_scan

    walls = []

    def phase(n: int, what: str, t0: float) -> None:
        walls.append((n, what, time.perf_counter() - t0))
        log(f"[wall] phase {n} ({what}): {walls[-1][2]:.1f}s")

    # phase 1: card
    t0 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    card = ", ".join(x.strip() for x in smi.split(","))
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products stay f32
    torch.backends.cudnn.allow_tf32 = False
    phase(1, "card", t0)

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f"[build] {lib_path.relative_to(_build.ROOT)} ready in "
        f"{time.perf_counter() - t0:.2f}s")
    for kernel, line in ptxas_lines():
        log(f"[build] {kernel}: {line}")
    phase(2, "build", t0)

    # phase 3: kernels against their plain versions
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = [check_ring(cmp_ring, rng), check_paged(paged_attention, gen),
            check_flash(flash_attention, gen), *check_claim(cmp_claim, rng)]
    repaired = check_attention_repairs(paged_attention, flash_attention, gen)
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], repaired["paged"])
    rows[2]["max_abs_err"] = max(rows[2]["max_abs_err"], repaired["flash"])
    scan_rows = check_xlstm(xlstm_scan, args.seed) + check_ssd(ssd_scan, args.seed)
    scan_rows.append(check_cache_attention(cache_attention, gen))
    fused_rows = check_norm_rope(norm_rope, gen)
    ca_after3 = cache_attention.launches
    phase(3, "kernels", t0)

    # phase 4: small-input reference
    t0 = time.perf_counter()
    for arch in SERVED:
        small_reference(args.seed, arch)
    phase(4, "small-input reference", t0)

    # phase 5: the main path, one model after the other (each one's weights
    # are freed before the next is made)
    t0 = time.perf_counter()
    kernels = {"cmp_ring": cmp_ring, "paged_attention": paged_attention,
               "flash_attention": flash_attention, "cmp_claim": cmp_claim}
    phase5 = dict.fromkeys((*kernels, *norm_rope.KERNELS), 0)
    for arch in SERVED:
        for name, n in main_path(args.seed, kernels, norm_rope, arch).items():
            phase5[name] += n
        gc.collect()
        torch.cuda.empty_cache()
    phase(5, "Engine at full width", t0)

    # phase 6: the device CMP queue
    t0 = time.perf_counter()
    phase6 = device_queue(args.seed, kernels)
    phase(6, "device CMP queue", t0)

    # phase 7: the serve driver at glm4-9b's full width
    t0 = time.perf_counter()
    phase7 = serve_driver(args.seed, kernels, card)
    phase(7, "serve driver", t0)

    # phase 8: training, smoke references and Yi-6B at full width
    t0 = time.perf_counter()
    training(args.seed, kernels, card)
    phase(8, "training", t0)

    # phase 9: the SSM, hybrid and frontend families
    t0 = time.perf_counter()
    if cache_attention.launches != ca_after3:  # no chunked prefill runs in phases 4-8
        raise AssertionError(f"cache_attention launched in phases 4-8 ({ca_after3} -> "
                             f"{cache_attention.launches})")
    phase9, scans9, ssd9, cache9 = families(args.seed, kernels, xlstm_scan, ssd_scan,
                                            cache_attention, card)
    ssd_after9, ca_after9 = dict(ssd_scan.launches), cache_attention.launches
    phase(9, "SSM, hybrid and frontend families", t0)

    # phase 10: the parallel layer and the launch tooling
    t0 = time.perf_counter()
    phase10, scans10 = parallel_layer(args.seed, kernels, xlstm_scan, card, here)
    phase(10, "parallel layer and launch tooling", t0)

    # phase 11: the examples
    t0 = time.perf_counter()
    phase11 = examples(here, kernels, xlstm_scan, card)
    phase(11, "examples", t0)
    if ssd_scan.launches != ssd_after9:  # no hymba layer runs in phases 10 and 11
        raise AssertionError(f"an SSD kernel launched after phase 9 ({ssd_after9} -> "
                             f"{ssd_scan.launches})")
    if cache_attention.launches != ca_after9:
        raise AssertionError(f"cache_attention launched after phase 9 ({ca_after9} -> "
                             f"{cache_attention.launches})")
    log("[wall] " + "; ".join(f"phase {n} {s:.1f}s" for n, _, s in walls)
        + f"; total {sum(s for *_, s in walls):.1f}s ({card})")

    # each row's launches: the serving kernels' from phases 5 and 7 (and
    # flash's from phase 9's pallas route), the claim kernel's from phase 6
    # (by the JAX call site of its pool size)
    serving = ("cmp_ring", "paged_attention", "flash_attention")
    ex = phase11["launches"]
    launches = {name: phase5[name] + phase7[name] + ex[name] for name in serving} | phase6
    launches["flash_attention"] += phase9 + phase10
    log(f"[launches] phase 5 (Engine): { {k: phase5[k] for k in serving} }; phase 6 "
        f"(slotpool): {phase6}; phase 7 (serve driver): { {k: phase7[k] for k in serving} }"
        f"; phase 9 (hymba, attention_impl='pallas'): flash {phase9}; phase 10 (the Yi-6B "
        f"pipeline forward): flash {phase10}; phase 11 (the serve examples): "
        f"{ {k: ex[k] for k in serving} }")
    scans = xl_add(xl_add(scans9, scans10), phase11["scans"])
    log(f"[launches] the scan kernels: phase 9 (xlstm smoke, train driver, decode) "
        f"{scans9}; phase 10 (b) (xlstm-125m sharded and plain) {scans10}; phase 11 "
        f"(torch_train_lm.py) {phase11['scans']}")
    for row in rows:
        row["max_abs_err"] = max(row["max_abs_err"], phase11["errs"].get(row["name"], 0.0))
        row["launches"] = launches[row["name"]]
        row["of"] = "pallas_call"
    log(f"[launches] the SSD kernels: phase 9 (hymba smoke, train driver, decode) {ssd9}; "
        f"cache_attention: phase 9 (llava-next's prefill) {cache9}")
    scan_launches = {**scans, **ssd9, "cache_attention": cache9}
    for row in scan_rows:
        row["launches"] = scan_launches[row["name"]]
    rows += scan_rows
    for row in fused_rows:  # phase 5's forwards, held to 2L + 1 and L a forward
        row["launches"] = phase5[row["name"]]
    log(f"[launches] the paged block's fused chains: phase 5 (Engine) "
        f"{ {k: phase5[k] for k in norm_rope.KERNELS} }")
    rows += fused_rows
    for row in rows:
        row["route"] = "cuda"
    keys = ["name", "route", "source", "replaces", "of", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms"]
    log(f"{smi} (the card of every number above)")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + ["chain_floor_ms"] if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
