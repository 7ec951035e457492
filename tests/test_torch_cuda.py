"""The port's CUDA kernels against their plain PyTorch versions, both on
the card, at small shapes in float32 and bfloat16 (the shapes of
tests/test_torch_kernels.py). Marked ``cuda``: without a CUDA device these
skip; on a machine with one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 (sums in another order), 3e-2 (flash, the MoE
block) and 4e-2 (paged) in bfloat16, the reference tests' tolerances; the
CMP kernels (ring, claim, the fused slot-pool claim), the slot pool and
the admission ring bit-exact; the paged block's fused norm and RoPE chains
within one bf16 ulp of their plain versions (float32: 1e-6), their V
pages bit for bit."""

import numpy as np
import pytest
import torch

from repro_torch.core import slotpool
from repro_torch.kernels import cmp_claim, cmp_ring, flash_attention, paged_attention
from torch_norm_rope_cases import NR_CALLS, NR_MODELS, norm_case, rope_case, within_one_ulp
from torch_xlstm_cases import EXTREME_CASES, check_rows, extreme_case

pytestmark = pytest.mark.cuda
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    return torch.device("cuda")


def _close(got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("n,k", [(16, 4), (64, 4), (128, 64), (1000, 96)])
def test_ring_kernel_is_bit_exact(dev, n, k):
    rng = np.random.default_rng(n + k)
    state = torch.zeros(n, dtype=torch.int32, device=dev)
    cycle, meta = torch.zeros_like(state), torch.zeros(2, dtype=torch.int32, device=dev)
    before = cmp_ring.launches
    for _ in range(60):
        req = (int(rng.integers(0, n // 2 + 1)), int(rng.integers(0, k + 1)))
        got = cmp_ring.cmp_ring_step(state, cycle, meta, req, k=k, window=n // 4)
        want = cmp_ring.plain(state, cycle, meta, req, k=k, window=n // 4)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        state, cycle, meta = got[:3]
    assert cmp_ring.launches == before + 60


def _ring_pair(state, cycle, meta, req, k, window):
    """One ring step by the kernel and by the plain version: bit-exact, one
    launch. Returns the kernel's outputs."""
    before = cmp_ring.launches
    got = cmp_ring.cmp_ring_step(state, cycle, meta, req, k=k, window=window)
    assert cmp_ring.launches == before + 1
    want = cmp_ring.plain(state, cycle, meta, req, k=k, window=window)
    for name, a, b in zip(("state", "cycle", "meta", "claimed"), got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, req, k)
    return got


@pytest.mark.parametrize("n", [128, 4096, 8192, 16384])
def test_ring_kernel_engine_sizes_bit_exact(dev, n):
    """The engine's ring at max_batch n/16 (capacity 16 x, claim_block 8 x,
    window capacity/4): a trajectory of pushes and claims, bit-exact at
    every step. N = 16,384 is max_batch 1,024, past the old 4,096 cap."""
    k, window = n // 2, n // 4
    rng = np.random.default_rng(n)
    state = torch.zeros(n, dtype=torch.int32, device=dev)
    cycle, meta = torch.zeros_like(state), torch.zeros(2, dtype=torch.int32, device=dev)
    claims = 0
    for _ in range(40):
        req = (int(rng.integers(0, n // 2 + 1)), int(rng.choice([k, int(rng.integers(0, k + 1))])))
        state, cycle, meta, claimed = _ring_pair(state, cycle, meta, req, k, window)
        claims += int((claimed >= 0).sum())
    assert claims > 0


def _broken_ring(n, case, rng):
    """Ring states that break the enqueue invariant (a cycle c away from slot
    (c-1) mod N, or outside the last N cycles): random states (3 is no
    domain state), permuted and duplicate cycles, cycles near INT32_MAX with
    the frontier wrapped past it."""
    imax, imin = np.iinfo(np.int32).max, np.iinfo(np.int32).min
    state = rng.integers(0, 4, size=n)
    enq = int(rng.integers(0, 1000))
    if case == "permuted":
        cycle = rng.permutation(n) + enq - n // 2
    elif case == "duplicate":
        cycle = rng.integers(enq - 3, enq + 1, size=n)
    elif case == "near_max":
        cycle = imax - rng.integers(0, 2 * n, size=n)
        enq = imax - n // 3
    elif case == "wrapped":
        cycle = imax - rng.integers(0, n, size=n)
        enq = imin + n // 3
    else:
        cycle = rng.integers(imin, imax, size=n)
        enq = int(rng.integers(imin, imax))
    dc = int(rng.integers(imin, imax)) if case == "random" else enq - n // 2
    to = lambda a: torch.from_numpy(np.asarray(a).astype(np.int64).astype(np.int32))
    return to(state), to(cycle), to([enq, dc])


@pytest.mark.parametrize("n", [1, 37, 128, 4096, 16384])
@pytest.mark.parametrize("case", ["random", "permuted", "duplicate", "near_max", "wrapped"])
def test_ring_kernel_general_inputs_bit_exact(dev, n, case):
    """Inputs that break the invariant take the kernel's general path (a
    sort of the keys): bit-exact with ties, k > the claimable count,
    want = 0 and < 0, push_n = N and past it, window 0."""
    rng = np.random.default_rng(n * 10 + len(case))
    state, cycle, meta = (t.to(dev) for t in _broken_ring(n, case, rng))
    half = max(1, n // 2)
    for k, req, window in ((half, (int(rng.integers(0, n + 1)), half), n // 4),
                           (n, (0, n), 0), (half, (n // 3, 0), n // 4),
                           (1, (n, 1), n), (half, (n + 7, -1), 3),
                           (n, (n // 2, n // 2 + 1), n // 4)):
        got = _ring_pair(state, cycle, meta, req, k, window)
        state, cycle, meta = got[:3]


def test_admission_ring_at_max_batch_512_matches_cpu(dev):
    """Engine(max_batch=512, device_admission=True)'s ring (k=512,
    claim_block=4,096, capacity 8,192), which the card refused before the
    cap rose: the same claims, rejections and ring tensors as on the CPU."""
    from repro_torch.serving.admission import DeviceAdmissionRing

    rings = {d: DeviceAdmissionRing(k=512, claim_block=4096, device=d)
             for d in (dev, "cpu")}
    rng = np.random.default_rng(5)
    nxt, served = 0, 0
    for _ in range(30):
        push = list(range(nxt, nxt + int(rng.integers(0, 3000))))
        nxt += len(push)
        want = int(rng.integers(0, 513))
        outs = [ring.step(list(push), want) for ring in rings.values()]
        assert outs[0] == outs[1]
        served += len(outs[0][0])
        a, b = rings.values()
        for x, y in ((a.state, b.state), (a.cycle, b.cycle), (a.meta, b.meta)):
            assert torch.equal(x.cpu(), y)
    assert served > 0 and rings[dev].stats == rings["cpu"].stats
    assert rings[dev].capacity == 8192 and rings[dev].stats["kernel_calls"] > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(8, 1), (2, 64)])
def test_moe_block_on_card_matches_cpu(dev, dtype, B, S):
    """granite-moe-3b-a800m's MoE block (d_model 1536, 40 experts of 512,
    top-8, the router float32) on the card against its CPU run, at a decode
    batch and a short prefill (capacity 8 and 128: the prefill drops)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import blocks, moe

    cfg = dataclasses.replace(get_config("granite_moe"), dtype=dtype)
    p = blocks.init_moe(cfg, torch.Generator().manual_seed(0), "cpu")["moe"]
    assert p["router"].dtype == torch.float32
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(DT[dtype])
    kw = dict(num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
              capacity_factor=cfg.capacity_factor, act=cfg.act)
    want, want_aux = moe.moe_block(x, p, **kw)
    got, aux = moe.moe_block(x.to(dev), {n: t.to(dev) for n, t in p.items()}, **kw)
    _close(got.cpu(), want, 2e-5 if dtype == "float32" else 3e-2)
    assert abs(float(aux) - float(want_aux)) < 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_kernels_at_granite_heads(dev, dtype):
    """granite-moe's heads (24 query heads over 8 KV heads, head_dim 64):
    flash prefill and paged decode against their plain versions."""
    H, KV, hd, page, pps = 24, 8, 64, 16, 64
    g = torch.Generator(device=dev).manual_seed(24)
    tol = 2e-5 if dtype == "float32" else 3e-2
    for S in (64, 300, 512):
        q = torch.randn(1, H, S, hd, generator=g, device=dev).to(DT[dtype])
        k = torch.randn(1, KV, S, hd, generator=g, device=dev).to(DT[dtype])
        v = torch.randn(1, KV, S, hd, generator=g, device=dev).to(DT[dtype])
        _close(flash_attention.flash_attention(q, k, v, causal=True).contiguous(),
               flash_attention.plain(q, k, v, causal=True), tol)
    B, P = 8, 8 * pps + 1
    q = torch.randn(B, H, hd, generator=g, device=dev).to(DT[dtype])
    kp = torch.randn(P, KV, page, hd, generator=g, device=dev).to(DT[dtype])
    vp = torch.randn(P, KV, page, hd, generator=g, device=dev).to(DT[dtype])
    bt = (torch.randperm(P - 1, generator=g, device=dev)[:B * pps] + 1).view(B, pps)
    bt = bt.to(torch.int32).contiguous()
    sl = torch.tensor([1, 17, 64, 65, 300, 511, 777, 1024], dtype=torch.int32, device=dev)
    _close(paged_attention.paged_attention(q, kp, vp, bt, sl),
           paged_attention.plain(q, kp, vp, bt, sl), 2e-5 if dtype == "float32" else 4e-2)


def _claim_inputs(n, seed, dev):
    rng = np.random.default_rng(seed)
    state = rng.choice([0, 1, 2], size=n).astype(np.int32)
    cycle = rng.permutation(n).astype(np.int32)
    cycle[rng.random(n) < 0.05] = np.iinfo(np.int32).max
    cycle[rng.random(n) < 0.05] = -1
    return (torch.from_numpy(state).to(dev), torch.from_numpy(cycle).to(dev))


@pytest.mark.parametrize("n", [1, 300, 2048, 2049, 65536])
@pytest.mark.parametrize("k,block_n", [(1, None), (64, None), (64, 128), (5, 7),
                                       ("n+3", None), ("n+3", 256)])
def test_claim_kernel_is_bit_exact(dev, n, k, block_n):
    k = n + 3 if k == "n+3" else k
    state, cycle = _claim_inputs(n, n + k, dev)
    before = cmp_claim.launches
    got = cmp_claim.cmp_claim(state, cycle, k=k, block_n=block_n)
    assert cmp_claim.launches == before + 1  # one launch at every N
    want = cmp_claim.plain(state, cycle, k=k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [65536, 1 << 20])
def test_claim_bits_do_not_depend_on_block_n(dev, n):
    """block_n is the JAX package's tile; the kernel picks its own, so every
    block_n (tiles above the old one-CTA limit included) gives the same bits."""
    state, cycle = _claim_inputs(n, 5, dev)
    want = cmp_claim.plain(state, cycle, k=64)
    for block_n in (None, 64, 128, n, 1 << 20):
        got = cmp_claim.cmp_claim(state, cycle, k=64, block_n=block_n)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _pool_args(n, seed, dev):
    rng = np.random.default_rng(seed)
    state, cycle = _claim_inputs(n, seed, dev)
    retire = torch.from_numpy(rng.integers(-9, 9, size=n).astype(np.int32)).to(dev)
    deque = torch.tensor(int(rng.integers(-3, 50)), dtype=torch.int32, device=dev)
    return state, cycle, retire, deque


@pytest.mark.parametrize("n", [7, 512, 513, 5000, 65536])
def test_claim_pool_matches_plain_over_a_churn(dev, n):
    """claim_pool (claim + slotpool.claim's epilogue, one launch) against its
    plain version on all five outputs, over rounds that feed each claim's
    state and retire cycles into the next, with fresh AVAILABLE slots."""
    rng = np.random.default_rng(n)
    state, cycle, retire, deque = _pool_args(n, n, dev)
    for _ in range(12):
        k = int(rng.choice([1, 64, n + 3]))
        before = cmp_claim.launches
        got = cmp_claim.claim_pool(state, cycle, retire, deque, k=k)
        assert cmp_claim.launches == before + 1
        want = cmp_claim.plain_pool(state, cycle, retire, deque, k=k)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
        state, _, _, retire, deque = got
        fresh = torch.from_numpy(rng.random(n) < 0.2).to(dev)
        state = torch.where(fresh, 1, state).to(torch.int32)


@pytest.mark.parametrize("n", [300, 65536])
def test_claim_pool_graph_replay_matches_eager(dev, n):
    """A CUDA graph of claim_pool calls replays to the eager calls' bits, replay
    after replay: the arrival counter the last CTA resets is clean each time."""
    state, cycle, retire, deque = _pool_args(n, 1, dev)
    want = [cmp_claim.claim_pool(state, cycle, retire, deque, k=k) for k in (64, 5)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cmp_claim.claim_pool(state, cycle, retire, deque, k=64)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [cmp_claim.claim_pool(state, cycle, retire, deque, k=k) for k in (64, 5)]
    for _ in range(3):
        for got in outs:
            for t in got:
                t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, w in zip(outs, want):
            for a, b in zip(got, w):
                assert torch.equal(a, b)
        again = cmp_claim.claim_pool(state, cycle, retire, deque, k=64)  # eager between replays
        for a, b in zip(again, want[0]):
            assert torch.equal(a, b)


def test_claim_pool_graphs_on_one_capture_stream_replay_in_any_order(dev):
    """Two graphs captured on torch's shared capture stream, the first call on
    that stream under capture, share one counter zeroed before either
    capture: replaying the second graph first gives the eager bits."""
    n = 65536
    state, cycle, retire, deque = _pool_args(n, 2, dev)
    want = {k: cmp_claim.claim_pool(state, cycle, retire, deque, k=k) for k in (64, 5)}
    graphs, outs = {}, {}
    for k in (64, 5):
        graphs[k] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[k]):
            outs[k] = cmp_claim.claim_pool(state, cycle, retire, deque, k=k)
    for k in (5, 64, 5):
        graphs[k].replay()
        torch.cuda.synchronize()
        for a, b in zip(outs[k], want[k]):
            assert torch.equal(a, b)


def test_claim_refuses_a_first_call_under_capture(dev, monkeypatch):
    """A device's counters are zeroed outside capture: with none made yet, a
    call under capture raises instead of capturing the fill."""
    monkeypatch.setattr(cmp_claim, "_blocks", {})
    monkeypatch.setattr(cmp_claim, "_counters", {})
    state, cycle = _claim_inputs(4096, 3, dev)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="under CUDA-graph capture"):
        with torch.cuda.graph(graph):
            cmp_claim.cmp_claim(state, cycle, k=64)


def test_slotpool_claim_on_card_matches_cpu(dev):
    """A short FIFO churn on a 5000-slot pool (one claim_pool launch a
    claim): card and CPU pools stay bit-identical after every op."""
    rng = np.random.default_rng(3)
    pools = {"cuda": slotpool.make(5000, dev), "cpu": slotpool.make(5000, "cpu")}
    for name in pools:
        pools[name], _, _ = slotpool.produce(pools[name], 3000)
    for _ in range(40):
        kp, kc = int(rng.integers(1, 65)), int(rng.integers(1, 65))
        outs = {}
        for name, pool in pools.items():
            pool, _, _ = slotpool.produce(pool, kp)
            pool, ids, valid = slotpool.claim(pool, kc)
            pool = slotpool.advance(pool, pool.deque_cycle + 1)
            pool, _ = slotpool.reclaim(pool, 128)
            pools[name], outs[name] = pool, (ids, valid)
        for a, b in zip(outs["cuda"] + tuple(pools["cuda"]),
                        outs["cpu"] + tuple(pools["cpu"])):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("B,H,KV,hd,page,P,pps", [
    (2, 4, 2, 32, 8, 16, 4), (3, 8, 8, 64, 16, 32, 6), (4, 16, 1, 16, 4, 24, 5),
    (2, 32, 4, 128, 16, 40, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain(dev, B, H, KV, hd, page, P, pps, dtype):
    g = torch.Generator(device=dev).manual_seed(B * 100 + H + hd)
    q = torch.randn(B, H, hd, generator=g, device=dev).to(DT[dtype])
    kp = torch.randn(P, KV, page, hd, generator=g, device=dev).to(DT[dtype])
    vp = torch.randn(P, KV, page, hd, generator=g, device=dev).to(DT[dtype])
    bt = torch.randint(0, P, (B, pps), generator=g, device=dev, dtype=torch.int32)
    sl = torch.randint(2, pps * page + 1, (B,), generator=g, device=dev,
                       dtype=torch.int32)
    sl[0], sl[1] = 1, 0
    _close(paged_attention.paged_attention(q, kp, vp, bt, sl),
           paged_attention.plain(q, kp, vp, bt, sl),
           2e-5 if dtype == "float32" else 4e-2)


@pytest.mark.parametrize("B,H,KV,S,T,hd,causal,window", [
    (1, 4, 4, 128, 128, 32, True, 0), (2, 8, 2, 256, 256, 64, True, 0),
    (1, 16, 1, 192, 192, 64, True, 0), (2, 4, 2, 100, 100, 16, True, 0),
    (2, 4, 2, 256, 256, 32, True, 32), (1, 4, 2, 64, 64, 32, False, 0),
    (1, 4, 2, 70, 130, 128, False, 0), (1, 32, 4, 300, 300, 128, True, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(dev, B, H, KV, S, T, hd, causal, window, dtype):
    g = torch.Generator(device=dev).manual_seed(S + H + hd)
    q = torch.randn(B, H, S, hd, generator=g, device=dev).to(DT[dtype])
    k = torch.randn(B, KV, T, hd, generator=g, device=dev).to(DT[dtype])
    v = torch.randn(B, KV, T, hd, generator=g, device=dev).to(DT[dtype])
    got = flash_attention.flash_attention(q, k, v, causal=causal, sliding_window=window)
    want = flash_attention.plain(q, k, v, causal=causal, sliding_window=window)
    _close(got.contiguous(), want, 2e-5 if dtype == "float32" else 3e-2)


def test_flash_kernel_reads_strided_model_layout(dev):
    """The model layout [B, S, H, hd] goes in through strides, no copy."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(2, 50, 8, 32, generator=g, device=dev)
    k = torch.randn(2, 50, 2, 32, generator=g, device=dev)
    v = torch.randn(2, 50, 2, 32, generator=g, device=dev)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.is_contiguous()
    want = flash_attention.plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True).transpose(1, 2)
    _close(got, want.contiguous(), 2e-5)


@pytest.mark.parametrize("S,T,hd,causal,window", [
    (64, 64, 128, True, 0),      # one 64x64x128 tile
    (64, 64, 64, False, 0),      # one tile, hd 64 (one swizzled block)
    (65, 65, 128, True, 0),      # ragged: a second tile of one row
    (200, 200, 128, True, 0),    # ragged S and T
    (512, 512, 128, True, 100),  # window edge inside tiles
    (96, 333, 128, False, 0),    # non-causal, T != S
    (130, 70, 128, True, 0),     # causal, T < S
    (128, 128, 40, True, 0)])    # hd 40, zero-padded to 64
def test_flash_bf16_tensor_core_tiles(dev, S, T, hd, causal, window):
    """The bf16 wgmma kernel at the serving path's heads (H=32, KV=4)."""
    g = torch.Generator(device=dev).manual_seed(S * 7 + T + hd)
    q = torch.randn(1, 32, S, hd, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, 4, T, hd, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(1, 4, T, hd, generator=g, device=dev).to(torch.bfloat16)
    before = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, causal=causal, sliding_window=window)
    assert flash_attention.launches == before + 1
    want = flash_attention.plain(q, k, v, causal=causal, sliding_window=window)
    _close(got.contiguous(), want, 3e-2)


def test_flash_bf16_reads_strided_model_layout(dev):
    """bf16 model layout [B, S, H, hd] (as prefill hands it in) through strides."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn(2, 150, 32, 128, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(2, 150, 4, 128, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(2, 150, 4, 128, generator=g, device=dev).to(torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    assert got.is_contiguous()
    want = flash_attention.plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True).transpose(1, 2)
    _close(got, want.contiguous(), 3e-2)


def test_flash_bf16_refuses_unaligned_rows(dev):
    q = torch.zeros(1, 2, 8, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q[:, :1], q[:, :1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_edges(dev, dtype):
    """pps = 64 pages of 16 (the serving path's table): 16 splits of 4 pages.
    B = 1 lanes at seq_len 0, 1, a chunk multiple (64, 128), a chunk edge
    inside a page (65, 72), a partial last page (1000) and the full 1024."""
    H, KV, hd, page, pps = 32, 4, 128, 16, 64
    P = pps + 3
    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(1, H, hd, generator=g, device=dev).to(DT[dtype])
    kp = torch.randn(P, KV, page, hd, generator=g, device=dev).to(DT[dtype])
    vp = torch.randn(P, KV, page, hd, generator=g, device=dev).to(DT[dtype])
    bt = torch.randperm(P, generator=g, device=dev)[:pps].view(1, pps).to(torch.int32)
    tol = 2e-5 if dtype == "float32" else 4e-2
    for n in (0, 1, 64, 65, 72, 128, 1000, 1024):
        sl = torch.tensor([n], dtype=torch.int32, device=dev)
        before = paged_attention.launches
        got = paged_attention.paged_attention(q, kp, vp, bt, sl)
        assert paged_attention.launches == before + paged_attention.launches_per_call(
            pps, page) == before + 2
        want = paged_attention.plain(q, kp, vp, bt, sl)
        _close(got, want, tol)
        if n == 0:
            assert not got.any()


def test_paged_launches_per_call(dev):
    """One launch when the table fits one split, two (split + combine)
    otherwise."""
    g = torch.Generator(device=dev).manual_seed(2)
    for pps, want in ((4, 1), (5, 2), (64, 2)):
        q = torch.randn(2, 8, 64, generator=g, device=dev)
        kp = torch.randn(pps * 2, 2, 16, 64, generator=g, device=dev)
        bt = torch.arange(pps * 2, device=dev, dtype=torch.int32).view(2, pps)
        sl = torch.tensor([pps * 16, 3], dtype=torch.int32, device=dev)
        before = paged_attention.launches
        got = paged_attention.paged_attention(q, kp, kp, bt, sl)
        assert paged_attention.launches - before == want
        _close(got, paged_attention.plain(q, kp, kp, bt, sl), 2e-5)


def test_paged_bf16_refuses_what_its_tiles_do_not_take(dev):
    """bf16 heads the 16 x 8 x 16 tensor-core tiles do not take (a head_dim
    that is not a multiple of 16) run on the scalar kernel, pages that do
    not divide 64 on 64-token splits; what no path takes, a head_dim that
    is not a multiple of 4 (16-byte row copies) or (H/KV) * head_dim above
    4,096 (one CTA's query rows), is refused rather than run."""
    for page, hd in ((48, 64), (16, 40)):
        q = torch.randn(1, 4, hd, device=dev).to(torch.bfloat16)
        kp = torch.randn(4, 2, page, hd, device=dev).to(torch.bfloat16)
        bt = torch.tensor([[1, 3]], device=dev, dtype=torch.int32)
        sl = torch.tensor([page + 5], device=dev, dtype=torch.int32)
        _close(paged_attention.paged_attention(q, kp, kp, bt, sl),
               paged_attention.plain(q, kp, kp, bt, sl), 4e-2)
    for H, KV, hd in ((4, 2, 6), (64, 1, 128)):
        q = torch.zeros(1, H, hd, device=dev, dtype=torch.bfloat16)
        kp = torch.zeros(4, KV, 16, hd, device=dev, dtype=torch.bfloat16)
        bt = torch.zeros(1, 2, device=dev, dtype=torch.int32)
        sl = torch.ones(1, device=dev, dtype=torch.int32)
        with pytest.raises(ValueError):
            paged_attention.paged_attention(q, kp, kp, bt, sl)


def _paged_case(dev, B, H, KV, hd, page, pps, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    P = B * pps + 1
    q = torch.randn(B, H, hd, generator=g, device=dev).to(DT[dtype])
    kp = torch.randn(P, KV, page, hd, generator=g, device=dev).to(DT[dtype])
    vp = torch.randn(P, KV, page, hd, generator=g, device=dev).to(DT[dtype])
    bt = (torch.randperm(P - 1, generator=g, device=dev)[:B * pps] + 1).view(B, pps)
    T = pps * page
    sl = torch.tensor([1, page, min(64, T), min(65, T), T - 1, T][:B], dtype=torch.int32,
                      device=dev)
    return q, kp, vp, bt.to(torch.int32).contiguous(), sl


@pytest.mark.parametrize("page", [8, 24, 32, 48, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_every_page_size(dev, page, dtype):
    """64-token splits at any page size: pages that divide 64, that do not
    (24, 48: a page straddles two splits) and that exceed it (128, 256: a
    page is several splits), at Yi-6B's heads (bf16 on the mma tiles)."""
    pps = max(1, 1024 // page)
    q, kp, vp, bt, sl = _paged_case(dev, 6, 32, 4, 128, page, pps, dtype, page)
    before = paged_attention.launches
    got = paged_attention.paged_attention(q, kp, vp, bt, sl)
    assert paged_attention.launches - before == paged_attention.launches_per_call(pps, page)
    _close(got, paged_attention.plain(q, kp, vp, bt, sl),
           2e-5 if dtype == "float32" else 4e-2)


@pytest.mark.parametrize("H,KV,hd", [(4, 2, 8), (8, 2, 72), (32, 32, 96), (32, 1, 128),
                                     (32, 2, 128), (64, 2, 64)])
def test_paged_bf16_heads_past_the_mma_tiles(dev, H, KV, hd):
    """bf16 head shapes the mma tiles do not take (head_dim 8 and 72, H/KV
    32 and 32 at hd 64) on the scalar kernel, beside phi3's hd 96 and glm4's
    H/KV 16 on the tiles, against the plain version at 2e-2."""
    q, kp, vp, bt, sl = _paged_case(dev, 6, H, KV, hd, 16, 40, "bfloat16", H + hd)
    got = paged_attention.paged_attention(q, kp, vp, bt, sl)
    _close(got, paged_attention.plain(q, kp, vp, bt, sl), 2e-2)


@pytest.mark.parametrize("B", [2, 4])
@pytest.mark.parametrize("page,pps", [(16, 16), (128, 2)])
def test_paged_bf16_at_the_serve_drivers_decode(dev, B, page, pps):
    """The serve driver's decode: glm4-9b's heads (32 over 2, hd 128), 2
    lanes a replica (4 on one), max_seq 256 as 16 pages of 16 or 2 of 128,
    contexts of 3-15 tokens (3-7-token prompts and 8 new tokens)."""
    q, kp, vp, bt, _ = _paged_case(dev, B, 32, 2, 128, page, pps, "bfloat16", B + page)
    for n in range(13):  # lane b at 3 + (n + 3b) % 13: every lane sees 3..15
        sl = torch.tensor([3 + (n + 3 * b) % 13 for b in range(B)], dtype=torch.int32,
                          device=dev)
        _close(paged_attention.paged_attention(q, kp, vp, bt, sl),
               paged_attention.plain(q, kp, vp, bt, sl), 2e-2)


@pytest.mark.parametrize("H,KV,hd", [(32, 2, 128), (32, 32, 96), (32, 32, 64), (64, 8, 128)])
@pytest.mark.parametrize("S", [2, 3, 5, 7])
def test_flash_bf16_short_prompts_in_one_tile(dev, H, KV, hd, S):
    """A prompt of a few tokens in bf16 (the serve driver's prefills): one
    wgmma tile with S live rows, the rest zero-filled by the TMA boxes, in
    the model layout, at the heads of glm4-9b, phi3, musicgen and
    command-r."""
    from repro_torch.kernels import ops

    g = torch.Generator(device=dev).manual_seed(S * 1000 + H + KV + hd)
    q = torch.randn(1, S, H, hd, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(1, S, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(1, S, KV, hd, generator=g, device=dev).to(torch.bfloat16)
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    want = flash_attention.plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True).transpose(1, 2)
    _close(got, want.contiguous(), 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [5.0, 30.0])
def test_attention_kernels_softcap(dev, dtype, cap):
    """A logit softcap in both attention kernels (paged on the mma tiles and
    the scalar path; flash on wgmma tiles and the f32 kernel) against their
    plain versions; inputs scaled so the cap bites."""
    tol = 2e-5 if dtype == "float32" else 3e-2
    g = torch.Generator(device=dev).manual_seed(int(cap))
    for H, KV, hd in ((32, 4, 128), (8, 2, 72)):
        q, kp, vp, bt, sl = _paged_case(dev, 6, H, KV, hd, 16, 40, dtype, hd)
        q = (q.float() * 8).to(q.dtype)
        _close(paged_attention.paged_attention(q, kp, vp, bt, sl, softcap=cap),
               paged_attention.plain(q, kp, vp, bt, sl, softcap=cap), tol)
    for S, hd in ((200, 128), (77, 64)):
        q = (torch.randn(1, 8, S, hd, generator=g, device=dev) * 8).to(DT[dtype])
        k = torch.randn(1, 2, S, hd, generator=g, device=dev).to(DT[dtype])
        v = torch.randn(1, 2, S, hd, generator=g, device=dev).to(DT[dtype])
        got = flash_attention.flash_attention(q, k, v, causal=True, softcap=cap)
        _close(got.contiguous(), flash_attention.plain(q, k, v, causal=True, softcap=cap),
               tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_prefill_on_card_matches_plain(dev, dtype):
    """A prefill past position 0 (two chunks) and a softcapped config
    through paged_forward on the card (the paged kernel over B*S rows)
    against the same calls on the CPU (the plain versions): logits within
    the dtype's tolerance."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.paged_model import paged_forward

    for cap in (0.0, 30.0):
        cfg = dataclasses.replace(get_config("glm4-9b", smoke=True), dtype=dtype,
                                  attn_softcap=cap)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        L, KV, hd, page, pps = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, 8, 4
        shape = (L, 9, KV, page, hd)
        bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
        toks = torch.randint(1, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
        outs = {}
        for d in ("cpu", dev):
            p = _tree_to(params, d)
            kp, vp = torch.zeros(shape, dtype=DT[dtype], device=d), torch.zeros(
                shape, dtype=DT[dtype], device=d)
            sl = torch.zeros(2, dtype=torch.int32, device=d)
            logits = []
            for lo, hi in ((0, 11), (11, 20)):
                out, kp, vp = paged_forward(p, toks[:, lo:hi].to(d), cfg, kp, vp, bt.to(d), sl)
                logits.append(out.cpu())
                sl = sl + (hi - lo)
            outs[str(d)] = logits
        for a, b in zip(outs[str(dev)], outs["cpu"]):
            torch.testing.assert_close(a, b, atol=1e-4 if dtype == "float32" else 5e-2,
                                       rtol=1e-4 if dtype == "float32" else 5e-2)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("n", [17600, 32768, 65536])
def test_ring_grid_path_engine_sizes_bit_exact(dev, n):
    """Rings past the one-CTA limit (max_batch 1,100, 2,048 and 4,096 give
    N = 17,600, 32,768, 65,536) take the grid path: the engine's trajectory
    bit-exact at every step, four launches a call that can claim."""
    k, window = n // 2, n // 4
    rng = np.random.default_rng(n)
    state = torch.zeros(n, dtype=torch.int32, device=dev)
    cycle, meta = torch.zeros_like(state), torch.zeros(2, dtype=torch.int32, device=dev)
    claims = 0
    for _ in range(25):
        req = (int(rng.integers(0, n // 2 + 1)), int(rng.choice([k, int(rng.integers(0, k + 1))])))
        before = cmp_ring.launches
        got = cmp_ring.cmp_ring_step(state, cycle, meta, req, k=k, window=window)
        assert cmp_ring.launches - before == cmp_ring.grid_launches(k, req[1])
        want = cmp_ring.plain(state, cycle, meta, req, k=k, window=window)
        for name, a, b in zip(("state", "cycle", "meta", "claimed"), got, want):
            assert torch.equal(a, b), (name, req)
        state, cycle, meta = got[:3]
        claims += int((got[3] >= 0).sum())
    assert claims > 0


@pytest.mark.parametrize("n", [16385, 32768])
@pytest.mark.parametrize("case", ["random", "permuted", "duplicate", "near_max", "wrapped"])
def test_ring_grid_path_general_inputs_bit_exact(dev, n, case):
    """The grid path on states that break the enqueue invariant: duplicate
    cycles make the oracle's threshold select claim more slots than take,
    which the grid path's publish repeats; k > claimable, want 0 and < 0,
    push_n = N and past it, window 0."""
    rng = np.random.default_rng(n * 10 + len(case))
    state, cycle, meta = (t.to(dev) for t in _broken_ring(n, case, rng))
    half = n // 2
    for k, req, window in ((half, (int(rng.integers(0, n + 1)), half), n // 4),
                           (n, (0, n), 0), (half, (n // 3, 0), n // 4),
                           (1, (n, 1), n), (half, (n + 7, -1), 3),
                           (n, (n // 2, n // 2 + 1), n // 4)):
        got = cmp_ring.cmp_ring_step(state, cycle, meta, req, k=k, window=window)
        want = cmp_ring.plain(state, cycle, meta, req, k=k, window=window)
        for name, a, b in zip(("state", "cycle", "meta", "claimed"), got, want):
            assert a.dtype == b.dtype and torch.equal(a, b), (name, req, k)
        state, cycle, meta = got[:3]


def _smoke_engine_run(dev, dtype, **kw):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine

    cfg = dataclasses.replace(get_config("glm4-9b", smoke=True), dtype=dtype)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = Engine(cfg, params, device=dev, **kw)
    prompts = [[(7 * i + j) % 500 + 1 for j in range(3 + i % 40)] for i in range(12)]
    uids = eng.submit_many(prompts, max_new_tokens=6)
    done = eng.run_until_idle(max_steps=200)
    assert all(u is not None and len(done[u].output) == 6 for u in uids)
    return eng


def test_engine_serves_page_128_in_bf16(dev):
    """Engine(page_size=128) on a bf16 model: the paged kernel's 64-token
    splits take a page of 128 as two splits."""
    before = paged_attention.launches
    eng = _smoke_engine_run(dev, "bfloat16", max_batch=4, page_size=128, num_pages=16,
                            max_seq=256)
    assert paged_attention.launches > before and eng.page_size == 128


def test_engine_serves_max_batch_1100_with_device_admission(dev):
    """Engine(max_batch=1100, device_admission=True): its ring of 17,600
    slots runs the grid path."""
    before = cmp_ring.launches
    eng = _smoke_engine_run(dev, "float32", max_batch=1100, page_size=8, num_pages=1200,
                            max_seq=64, device_admission=True)
    assert eng._dev_admit.capacity == 17600
    assert cmp_ring.launches - before >= 4


@pytest.mark.parametrize("arch", ["yi_6b", "granite_moe"])
def test_train_steps_on_card_match_cpu(dev, arch):
    """Three Trainer steps on a float32 smoke model on the card and on the
    CPU from the same params: the losses within 1e-5 and the params within
    1e-4 (f32 sums in another order; AdamW's per-element division carries
    a last-bit difference to a few ulps of lr a step), and no serving
    kernel launched (training attends through the plain path)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_loop import Trainer

    cfg = get_config(arch, smoke=True)
    opt = O.OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    batches = [synth_batch(0, i, 2, 16, cfg.vocab_size) for i in range(3)]
    kernels = (cmp_claim, cmp_ring, flash_attention, paged_attention)
    before = [m.launches for m in kernels]
    cpu = Trainer(cfg, opt, seed=1, device="cpu")
    card = Trainer(cfg, opt, seed=1, device=dev)
    card.params = O.tree_unflatten(cpu.params, iter([p.to(dev) for p in
                                                     O.tree_leaves(cpu.params)]))
    card.opt_state = O.init(card.params, opt)
    for tr in (cpu, card):
        tr.fit(iter(batches), 3)
    np.testing.assert_allclose(card.history, cpu.history, atol=1e-5, rtol=1e-5)
    for a, b in zip(O.tree_leaves(card.params), O.tree_leaves(cpu.params)):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    assert [m.launches for m in kernels] == before


@pytest.mark.parametrize("S", [300, 1100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_impl_pallas_at_hymba_heads(dev, dtype, S):
    """``self_attention(impl="pallas")`` on the card launches the flash
    kernel once, at hymba-1.5b's heads (25 over 5, hd 64) and window
    (1,024: past it at S = 1,100), in the model layout, and agrees with the
    plain attention (``impl="ref"``); it refuses inputs that record a
    graph."""
    from repro_torch.models import layers as TL

    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(1, S, 25, 64, generator=g, device=dev).to(DT[dtype])
    k, v = (torch.randn(1, S, 5, 64, generator=g, device=dev).to(DT[dtype]) for _ in range(2))
    before = flash_attention.launches
    got = TL.self_attention(q, k, v, sliding_window=1024, impl="pallas")
    assert flash_attention.launches == before + 1
    want = TL.self_attention(q, k, v, sliding_window=1024, impl="ref")
    _close(got.contiguous(), want, 2e-5 if dtype == "float32" else 3e-2)
    with pytest.raises(NotImplementedError):
        TL.self_attention(q.requires_grad_(True), k, v, sliding_window=1024, impl="pallas")


@pytest.mark.parametrize("arch", ["xlstm_125m", "hymba_1_5b"])
def test_decode_step_of_new_block_kinds_on_card_matches_cpu(dev, arch):
    """A prefill and one decode step of the mlstm and slstm kinds (xLSTM)
    and of hymba (KV ring + Mamba state) on a float32 smoke model, card
    against CPU from the same params: logits and every cache leaf within
    1e-5 (f32 sums in another order), -inf stabilisers in the same places,
    and no kernel launched (the plain attention path)."""
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.training import optimizer as O

    cfg = get_config(arch, smoke=True)
    g = torch.Generator().manual_seed(2)
    params = init_params(cfg, g, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9), generator=g, dtype=torch.int32)
    kernels = (cmp_claim, cmp_ring, flash_attention, paged_attention)
    before = [m.launches for m in kernels]
    out = {}
    for d in ("cpu", dev):
        p = O.tree_unflatten(params, iter([x.to(d) for x in O.tree_leaves(params)]))
        cache = init_cache(cfg, 2, 12, device=d)
        _, cache = prefill(p, tokens[:, :8].to(d), cfg, cache)
        lg, cache = decode_step(p, tokens[:, 8:].to(d), cfg, cache)
        out[str(d)] = [lg] + O.tree_leaves(cache)
    assert [m.launches for m in kernels] == before
    for a, b in zip(out[str(dev)], out["cpu"], strict=True):
        assert a.is_cuda and a.dtype == b.dtype
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-5)



# the xLSTM time loops (kernels/xlstm_scan.py) at xlstm-125m's widths: 4
# heads of 192. Tolerances: atol = rtol = 2e-2 in bfloat16 (inputs and h
# rounded to bf16 at the same points, f32 sums in another order, the
# recurrence carrying a rounding one ulp apart), and a relative L2 of 1e-4
# in float32 (the same arithmetic, sums over d = 192 in another order).
XL_H, XL_D = 4, 192


def _xl_close(got, want, dtype):
    """Infinities (the fresh stabiliser) in the same places, the rest close."""
    assert got.shape == want.shape and got.dtype == want.dtype and got.is_cuda
    got, want = got.detach(), want.detach()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], want[~fin])
    got, want = got[fin], want[fin]
    if dtype == "bfloat16":
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    else:
        err = ((got.float() - want.float()).norm() / want.float().norm().clamp(min=1e-30))
        assert float(err) <= 1e-4, float(err)


def _mlstm_inputs(dev, dtype, B, S, carried, seed=0, d=XL_D, extreme=False):
    """q, k (scaled), v, the log gates and a state; ``extreme``: a fifth of
    the gates at their extremes, log_i +-30 and f_pre -30 or +30."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    q, k, v = (rnd(B, XL_H, S, d).to(DT[dtype]) for _ in range(3))
    k = k / torch.tensor(d ** 0.5).to(k.dtype)
    log_i, f_pre = rnd(B, XL_H, S), rnd(B, XL_H, S) + 2.0
    if extreme:
        u, w = (torch.rand(B, XL_H, S, generator=g, device=dev) for _ in range(2))
        log_i = torch.where(u < 0.1, 30.0, torch.where(u > 0.9, -30.0, log_i))
        f_pre = torch.where(w < 0.1, -30.0, torch.where(w > 0.9, 30.0, f_pre))
    log_f = torch.nn.functional.logsigmoid(f_pre)
    if carried:
        C, n, m = rnd(B, XL_H, d, d) * 0.1, rnd(B, XL_H, d) * 0.1, rnd(B, XL_H)
    else:
        C, n = torch.zeros(B, XL_H, d, d, device=dev), torch.zeros(B, XL_H, d, device=dev)
        m = torch.full((B, XL_H), float("-inf"), device=dev)
    return q, k, v, log_i, log_f, C, n, m


# (B, S, carried, d, extreme): at B = 2 every S of one step, past the chunk
# of 32 and not a multiple of it, fresh and carried, at both widths; then
# B = 1, 3, 5 and the extreme gates
MLSTM_CASES = [(2, S, carried, d, False) for d in (XL_D, 40) for carried in (False, True)
               for S in (1, 40, 100)]
MLSTM_CASES += [(1, 37, True, XL_D, False), (3, 70, False, XL_D, False),
                (5, 33, True, XL_D, False), (5, 96, False, 40, False),
                (2, 100, False, XL_D, True), (3, 45, True, XL_D, True), (1, 1, True, XL_D, True)]


@pytest.mark.parametrize("B,S,carried,d,extreme", MLSTM_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_kernels_match_plain(dev, dtype, B, S, carried, d, extreme):
    """The chunkwise mLSTM forward kernel against ``ref.ref_mlstm_fwd_saved``
    (h, the state, and every saved tensor), the backward kernels against
    ``ref.ref_mlstm_bwd`` on the forward kernel's saves, 1 + 2 launches:
    S of one step, past the chunk and not a multiple of it; B = 1, 2, 3, 5;
    at xlstm-125m's head width and at 40 (a last block of 8 value columns);
    gates at their extremes (float32's h there: row by row to the float64
    loop, ``torch_xlstm_rows.py``)."""
    from repro_torch.kernels import ref, xlstm_scan as xs

    args = _mlstm_inputs(dev, dtype, B, S, carried, d=d, extreme=extreme)
    before = dict(xs.launches)
    h, C, n, m, saved = xs.mlstm_fwd(*args, save=True)
    want = ref.ref_mlstm_fwd_saved(*args, xs.kernel_chunk())
    apart = extreme and dtype == "float32"
    for i, (got_t, want_t) in enumerate(zip((h, C, n, m, *saved), (*want[:4], *want[4]),
                                            strict=True)):
        if apart and i in (0, 8):  # h and its float32 save
            continue
        _xl_close(got_t, want_t, "float32" if got_t.dtype == torch.float32 and dtype ==
                  "float32" else "bfloat16")
    if apart:
        check_rows(args, saved[4], want[4][4])
    g = torch.Generator(device=dev).manual_seed(9)
    dh = torch.randn(h.shape, generator=g, device=dev).to(h.dtype)
    dC, dn, dm = (torch.randn(t.shape, generator=g, device=dev) for t in (C, n, m))
    got = xs.mlstm_bwd(*args[:5], saved, dh, dC, dn, dm)
    want = ref.ref_mlstm_bwd(*args[:5], saved, dh, dC, dn, dm, xs.kernel_chunk())
    for a, b in zip(got, want, strict=True):
        _xl_close(a, b, dtype)
    assert xs.launches["mlstm_fwd"] == before["mlstm_fwd"] + 1
    assert xs.launches["mlstm_bwd"] == before["mlstm_bwd"] + 2


@pytest.mark.parametrize("S,carried", EXTREME_CASES)
def test_mlstm_kernel_on_ill_conditioned_rows(dev, S, carried):
    """The float32 forward kernel on the CPU tests' extreme cases (2 x 4
    heads of 16), whose h has rows so ill-conditioned that the float32
    plain loop is more than 1e-4 of the row off float64 (on the CPU, as
    those tests find them): h held by the row check with its looser branch
    run (``torch_xlstm_cases.py``), everything else to the plain loop."""
    from repro_torch.kernels import xlstm_scan as xs

    args, want = extreme_case(S, carried)
    h, C, n, m, saved = xs.mlstm_fwd(*(a.to(dev) for a in args), save=True)
    assert check_rows(args, saved[4].cpu(), want[4][4]) > 0
    for got_t, want_t in zip((C, n, m, *saved[:4]), (*want[1:4], *want[4][:4]), strict=True):
        _xl_close(got_t, want_t.to(dev), "float32")


def _slstm_inputs(dev, dtype, B, S, carried, seed=0, hd=XL_D, extreme=False):
    """zx, ix, fx, ox, r and a state; ``extreme``: ix and fx scaled by 30,
    so the gate means reach +-30."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    xs_ = [rnd(B, S, XL_H, hd) for _ in range(4)]
    if extreme:
        xs_[1], xs_[2] = xs_[1] * 30, xs_[2] * 30
    xs_ = [t.to(DT[dtype]) for t in xs_]
    r = (rnd(XL_H, hd, 4 * hd) * hd ** -0.5).to(DT[dtype]).float()
    if carried:
        c, h = rnd(B, XL_H, hd), rnd(B, XL_H, hd) * 0.5
        n, m = rnd(B, XL_H, hd).abs() + 0.5, rnd(B, XL_H)
    else:
        c = n = h = torch.zeros(B, XL_H, hd, device=dev)
        m = torch.full((B, XL_H), float("-inf"), device=dev)
    return (*xs_, r, c, n, h, m)


@pytest.mark.parametrize("extreme", [False, True])
@pytest.mark.parametrize("hd", [XL_D, 37])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S", [1, 40])
@pytest.mark.parametrize("B", [1, 2, 3, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_kernels_match_plain(dev, dtype, B, S, carried, hd, extreme):
    """The sLSTM forward kernel against ``ref.ref_slstm_fwd_saved`` and the
    backward kernels against ``ref.ref_slstm_bwd`` on the forward kernel's
    saves, 1 + 2 launches: B = 1, 2, 3 (one cluster of rows a head) and 5
    (two, the second of one row); at xlstm-125m's head width and at 37 (5
    elements a CTA, the last CTA's 3 past the head); gate means at +-30."""
    from repro_torch.kernels import ref, xlstm_scan as xs

    args = _slstm_inputs(dev, dtype, B, S, carried, hd=hd, extreme=extreme)
    before = dict(xs.launches)
    out = xs.slstm_fwd(*args, save=True)
    want = ref.ref_slstm_fwd_saved(*args)
    for a, b in zip((*out[:5], *out[5]), (*want[:5], *want[5]), strict=True):
        _xl_close(a, b, "float32" if a.dtype == torch.float32 and dtype == "float32"
                  else "bfloat16")
    g = torch.Generator(device=dev).manual_seed(9)
    grads = [torch.randn(t.shape, generator=g, device=dev).to(t.dtype) for t in out[:5]]
    got = xs.slstm_bwd(args[4], out[5], *grads)
    want = ref.ref_slstm_bwd(args[4], out[5], *grads)
    for a, b in zip(got, want, strict=True):
        _xl_close(a, b, dtype)
    assert xs.launches["slstm_fwd"] == before["slstm_fwd"] + 1
    assert xs.launches["slstm_bwd"] == before["slstm_bwd"] + 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_blocks_on_card_match_plain_autograd(dev, dtype):
    """``mlstm_block`` and ``slstm_block`` at xlstm-125m's width (d_model
    768, 4 heads) on the card, through the kernels' autograd Functions,
    against the same blocks on the plain loops with ordinary autograd (the
    wrapper's own plain versions, swapped in) on the card: outputs, final
    states and every gradient. The weights are at the model's init scale
    (0.02-0.03): a recurrent matrix ten times larger makes the sLSTM
    expand, and its float32 rounding then grows past 1e-4 over 70 steps
    in either version."""
    from repro_torch.kernels import xlstm_scan as xs
    from repro_torch.models import ssm

    g = torch.Generator(device=dev).manual_seed(3)
    D, B, S = 768, 2, 70
    x = (torch.randn(B, S, D, generator=g, device=dev) * 0.5).to(DT[dtype])
    mk = lambda *s: (torch.randn(*s, generator=g, device=dev) * 0.03).to(DT[dtype])  # noqa
    pm = {k: mk(D, D) for k in ("wq", "wk", "wv", "wo", "ogate")}
    pm |= {"wi": mk(D, XL_H), "wf": mk(D, XL_H)}
    ps = {k: mk(D, D) for k in ("wz", "wi", "wf", "wo", "wout")}
    ps |= {k: mk(XL_H, XL_D, XL_D) for k in ("rz", "ri", "rf", "ro")}
    runs = {}
    for how in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in (x, *pm.values(), *ps.values())]
        xx, pmm, pss = leaves[0], dict(zip(pm, leaves[1:8])), dict(zip(ps, leaves[8:]))
        real = (xs.mlstm, xs.slstm)
        if how == "plain":
            xs.mlstm, xs.slstm = xs.plain_mlstm, xs.plain_slstm
        try:
            before = dict(xs.launches)
            y1, st1 = ssm.mlstm_block(xx, pmm, num_heads=XL_H)
            y2, st2 = ssm.slstm_block(y1, pss, num_heads=XL_H)
            loss = (y2.float() ** 2).mean() + st1[0].sum() * 1e-3 + st2[2].sum() * 1e-3
            grads = torch.autograd.grad(loss, leaves)
        finally:
            xs.mlstm, xs.slstm = real
        moved = {k: xs.launches[k] - before[k] for k in xs.KERNELS}
        runs[how] = ([y2, *st1[:3], *st2], grads, moved)
    assert runs["kernel"][2] == {"mlstm_fwd": 1, "mlstm_bwd": 2, "slstm_fwd": 1, "slstm_bwd": 2}
    assert runs["plain"][2] == dict.fromkeys(xs.KERNELS, 0)
    for a, b in zip(runs["kernel"][0] + list(runs["kernel"][1]),
                    runs["plain"][0] + list(runs["plain"][1]), strict=True):
        _xl_close(a, b, dtype)


def test_xlstm_kernels_refuse_what_they_do_not_take(dev):
    """No fallback: a CUDA call outside the kernels' limits raises."""
    from repro_torch.kernels import xlstm_scan as xs

    q, k, v, li, lf, C, n, m = _mlstm_inputs(dev, "float32", 1, 3, False)
    with pytest.raises(ValueError):
        xs.mlstm(q.half(), k.half(), v.half(), li, lf, C, n, m)
    with pytest.raises(ValueError):
        xs.mlstm(q, k, v, li.double(), lf, C, n, m)
    wide = torch.zeros(1, 1, 2, 264, device=dev)
    with pytest.raises(ValueError):
        xs.mlstm(wide, wide, wide, li[:1, :1, :2], lf[:1, :1, :2],
                 torch.zeros(1, 1, 264, 264, device=dev), torch.zeros(1, 1, 264, device=dev),
                 m[:1, :1])
    zx = torch.zeros(1, 2, 1, 264, device=dev)
    st = torch.zeros(1, 1, 264, device=dev)
    with pytest.raises(ValueError):
        xs.slstm(zx, zx, zx, zx, torch.zeros(1, 264, 1056, device=dev), st, st, st,
                 m[:1, :1])


def _xl_backward(dev, kind, dtype, B, S, hd=XL_D):
    """One backward call of ``kind`` (mLSTM or sLSTM) on the forward kernel's
    saves from a carried state, seeded cotangents; (the gradients, the plain
    backward's gradients on the same saves)."""
    from repro_torch.kernels import ref, xlstm_scan as xs

    g = torch.Generator(device=dev).manual_seed(11)
    if kind == "mlstm":
        args = _mlstm_inputs(dev, dtype, B, S, True, d=hd)
        *out, saved = xs.mlstm_fwd(*args, save=True)
        cots = [torch.randn(t.shape, generator=g, device=dev).to(t.dtype) for t in out]
        return (lambda: xs.mlstm_bwd(*args[:5], saved, *cots),
                lambda: ref.ref_mlstm_bwd(*args[:5], saved, *cots, xs.kernel_chunk()))
    args = _slstm_inputs(dev, dtype, B, S, True, hd=hd)
    *out, saved = xs.slstm_fwd(*args, save=True)
    cots = [torch.randn(t.shape, generator=g, device=dev).to(t.dtype) for t in out]
    return (lambda: xs.slstm_bwd(args[4], saved, *cots),
            lambda: ref.ref_slstm_bwd(args[4], saved, *cots))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xlstm_backward_gives_the_same_bits_run_after_run(dev, dtype, kind):
    """No atomics: two backward calls on the same inputs give bit-equal
    gradients, at xlstm-125m's head width over 100 steps (several mLSTM
    chunks), at B = 2 and B = 5 (the sLSTM's two cluster shapes)."""
    for B in (2, 5):
        kernel, _ = _xl_backward(dev, kind, dtype, B, 100)
        first, second = kernel(), kernel()
        torch.cuda.synchronize()
        for a, b in zip(first, second, strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("B", [2, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_backward_cluster_shapes(dev, dtype, B):
    """The sLSTM backward's two cluster shapes at xlstm-125m's head width,
    100 steps from a carried state: G = 2 batch rows a cluster at B = 2 (one
    cluster a head), G = 4 at B = 5 (two clusters a head, the second of one
    row), against ``ref.ref_slstm_bwd`` on the forward kernel's saves, 2
    launches a call."""
    from repro_torch.kernels import xlstm_scan as xs

    kernel, plain = _xl_backward(dev, "slstm", dtype, B, 100)
    before = xs.launches["slstm_bwd"]
    got = kernel()
    assert xs.launches["slstm_bwd"] == before + 2
    for a, b in zip(got, plain(), strict=True):
        _xl_close(a, b, dtype)


# SSD's chunk loop and decode step (kernels/ssd_scan.py) at hymba-1.5b's
# width (25 heads, P = 64, N = 16, chunks of 256) and the smoke width (4
# heads, P = 16, N = 4). Tolerances as for the xLSTM loops: atol = rtol =
# 2e-2 in bfloat16 (y, dx, db, dc rounded to bf16 once, f32 sums in another
# order), a relative L2 of 1e-4 in float32.
SSD_WIDTHS = {"hymba": (25, 64, 16), "smoke": (4, 16, 4)}


def _ssd_inputs(dev, dtype, B, S, width, carried, seed=0):
    H, P, N = SSD_WIDTHS[width]
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    x = rnd(B, S, H, P).to(DT[dtype])
    b, c = ((rnd(B, S, H, N) * 0.5).to(DT[dtype]) for _ in range(2))
    log_a = -torch.nn.functional.softplus(rnd(B, S, H))
    state = rnd(B, H, P, N) if carried else torch.zeros(B, H, P, N, device=dev)
    return x, b, c, log_a, state


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("S,chunk", [(1, 1), (40, 16), (300, 256), (1100, 256), (200, 16)])
@pytest.mark.parametrize("width", list(SSD_WIDTHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernels_match_plain(dev, dtype, width, S, chunk, carried):
    """The SSD forward kernel against ``ref.ref_ssd_fwd_saved`` (y, the
    final state and the states saved at the chunk starts) and the backward
    kernels against ``ref.ref_ssd_bwd`` on the kernel's saves, with the
    launches ``LAUNCHES_PER_CALL`` gives; S = 300 in chunks of 256 pads its
    last chunk, S = 40 in 16 as well; S = 1,100 in 256 (5 chunks) and 200
    in 16 (13) are more chunks than a cluster's 4 CTAs, so the state goes
    from cluster group to group and the last group leaves CTAs idle."""
    from repro_torch.kernels import ref, ssd_scan as ss

    args = _ssd_inputs(dev, dtype, 2, S, width, carried)
    before = dict(ss.launches)
    y, h, saved = ss.ssd_fwd(*args, chunk=chunk, save=True)
    want = ref.ref_ssd_fwd_saved(*args, chunk)
    for a, b in zip((y, h, saved), want, strict=True):
        _xl_close(a, b, dtype if a.dtype == DT[dtype] else "float32")
    g = torch.Generator(device=dev).manual_seed(9)
    dy = torch.randn(y.shape, generator=g, device=dev).to(y.dtype)
    dh = torch.randn(h.shape, generator=g, device=dev)
    got = ss.ssd_bwd(*args[:4], saved, dy, dh, chunk=chunk)
    want = ref.ref_ssd_bwd(*args[:4], saved, dy, dh, chunk)
    for a, b in zip(got, want, strict=True):
        _xl_close(a, b, dtype)
    assert ss.launches["ssd_fwd"] == before["ssd_fwd"] + ss.LAUNCHES_PER_CALL["ssd_fwd"]
    assert ss.launches["ssd_bwd"] == before["ssd_bwd"] + ss.LAUNCHES_PER_CALL["ssd_bwd"]


@pytest.mark.parametrize("width", list(SSD_WIDTHS))
@pytest.mark.parametrize("x_dtype,bc_dtype", [("float32", "float32"), ("float32", "bfloat16"),
                                              ("bfloat16", "bfloat16")])
def test_ssd_decode_kernel_matches_plain(dev, x_dtype, bc_dtype, width):
    """The decode kernel against ``ref.ref_ssd_decode_step``, one launch;
    x in float32 with b, c in bf16 is the bf16 model's decode (its x is the
    float32 x * dt)."""
    from repro_torch.kernels import ref, ssd_scan as ss

    x, b, c, log_a, state = _ssd_inputs(dev, "float32", 4, 1, width, True)
    x = x[:, 0].to(DT[x_dtype])
    b, c = (t[:, 0].to(DT[bc_dtype]) for t in (b, c))
    before = ss.launches["ssd_decode"]
    got = ss.ssd_decode(x, b, c, log_a[:, 0], state)
    want = ref.ref_ssd_decode_step(x, b, c, log_a[:, 0], state)
    for a, w in zip(got, want, strict=True):
        _xl_close(a, w, x_dtype if a.dtype == DT[x_dtype] else "float32")
    assert ss.launches["ssd_decode"] == before + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_block_on_card_matches_plain_autograd(dev, dtype):
    """One hymba-1.5b layer (attention and the Mamba branch, d_model 1,600,
    25 SSD heads of 64) over 2 x 300 tokens on the card, the scan through
    ``SSD``'s kernels, against the same layer on the plain loop with
    ordinary autograd (swapped in) on the card: the output and every
    gradient; then one decode step of the branch through the decode
    kernel, also with autograd recording (``SSDDecode``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import blocks, ssm

    cfg = dataclasses.replace(get_config("hymba_1_5b"), dtype=dtype)
    g = torch.Generator(device=dev).manual_seed(4)
    params = blocks.init_hymba(cfg, g, dev)
    x = (torch.randn(2, 300, cfg.d_model, generator=g, device=dev) * 0.5).to(DT[dtype])
    names = [("mamba", k) for k in params["mamba"]]
    runs = {}
    for how in ("kernel", "plain"):
        leaves = [x.clone().requires_grad_(True)]
        leaves += [params[a][k].clone().requires_grad_(True) for a, k in names]
        p = dict(params) | {"mamba": dict(zip([k for _, k in names], leaves[1:]))}
        real = ss.ssd_chunked
        if how == "plain":
            ss.ssd_chunked = ss.plain_chunked
        try:
            before = dict(ss.launches)
            y, _, _ = blocks.apply_hymba(leaves[0], p, cfg)
            grads = torch.autograd.grad((y.float() ** 2).mean(), leaves)
        finally:
            ss.ssd_chunked = real
        moved = {k: ss.launches[k] - before[k] for k in ss.KERNELS}
        runs[how] = ([y, *grads], moved)
    assert runs["kernel"][1] == {"ssd_fwd": ss.LAUNCHES_PER_CALL["ssd_fwd"],
                                 "ssd_bwd": ss.LAUNCHES_PER_CALL["ssd_bwd"], "ssd_decode": 0}
    assert runs["plain"][1] == dict.fromkeys(ss.KERNELS, 0)
    for a, b in zip(runs["kernel"][0], runs["plain"][0], strict=True):
        _xl_close(a, b, dtype)
    H, P, N = SSD_WIDTHS["hymba"]
    state = torch.randn(2, H, P, N, generator=g, device=dev)
    xt = x[:, :1]
    with torch.no_grad():
        want = ssm.mamba_block(xt, params["mamba"], num_heads=H, ssm_state=N, state=state,
                               decode=True)
        ss.ssd_decode, real = ss.plain_decode, ss.ssd_decode
        try:
            plain = ssm.mamba_block(xt, params["mamba"], num_heads=H, ssm_state=N,
                                    state=state, decode=True)
        finally:
            ss.ssd_decode = real
    before = dict(ss.launches)
    xg = xt.clone().requires_grad_(True)
    got = ssm.mamba_block(xg, params["mamba"], num_heads=H, ssm_state=N, state=state,
                          decode=True)
    assert ss.launches["ssd_decode"] == before["ssd_decode"] + 1
    (dx,) = torch.autograd.grad((got[0].float() ** 2).mean(), xg)
    assert torch.isfinite(dx).all() and dx.abs().sum() > 0
    for a, b in zip(want, plain, strict=True):
        _xl_close(a, b, dtype if a.dtype == DT[dtype] else "float32")
    for a, b in zip(got, want, strict=True):
        _xl_close(a.detach(), b, dtype if a.dtype == DT[dtype] else "float32")


def test_ssd_kernels_refuse_what_they_do_not_take(dev):
    """No fallback: a CUDA call outside the kernels' limits raises: a
    float16 input, a float64 log_a, a tensor on the CPU, a state of width
    0. A chunk past 256, a state wider than 16 and a decode past 1,024
    value columns run (below)."""
    from repro_torch.kernels import ssd_scan as ss

    x, b, c, log_a, state = _ssd_inputs(dev, "float32", 1, 300, "smoke", False)
    with pytest.raises(ValueError):
        ss.ssd_chunked(x.half(), b.half(), c.half(), log_a, chunk=256, state=state)
    with pytest.raises(ValueError):
        ss.ssd_chunked(x, b, c, log_a.double(), chunk=256, state=state)
    with pytest.raises(ValueError):
        ss.ssd_chunked(x, b.cpu(), c, log_a, chunk=256, state=state)
    empty = torch.zeros(1, 3, 4, 0, device=dev)
    with pytest.raises(ValueError):
        ss.ssd_chunked(x[:, :3], empty, empty, log_a[:, :3], chunk=3,
                       state=torch.zeros(1, 4, 16, 0, device=dev))


@pytest.mark.parametrize("N,S,chunk", [(17, 40, 16), (64, 300, 256), (40, 70, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_states_wider_than_16(dev, dtype, N, S, chunk):
    """A state wider than the kernels' tile of 16 runs as ceil(N / 16)
    tiles: the forward kernel (+ the tiles' sum, 2 launches) against
    ``ref.ref_ssd_fwd_saved`` and the backward kernels against
    ``ref.ref_ssd_bwd`` on its saves, at 8 heads of P = 24 (a value block
    of 8 past 16), from a carried state."""
    from repro_torch.kernels import ref, ssd_scan as ss

    g = torch.Generator(device=dev).manual_seed(N)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    x = rnd(2, S, 8, 24).to(DT[dtype])
    b, c = ((rnd(2, S, 8, N) * 0.3).to(DT[dtype]) for _ in range(2))
    log_a = -torch.nn.functional.softplus(rnd(2, S, 8))
    args = (x, b, c, log_a, rnd(2, 8, 24, N))
    before = dict(ss.launches)
    y, h, saved = ss.ssd_fwd(*args, chunk=chunk, save=True)
    for a, w in zip((y, h, saved), ref.ref_ssd_fwd_saved(*args, chunk), strict=True):
        _xl_close(a, w, dtype if a.dtype == DT[dtype] else "float32")
    dy = rnd(*y.shape).to(y.dtype)
    dh = rnd(*h.shape)
    got = ss.ssd_bwd(*args[:4], saved, dy, dh, chunk=chunk)
    for a, w in zip(got, ref.ref_ssd_bwd(*args[:4], saved, dy, dh, chunk), strict=True):
        _xl_close(a, w, dtype)
    assert ss.launches["ssd_fwd"] == before["ssd_fwd"] + 2
    assert ss.launches["ssd_bwd"] == before["ssd_bwd"] + 2


def _ssd_both(ss, args, chunk, seed=9):
    """The forward kernel (with its saves) and the backward kernels on them,
    on cotangents from ``seed``: [y, h, saved, dx, db, dc, d log_a, dh0] and
    the cotangents."""
    y, h, saved = ss.ssd_fwd(*args, chunk=chunk, save=True)
    g = torch.Generator(device=y.device).manual_seed(seed)
    dy = torch.randn(y.shape, generator=g, device=y.device).to(y.dtype)
    dh = torch.randn(h.shape, generator=g, device=y.device)
    return [y, h, saved, *ss.ssd_bwd(*args[:4], saved, dy, dh, chunk=chunk)], (dy, dh)


@pytest.mark.parametrize("P,N", [(64, 16), (100, 24)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernels_repeat_the_same_bits(dev, dtype, P, N):
    """Two forward and two backward calls on the same inputs give the same
    bits (no float atomics): at hymba-1.5b's head (one launch each) and at a
    head split over value blocks and state tiles (the partials' sums)."""
    from repro_torch.kernels import ssd_scan as ss

    g = torch.Generator(device=dev).manual_seed(P + N)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    args = (rnd(2, 300, 5, P).to(DT[dtype]), (rnd(2, 300, 5, N) * 0.5).to(DT[dtype]),
            (rnd(2, 300, 5, N) * 0.5).to(DT[dtype]),
            -torch.nn.functional.softplus(rnd(2, 300, 5)), rnd(2, 5, P, N))
    first, _ = _ssd_both(ss, args, 256)
    again, _ = _ssd_both(ss, args, 256)
    for a, b in zip(first, again, strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_strong_decay_at_hymba_width(dev, dtype):
    """A decay of -0.7 a step, so a 256-token chunk's summed decay is 179,
    past float32's exp range (exp(-la_s) would overflow), at hymba-1.5b's
    width over 2 x 512 from a carried state: every output and gradient
    finite and equal to the plain loop's."""
    from repro_torch.kernels import ref, ssd_scan as ss

    x, b, c, _, state = _ssd_inputs(dev, dtype, 2, 512, "hymba", True, seed=3)
    args = (x, b, c, torch.full(x.shape[:3], -0.7, device=dev), state)
    got, (dy, dh) = _ssd_both(ss, args, 256)
    y, h, saved = ref.ref_ssd_fwd_saved(*args, 256)
    want = [y, h, saved, *ref.ref_ssd_bwd(*args[:4], saved, dy, dh, 256)]
    for a, w in zip(got, want, strict=True):
        assert torch.isfinite(a).all()
        _xl_close(a, w, dtype if a.dtype == DT[dtype] else "float32")


@pytest.mark.parametrize("P", [24, 37, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_value_widths(dev, dtype, P):
    """Heads of P = 24 and 37 (not a multiple of 16; 37 odd, so no pair
    stores and no 16-byte loads) and 100 (past the backward's value block of
    64: its partials and second launch): the forward against
    ``ref.ref_ssd_fwd_saved`` and the backward against ``ref.ref_ssd_bwd``
    on its saves, 2 x 300 in chunks of 256 from a carried state."""
    from repro_torch.kernels import ref, ssd_scan as ss

    g = torch.Generator(device=dev).manual_seed(P)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    args = (rnd(2, 300, 3, P).to(DT[dtype]), (rnd(2, 300, 3, 16) * 0.5).to(DT[dtype]),
            (rnd(2, 300, 3, 16) * 0.5).to(DT[dtype]),
            -torch.nn.functional.softplus(rnd(2, 300, 3)), rnd(2, 3, P, 16))
    before = dict(ss.launches)
    got, (dy, dh) = _ssd_both(ss, args, 256)
    y, h, saved = ref.ref_ssd_fwd_saved(*args, 256)
    want = [y, h, saved, *ref.ref_ssd_bwd(*args[:4], saved, dy, dh, 256)]
    for a, w in zip(got, want, strict=True):
        _xl_close(a, w, dtype if a.dtype == DT[dtype] else "float32")
    assert ss.launches["ssd_fwd"] == before["ssd_fwd"] + ss.LAUNCHES_PER_CALL["ssd_fwd"]
    assert ss.launches["ssd_bwd"] == before["ssd_bwd"] + ss.LAUNCHES_PER_CALL["ssd_bwd"] + (
        P > 64)


@pytest.mark.parametrize("S,chunk", [(600, 257), (600, 300), (700, 512), (300, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunks_past_256_run_as_sub_chunks(dev, dtype, S, chunk):
    """A chunk past the kernels' 256 runs as equal sub-chunks of at most
    256 (the same function: the recurrence is exact at any chunk): y, the
    final state and every gradient through ``SSD`` against the plain loop
    at the asked chunk with ordinary autograd, at hymba's width."""
    from repro_torch.kernels import ref, ssd_scan as ss

    args = _ssd_inputs(dev, dtype, 2, S, "hymba", True)
    runs = []
    for fn in (ss.ssd_chunked, ref.ref_ssd_chunked):
        leaves = [t.clone().requires_grad_(True) for t in args]
        before = dict(ss.launches)
        y, h = fn(*leaves[:4], chunk=chunk, state=leaves[4])
        g = torch.Generator(device=dev).manual_seed(5)
        dy = torch.randn(y.shape, generator=g, device=dev).to(y.dtype)
        grads = torch.autograd.grad((y.float() * dy.float()).sum() + h.sum(), leaves)
        runs.append(([y, h, *grads], {k: ss.launches[k] - before[k] for k in ss.KERNELS}))
    assert runs[0][1] == {"ssd_fwd": ss.LAUNCHES_PER_CALL["ssd_fwd"],
                          "ssd_bwd": ss.LAUNCHES_PER_CALL["ssd_bwd"], "ssd_decode": 0}
    assert runs[1][1] == dict.fromkeys(ss.KERNELS, 0)
    for a, b in zip(runs[0][0], runs[1][0], strict=True):
        _xl_close(a, b, dtype if a.dtype == DT[dtype] else "float32")


@pytest.mark.parametrize("P", [1025, 2500])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_past_1024_columns(dev, dtype, P):
    """The decode step with more value columns than a CTA has threads: the
    columns over ceil(P / 1,024) CTAs, one launch, against the plain step."""
    from repro_torch.kernels import ref, ssd_scan as ss

    g = torch.Generator(device=dev).manual_seed(P)
    x = torch.randn(3, 2, P, generator=g, device=dev).to(DT[dtype])
    b, c = (torch.randn(3, 2, 16, generator=g, device=dev).to(DT[dtype]) for _ in range(2))
    log_a = -torch.rand(3, 2, generator=g, device=dev)
    state = torch.randn(3, 2, P, 16, generator=g, device=dev)
    before = ss.launches["ssd_decode"]
    got = ss.ssd_decode(x, b, c, log_a, state)
    assert ss.launches["ssd_decode"] == before + 1
    for a, w in zip(got, ref.ref_ssd_decode_step(x, b, c, log_a, state), strict=True):
        _xl_close(a, w, dtype if a.dtype == DT[dtype] else "float32")


@pytest.mark.parametrize("x_dtype,bc_dtype", [("float32", "float32"), ("float32", "bfloat16"),
                                              ("bfloat16", "bfloat16")])
def test_ssd_decode_function_gradients_match_plain_autograd(dev, x_dtype, bc_dtype):
    """A decode step that autograd records runs the kernel forward (one
    launch) and ``SSDDecode``'s backward, the plain step's vjp: y and the
    state against the plain step, every input's gradient equal to the
    plain step's autograd on the card."""
    from repro_torch.kernels import ref, ssd_scan as ss

    x, b, c, log_a, state = _ssd_inputs(dev, "float32", 4, 1, "hymba", True)
    inputs = (x[:, 0].to(DT[x_dtype]), b[:, 0].to(DT[bc_dtype]), c[:, 0].to(DT[bc_dtype]),
              log_a[:, 0], state)
    g = torch.Generator(device=dev).manual_seed(2)
    runs = []
    for fn in (ss.ssd_decode, ref.ref_ssd_decode_step):
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        before = ss.launches["ssd_decode"]
        y, h = fn(*leaves)
        cot = [torch.randn(t.shape, generator=g.manual_seed(2), device=dev).to(t.dtype)
               for t in (y, h)]
        grads = torch.autograd.grad((y * cot[0]).float().sum() + (h * cot[1]).sum(), leaves)
        runs.append(([y, h], grads, ss.launches["ssd_decode"] - before))
    assert [r[2] for r in runs] == [1, 0]
    for a, w in zip(runs[0][0], runs[1][0], strict=True):
        _xl_close(a, w, x_dtype if a.dtype == DT[x_dtype] else "float32")
    for a, w in zip(runs[0][1], runs[1][1], strict=True):
        _xl_close(a, w, "bfloat16" if a.dtype == torch.bfloat16 else "float32")


# chunked_cache_attention's KV-block scan (kernels/cache_attention.py).
# Tolerances: atol = rtol = 2e-5 in float32 (sums in another order), 2e-2 in
# bfloat16 (the plain loop rounds each block's scores and P V to bf16).


def _ring(rng, B, S, T, kind):
    """Positions of a ring of T slots and of S queries: ``prefix``, a
    prefill of S into a ring that held T // 3 positions, in slot order
    (slots past them empty); ``wrap``, a ring written up to position N > T
    (slot t holds the latest p = t mod T), a sixth of its slots emptied at
    random, queries at the last S positions, and query 0 of row 0 at
    position 0, which sees no slot (its output is 0); ``blind``, slots
    holding positions S.. and queries at 0..S-1: no query sees a slot."""
    if kind == "blind":
        k_pos = np.broadcast_to(np.arange(S, S + T), (B, T)).copy()
        q_pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    elif kind == "prefix":
        n = min(T, T // 3 + S)
        k_pos = np.where(np.arange(T) < n, np.arange(T), -1)
        k_pos = np.broadcast_to(k_pos, (B, T)).copy()
        q_pos = np.broadcast_to(np.arange(n - S, n), (B, S)).copy()
    else:
        N = T + T // 2 + 5
        k_pos = np.stack([(N - 1 - (N - 1 - np.arange(T)) % T) for _ in range(B)])
        k_pos[rng.random((B, T)) < 1 / 6] = -1
        q_pos = np.broadcast_to(np.arange(N - S, N), (B, S)).copy()
        q_pos[0, 0] = 0
    return q_pos.astype(np.int32), k_pos.astype(np.int32)


def _cache_case(dev, dtype, B, S, T, H, KV, hd, kind, seed):
    rng = np.random.default_rng(seed)
    q_pos, k_pos = _ring(rng, B, S, T, kind)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(DT[dtype])
    k = torch.randn(B, T, KV, hd, generator=g, device=dev).to(DT[dtype])
    v = torch.randn(B, T, KV, hd, generator=g, device=dev).to(DT[dtype])
    return q, k, v, torch.from_numpy(q_pos).to(dev), torch.from_numpy(k_pos).to(dev)


@pytest.mark.parametrize("B,S,T,H,KV,window,softcap,kind", [
    (2, 100, 130, 4, 4, 0, 0.0, "prefix"),    # rep 1, ragged S and T
    (1, 70, 200, 8, 2, 0, 30.0, "wrap"),      # rep 4, a softcap, a wrapped ring
    (2, 130, 257, 8, 1, 48, 0.0, "wrap"),     # rep 8, a window
    (1, 2, 150, 6, 3, 16, 5.0, "prefix"),     # S = 2, rep 2, window and softcap
    (1, 64, 64, 10, 5, 0, 0.0, "prefix"),     # rep 2, one whole tile
    (2, 70, 100, 8, 2, 0, 0.0, "blind")])     # no tile to walk: all zeros
@pytest.mark.parametrize("hd", [8, 16, 64, 96, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_attention_kernel_matches_plain(dev, dtype, hd, B, S, T, H, KV, window, softcap,
                                              kind):
    """One launch a call, against the plain loop (KV blocks of 64) on the
    same inputs; a query that sees no slot comes out 0, not NaN."""
    from repro_torch.kernels import cache_attention as ca

    q, k, v, q_pos, k_pos = _cache_case(dev, dtype, B, S, T, H, KV, hd, kind,
                                        S + T + H + hd)
    kw = dict(sliding_window=window, softcap=softcap)
    before = ca.launches
    got = ca.cache_attention(q, k, v, q_pos, k_pos, block_k=64, **kw)
    assert ca.launches == before + 1
    want = ca.plain(q, k, v, q_pos, k_pos, block_k=64, **kw)
    _close(got, want, 2e-5 if dtype == "float32" else 2e-2)
    assert torch.isfinite(got).all()
    if kind == "wrap":
        assert not got[0, 0].any()
    if kind == "blind":
        assert not got.any()


def test_cache_attention_at_llavas_prefill(dev):
    """llava-next-mistral-7b's prefill (B 2, 2,880 patch embeddings + 64
    tokens into a ring of 2,976 slots; H/KV 32/8, hd 128, bf16) in one
    launch, against the plain loop in KV blocks of 1,024; and row by row
    against that loop in float32 on the same inputs, within a relative L2
    of 1e-2 (P and the output rounded to bf16 give ~2.3e-3 each; a tile
    dropped or counted twice moves a late row by 0.05 or more)."""
    from repro_torch.kernels import cache_attention as ca

    q, k, v, _, _ = _cache_case(dev, "bfloat16", 2, 2944, 2976, 32, 8, 128, "prefix", 0)
    k_pos = torch.where(torch.arange(2976, device=dev) < 2944,
                        torch.arange(2976, device=dev), -1).to(torch.int32).expand(2, -1)
    q_pos = torch.arange(2944, dtype=torch.int32, device=dev).expand(2, -1)
    before = ca.launches
    got = ca.cache_attention(q, k, v, q_pos, k_pos, block_k=1024)
    assert ca.launches == before + 1
    _close(got, ca.plain(q, k, v, q_pos, k_pos, block_k=1024), 2e-2)
    exact = ca.plain(q.float(), k.float(), v.float(), q_pos, k_pos, block_k=1024)
    rows = (got.float() - exact).norm(dim=-1) / exact.norm(dim=-1).clamp_min(1e-30)
    assert rows.max().item() <= 1e-2, rows.max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_attention_reads_strided_views(dev, dtype):
    """q as views, read through their strides: heads out of a wider
    tensor, the [B, H, S, hd] layout transposed, an odd element offset (off
    the tensor cores' 16-byte rows in bf16), and a non-unit hd stride
    (copied); the ring a view of a wider one."""
    from repro_torch.kernels import cache_attention as ca

    q, k, v, q_pos, k_pos = _cache_case(dev, dtype, 2, 90, 140, 8, 2, 64, "wrap", 3)
    want = ca.plain(q, k, v, q_pos, k_pos, block_k=64)
    tol = 2e-5 if dtype == "float32" else 2e-2
    wide = torch.cat([q, q.flip(2)], dim=2)[:, :, :8]
    flipped = q.transpose(1, 2).contiguous().transpose(1, 2)
    odd = torch.cat([q.flatten(), q.flatten()[:1]])[1:].view_as(q)
    odd.copy_(q)
    cols = torch.stack([q, q], dim=-1)[..., 0]
    kw = torch.cat([k, k], dim=2)[:, :, :2]
    vw = torch.cat([v, v], dim=2)[:, :, :2]
    for view in (wide, flipped, odd, cols):
        assert not view.is_contiguous() or view.data_ptr() % 16
        _close(ca.cache_attention(view, kw, vw, q_pos, k_pos), want, tol)


def test_cache_attention_refuses_what_it_does_not_take(dev):
    """No fallback: a head_dim past the largest, 256 (the message names
    it), int64 positions, float16, a KV count that does not divide H, a
    tensor on the CPU. A call that autograd records runs (below)."""
    from repro_torch.kernels import cache_attention as ca

    q, k, v, q_pos, k_pos = _cache_case(dev, "float32", 1, 5, 70, 4, 2, 16, "prefix", 1)
    big = torch.zeros(1, 5, 4, 264, device=dev)
    kb = torch.zeros(1, 70, 2, 264, device=dev)
    with pytest.raises(ValueError, match="head_dim 264"):
        ca.cache_attention(big, kb, kb, q_pos, k_pos)
    with pytest.raises(ValueError):
        ca.cache_attention(q, k, v, q_pos.long(), k_pos)
    with pytest.raises(ValueError):
        ca.cache_attention(q.half(), k.half(), v.half(), q_pos, k_pos)
    with pytest.raises(ValueError):
        ca.cache_attention(q[:, :, :3], k, v, q_pos, k_pos)
    with pytest.raises(ValueError):
        ca.cache_attention(q, k.cpu(), v, q_pos, k_pos)


@pytest.mark.parametrize("hd", [136, 192, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_attention_heads_past_128(dev, dtype, hd):
    """Heads wider than the wgmma kernel's 128 run on the CUDA cores (up to
    256), one launch, against the plain loop: a wrapped ring with a window
    and a softcap, and a prefix."""
    from repro_torch.kernels import cache_attention as ca

    for B, S, T, H, KV, window, softcap, kind in ((1, 70, 200, 8, 2, 48, 30.0, "wrap"),
                                                  (2, 100, 130, 4, 4, 0, 0.0, "prefix")):
        q, k, v, q_pos, k_pos = _cache_case(dev, dtype, B, S, T, H, KV, hd, kind, hd + S)
        kw = dict(sliding_window=window, softcap=softcap)
        before = ca.launches
        got = ca.cache_attention(q, k, v, q_pos, k_pos, block_k=64, **kw)
        assert ca.launches == before + 1
        _close(got, ca.plain(q, k, v, q_pos, k_pos, block_k=64, **kw),
               2e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_attention_function_gradients_match_plain_autograd(dev, dtype):
    """A call that autograd records runs the kernel forward (one launch)
    and ``CacheAttention``'s backward, the plain loop's vjp: the output
    against the plain loop, the gradients of q, k and v equal to the plain
    loop's autograd on the card (a wrapped ring, GQA, a window)."""
    from repro_torch.kernels import cache_attention as ca

    args = _cache_case(dev, dtype, 2, 40, 90, 8, 2, 64, "wrap", 7)
    kw = dict(sliding_window=30, softcap=0.0, block_k=32)
    g = torch.Generator(device=dev).manual_seed(1)
    dout = torch.randn(args[0].shape, generator=g, device=dev).to(args[0].dtype)
    runs = []
    for fn in (ca.cache_attention, ca.plain):
        leaves = [t.clone().requires_grad_(True) for t in args[:3]]
        before = ca.launches
        out = fn(*leaves, *args[3:], **kw)
        runs.append((out, torch.autograd.grad(out, leaves, dout), ca.launches - before))
    assert [r[2] for r in runs] == [1, 0]
    _close(runs[0][0].detach(), runs[1][0].detach(), 2e-5 if dtype == "float32" else 2e-2)
    for a, b in zip(runs[0][1], runs[1][1], strict=True):
        assert torch.equal(a, b)


def test_llava_prefill_through_the_kernel_on_card_matches_cpu(dev):
    """The llava-next smoke model (float32) with attn_chunk_kv 4, so its
    prefill of 3 patch embeddings + 8 tokens into a ring of 15 takes the
    chunked path: one launch a layer on the card, the logits and the cache
    within 1e-5 of the CPU's (the plain loop)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import cache_attention as ca
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.models.frontends import vision_patch_embeds
    from repro_torch.training import optimizer as O

    cfg = dataclasses.replace(get_config("llava_next", smoke=True), attn_chunk_kv=4)
    g = torch.Generator().manual_seed(4)
    params = init_params(cfg, g, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 8), generator=g, dtype=torch.int32)
    extra = vision_patch_embeds(cfg, 2, 3, g, device="cpu")
    out = {}
    for d in ("cpu", dev):
        p = O.tree_unflatten(params, iter([x.to(d) for x in O.tree_leaves(params)]))
        before = ca.launches
        with torch.no_grad():
            lg, cache = prefill(p, tokens.to(d), cfg, init_cache(cfg, 2, 15, device=d),
                                extra_embeds=extra.to(d))
        assert ca.launches - before == (cfg.num_layers if d == dev else 0)
        out[str(d)] = [lg] + O.tree_leaves(cache)
    for a, b in zip(out[str(dev)], out["cpu"], strict=True):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-5)


# The bf16 cache attention kernel's CTAs (128 query rows, two consumer
# warpgroups of 64), its ring of K/V stages (2 at hd 128, 4 at 64) and its
# plan; the decode step on the views the model hands it. Tolerances as
# above; in bf16 each output row also within a relative L2 of 1e-2 of the
# plain loop run in float32 on the same inputs (P and the output rounded to
# bf16 give ~2.3e-3; a tile dropped or counted twice moves a row by more).


def _cache_rows_close(got, q, k, v, q_pos, k_pos, **kw):
    from repro_torch.kernels import cache_attention as ca

    _close(got, ca.plain(q, k, v, q_pos, k_pos, block_k=64, **kw), 2e-2)
    exact = ca.plain(q.float(), k.float(), v.float(), q_pos, k_pos, block_k=64, **kw)
    rows = (got.float() - exact).norm(dim=-1) / exact.norm(dim=-1).clamp_min(1e-30)
    assert rows.max().item() <= 1e-2, rows.max().item()


@pytest.mark.parametrize("S", [1, 37, 64, 65, 127, 128, 129, 300])
@pytest.mark.parametrize("hd", [64, 128])
def test_cache_attention_rows_around_a_cta(dev, hd, S):
    """S below one warpgroup's 64 rows, at and past 64 and 128 (a
    warpgroup with no row below S, or one), a prefill into a ring that held
    positions before it (H/KV 8/2): one launch, against the plain loop."""
    from repro_torch.kernels import cache_attention as ca

    q, k, v, q_pos, k_pos = _cache_case(dev, "bfloat16", 2, S, S + 200, 8, 2, hd, "prefix",
                                        S + hd)
    before = ca.launches
    got = ca.cache_attention(q, k, v, q_pos, k_pos)
    assert ca.launches == before + 1
    _cache_rows_close(got, q, k, v, q_pos, k_pos)


@pytest.mark.parametrize("T,S,softcap", [(100, 40, 0.0), (128, 128, 30.0), (384, 300, 0.0),
                                         (640, 200, 30.0), (1152, 129, 0.0)])
@pytest.mark.parametrize("hd", [64, 128])
def test_cache_attention_tile_counts_wrap_the_stages(dev, hd, T, S, softcap):
    """One 128-slot tile, one whole tile, 3, 5 and 9 tiles (an odd count, so
    the K/V ring's 2 or 4 stages wrap mid-walk), in a ring written past its
    end with empty slots (CTAs listing different tiles), with and without a
    softcap: one launch, against the plain loop."""
    from repro_torch.kernels import cache_attention as ca

    q, k, v, q_pos, k_pos = _cache_case(dev, "bfloat16", 2, S, T, 8, 4, hd, "wrap", T + S)
    before = ca.launches
    got = ca.cache_attention(q, k, v, q_pos, k_pos, softcap=softcap)
    assert ca.launches == before + 1
    _cache_rows_close(got, q, k, v, q_pos, k_pos, softcap=softcap)
    assert not got[0, 0].any()  # the query at position 0 sees no slot


@pytest.mark.parametrize("hd", [64, 128])
def test_cache_attention_cta_without_tiles_writes_zeros(dev, hd):
    """Rows 0..127 (the first CTA) see no slot, rows 128.. see the ring:
    the CTA that lists no tile writes zeros, the other its rows' attention."""
    from repro_torch.kernels import cache_attention as ca

    S, T = 256, 300
    g = torch.Generator(device=dev).manual_seed(hd)
    q = torch.randn(2, S, 4, hd, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(2, T, 2, hd, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    q_pos = torch.cat([torch.arange(128), torch.arange(1000, 1128)]).to(torch.int32)
    q_pos = q_pos.to(dev).expand(2, -1).contiguous()
    k_pos = torch.arange(900, 900 + T, dtype=torch.int32, device=dev).expand(2, -1).contiguous()
    got = ca.cache_attention(q, k, v, q_pos, k_pos)
    assert not got[:, :128].any() and got[:, 128:].abs().sum(dim=-1).gt(0).all()
    _cache_rows_close(got, q, k, v, q_pos, k_pos)


@pytest.mark.parametrize("B", [1, 4])
def test_cache_attention_at_hymbas_second_chunk(dev, B):
    """hymba-1.5b's heads (25 over 5, hd 64) over its 1,024-slot ring in a
    chunked prefill's second chunk: positions 0..2,047 written into the
    ring (each slot the latest), queries at 1,024..2,047, its window of
    1,024, against the plain loop."""
    from repro_torch.kernels import cache_attention as ca

    S = T = W = 1024
    t = torch.arange(T, device=dev)
    k_pos = (2 * S - 1 - (2 * S - 1 - t) % T).to(torch.int32).expand(B, -1).contiguous()
    q_pos = torch.arange(S, 2 * S, dtype=torch.int32, device=dev).expand(B, -1).contiguous()
    g = torch.Generator(device=dev).manual_seed(B)
    q = torch.randn(B, S, 25, 64, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(B, T, 5, 64, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    got = ca.cache_attention(q, k, v, q_pos, k_pos, sliding_window=W)
    _cache_rows_close(got, q, k, v, q_pos, k_pos, sliding_window=W)


def test_cache_attention_strided_views_at_hd_128(dev):
    """q a view of every other head of a wider tensor, k and v views into
    rings with twice the KV heads, the output written in q's layout: the
    tensor-core path reads them in place (TMA maps from their strides)."""
    from repro_torch.kernels import cache_attention as ca

    q, k, v, q_pos, k_pos = _cache_case(dev, "bfloat16", 2, 300, 400, 8, 2, 128, "wrap", 5)
    wide = torch.stack([q, -q], dim=3).flatten(2, 3)[:, :, ::2]
    kw, vw = (torch.cat([t, t.flip(1)], dim=2)[:, :, :2] for t in (k, v))
    assert not (wide.is_contiguous() or kw.is_contiguous() or vw.is_contiguous())
    got = ca.cache_attention(wide, kw, vw, q_pos, k_pos, sliding_window=100)
    _cache_rows_close(got, q, k, v, q_pos, k_pos, sliding_window=100)


def _decode_views(dev, x_dtype, bc_dtype, B=4, H=25, P=64, N=16, seed=0):
    """The decode step's inputs as ``mamba_block`` hands them, and more
    strided: b and c halves of ``bc.chunk(2)`` of a fused projection's one
    position, x a view into a wider tensor, log_a every other element, and
    a carried state."""
    g = torch.Generator(device=dev).manual_seed(seed)
    fused = torch.randn(B, 1, 2 * H * P + 2 * H * N + H, generator=g, device=dev)
    _, _, bc, _ = fused.to(DT[bc_dtype]).split([H * P, H * P, 2 * H * N, H], dim=-1)
    b, c = (t.view(B, 1, H, N)[:, 0] for t in bc.chunk(2, dim=-1))
    x = torch.randn(B, H, 2 * P, generator=g, device=dev).to(DT[x_dtype])[..., P:]
    log_a = (-torch.rand(B, H, 2, generator=g, device=dev))[..., 1]
    state = torch.randn(B, H, P, N, generator=g, device=dev)
    return x, b, c, log_a, state


@pytest.mark.parametrize("x_dtype,bc_dtype", [("float32", "float32"), ("float32", "bfloat16"),
                                              ("bfloat16", "float32"),
                                              ("bfloat16", "bfloat16")])
def test_ssd_decode_reads_strided_views(dev, x_dtype, bc_dtype):
    """Each dtype pair on strided x, b, c and log_a (hymba-1.5b's width):
    one launch, y and the new state against the plain step on the same
    views, the state a fresh contiguous tensor."""
    from repro_torch.kernels import ref, ssd_scan as ss

    args = _decode_views(dev, x_dtype, bc_dtype)
    assert not any(t.is_contiguous() for t in args[:4])
    before = ss.launches["ssd_decode"]
    got = ss.ssd_decode(*args)
    assert ss.launches["ssd_decode"] == before + 1
    assert got[1].is_contiguous() and got[1].data_ptr() != args[4].data_ptr()
    for a, w in zip(got, ref.ref_ssd_decode_step(*args), strict=True):
        _xl_close(a, w, x_dtype if a.dtype == DT[x_dtype] else "float32")


@pytest.mark.parametrize("N", [16, 24, 64, 5, 1100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_state_widths(dev, dtype, N):
    """State widths of 16 (hymba's, 4 threads a value column), 24 and 64
    (8 and 16), 5 (not a multiple of 4: a thread an element) and 1,100
    (past the 1,024 values of b and c a CTA stages at a time), on strided
    views: against the plain step."""
    from repro_torch.kernels import ref, ssd_scan as ss

    args = _decode_views(dev, dtype, dtype, B=2, H=3, P=40, N=N, seed=N)
    got = ss.ssd_decode(*args)
    for a, w in zip(got, ref.ref_ssd_decode_step(*args), strict=True):
        _xl_close(a, w, dtype if a.dtype == DT[dtype] else "float32")


def test_ssd_decode_is_one_kernel_under_the_profiler(dev):
    """hymba-1.5b's decode step on the strided b and c of its fused
    projection (x * dt in float32, b and c bf16): the profiler sees one
    kernel, the decode kernel, and no copy."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ssd_scan as ss

    args = _decode_views(dev, "float32", "bfloat16")
    ss.ssd_decode(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ss.ssd_decode(*args)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0]
    assert len(kernels) == 1 and "ssd_decode_kernel" in kernels[0].key, \
        [(e.key, e.count) for e in kernels]
    assert kernels[0].count == 1


# ---------------------------------------------------------------------------
# the paged block's fused chains (kernels/norm_rope.py)
# ---------------------------------------------------------------------------


def _nr_case(dev, model, call, dtype):
    """One call's rope_write inputs from a generator seeded by its shape."""
    B, S, _ = NR_CALLS[call]
    g = torch.Generator(device=dev).manual_seed(B * S + NR_MODELS[model][2])
    return rope_case(g, dev, model, call, DT[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("call", list(NR_CALLS))
@pytest.mark.parametrize("model", list(NR_MODELS))
def test_rope_write_kernel_matches_plain(dev, model, call, dtype):
    """q and k RoPE'd and every K page within one bf16 ulp of the plain
    version (float32: 1e-6), every V page bit for bit; scratch page 0's
    slot 0 holds the idle lanes' writes (both versions race there)."""
    from repro_torch.kernels import norm_rope

    q, k, v, pos, inv_freq, bt, kp, vp = _nr_case(dev, model, call, dtype)
    want_kp, want_vp = kp.clone(), vp.clone()
    want_q, want_k = norm_rope.plain_rope_write(q, k, v, pos, inv_freq, bt, want_kp, want_vp)
    before = norm_rope.launches["rope_write"]
    got_q, got_k = norm_rope.rope_write(q, k, v, pos, inv_freq, bt, kp, vp)
    torch.cuda.synchronize()
    assert norm_rope.launches["rope_write"] == before + 1
    within_one_ulp("q", got_q, want_q)
    within_one_ulp("k", got_k, want_k)
    idle = (bt == 0).all(1)
    assert torch.equal(vp[1:], want_vp[1:]) and torch.equal(vp[0, :, 1:], want_vp[0, :, 1:])
    within_one_ulp("k pages", kp[1:], want_kp[1:])
    if idle.any():  # lanes may race element by element: each element one lane's
        assert (vp[0, :, 0][None] == v[idle][:, 0]).any(0).all()
        assert (kp[0, :, 0][None] == got_k[idle][:, 0]).any(0).all()
    else:
        assert torch.equal(vp[0], want_vp[0]) and torch.equal(kp[0], want_kp[0])


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("call", list(NR_CALLS))
@pytest.mark.parametrize("model", list(NR_MODELS))
def test_rms_norm_kernel_matches_plain(dev, model, call, dtype, residual):
    """The norm within one bf16 ulp of the plain version (float32: 1e-6) at
    the model's width over a call's rows; the residual sum bit for bit."""
    from repro_torch.kernels import norm_rope

    B, S, _ = NR_CALLS[call]
    g = torch.Generator(device=dev).manual_seed(B * S + NR_MODELS[model][3])
    x, r, scale = norm_case(g, dev, model, call, DT[dtype])
    r = r if residual else None
    before = norm_rope.launches["rms_norm"]
    got = norm_rope.rms_norm(x, scale, residual=r)
    want = norm_rope.plain_rms_norm(x, scale, residual=r)
    torch.cuda.synchronize()
    assert norm_rope.launches["rms_norm"] == before + 1
    if residual:
        assert torch.equal(got[0], want[0])
        got, want = got[1], want[1]
    within_one_ulp("rms_norm", got, want)


@pytest.mark.parametrize("arch", ["yi_6b", "granite_moe", "musicgen_large"])
def test_paged_forward_launches_the_fused_chains(dev, arch):
    """One paged forward of L layers launches rms_norm 2L + 1 times (none
    for a layernorm config) and rope_write L times, prefill and decode
    alike; its logits are the CPU run's (float32 smoke config)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import norm_rope
    from repro_torch.models import model as M
    from repro_torch.serving.paged_model import paged_forward
    from repro_torch.tree import tree_map

    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda t: t.to(dev), params)
    L, KV, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    kp = torch.zeros(L, 9, KV, 16, hd, dtype=getattr(torch, cfg.dtype))
    pages = {"cpu": (kp, kp.clone()), "cuda": tuple(torch.zeros_like(kp, device=dev)
                                                      for _ in "kv")}
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    rms = 0 if cfg.norm == "layernorm" else 2 * L + 1
    for toks, lens in (([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]], [0, 0]), ([[5], [8]], [5, 5])):
        toks, lens = torch.tensor(toks, dtype=torch.int32), torch.tensor(lens, dtype=torch.int32)
        want, _, _ = paged_forward(params, toks, cfg, *pages["cpu"], bt, lens)
        before = dict(norm_rope.launches)
        got, _, _ = paged_forward(card, toks.to(dev), cfg, *pages["cuda"], bt.to(dev),
                                  lens.to(dev))
        torch.cuda.synchronize()
        assert norm_rope.launches["rms_norm"] - before["rms_norm"] == rms
        assert norm_rope.launches["rope_write"] - before["rope_write"] == L
        _close(got.cpu(), want, 2e-5)
    for a, b in zip(pages["cuda"], pages["cpu"]):
        _close(a.cpu(), b, 2e-5)


def test_fused_chain_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Each wrapper raises, and launches nothing, on a strided input, a
    scale of another width, int64 positions, pages of another dtype than
    q's or an odd head_dim."""
    from repro_torch.kernels import norm_rope

    q, k, v, pos, inv_freq, bt, kp, vp = _nr_case(dev, "granite_moe", "chunk64at100", "bfloat16")
    x = torch.randn(4, 64, dtype=torch.bfloat16, device=dev)
    before = dict(norm_rope.launches)
    with pytest.raises(ValueError, match="contiguous"):
        norm_rope.rms_norm(x.t(), x[:, 0].contiguous())
    with pytest.raises(ValueError, match="scale"):
        norm_rope.rms_norm(x, x[0, :32])
    with pytest.raises(ValueError, match="positions"):
        norm_rope.rope_write(q, k, v, pos.long(), inv_freq, bt, kp, vp)
    with pytest.raises(ValueError, match="k_pages must be contiguous torch.bfloat16"):
        norm_rope.rope_write(q, k, v, pos, inv_freq, bt, kp.float(), vp.float())
    with pytest.raises(ValueError, match="contiguous"):
        norm_rope.rope_write(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, pos,
                             inv_freq, bt, kp, vp)
    with pytest.raises(ValueError, match="hd even"):
        norm_rope.rope_write(q[..., :63].contiguous(), k[..., :63].contiguous(),
                             v[..., :63].contiguous(), pos, inv_freq[:31], bt,
                             kp[..., :63].contiguous(), vp[..., :63].contiguous())
    assert norm_rope.launches == before
