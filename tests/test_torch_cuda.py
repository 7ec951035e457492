"""The port's CUDA kernels against their plain PyTorch versions, both on
the card, at small shapes in float32 and bfloat16 (the shapes of
tests/test_torch_kernels.py). Marked ``cuda``: without a CUDA device these
skip; on a machine with one, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 in float32 (sums in another order), 3e-2 (flash) and
4e-2 (paged) in bfloat16, the reference tests' tolerances; the CMP kernels
(ring, claim) and the slot pool bit-exact."""

import numpy as np
import pytest
import torch

from repro_torch.core import slotpool
from repro_torch.kernels import cmp_claim, cmp_ring, flash_attention, paged_attention

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
    tiled = n > (block_n or cmp_claim.DEFAULT_BLOCK)
    before = cmp_claim.launches
    got = cmp_claim.cmp_claim(state, cycle, k=k, block_n=block_n)
    assert cmp_claim.launches == before + (2 if tiled else 1)
    want = cmp_claim.plain(state, cycle, k=k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_claim_kernel_refuses_a_tile_above_one_cta(dev):
    state, cycle = _claim_inputs(65536, 0, dev)
    with pytest.raises(ValueError):
        cmp_claim.cmp_claim(state, cycle, k=4, block_n=65536)


def test_slotpool_claim_on_card_matches_cpu(dev):
    """A short FIFO churn on a 5000-slot pool (tiled claims): card and CPU
    pools stay bit-identical after every op."""
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
