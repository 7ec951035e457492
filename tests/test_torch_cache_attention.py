"""``chunked_cache_attention``'s KV-block scan (``kernels/cache_attention.py``)
on the CPU, where the wrapper runs its plain loop (``ref.py``), against the
JAX package's ``chunked_cache_attention`` from the same numpy inputs: GQA
with 1, 2 and 4 query heads a KV head, rings a whole number of blocks and
not, a wrapped ring with empty slots, a window, a softcap and both, a
query that sees no slot (zeros, no NaN), two queries. Then ``meta``
tensors (the dry run's) take the plain loop and launch nothing, and
llava-next's smoke prefill through the chunked path against JAX's.
Then the kernels' tile plan and the bf16 kernel's walk over it, mirrored
in ``tests/torch_cache_cases.py``: the plan held to the visibility mask of
the positions, the walk to the function in float64 and to JAX's.

Tolerances: 2e-5 (atol = rtol) in float32, sums in another order; 3e-2 in
bfloat16, inputs rounded to bf16 alike in both packages and each package
rounding its block products to bf16 in its own order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro_torch.bridge import cache_to_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import _build, ops
from repro_torch.kernels import cache_attention as ca
from repro_torch.kernels import ref
from repro_torch.models import init_cache, prefill
from repro_torch.models import layers as TL
import torch_cache_cases as CC

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ring(rng, B, S, T, kind):
    """Positions of a ring of T slots and of S queries: ``prefix``, a
    prefill of S after T // 3 positions, in slot order (the slots past them
    empty); ``wrap``, a ring written up to position N > T (slot t holds the
    latest p = t mod T), a sixth of the slots emptied at random, queries
    at the last S positions, and query 0 of row 0 at position 0, which
    sees no slot."""
    if kind == "prefix":
        n = min(T, T // 3 + S)
        k_pos = np.broadcast_to(np.where(np.arange(T) < n, np.arange(T), -1), (B, T)).copy()
        q_pos = np.broadcast_to(np.arange(n - S, n), (B, S)).copy()
    else:
        N = T + T // 2 + 5
        k_pos = np.stack([N - 1 - (N - 1 - np.arange(T)) % T for _ in range(B)])
        k_pos[rng.random((B, T)) < 1 / 6] = -1
        q_pos = np.broadcast_to(np.arange(N - S, N), (B, S)).copy()
        q_pos[0, 0] = 0
    return q_pos.astype(np.int32), k_pos.astype(np.int32)


def _inputs(seed, B, S, T, H, KV, hd, kind):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, T, KV, hd)).astype(np.float32) for _ in range(2))
    return (q, k, v, *_ring(rng, B, S, T, kind))


# (B, S, T, H, KV, hd, block_k, window, softcap, kind)
CASES = {
    "rep1-whole-blocks": (2, 9, 24, 2, 2, 8, 8, 0, 0.0, "prefix"),
    "rep2-ragged-ring": (2, 11, 21, 4, 2, 8, 8, 0, 0.0, "prefix"),
    "rep4-wrapped": (2, 7, 20, 8, 2, 16, 6, 0, 0.0, "wrap"),
    "window": (1, 10, 30, 4, 1, 8, 8, 6, 0.0, "wrap"),
    "softcap": (2, 6, 17, 4, 2, 8, 4, 0, 5.0, "wrap"),
    "window-softcap": (2, 8, 19, 6, 3, 8, 5, 4, 2.0, "prefix"),
    "two-queries": (2, 2, 13, 4, 1, 8, 4, 3, 0.0, "wrap"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_cache_attention_matches_jax(case, dtype):
    B, S, T, H, KV, hd, block_k, window, softcap, kind = CASES[case]
    q, k, v, q_pos, k_pos = _inputs(len(case) + T, B, S, T, H, KV, hd, kind)
    kw = dict(sliding_window=window, softcap=softcap, block_k=block_k)
    floats = [torch.from_numpy(x).to(TDT[dtype]) for x in (q, k, v)]
    got = ca.cache_attention(*floats, *map(torch.from_numpy, (q_pos, k_pos)), **kw)
    want = JL.chunked_cache_attention(*(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)),
                                      jnp.asarray(q_pos), jnp.asarray(k_pos), **kw)
    assert got.dtype == TDT[dtype] and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    assert torch.isfinite(got).all()
    if kind == "wrap":  # the query at position 0 sees no slot
        assert not got[0, 0].any()
    # the model's entry point is the same loop on plain CPU tensors
    assert torch.equal(TL.chunked_cache_attention(
        *floats, *map(torch.from_numpy, (q_pos, k_pos)), **kw), got)


def test_block_k_orders_only_the_sums():
    """The kernel takes the whole ring at once; on the CPU the loop's
    block_k changes the result only by the order of its f32 sums."""
    q, k, v, q_pos, k_pos = map(torch.from_numpy, _inputs(5, 2, 9, 40, 4, 2, 8, "wrap"))
    outs = [ref.ref_chunked_cache_attention(q, k, v, q_pos, k_pos, sliding_window=12,
                                            block_k=b) for b in (4, 7, 40, 64)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=2e-6, rtol=2e-6)


def _no_build(*_):
    raise AssertionError("a host tensor reached the kernel library")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_host_and_meta_tensors_take_the_plain_loop(device, monkeypatch):
    """On CPU and ``meta`` tensors ``ops.chunked_cache_attention`` runs the
    plain loop (bit for bit ``ref.py``'s on the CPU), never loads the kernel
    library and counts no launch: the dry run traces prefill on ``meta``."""
    monkeypatch.setattr(_build, "lib", _no_build)
    before = ca.launches
    arrays = _inputs(9, 2, 6, 20, 4, 2, 8, "prefix")
    args = [torch.from_numpy(a).to(device) for a in arrays]
    out = ops.chunked_cache_attention(*args, sliding_window=5, block_k=8)
    assert out.shape == (2, 6, 4, 8) and out.device.type == device
    if device == "cpu":
        assert torch.equal(out, ref.ref_chunked_cache_attention(*args, sliding_window=5,
                                                                block_k=8))
    assert ca.launches == before


def test_llava_prefill_through_the_chunked_path_matches_jax(monkeypatch):
    """llava-next's smoke model with attn_chunk_kv 4, so that its prefill
    of 3 patch embeddings + 8 tokens into a ring of 15 slots takes the
    chunked path in every layer: the port's last-position logits and
    cache against JAX's from the same weights and inputs."""
    jcfg = dataclasses.replace(jax_config("llava_next", smoke=True), attn_chunk_kv=4)
    cfg = dataclasses.replace(get_config("llava_next", smoke=True), attn_chunk_kv=4)
    assert TL.kv_chunks(11, 15, cfg.attn_chunk_kv) == 4
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    extra = (rng.standard_normal((2, 3, cfg.d_model)) * 0.02).astype(np.float32)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    jlg, jcache = jax_prefill(jparams, jnp.asarray(tokens), jcfg, jax_init_cache(jcfg, 2, 15),
                              extra_embeds=jnp.asarray(extra))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               dtype=torch.float32, device="cpu")
    calls, real = [], TL.kops.chunked_cache_attention
    monkeypatch.setattr(TL.kops, "chunked_cache_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    lg, cache = prefill(params, torch.from_numpy(tokens), cfg,
                        init_cache(cfg, 2, 15, device="cpu"), extra_embeds=torch.from_numpy(extra))
    assert len(calls) == cfg.num_layers
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-5, rtol=1e-5)
    leaves = jax.tree_util.tree_leaves(cache_to_numpy(cache))
    jleaves = jax.tree_util.tree_leaves(jcache)
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["rep2-ragged-ring", "rep4-wrapped", "window-softcap"])
def test_cache_attention_gradient_matches_jax_vjp(case):
    """The reference's loop is a ``lax.scan`` that ``jax.grad`` goes through
    (XLA's reverse of its jnp ops). The port's plain loop, which the
    wrapper runs on the CPU and ``CacheAttention``'s backward recomputes on
    the card, with torch autograd against ``jax.vjp`` of
    ``chunked_cache_attention``: the gradients of q, k and v in float32
    (a wrapped ring's query that sees no slot takes none)."""
    B, S, T, H, KV, hd, block_k, window, softcap, kind = CASES[case]
    q, k, v, q_pos, k_pos = _inputs(len(case) + T + 1, B, S, T, H, KV, hd, kind)
    kw = dict(sliding_window=window, softcap=softcap, block_k=block_k)
    dout = np.random.default_rng(T).standard_normal((B, S, H, hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: JL.chunked_cache_attention(
        a, b, c, jnp.asarray(q_pos), jnp.asarray(k_pos), **kw), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ca.cache_attention(*leaves, *map(torch.from_numpy, (q_pos, k_pos)), **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL["float32"],
                                   rtol=TOL["float32"])
    if kind == "wrap":
        assert not got[0][0, 0].any()


@pytest.mark.parametrize("plan", ["bf16", "scalar"])
@pytest.mark.parametrize("case", list(CC.CASES))
def test_tile_plan_covers_every_visible_pair(case, plan):
    """The kernels' tile plan, each CTA's from its rows' position ranges:
    every visible (row, slot) pair in a listed tile, each tile listed once
    in slot order, and every tile flagged full for a group of 64 rows
    inside T with all of the group's pairs visible; the bf16 kernel's 128
    rows and 128-slot tiles, the CUDA-core kernel's 64 and 64. Prefills at
    S below, at and past 64 and 128, wrapped rings with empty slots and
    windows, a windowed prefill's second chunk, a ring no query sees."""
    S, T, window, kind = CC.CASES[case]
    q_pos, k_pos = CC.ring(np.random.default_rng(S + T), 3, S, T, kind)
    for b in range(3):
        CC.check_plan(q_pos[b], k_pos[b], window, **(CC.BF16 if plan == "bf16" else CC.SCALAR))


@pytest.mark.parametrize("seed", range(8))
def test_tile_plan_on_random_positions(seed):
    """The same on positions in no order at all (the plan assumes none):
    queries and slots at random positions, a fifth of the slots empty,
    windows of 0 to 300, S and T from 1 to 400."""
    rng = np.random.default_rng(seed)
    for _ in range(6):
        S, T = (int(x) for x in rng.integers(1, 401, 2))
        q_pos = rng.integers(0, 500, S)
        k_pos = np.where(rng.random(T) < 0.2, -1, rng.integers(0, 500, T))
        window = int(rng.choice([0, 1, 17, 64, 300]))
        for plan in (CC.BF16, CC.SCALAR):
            CC.check_plan(q_pos, k_pos, window, **plan)


@pytest.mark.parametrize("case,softcap", [("prefix-S65", 0.0), ("prefix-S129", 0.0),
                                          ("wrap-window", 5.0), ("chunk2-window-ragged", 0.0),
                                          ("wrap", 30.0), ("blind", 0.0)])
def test_tiled_walk_matches_jax(case, softcap):
    """The bf16 kernel's walk over its plan in float64 (a tile masked only
    for the groups not flagged full, slots past T as zeros) against the
    function in float64 at 1e-12, and JAX's ``chunked_cache_attention`` on
    the same float32 inputs at 2e-5; H/KV 4/2, hd 16."""
    S, T, window, kind = CC.CASES[case]
    rng = np.random.default_rng(S * T)
    q_pos, k_pos = CC.ring(rng, 2, S, T, kind)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, T, 2, 16)).astype(np.float32) for _ in range(2))
    args = [torch.from_numpy(x) for x in (q, k, v, q_pos, k_pos)]
    got = CC.tiled_attention(*args, window=window, softcap=softcap)
    exact = CC.dense_attention(*args, window=window, softcap=softcap)
    torch.testing.assert_close(got, exact, atol=1e-12, rtol=1e-12)
    want = JL.chunked_cache_attention(*map(jnp.asarray, (q, k, v, q_pos, k_pos)),
                                      sliding_window=window, softcap=softcap, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float64), atol=TOL["float32"],
                               rtol=TOL["float32"])
