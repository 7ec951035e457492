"""The port's decode path (``init_cache`` -> ``prefill`` -> ``decode_step``)
against the JAX package's on the ten smoke configs, on the CPU in float32:
the same logits and caches from the reference's weights (taken through
``params_from_numpy``), a decode that moves between the packages mid-way
(``cache_from_numpy`` / ``cache_to_numpy``), and the reference's own checks
(decode == full forward, the sliding-window ring, the vision stub) on the
port. Then the cache half of ``models/layers.py`` function for function,
the frontend stubs, and the bridge's float32 leaves.

Tolerances: 1e-5 (atol = rtol) against JAX, sums taken in another order
(measured <= 4e-7); 5e-3 for decode against the full forward, the
reference's own (test_models.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.models.frontends import num_frontend_embeds as jax_num_frontend_embeds
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import apply, decode_step, init_cache, init_params, loss_fn, prefill
from repro_torch.models import blocks as TB
from repro_torch.models import layers as TL
from repro_torch.models.frontends import (audio_frame_tokens, num_frontend_embeds,
                                          vision_patch_embeds)

TOL = 1e-5
B, S, PROMPT, N_EXTRA = 2, 12, 8, 3


def _close(t, j, tol=TOL):
    tl = jax.tree_util.tree_leaves(cache_to_numpy(t))
    jl = jax.tree_util.tree_leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                   atol=tol, rtol=tol)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_runs():
    """Per arch, built at first use: the reference's weights, tokens and
    (for the vision config) 3 patch embeddings; its prefill of 8 positions
    and 4 decode steps, with the logits and the caches after the prefill
    and at the end."""
    runs = {}

    def get(arch):
        if arch in runs:
            return runs[arch]
        cfg = jax_config(arch, smoke=True)
        rng = np.random.default_rng(ARCHS.index(arch))
        tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        extra = ((rng.standard_normal((B, N_EXTRA, cfg.d_model)) * 0.02).astype(np.float32)
                 if cfg.frontend == "vision" else None)
        n_extra = 0 if extra is None else N_EXTRA
        params = jax_init_params(cfg, jax.random.PRNGKey(0))
        pf = jax.jit(jax_prefill, static_argnums=2)
        ds = jax.jit(jax_decode_step, static_argnums=2)
        cache = jax_init_cache(cfg, B, n_extra + S + 4)
        lg, cache = pf(params, jnp.asarray(tokens[:, :PROMPT]), cfg, cache,
                       extra_embeds=None if extra is None else jnp.asarray(extra))
        run = {"params": _np(params), "tokens": tokens, "extra": extra, "decode": ds,
               "jparams": params, "prefill_cache": cache, "logits": [np.asarray(lg)]}
        for t in range(PROMPT, S):
            lg, cache = ds(params, jnp.asarray(tokens[:, t:t + 1]), cfg, cache)
            run["logits"].append(np.asarray(lg))
        run["cache"] = _np(cache)
        runs[arch] = run
        return run

    return get


def _port(arch, run):
    cfg = get_config(arch, smoke=True)
    params = params_from_numpy(run["params"], dtype=torch.float32, device="cpu")
    extra = None if run["extra"] is None else torch.from_numpy(run["extra"])
    return cfg, params, torch.from_numpy(run["tokens"]), extra


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch, jax_runs):
    """prefill + 4 decode steps: each step's logits and the caches after the
    prefill and at the end, leaf for leaf (-inf stabilisers included)."""
    run = jax_runs(arch)
    cfg, params, tokens, extra = _port(arch, run)
    cache = init_cache(cfg, B, (0 if extra is None else N_EXTRA) + S + 4, device="cpu")
    lg, cache = prefill(params, tokens[:, :PROMPT], cfg, cache, extra_embeds=extra)
    _close(cache, _np(run["prefill_cache"]))
    got = [lg]
    for t in range(PROMPT, S):
        lg, cache = decode_step(params, tokens[:, t:t + 1], cfg, cache)
        got.append(lg)
    for a, b in zip(got, run["logits"], strict=True):
        assert a.dtype == torch.float32 and a.shape == (B, cfg.vocab_size)
        _close(a, b)
    _close(cache, run["cache"])
    assert cache["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_crosses_packages(arch, jax_runs):
    """The port decodes on from JAX's prefill cache, and JAX from the
    port's: both give JAX's uninterrupted logits."""
    run = jax_runs(arch)
    cfg, params, tokens, extra = _port(arch, run)
    port_cache = init_cache(cfg, B, (0 if extra is None else N_EXTRA) + S + 4, device="cpu")
    cache = cache_from_numpy(_np(run["prefill_cache"]), port_cache)
    for i, t in enumerate(range(PROMPT, S)):
        lg, cache = decode_step(params, tokens[:, t:t + 1], cfg, cache)
        _close(lg, run["logits"][i + 1])
    _, port_cache = prefill(params, tokens[:, :PROMPT], cfg, port_cache, extra_embeds=extra)
    treedef = jax.tree_util.tree_structure(run["prefill_cache"])
    jcache = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(a, b.dtype) for a, b in zip(jax.tree_util.tree_leaves(
            cache_to_numpy(port_cache)), jax.tree_util.tree_leaves(run["prefill_cache"]))])
    jcfg = jax_config(arch, smoke=True)
    lg, _ = run["decode"](run["jparams"], jnp.asarray(run["tokens"][:, PROMPT:PROMPT + 1]),
                          jcfg, jcache)
    np.testing.assert_allclose(np.asarray(lg), run["logits"][1], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_matches_full_forward(arch):
    """tests/test_models.py's check on the port, from its own weights."""
    cfg = get_config(arch, smoke=True)
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    full, _ = apply(params, tokens, cfg)
    cache = init_cache(cfg, B, S + 4, device="cpu")
    lg, cache = prefill(params, tokens[:, :PROMPT], cfg, cache)
    errs = [(lg - full[:, PROMPT - 1]).abs().max().item()]
    for t in range(PROMPT, S):
        lg, cache = decode_step(params, tokens[:, t:t + 1], cfg, cache)
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 5e-3, f"{arch}: decode diverges {errs}"


def test_sliding_window_cache_is_ring():
    """tests/test_models.py's check on the port: hymba's ring holds the
    window and never grows; a prefill of one window and decode past it
    follow the full forward."""
    cfg = get_config("hymba_1_5b", smoke=True)
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    n = 24
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=g, dtype=torch.int32)
    full, _ = apply(params, tokens, cfg)
    w = cfg.sliding_window
    cache = init_cache(cfg, 1, w, device="cpu")
    lg, cache = prefill(params, tokens[:, :w], cfg, cache)
    assert cache["blocks"]["0"][0].k.shape[2] == w
    err = (lg - full[:, w - 1]).abs().max().item()
    for t in range(w, n):
        lg, cache = decode_step(params, tokens[:, t:t + 1], cfg, cache)
        err = max(err, (lg - full[:, t]).abs().max().item())
    assert cache["blocks"]["0"][0].k.shape[2] == w
    assert sorted(cache["blocks"]["0"][0].pos[0, 0].tolist()) == list(range(n - w, n))
    assert err < 5e-3


def test_second_window_chunk_matches_jax():
    """A prompt of two windows prefilled in two chunks into a ring of the
    window: the second chunk's queries find the keys they need overwritten
    in both packages (ROADMAP Queue 3), so it is the reference's result,
    not the full forward's, that the port reproduces."""
    jcfg, cfg = jax_config("hymba_1_5b", smoke=True), get_config("hymba_1_5b", smoke=True)
    w = cfg.sliding_window
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(_np(jparams), dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 2 * w)).astype(np.int32)
    jcache, cache = jax_init_cache(jcfg, 2, w), init_cache(cfg, 2, w, device="cpu")
    for lo in (0, w):
        jlg, jcache = jax_prefill(jparams, jnp.asarray(tokens[:, lo:lo + w]), jcfg, jcache)
        lg, cache = prefill(params, torch.from_numpy(tokens[:, lo:lo + w]), cfg, cache)
        _close(lg, jlg)
    _close(cache, _np(jcache))
    full, _ = apply(params, torch.from_numpy(tokens), cfg)
    assert (lg - full[:, -1]).abs().max().item() > 1e-2  # not the full forward's


def test_vlm_frontend_stub_path():
    """tests/test_models.py's check on the port: patch embeddings go before
    the tokens, unlabelled by the loss."""
    cfg = get_config("llava_next", smoke=True)
    g = torch.Generator().manual_seed(0)
    params = init_params(cfg, g, "cpu")
    n, ni = 8, 4
    tokens = torch.randint(0, cfg.vocab_size, (B, n), generator=g, dtype=torch.int32)
    embeds = vision_patch_embeds(cfg, B, ni, g, device="cpu")
    loss, _ = loss_fn(params, {"tokens": tokens, "extra_embeds": embeds}, cfg)
    assert torch.isfinite(loss)
    logits, _ = apply(params, tokens, cfg, extra_embeds=embeds)
    assert logits.shape == (B, ni + n, cfg.vocab_size)


def test_frontend_stubs():
    cfg = get_config("llava_next", smoke=True)
    g = torch.Generator().manual_seed(0)
    e = vision_patch_embeds(dataclasses.replace(cfg, dtype="bfloat16"), 3, 5, g, device="cpu")
    assert e.shape == (3, 5, cfg.d_model) and e.dtype == torch.bfloat16
    assert 0.015 < e.float().std().item() < 0.025
    audio = get_config("musicgen_large", smoke=True)
    t = audio_frame_tokens(audio, 2, 50, g, device="cpu")
    assert t.shape == (2, 50) and t.dtype == torch.int32
    assert 0 <= int(t.min()) and int(t.max()) < audio.vocab_size
    for arch in ARCHS:
        assert num_frontend_embeds(get_config(arch)) == jax_num_frontend_embeds(
            jax_config(arch))
    assert num_frontend_embeds(cfg) == 2880


# ---------------------------------------------------------------------------
# the cache half of models/layers.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,S", [(8, 3), (8, 8), (8, 11)])
def test_cache_insert_matches_jax(T, S):
    """A ring of T slots after one insert of 5 entries and then S more: the
    ring wraps, and S >= T keeps only the last T."""
    rng = np.random.default_rng(T + S)
    jc, tc = JL.make_kv_cache(2, T, 2, 4, jnp.float32), TL.make_kv_cache(2, T, 2, 4,
                                                                        torch.float32, "cpu")
    start = 0
    for n in (5, S):
        k, v = (rng.standard_normal((2, n, 2, 4)).astype(np.float32) for _ in range(2))
        pos = np.broadcast_to(np.arange(start, start + n, dtype=np.int32), (2, n)).copy()
        jc = JL.cache_insert(jc, *map(jnp.asarray, (k, v, pos)))
        old = tc
        tc = TL.cache_insert(tc, *map(torch.from_numpy, (k, v, pos)))
        start += n
    assert isinstance(tc, TL.KVCache) and tc.pos.dtype == torch.int32
    assert not torch.equal(old.pos, tc.pos)  # a new cache; the old one is kept
    _close(tc, _np(jc), 0.0)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 5.0)])
def test_chunked_cache_attention_matches_jax(window, softcap):
    """KV blocks of 4 over a cache of 10 slots (padded to 12, two of them
    empty): against JAX's and against the direct cache attention."""
    rng = np.random.default_rng(window)
    Bq, Sq, H, KV, hd, T = 2, 6, 4, 2, 8, 10
    q = rng.standard_normal((Bq, Sq, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, T, KV, hd)).astype(np.float32) for _ in range(2))
    k_pos = np.broadcast_to(np.r_[np.arange(8), -1, -1].astype(np.int32), (Bq, T)).copy()
    q_pos = np.broadcast_to(np.arange(2, 2 + Sq, dtype=np.int32), (Bq, Sq)).copy()
    args = (q, k, v, q_pos, k_pos)
    kw = dict(sliding_window=window, softcap=softcap)
    got = TL.chunked_cache_attention(*map(torch.from_numpy, args), block_k=4, **kw)
    _close(got, JL.chunked_cache_attention(*map(jnp.asarray, args), block_k=4, **kw))
    _close(got, np.asarray(JL.cache_attention(*map(jnp.asarray, args), **kw)))
    assert TL.kv_chunks(Sq, T, 4) == JL.kv_chunks(Sq, T, 4) == 3
    assert [TL.kv_chunks(*a) for a in ((1, 10, 4), (6, 4, 4), (6, 10, 0))] == [0, 0, 0]


# ---------------------------------------------------------------------------
# hymba's float32 leaves
# ---------------------------------------------------------------------------


def test_bridge_keeps_hymba_f32_leaves_exact():
    """A bf16 hymba model from JAX: a_log and d_skip arrive float32 and bit
    for bit (non-trivial values), everything else bf16."""
    jcfg = dataclasses.replace(jax_config("hymba_1_5b", smoke=True), dtype="bfloat16")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    mamba = jparams["blocks"]["0"]["mamba"]
    rng = np.random.default_rng(0)
    for name in ("a_log", "d_skip"):
        assert mamba[name].dtype == jnp.float32
        mamba[name] = jnp.asarray(rng.standard_normal(mamba[name].shape).astype(np.float32))
    params = params_from_numpy(_np(jparams), dtype=torch.bfloat16, device="cpu")
    got = params["blocks"]["0"]["mamba"]
    for name in ("a_log", "d_skip"):
        assert got[name].dtype == torch.float32
        assert np.array_equal(got[name].numpy(), np.asarray(mamba[name]))
    assert got["win"].dtype == params["embed"].dtype == torch.bfloat16


def test_init_hymba_keeps_f32_leaves():
    cfg = dataclasses.replace(get_config("hymba_1_5b", smoke=True), dtype="bfloat16")
    one = TB.init_hymba(cfg, torch.Generator().manual_seed(0), "cpu")
    assert one["mamba"]["a_log"].dtype == one["mamba"]["d_skip"].dtype == torch.float32
    assert one["mamba"]["win"].dtype == torch.bfloat16
    stacked = init_params(cfg, torch.Generator().manual_seed(0), "cpu")["blocks"]["0"]["mamba"]
    assert stacked["a_log"].dtype == torch.float32
    assert stacked["a_log"].shape == (cfg.pattern_repeats, cfg.ssm_heads)
    assert torch.equal(stacked["d_skip"], torch.ones_like(stacked["d_skip"]))


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_125m"])
def test_tree_walks_caches_as_jax(arch):
    """``repro_torch.tree`` walks a cache (dicts, hymba's tuples, KVCache
    NamedTuples, the mLSTM state) leaf for leaf in JAX's order, rebuilds
    each node's type, and ``cache_from_numpy`` refuses a tree of another
    shape."""
    from repro_torch import tree as T

    cfg = get_config(arch, smoke=True)
    got = init_cache(cfg, B, 10, device="cpu")
    want = _np(jax_init_cache(jax_config(arch, smoke=True), B, 10))
    leaves = T.tree_leaves(got)
    assert [tuple(x.shape) for x in leaves] == [a.shape for a in jax.tree_util.tree_leaves(want)]
    def structure(tree):  # the NamedTuples are two classes of one name
        return str(jax.tree_util.tree_structure(tree))

    assert structure(cache_to_numpy(got)) == structure(want)
    again = T.tree_unflatten(got, iter(leaves))
    assert structure(again) == structure(got)
    assert all(a is b for a, b in zip(T.tree_leaves(again), leaves, strict=True))
    doubled = T.tree_map(lambda x, y: x + y, got, got)
    assert all(torch.equal(d, x + x) for d, x in zip(T.tree_leaves(doubled), leaves))
    with pytest.raises(ValueError):
        cache_from_numpy(want, init_cache(cfg, B + 1, 10, device="cpu"))
