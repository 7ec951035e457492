"""The port's MoE slice on the CPU against the JAX package, on inputs made
with numpy and fed to both: ``assign_slots`` bit for bit, ``moe_block`` in
float32 (2e-5: the frameworks sum in other orders) and through bfloat16
(3e-2, ``tests/test_kernels.py``'s bf16 tolerance), routing ties to the
lower expert index as ``lax.top_k``, the bridge's float32 router, and on
the ``granite_moe`` smoke config (float32) the paged forward's logits and
the engine's tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.models import moe as jax_moe
from repro.serving.engine import Engine as JaxEngine
from repro.serving.paged_model import paged_forward as jax_paged_forward
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models import moe
from repro_torch.serving.engine import Engine
from repro_torch.serving.paged_model import paged_forward


def _assign_both(ids: np.ndarray, e: int, c: int):
    slot, keep = moe.assign_slots(torch.from_numpy(ids), e, c)
    jslot, jkeep = jax_moe.assign_slots(jnp.asarray(ids), e, c)
    assert slot.dtype == torch.int32 and keep.dtype == torch.bool
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    return slot, keep


@pytest.mark.parametrize("a,e,c", [(7, 3, 2), (64, 4, 16), (64, 4, 8), (256, 40, 3),
                                   (1, 1, 1), (96, 8, 96)])
def test_assign_slots_matches_jax(a, e, c):
    """Random expert ids, most cases with more claims on an expert than its
    capacity: the same slots and drops, bit for bit."""
    ids = np.random.default_rng(a * 100 + e + c).integers(0, e, size=a).astype(np.int32)
    slot, keep = _assign_both(ids, e, c)
    if a > e * c:
        assert not bool(keep.all()), "no claim overflowed capacity"
    assert bool((slot[~keep] == e * c).all())


@settings(max_examples=60, deadline=None)
@given(ids=st.lists(st.integers(0, 5), min_size=1, max_size=80), c=st.integers(1, 12))
def test_assign_slots_property(ids, c):
    """Any claim sequence: the port equals JAX, and each expert keeps its
    first c claims in token order at slots (e, 0), (e, 1), ..."""
    ids = np.asarray(ids, np.int32)
    slot, keep = _assign_both(ids, 6, c)
    for e in range(6):
        mine = np.flatnonzero(ids == e)
        np.testing.assert_array_equal(keep.numpy()[mine], np.arange(len(mine)) < c)
        kept = mine[:c]
        np.testing.assert_array_equal(slot.numpy()[kept], e * c + np.arange(len(kept)))


def _moe_params(rng, D, E, F, dtype):
    p = {"router": rng.normal(size=(D, E)).astype(np.float32) * 0.5,
         "wg": rng.normal(size=(E, D, F)).astype(np.float32) * 0.1,
         "wu": rng.normal(size=(E, D, F)).astype(np.float32) * 0.1,
         "wd": rng.normal(size=(E, F, D)).astype(np.float32) * 0.1}
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.dtype(dtype))
          for k, v in p.items()}
    tp = params_from_numpy(p, dtype=getattr(torch, dtype), device="cpu")
    return jp, tp


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_moe_block_matches_jax(dtype, groups, act):
    """moe_block at smoke widths with capacity overflow (B*S*k claims on
    E*C slots), dropped claims included, groups 1 and 2."""
    B, S, D, E, F, k = 4, 6, 32, 8, 48, 2
    rng = np.random.default_rng(groups * 10 + len(dtype))
    jp, tp = _moe_params(rng, D, E, F, dtype)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    kw = dict(num_experts=E, top_k=k, capacity_factor=1.0, min_capacity=2, act=act,
              groups=groups)
    jy, jaux = jax_moe.moe_block(jnp.asarray(x, jnp.dtype(dtype)), jp, **kw)
    ty, taux = moe.moe_block(torch.from_numpy(x).to(getattr(torch, dtype)), tp, **kw)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (B, S, D)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5, rtol=1e-5)
    xt = torch.from_numpy(x).reshape(groups, -1, D)[0]  # the first group's tokens
    ids = torch.sort(xt @ tp["router"], dim=-1, descending=True, stable=True).indices
    T = xt.shape[0]
    _, keep = moe.assign_slots(ids[:, :k].reshape(-1), E, max(2, int(T * k / E)))
    assert not bool(keep.all()), "no claim overflowed capacity"


def test_moe_routing_ties_pick_the_lower_expert():
    """A zero router ties every expert: lax.top_k takes experts 0..k-1, and
    so must the port (torch.topk promises no order among ties). Each expert
    gives another output, so a wrong pick shows in y."""
    D, E, F, k = 8, 6, 4, 3
    rng = np.random.default_rng(0)
    jp, tp = _moe_params(rng, D, E, F, "float32")
    jp["router"], tp["router"] = jnp.zeros((D, E), jnp.float32), torch.zeros((D, E))
    x = rng.normal(size=(1, 4, D)).astype(np.float32)
    kw = dict(num_experts=E, top_k=k, capacity_factor=10.0, min_capacity=8)
    jy, _ = jax_moe.moe_block(jnp.asarray(x), jp, **kw)
    ty, _ = moe.moe_block(torch.from_numpy(x), tp, **kw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=2e-5, rtol=2e-5)
    xt = torch.from_numpy(x[0])
    want = sum(torch.nn.functional.silu(xt @ tp["wg"][e]) * (xt @ tp["wu"][e])
               @ tp["wd"][e] for e in range(k)) / k
    np.testing.assert_allclose(ty[0].numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_bridge_keeps_the_router_float32():
    """A bf16 granite_moe tree through the bridge: every leaf has the dtype
    the port's own init_params gives it (the router float32, the rest bf16)."""
    jcfg = dataclasses.replace(jax_config("granite_moe", smoke=True), dtype="bfloat16")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    tparams = params_from_numpy(
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jparams),
        dtype=torch.bfloat16, device="cpu")
    cfg = dataclasses.replace(get_config("granite_moe", smoke=True), dtype="bfloat16")
    own = init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            for key, val in tree.items():
                yield from leaves(val, f"{path}.{key}" if path else key)
        else:
            yield path, tree

    got = dict(leaves(tparams))
    want = dict(leaves(own))
    assert sorted(got) == sorted(want)
    for path, t in want.items():
        assert got[path].dtype == t.dtype and got[path].shape == t.shape, path
    assert got["blocks.0.moe.router"].dtype == torch.float32
    assert got["blocks.0.moe.wg"].dtype == torch.bfloat16
    jleaf = np.asarray(jparams["blocks"]["0"]["moe"]["router"])
    assert jleaf.dtype == np.float32
    np.testing.assert_array_equal(got["blocks.0.moe.router"].numpy(), jleaf)


@pytest.fixture(scope="module")
def granite():
    jcfg = jax_config("granite_moe", smoke=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    jfwd = jax.jit(lambda p, t, kp, vp, bt, sl:
                   jax_paged_forward(p, t, jcfg, kp, vp, bt, sl))
    return jcfg, jparams, get_config("granite_moe", smoke=True), tparams, jfwd


def test_paged_forward_moe_matches_jax(granite):
    """granite_moe smoke: a prefill (the flash path's plain version), then
    decode steps over two lanes (the paged path's), logits allclose at 1e-4
    as for the dense model (tests/test_torch_serving.py)."""
    jcfg, jparams, cfg, tparams, _ = granite
    L, KV, hd, P, page, pps = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, 12, 4, 4
    jk = jv = jnp.zeros((L, P, KV, page, hd), jnp.float32)
    tk, tv = torch.zeros((L, P, KV, page, hd)), torch.zeros((L, P, KV, page, hd))
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    prompts = [[5, 17, 200, 3, 9, 1], [9, 9, 42]]
    last = []
    for lane, prompt in enumerate(prompts):
        toks, sl = np.asarray([prompt], np.int32), np.zeros((1,), np.int32)
        jl, jk, jv = jax_paged_forward(jparams, jnp.asarray(toks), jcfg, jk, jv,
                                       jnp.asarray(bt[lane:lane + 1]), jnp.asarray(sl))
        tl, tk, tv = paged_forward(tparams, torch.from_numpy(toks), cfg, tk, tv,
                                   torch.from_numpy(bt[lane:lane + 1]),
                                   torch.from_numpy(sl))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        last.append(int(jnp.argmax(jl[0])))
    seq = np.asarray([6, 3], np.int32)
    last = np.asarray(last, np.int32)
    for _ in range(4):
        toks = last[:, None]
        jl, jk, jv = jax_paged_forward(jparams, jnp.asarray(toks), jcfg, jk, jv,
                                       jnp.asarray(bt), jnp.asarray(seq))
        tl, tk, tv = paged_forward(tparams, torch.from_numpy(toks), cfg, tk, tv,
                                   torch.from_numpy(bt), torch.from_numpy(seq))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
        last = np.array(jnp.argmax(jl, axis=-1), np.int32)
        seq = seq + 1


@pytest.mark.parametrize("device_admission", [False, True])
def test_engine_moe_matches_jax_engine(granite, device_admission):
    """tests/test_serving.py::test_engine_moe's engine, and a batch of four
    requests on two lanes: the port's tokens, completion order and step
    count equal the JAX engine's."""
    jcfg, jparams, cfg, tparams, jfwd = granite
    kw = dict(max_batch=2, page_size=8, num_pages=16, window=2, max_seq=32)
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6], [5, 3, 5, 8, 9, 7], [2, 7]]
    jeng = JaxEngine(jcfg, jparams, forward_fn=jfwd, device_admission=device_admission, **kw)
    teng = Engine(cfg, tparams, device_admission=device_admission, device="cpu", **kw)
    juids = [jeng.submit(p, max_new_tokens=4) for p in prompts]
    tuids = [teng.submit(p, max_new_tokens=4) for p in prompts]
    jdone, tdone = jeng.run_until_idle(max_steps=200), teng.run_until_idle(max_steps=200)
    assert tuids == juids and list(tdone) == list(jdone)
    assert [tdone[u].output for u in tuids] == [jdone[u].output for u in juids]
    assert teng.step_count == jeng.step_count
    assert set(tuids) <= set(tdone)
