"""The port's serving slice on the CPU against the JAX package on the
yi_6b smoke config (float32), with the JAX weights carried over by
repro_torch.bridge: paged_forward logits and pages, whole-engine outputs
and completion order with device admission off and on, the admission ring
protocol, and the KV pool's tenant metering."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.serving.engine import Engine as JaxEngine
from repro.serving.paged_model import paged_forward as jax_paged_forward
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.sched import TenantQuotaLedger
from repro_torch.serving.admission import DeviceAdmissionRing
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_cache import PagedKVPool
from repro_torch.serving.paged_model import paged_forward


@pytest.fixture(scope="module")
def model():
    jcfg = jax_config("yi_6b", smoke=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    # one compiled forward shared by every JAX engine of this module
    jfwd = jax.jit(lambda p, t, kp, vp, bt, sl:
                   jax_paged_forward(p, t, jcfg, kp, vp, bt, sl))
    return jcfg, jparams, get_config("yi_6b", smoke=True), tparams, jfwd


def _close(t, j, tol=1e-4):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=tol, rtol=tol)


def _pages_equal_but_scratch(t, j):
    """Pages agree everywhere except scratch page 0, which takes duplicate
    writes from idle lanes in an unspecified order: the same slots written,
    with K/V values allclose at 1e-5 (the projections sum in another
    order in the two frameworks)."""
    t, j = t[:, 1:].numpy(), np.asarray(j)[:, 1:]
    np.testing.assert_array_equal(t != 0, j != 0)
    np.testing.assert_allclose(t, j, atol=1e-5, rtol=1e-5)


def test_paged_forward_matches_jax(model):
    """Prefill (the flash path), decode steps with an idle lane (the paged
    path, scratch writes) and one chunked call (the paged kernel over B*S rows),
    each against the reference's gathered attention: logits allclose at
    1e-4 (the two frameworks sum in different orders), the same page slots
    written with allclose values."""
    jcfg, jparams, cfg, tparams, _ = model
    L, KV, hd, P, page, pps = cfg.num_layers, cfg.num_kv_heads, 16, 16, 4, 6
    jk = jv = jnp.zeros((L, P, KV, page, hd), jnp.float32)
    tk, tv = torch.zeros((L, P, KV, page, hd)), torch.zeros((L, P, KV, page, hd))
    bt = np.zeros((3, pps), np.int32)
    bt[0, :4], bt[1, :3] = [1, 2, 3, 4], [5, 6, 7]  # lane 2 stays idle
    prompts = [[5, 17, 200, 3, 9, 1], [9, 9, 42]]
    last = []
    for lane, prompt in enumerate(prompts):
        toks, sl = np.asarray([prompt], np.int32), np.zeros((1,), np.int32)
        jl, jk, jv = jax_paged_forward(jparams, jnp.asarray(toks), jcfg, jk, jv,
                                       jnp.asarray(bt[lane:lane + 1]), jnp.asarray(sl))
        tl, tk, tv = paged_forward(tparams, torch.from_numpy(toks), cfg, tk, tv,
                                   torch.from_numpy(bt[lane:lane + 1]),
                                   torch.from_numpy(sl))
        _close(tl, jl)
        _pages_equal_but_scratch(tk, jk)
        last.append(int(jnp.argmax(jl[0])))
    seq = np.asarray([6, 3, 0], np.int32)
    last = np.asarray(last + [0], np.int32)
    for _ in range(5):
        toks = last[:, None]
        jl, jk, jv = jax_paged_forward(jparams, jnp.asarray(toks), jcfg, jk, jv,
                                       jnp.asarray(bt), jnp.asarray(seq))
        tl, tk, tv = paged_forward(tparams, torch.from_numpy(toks), cfg, tk, tv,
                                   torch.from_numpy(bt), torch.from_numpy(seq))
        _close(tl[:2], jl[:2])
        _pages_equal_but_scratch(tk, jk)
        _pages_equal_but_scratch(tv, jv)
        last = np.asarray([*np.asarray(jnp.argmax(jl[:2], axis=-1)), 0], np.int32)
        seq = seq + np.asarray([1, 1, 0], np.int32)
    toks, sl = np.asarray([[7, 8]], np.int32), seq[:1]
    jl, jk, _ = jax_paged_forward(jparams, jnp.asarray(toks), jcfg, jk, jv,
                                  jnp.asarray(bt[:1]), jnp.asarray(sl))
    tl, tk, _ = paged_forward(tparams, torch.from_numpy(toks), cfg, tk, tv,
                              torch.from_numpy(bt[:1]), torch.from_numpy(sl))
    _close(tl, jl)
    _pages_equal_but_scratch(tk, jk)


def test_paged_forward_refuses_moe_blocks(model):
    """paged_forward serves MoE blocks (tests/test_torch_moe.py holds them
    to the JAX package) and refuses a block without attention. The name is
    older than MoE serving: a failure here is either of those two checks."""
    _, _, cfg, tparams, _ = model
    z = torch.zeros((2, 4, 2, 4, 16))
    args = (torch.zeros((1, 2), dtype=torch.int32), z, z,
            torch.zeros((1, 2), dtype=torch.int32), torch.zeros((1,), dtype=torch.int32))
    moe_cfg = get_config("granite_moe", smoke=True)
    moe_params = init_params(moe_cfg, torch.Generator().manual_seed(0), "cpu")
    zm = torch.zeros((moe_cfg.num_layers, 4, moe_cfg.num_kv_heads, 4,
                      moe_cfg.resolved_head_dim))
    logits, _, _ = paged_forward(moe_params, args[0], moe_cfg, zm, zm.clone(), *args[3:])
    assert logits.shape == (1, moe_cfg.vocab_size) and bool(torch.isfinite(logits).all())
    with pytest.raises(AssertionError):
        paged_forward(tparams, args[0], dataclasses.replace(cfg, block_pattern=("mlstm",)),
                      *args[1:])


@pytest.mark.parametrize("softcap", [0.0, 30.0, 2.0])
def test_chunked_prefill_and_softcap_match_jax(model, softcap):
    """A prefill in two chunks (the second past position 0: the paged
    kernel's plain version over B*S rows) and decode steps, with the
    softcap off and on (the config's ``attn_softcap``; 2.0 bites on the
    smoke weights), against the reference's paged_forward (its gathered
    attention): logits allclose at 1e-4, the same pages written."""
    jcfg, jparams, cfg, tparams, _ = model
    jcfg = dataclasses.replace(jcfg, attn_softcap=softcap)
    cfg = dataclasses.replace(cfg, attn_softcap=softcap)
    L, KV, hd, P, page = cfg.num_layers, cfg.num_kv_heads, 16, 16, 4
    jk = jv = jnp.zeros((L, P, KV, page, hd), jnp.float32)
    tk, tv = torch.zeros((L, P, KV, page, hd)), torch.zeros((L, P, KV, page, hd))
    bt = np.array([[1, 2, 3, 4, 5, 0], [6, 7, 8, 9, 10, 11]], np.int32)
    toks = np.array([[5, 17, 200, 3, 9, 1, 8, 8, 2, 4, 77],
                     [9, 9, 42, 7, 1, 3, 3, 5, 6, 50, 2]], np.int32)
    seq = np.zeros((2,), np.int32)
    for lo, hi in ((0, 6), (6, 11), (11, 12)):
        chunk = toks[:, lo:hi] if hi <= toks.shape[1] else last[:, None]
        jl, jk, jv = jax_paged_forward(jparams, jnp.asarray(chunk), jcfg, jk, jv,
                                       jnp.asarray(bt), jnp.asarray(seq))
        tl, tk, tv = paged_forward(tparams, torch.from_numpy(chunk), cfg, tk, tv,
                                   torch.from_numpy(bt), torch.from_numpy(seq))
        _close(tl, jl)
        _pages_equal_but_scratch(tk, jk)
        last = np.array(jnp.argmax(jl, axis=-1), np.int32)
        seq = seq + chunk.shape[1]


ENGINE_CASES = {
    # tests/test_serving.py::test_engine_matches_reference
    "reference": (dict(max_batch=2, page_size=8, num_pages=32, window=2, max_seq=64),
                  [[5, 17, 200, 3], [9, 9, 42], [100, 2, 7, 7, 1], [11] * 9], 5),
    # tests/test_serving.py::test_engine_device_admission_matches_host
    "admission": (dict(max_batch=2, page_size=8, num_pages=32, window=2, max_seq=64),
                  [[5, 17, 200, 3], [9, 9, 42], [100, 2, 7], [11] * 5], 4),
    # tests/test_serving.py::test_preemption_recovers_and_completes
    "preemption": (dict(max_batch=3, page_size=4, num_pages=10, window=2, max_seq=24),
                   [[5, 17, 200, 3], [9, 9, 42], [100, 2, 7, 7, 1]], 6),
    # the same with a pool small enough that a lane is really preempted
    "pressure": (dict(max_batch=3, page_size=4, num_pages=8, window=2, max_seq=24),
                 [[5, 17, 200, 3], [9, 9, 42], [100, 2, 7, 7, 1]], 8),
}


@pytest.mark.parametrize("device_admission", [False, True])
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_jax_engine(model, case, device_admission):
    """Token-identical outputs, the same completion order, the same
    preemptions and step count, and (ring path) the same ring stats."""
    jcfg, jparams, cfg, tparams, jfwd = model
    kw, prompts, new = ENGINE_CASES[case]
    jeng = JaxEngine(jcfg, jparams, forward_fn=jfwd,
                     device_admission=device_admission, **kw)
    teng = Engine(cfg, tparams, device_admission=device_admission, device="cpu", **kw)
    juids = [jeng.submit(p, max_new_tokens=new) for p in prompts]
    tuids = [teng.submit(p, max_new_tokens=new) for p in prompts]
    jdone, tdone = jeng.run_until_idle(max_steps=400), teng.run_until_idle(max_steps=400)
    assert tuids == juids and list(tdone) == list(jdone)  # completion order
    assert [tdone[u].output for u in tuids] == [jdone[u].output for u in juids]
    assert [tdone[u].preemptions for u in tuids] == [jdone[u].preemptions for u in juids]
    assert teng.step_count == jeng.step_count
    assert teng.pool.free_pages() == jeng.pool.free_pages()
    assert set(tuids) <= set(tdone), "a request did not complete"
    if case == "pressure":
        assert sum(tdone[u].preemptions for u in tuids) > 0, "no preemption exercised"
    if device_admission:
        assert teng._dev_admit.stats["kernel_calls"] > 0, "ring path never exercised"
        assert teng._dev_admit.stats == jeng._dev_admit.stats
        assert teng.ring_pending == 0


def test_engine_on_cuda_without_a_card_raises(model):
    """The engine, the replica group and a serving Fabric run on the card
    unless asked for the CPU: without one they raise (the Fabric before it
    makes weights or transport workers); a scheduler-only Fabric needs no
    device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the engine runs there")
    from repro_torch.fabric import ClassSpec, Fabric, FabricConfig
    from repro_torch.serving.engine import EngineReplicaGroup

    _, _, cfg, tparams, _ = model
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(cfg, tparams)
    with pytest.raises(RuntimeError, match="CUDA"):
        EngineReplicaGroup(cfg, tparams, num_replicas=2)
    fcfg = FabricConfig(classes=(ClassSpec("default"),), arch="yi_6b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Fabric.open(fcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Fabric.from_snapshot(Fabric.open(fcfg, device="cpu").snapshot())
    Fabric.open(FabricConfig(classes=(ClassSpec("default"),))).close()


def test_engine_rejects_non_attention_families(model):
    _, _, cfg, tparams, _ = model
    with pytest.raises(AssertionError):
        Engine(dataclasses.replace(cfg, block_pattern=("mlstm",)), tparams, device="cpu")


# ---------------------------------------------------------------------------
# device admission ring (mirrors tests/test_serving.py)
# ---------------------------------------------------------------------------


def test_device_admission_ring_fifo_and_lookahead():
    ring = DeviceAdmissionRing(k=4, claim_block=16, device="cpu")
    entries = [("q", i) for i in range(40)]
    out, i = [], 0
    while len(out) < 40:
        push, i = entries[i:i + 8], min(i + 8, 40)
        claimed, rejected = ring.step(push, 4)
        assert not rejected
        out.extend(claimed)
    assert out == entries, "ring admission reordered the FIFO"
    assert ring.stats["kernel_calls"] < ring.stats["steps"]
    assert ring.pending == 0
    assert ring.state.device.type == "cpu" and ring.meta.dtype == torch.int32


def test_device_admission_ring_flush_is_exact_and_reusable():
    ring = DeviceAdmissionRing(k=2, claim_block=8, device="cpu")
    entries = [("q", i) for i in range(20)]
    claimed, _ = ring.step(entries, 2)
    assert claimed == entries[:2]
    state = ring.state
    assert ring.flush() == entries[2:]
    assert ring.state is state and int(ring.state.sum()) == 0  # zeroed in place
    assert ring.meta.tolist() == [20, 20]
    assert ring.pending == 0 and ring.flush() == []
    more = [("q", i) for i in range(20, 30)]
    claimed, rejected = ring.step(more, 2)
    assert not rejected
    while len(claimed) < 10:
        got, rejected = ring.step([], 2)
        assert got and not rejected
        claimed.extend(got)
    assert claimed == more


def test_device_admission_ring_rejects_past_capacity():
    ring = DeviceAdmissionRing(k=2, claim_block=2, capacity=8, window=2, device="cpu")
    entries = [("q", i) for i in range(12)]
    claimed, rejected = ring.step(entries, 0)
    assert claimed == [] and rejected == entries[8:]
    assert ring.pending + len(rejected) == 12


# ---------------------------------------------------------------------------
# KV pool tenant metering (mirrors tests/test_tenants.py)
# ---------------------------------------------------------------------------


def test_kv_pool_meters_tenant_pages():
    pool = PagedKVPool(get_config("yi_6b", smoke=True), num_pages=16, page_size=8,
                       window=2, device="cpu")
    led = TenantQuotaLedger(per_tenant=6, total=16, num_hosts=1)
    pool.attach_ledger(led)
    ids, valid = pool.alloc_for("a", 4)
    assert int(valid.sum()) == 4 and led.used("a") == 4
    denied, _ = pool.alloc_for("a", 3)  # 4+3 > 6: denied before the pool
    assert denied.shape == (0,)
    assert pool.free_pages() == 12 and pool.live_pages() == 4
    pool.retire_for("a", ids)
    assert led.used("a") == 0
    pool.tick(10)
    assert pool.reclaimable_pages() == 0 and pool.free_pages() == 16
    assert pool.protection_boundary() == 8
    pool.ledger = None
    ids2, valid2 = pool.alloc_for("b", 2)
    assert int(valid2.sum()) == 2 and led.used("b") == 0
