"""The port's training path against the JAX package on the CPU: ``loss_fn``
and its gradients (every block kind: the attention configs, xLSTM and
hymba), remat, AdamW, the ``Trainer``'s trajectory, checkpoints across
packages, exact resume and train-then-serve.

Parameters come from ``repro.models.init_params`` through numpy
(``params_from_numpy``), batches from ``synth_batch``; float32 but for
one bfloat16 trajectory. Tolerances, all from f32 sums taken in another
order by XLA and by torch:
* the loss, its metrics and every gradient leaf: atol = rtol = 1e-5 (the
  layers' tolerance; measured ≤ 1e-7 on the smoke configs);
* a trajectory: each step's loss within 1e-5, and the params within 1e-4
  after 8 steps. AdamW divides each moment by its root, so a last-bit
  difference in a gradient moves an element by up to a few ulps of lr per
  step (measured ≤ 4e-6 after 8 steps at lr 1e-3); 1e-4 = lr / 10 still
  catches one element taking a wrong update, which moves it by about lr;
* one trajectory in bfloat16, stated at its test.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import synth_batch
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.training import optimizer as JO
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import checkpointer as TC
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models import layers as TL
from repro_torch.models import loss_fn
from repro_torch.models import model as TM
from repro_torch.serving.engine import Engine
from repro_torch.training import optimizer as TO
from repro_torch.training.train_loop import Trainer

TOL = 1e-5
PARAM_TOL = 1e-4
ARCHS = ["yi_6b", "glm4_9b", "phi3_mini", "command_r_35b", "granite_moe",
         "llama4_maverick", "llava_next", "musicgen_large", "xlstm_125m", "hymba_1_5b"]
TRAINED = ["yi_6b", "granite_moe", "xlstm_125m", "hymba_1_5b"]


def _bridge(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             dtype=torch.float32, device="cpu")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _close_trees(ttree, jtree, tol):
    tl, jl = TO.tree_leaves(ttree), jax.tree_util.tree_leaves(jtree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        _close(t, j, tol)


def _batch(cfg, rng, extra: bool):
    tokens = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)
    batch = {"tokens": tokens}
    if extra:  # the frontend stubs' embeddings, prepended and unlabelled
        batch["extra_embeds"] = (rng.standard_normal((2, 3, cfg.d_model)) * 0.02
                                 ).astype(np.float32)
    return batch


def _grads(params, batch, cfg):
    live = [p.detach().requires_grad_(True) for p in TO.tree_leaves(params)]
    loss, metrics = loss_fn(TO.tree_unflatten(params, iter(live)), batch, cfg)
    return loss, metrics, torch.autograd.grad(loss, live)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    nb = _batch(cfg, np.random.default_rng(1), cfg.frontend is not None)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(p, b, jcfg), has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in nb.items()})
    loss, metrics, grads = _grads(_bridge(jparams), {k: torch.from_numpy(v)
                                                     for k, v in nb.items()}, cfg)
    _close(loss, jloss)
    for k in ("loss", "aux_loss", "ppl_proxy"):
        _close(metrics[k], jm[k])
    if "moe" in cfg.block_pattern:
        assert float(metrics["aux_loss"].detach()) > 0
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, j in zip(grads, jleaves):
        _close(g, j)


def test_remat_matches_no_remat_and_jax():
    """remat=True recomputes each pattern repeat in the backward: the same
    loss and gradients as without it, and as JAX's ``jax.checkpoint``."""
    import dataclasses

    jcfg = dataclasses.replace(jax_config("granite_moe", smoke=True), remat=True)
    cfg = get_config("granite_moe", smoke=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(2))
    nb = _batch(cfg, np.random.default_rng(2), False)
    tb = {"tokens": torch.from_numpy(nb["tokens"])}
    runs = [_grads(_bridge(jparams), tb, dataclasses.replace(cfg, remat=r))
            for r in (False, True)]
    for a, b in zip(runs[0][2], runs[1][2]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(p, {"tokens": jnp.asarray(nb["tokens"])}, jcfg),
        has_aux=True))(jparams)
    _close(runs[1][0], jloss)
    for g, j in zip(runs[1][2], jax.tree_util.tree_leaves(jgrads)):
        _close(g, j)


def test_schedule_matches_jax():
    cfg = TO.OptConfig(lr=1e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    jcfg = JO.OptConfig(lr=1e-3, warmup_steps=5, total_steps=40, min_lr_frac=0.1)
    for step in (0, 1, 4, 5, 6, 17, 39, 40, 90):
        got = TO.schedule(torch.tensor(step, dtype=torch.int32), cfg)
        assert got.dtype == torch.float32
        _close(got, JO.schedule(jnp.asarray(step, jnp.int32), jcfg), 1e-9)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(moments, monkeypatch):
    """Three AdamW steps on a tree with a stacked leaf, gradients large
    enough that clipping scales them (the clip branch), each leaf walked in
    slices of 40 elements (so the stacked leaf in slices of its layers)."""
    monkeypatch.setattr(TO, "SLICE", 40)
    rng = np.random.default_rng(3)
    shapes = {"embed": (7, 5), "blocks": {"0": {"w": (3, 4, 6), "scale": (3, 4)}},
              "lm_head": (5, 7)}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in s.items()}

    p_np = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, moment_dtype=moments)
    cfg, jcfg = TO.OptConfig(**kw), JO.OptConfig(**kw)
    params = jax.tree_util.tree_map(lambda a: torch.from_numpy(a.copy()), p_np)
    jparams = jax.tree_util.tree_map(jnp.asarray, p_np)
    state, jstate = TO.init(params, cfg), JO.init(jparams, jcfg)
    jax_update = jax.jit(JO.apply_updates, static_argnums=3)
    for _ in range(3):
        g_np = tree(lambda s: (rng.standard_normal(s) * 3).astype(np.float32))
        grads = jax.tree_util.tree_map(torch.from_numpy, g_np)
        assert float(TO.global_norm(grads)) > cfg.clip_norm  # the clip branch
        _close(TO.global_norm(grads), JO.global_norm(g_np))
        params, state, m = TO.apply_updates(params, grads, state, cfg)
        jparams, jstate, jm = jax_update(jparams, g_np, jstate, jcfg)
        _close(m["grad_norm"], jm["grad_norm"])
        _close(m["lr"], jm["lr"], 1e-9)
        _close_trees(params, jparams, 1e-6)
        mtol = 1e-6 if moments == "float32" else 1e-2  # one bf16 rounding apart
        for a, b in ((state.mu, jstate.mu), (state.nu, jstate.nu)):
            assert all(x.dtype == getattr(torch, moments) for x in TO.tree_leaves(a))
            _close_trees(a, b, mtol)
    assert int(state.step) == int(jstate.step) == 3


def _data_iter(batches):
    i = 0
    while True:
        yield batches[i % len(batches)]
        i += 1


OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)


def _port_trainer(arch, jparams, **kw):
    tr = Trainer(get_config(arch, smoke=True), TO.OptConfig(**OPT), device="cpu", **kw)
    tr.params = _bridge(jparams)
    tr.opt_state = TO.init(tr.params, tr.opt_cfg)
    return tr


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """One JAX Trainer per trained config, 8 steps on fixed batches, with a
    checkpoint kept at step 4 and its params and loss history at steps 6
    and 8 (one jit a config)."""
    runs = {}
    for arch in TRAINED:
        cfg = jax_config(arch, smoke=True)
        batches = [synth_batch(0, i, 2, 16, cfg.vocab_size) for i in range(8)]
        d = tmp_path_factory.mktemp(arch)
        tr = JaxTrainer(cfg, JO.OptConfig(**OPT), ckpt_dir=str(d / "live"),
                        ckpt_every=100, seed=3)
        it = _data_iter(batches)
        tr.fit(it, 4)
        shutil.copytree(d / "live", d / "at4")
        run = {"batches": batches, "init": jax_init_params(cfg, jax.random.PRNGKey(3)),
               "at4": str(d / "at4")}
        for n in (6, 8):
            tr.fit(it, 2)
            run[n] = (list(tr.history), jax.tree_util.tree_map(np.asarray, tr.params))
        runs[arch] = run
    return runs


@pytest.mark.parametrize("arch", TRAINED)
def test_trainer_trajectory_matches_jax(arch, jax_runs):
    run = jax_runs[arch]
    tr = _port_trainer(arch, run["init"])
    tr.fit(_data_iter(run["batches"]), 8)
    history, jparams = run[8]
    np.testing.assert_allclose(tr.history, history, atol=TOL, rtol=TOL)
    assert history[-1] < history[0]
    _close_trees(tr.params, jparams, PARAM_TOL)
    assert int(tr.opt_state.step) == 8


def test_trainer_trajectory_matches_jax_in_bf16():
    """8 steps in bfloat16 with remat (the dtype and remat of the full
    configs): losses within 1e-2 and params within 2**-6. Each step rounds
    the float32 update to bf16, and a last-bit difference rounds some
    elements one bf16 ulp apart (a quarter of them here), which the next
    steps carry; 2**-6 is two ulps of a unit-scale norm weight (measured:
    losses 7e-4, params 4.3e-3)."""
    import dataclasses

    kw = dict(dtype="bfloat16", remat=True)
    jcfg = dataclasses.replace(jax_config("yi_6b", smoke=True), **kw)
    cfg = dataclasses.replace(get_config("yi_6b", smoke=True), **kw)
    batches = [synth_batch(0, i, 2, 16, cfg.vocab_size) for i in range(8)]
    jtr = JaxTrainer(jcfg, JO.OptConfig(**OPT), seed=3)
    jtr.fit(_data_iter(batches), 8)
    tr = Trainer(cfg, TO.OptConfig(**OPT), device="cpu")
    tr.params = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(3))),
        dtype=torch.bfloat16, device="cpu")
    tr.opt_state = TO.init(tr.params, tr.opt_cfg)
    tr.fit(_data_iter(batches), 8)
    np.testing.assert_allclose(tr.history, jtr.history, atol=1e-2, rtol=0)
    assert all(p.dtype == torch.bfloat16 for p in TO.tree_leaves(tr.params["blocks"]))
    _close_trees(tr.params, jax.tree_util.tree_map(np.asarray, jtr.params), 2.0 ** -6)


@pytest.mark.parametrize("arch", TRAINED)
def test_port_resumes_a_jax_checkpoint(arch, jax_runs, tmp_path):
    """JAX's checkpoint at step 4 (params, OptState, data state), restored
    by the port's Trainer (another seed) and run 2 more steps: JAX's
    uninterrupted 6 steps."""
    run = jax_runs[arch]
    d = tmp_path / "ck"
    shutil.copytree(run["at4"], d)
    tr = Trainer(get_config(arch, smoke=True), TO.OptConfig(**OPT), ckpt_dir=str(d),
                 ckpt_every=100, seed=999, device="cpu")
    assert tr.try_restore() and tr.step == 4
    assert isinstance(tr.opt_state, TO.OptState) and int(tr.opt_state.step) == 4
    it = _data_iter(run["batches"])
    for _ in range(4):
        next(it)
    tr.fit(it, 2)
    history, jparams = run[6]
    np.testing.assert_allclose(tr.history, history[4:], atol=TOL, rtol=TOL)
    _close_trees(tr.params, jparams, PARAM_TOL)


def test_jax_resumes_a_port_checkpoint(jax_runs, tmp_path):
    """The reverse: the port's Trainer checkpoints at step 4, a JAX Trainer
    restores it and runs 2 more steps: JAX's uninterrupted 6 steps."""
    run = jax_runs["yi_6b"]
    d = str(tmp_path / "ck")
    tr = _port_trainer("yi_6b", run["init"], ckpt_dir=d, ckpt_every=4)
    tr.fit(_data_iter(run["batches"]), 4)
    jtr = JaxTrainer(jax_config("yi_6b", smoke=True), JO.OptConfig(**OPT), ckpt_dir=d,
                     ckpt_every=100, seed=999)
    assert jtr.try_restore() and jtr.step == 4
    it = _data_iter(run["batches"])
    for _ in range(4):
        next(it)
    jtr.fit(it, 2)
    history, jparams = run[6]
    np.testing.assert_allclose(jtr.history, history[4:], atol=TOL, rtol=TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jtr.params),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(np.asarray(a), b, atol=PARAM_TOL, rtol=PARAM_TOL)


def test_failure_recovery_resume_is_exact(tmp_path):
    """The port alone: train 6 steps straight vs train 4 + crash + restore
    + 2 — identical (tests/test_checkpoint.py's check, on the port)."""
    cfg = get_config("yi_6b", smoke=True)
    opt = TO.OptConfig(**OPT)
    batches = [synth_batch(0, i, 2, 16, cfg.vocab_size) for i in range(8)]
    tr_a = Trainer(cfg, opt, seed=3, device="cpu")
    tr_a.fit(_data_iter(batches), 6)
    d = str(tmp_path / "ck")
    tr_b = Trainer(cfg, opt, ckpt_dir=d, ckpt_every=4, seed=3, device="cpu")
    tr_b.fit(_data_iter(batches), 4)
    tr_b.async_ckpt.drain()
    tr_c = Trainer(cfg, opt, ckpt_dir=d, ckpt_every=100, seed=999, device="cpu")
    assert tr_c.try_restore() and tr_c.step == 4
    it = _data_iter(batches)
    for _ in range(4):
        next(it)
    tr_c.fit(it, 2)
    for a, b in zip(TO.tree_leaves(tr_a.params), TO.tree_leaves(tr_c.params)):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_train_loss_decreases_through_full_stack(tmp_path):
    """CMP data pipeline -> Trainer -> write-behind checkpoints
    (tests/test_system.py's check, on the port)."""
    cfg = get_config("yi_6b", smoke=True)
    opt = TO.OptConfig(lr=2e-3, warmup_steps=3, total_steps=100)
    pipe = DataPipeline(batch=4, seq=32, vocab=cfg.vocab_size, num_producers=2, window=16)
    tr = Trainer(cfg, opt, ckpt_dir=str(tmp_path), ckpt_every=10, device="cpu")
    res = tr.fit(iter(pipe), 25, data_pipe=pipe)
    pipe.close()
    first = sum(tr.history[:5]) / 5
    last = sum(tr.history[-5:]) / 5
    assert last < first - 0.2, f"loss did not decrease: {first} -> {last}"
    assert res["ckpt_dropped"] == 0 or res["ckpt_dropped"] < 3


def test_train_then_serve_same_params(tmp_path):
    """The checkpoint written by the port's training serves through the
    port's Engine."""
    cfg = get_config("yi_6b", smoke=True)
    opt = TO.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    pipe = DataPipeline(batch=2, seq=16, vocab=cfg.vocab_size, num_producers=1, window=8)
    tr = Trainer(cfg, opt, ckpt_dir=str(tmp_path), ckpt_every=5, device="cpu")
    tr.fit(iter(pipe), 6, data_pipe=pipe)
    pipe.close()
    step, state = TC.restore(str(tmp_path), {"params": tr.params, "opt_state": tr.opt_state,
                                             "data_state": pipe.state()})
    assert step == 6 and isinstance(state["opt_state"], TO.OptState)
    for a, b in zip(TO.tree_leaves(state["params"]), TO.tree_leaves(tr.params)):
        assert torch.equal(a, b)
    eng = Engine(cfg, state["params"], max_batch=2, page_size=8, num_pages=32, window=2,
                 max_seq=48, device="cpu")
    u = eng.submit([1, 2, 3], max_new_tokens=3)
    done = eng.run_until_idle()
    assert len(done[u].output) == 3


def test_attention_impl_pallas_refuses_grad():
    """The pallas route is the flash kernel, which has no backward (nor has
    the reference's a VJP): inputs that record a graph are refused."""
    q = torch.zeros(1, 4, 2, 8, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        TL.self_attention(q, q, q, impl="pallas")
    with torch.no_grad():
        assert TL.self_attention(q, q, q, impl="pallas").shape == q.shape


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (3, 0.0), (0, 5.0)])
def test_attention_impl_pallas_matches_jax(window, softcap):
    """``impl="pallas"``: the flash kernel's plain version here, the Pallas
    kernel in interpret mode in the reference; with a softcap both take the
    plain attention."""
    from repro.models import layers as JL

    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 9, 4, 8), (2, 9, 2, 8), (2, 9, 2, 8)))
    got = TL.self_attention(*map(torch.from_numpy, (q, k, v)), sliding_window=window,
                              softcap=softcap, impl="pallas")
    _close(got, JL.self_attention(*map(jnp.asarray, (q, k, v)), sliding_window=window,
                                  softcap=softcap, impl="pallas"))


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (3, 0.0), (0, 5.0), (2, 5.0)])
def test_self_attention_matches_jax(window, softcap):
    from repro.models import layers as JL

    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 6, 4, 8), (2, 6, 2, 8), (2, 6, 2, 8)))
    got = TL.self_attention(*map(torch.from_numpy, (q, k, v)), sliding_window=window,
                              softcap=softcap)
    _close(got, JL.self_attention(*map(jnp.asarray, (q, k, v)), sliding_window=window,
                                  softcap=softcap))


def test_active_param_count_matches_jax():
    from repro.models.model import active_param_count as jax_active

    for arch in ("yi_6b", "granite_moe", "llama4_maverick"):
        jcfg = jax_config(arch, smoke=True)
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
        assert TM.active_param_count(get_config(arch, smoke=True), _bridge(jparams)) == \
            jax_active(jcfg, jparams)
