"""The port's CMP-windowed 1F1B pipeline against the JAX package's on the
CPU: the planner tick for tick, the runner's outputs, gradients, losses and
stats on the reference test's cases (inputs from numpy with a seed; f32,
atol = rtol = 1e-5, sums of the same terms in the same order), the window
enforcement and the reference's buffer-pool limit, and a Yi-6B smoke model
split into two stages held to the port's ``loss_fn`` and the JAX
package's ``jax.value_and_grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

import repro.core.slotpool as jsp
from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.parallel import pipeline as JP
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import slotpool as sp
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import loss_fn
from repro_torch.models import model as M
from repro_torch.parallel import pipeline as P
from repro_torch.tree import tree_leaves, tree_unflatten

TOL = 1e-5


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("num_stages", range(1, 7))
def test_1f1b_ticks_equal_the_reference(num_stages):
    for num_micro in range(1, 11):
        got = P.one_f_one_b(num_stages, num_micro)
        want = JP.one_f_one_b(num_stages, num_micro)
        assert [(t.kind, t.stage, t.microbatch) for t in got] == [
            (t.kind, t.stage, t.microbatch) for t in want], (num_stages, num_micro)
        assert P.max_in_flight(got, num_stages) == JP.max_in_flight(want, num_stages)


def _weights(num_stages, d, seed):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((d, d)) * 0.3).astype(np.float32)
            for _ in range(num_stages)]


def _micro(num_micro, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, d)).astype(np.float32) for _ in range(num_micro)]


@pytest.mark.parametrize("num_stages,num_micro", [(3, 5), (2, 4), (4, 6), (5, 7)])
def test_forward_matches_the_jax_runner(num_stages, num_micro):
    d = 8
    ws = _weights(num_stages, d, 0)
    mb = _micro(num_micro, d, 1)
    jrun = JP.PipelineRunner([lambda x, w=w: jnp.tanh(x @ w) for w in ws], num_micro)
    trun = P.PipelineRunner([lambda x, w=torch.from_numpy(w): torch.tanh(x @ w)
                             for w in ws], num_micro, device="cpu")
    jout = jrun.forward([jnp.asarray(x) for x in mb])
    tout = trun.forward([torch.from_numpy(x) for x in mb])
    for t, j in zip(tout, jout, strict=True):
        _close(t, j)
    assert trun.stats == jrun.stats
    assert trun.stats["fwd"] == num_stages * num_micro
    assert trun.stats["reclaimed"] > 0
    assert trun.stats["peak_slots"] <= trun.window + 2


@pytest.mark.parametrize("num_stages,num_micro", [(3, 4), (2, 4), (4, 6), (1, 3)])
def test_train_grads_match_the_jax_runner(num_stages, num_micro):
    d = 6
    ws = _weights(num_stages, d, 2)
    mb = _micro(num_micro, d, 3)
    jrun = JP.PipelineRunner([lambda x, p: jnp.tanh(x @ p)] * num_stages, num_micro)
    trun = P.PipelineRunner([lambda x, p: torch.tanh(x @ p)] * num_stages, num_micro,
                            device="cpu")
    jg, jl = jrun.train_grads([jnp.asarray(w) for w in ws], [jnp.asarray(x) for x in mb],
                              lambda y: jnp.mean(y ** 2))
    tg, tl = trun.train_grads([torch.from_numpy(w) for w in ws],
                              [torch.from_numpy(x) for x in mb],
                              lambda y: torch.mean(y ** 2))
    _close(tl, jl)
    for t, j in zip(tg, jg, strict=True):
        _close(t, j)
    assert trun.stats == jrun.stats
    assert trun.stats["bwd"] == num_stages * num_micro


def test_window_violation_is_caught():
    """Consuming a buffer after the window slid past it raises in both
    packages (the UAF the CMP window prevents is *detected*)."""
    for pkg, pool_mod, arr in ((JP, jsp, jnp.zeros), (P, sp, torch.zeros)):
        kw = {"device": "cpu"} if pkg is P else {}
        runner = pkg.PipelineRunner([lambda x: x + 1, lambda x: x * 2], num_micro=2, **kw)
        runner._produce(0, 0, arr((1, 4)))
        runner._produce(0, 1, arr((1, 4)) + 1)
        runner._consume(0, 0)
        runner.pools[0] = pool_mod.advance(runner.pools[0], runner.pools[0].enq_cycle + 100)
        runner.pools[0], _ = pool_mod.reclaim_retired(runner.pools[0], 0)
        with pytest.raises(AssertionError, match="UAF"):
            runner._consume(0, 0)


@pytest.mark.parametrize("num_stages,num_micro,fits", [(4, 8, False), (4, 6, True),
                                                       (4, 4, True), (8, 8, True)])
def test_buffer_pool_limit_is_the_reference_s(num_stages, num_micro, fits):
    """Every microbatch enters boundary 0 before the first tick, into
    window + 2 slots: 4 x 8 exhausts the pool in both packages."""
    jrun = JP.PipelineRunner([lambda x: x] * num_stages, num_micro)
    trun = P.PipelineRunner([lambda x: x] * num_stages, num_micro, device="cpu")
    for run, mb in ((jrun, [jnp.zeros(1)] * num_micro), (trun, [torch.zeros(1)] * num_micro)):
        if fits:
            run.forward(mb)
        else:
            with pytest.raises(AssertionError, match="buffer pool exhausted"):
                run.forward(mb)


# ---------------------------------------------------------------------------
# a language model split into stages
# ---------------------------------------------------------------------------


def lm_stage_params(params, bounds):
    """Stage s's params: its slice of the stacked dense blocks, the
    embedding on the first stage, the final norm and head on the last."""
    out = []
    for s, (l0, l1) in enumerate(bounds):
        p = {"blocks": {"0": _slice(params["blocks"]["0"], l0, l1)}}
        if s == 0:
            p["embed"] = params["embed"]
        if s == len(bounds) - 1:
            p["final_norm"] = params["final_norm"]
            p["lm_head"] = params["lm_head"]
        out.append(p)
    return out


def _slice(tree, l0, l1):
    if isinstance(tree, dict):
        return {k: _slice(v, l0, l1) for k, v in tree.items()}
    return tree[l0:l1]


def lm_stage(cfg, s, n_stages, n_layers):
    """stage_s((tokens or hidden, targets), params) -> (hidden or logits,
    targets), built from the port's ``_unstack`` and ``B.APPLY``."""

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
    logits, targets = y
    logp = torch.log_softmax(logits, dim=-1)
    return torch.mean(-torch.gather(logp, -1, targets.long()[..., None])[..., 0])


def test_yi_smoke_in_two_stages_matches_loss_fn_and_jax():
    jcfg = jax_config("yi_6b", smoke=True)
    cfg = get_config("yi_6b", smoke=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               dtype=torch.float32, device="cpu")
    num_micro = 4
    rng = np.random.default_rng(5)
    toks = [rng.integers(0, cfg.vocab_size, (2, 9), dtype=np.int32) for _ in range(num_micro)]
    bounds = [(0, 1), (1, 2)]
    stage_params = lm_stage_params(params, bounds)
    runner = P.PipelineRunner([lm_stage(cfg, s, 2, 1) for s in range(2)], num_micro,
                              device="cpu")
    mb = [(torch.from_numpy(t[:, :-1]), torch.from_numpy(t[:, 1:])) for t in toks]
    grads, loss = runner.train_grads(stage_params, mb, lm_loss)
    assert runner.stats["fwd"] == runner.stats["bwd"] == 2 * num_micro

    # the stages' grads put back together into the model's tree
    full = {"embed": grads[0]["embed"], "final_norm": grads[1]["final_norm"],
            "lm_head": grads[1]["lm_head"],
            "blocks": {"0": _cat(grads[0]["blocks"]["0"], grads[1]["blocks"]["0"])}}

    # the non-pipelined sum: one autograd.grad of the port's loss_fn a micro
    leaves = tree_leaves(params)
    ref = [torch.zeros_like(x) for x in leaves]
    losses = []
    for t in toks:
        live = [x.detach().requires_grad_(True) for x in leaves]
        l_m, _ = loss_fn(tree_unflatten(params, iter(live)),
                         {"tokens": torch.from_numpy(t)}, cfg)
        for acc, g in zip(ref, torch.autograd.grad(l_m, live)):
            acc.add_(g)
        losses.append(l_m.detach())
    _close(loss, torch.stack(losses).mean())
    for g, r in zip(tree_leaves(full), ref, strict=True):
        _close(g, r)

    # and the JAX package's value_and_grad, summed over the same micros
    jgrads, jlosses = None, []
    for t in toks:
        (l_m, _), g = jax.value_and_grad(jax_loss_fn, has_aux=True)(
            jparams, {"tokens": jnp.asarray(t)}, jcfg)
        jgrads = g if jgrads is None else jax.tree_util.tree_map(jnp.add, jgrads, g)
        jlosses.append(l_m)
    _close(loss, jnp.mean(jnp.stack(jlosses)))
    for g, j in zip(tree_leaves(full), jax.tree_util.tree_leaves(jgrads), strict=True):
        _close(g, j)


def _cat(a, b):
    if isinstance(a, dict):
        return {k: _cat(a[k], b[k]) for k in a}
    return torch.cat([a, b])
