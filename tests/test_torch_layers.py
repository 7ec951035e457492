"""The port's model layers, parameter init and weight bridge against the
JAX package, on inputs made with numpy (float32, tolerance 1e-5 unless
stated: the two frameworks reduce in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import init_params, param_count
from repro_torch.models import layers as TL

TOL = 1e-5


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=tol, rtol=tol)


def _rand(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x, jnp.asarray(x), torch.from_numpy(x)


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    _, jx, tx = _rand(rng, 3, 5, 32)
    _, js, ts = _rand(rng, 32)
    _, jb, tb = _rand(rng, 32)
    _close(TL.rms_norm(tx, ts), JL.rms_norm(jx, js))
    _close(TL.layer_norm(tx, ts, tb), JL.layer_norm(jx, js, jb))
    _close(TL.norm(tx, {"scale": ts, "bias": tb}, "layernorm"),
           JL.norm(jx, {"scale": js, "bias": jb}, "layernorm"))


@pytest.mark.parametrize("theta", [10000.0, 5000000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    _, jx, tx = _rand(rng, 2, 7, 4, 16)
    pos = rng.integers(0, 900, (2, 7)).astype(np.int32)
    _close(TL.apply_rope(tx, torch.from_numpy(pos), theta),
           JL.apply_rope(jx, jnp.asarray(pos), theta), 1e-4)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (3, 0.0), (0, 5.0)])
def test_cache_attention_matches_jax(window, softcap):
    rng = np.random.default_rng(2)
    _, jq, tq = _rand(rng, 2, 3, 4, 8)
    _, jk, tk = _rand(rng, 2, 9, 2, 8)
    _, jv, tv = _rand(rng, 2, 9, 2, 8)
    qp = np.asarray([[6, 7, 8], [2, 3, 4]], np.int32)
    kp = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    kp[1, 5:] = -1
    got = TL.cache_attention(tq, tk, tv, torch.from_numpy(qp), torch.from_numpy(kp),
                             sliding_window=window, softcap=softcap)
    want = JL.cache_attention(jq, jk, jv, jnp.asarray(qp), jnp.asarray(kp),
                              sliding_window=window, softcap=softcap)
    _close(got, want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_swiglu_matches_jax(act):
    rng = np.random.default_rng(3)
    _, jx, tx = _rand(rng, 2, 3, 16)
    p = {k: _rand(rng, *s) for k, s in (("wg", (16, 24)), ("wu", (16, 24)),
                                        ("wd", (24, 16)))}
    _close(TL.swiglu(tx, {k: v[2] for k, v in p.items()}, act),
           JL.swiglu(jx, {k: v[1] for k, v in p.items()}, act))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def test_init_params_has_the_reference_tree():
    """Same key paths, shapes and dtypes as the JAX package's init, and the
    same distributions (unit norm scales, std 0.02 weights)."""
    jcfg, cfg = jax_config("yi_6b", smoke=True), get_config("yi_6b", smoke=True)
    jp = _paths(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tp = _paths(init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape, k
        assert str(tp[k].dtype).replace("torch.", "") == str(jp[k].dtype), k
    assert torch.equal(tp["final_norm.scale"], torch.ones(cfg.d_model))
    assert abs(float(tp["embed"].std()) - 0.02) < 2e-3
    assert param_count(_unflat(tp)) == sum(x.size for x in jp.values())


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, leaf = path.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = v
    return tree


def test_bridge_keeps_paths_and_bf16_values():
    rng = np.random.default_rng(4)
    tree = {"a": {"w": jnp.asarray(rng.standard_normal((3, 4)), jnp.bfloat16)},
            "b": jnp.asarray(rng.standard_normal(5), jnp.float32)}
    out = params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                            dtype=torch.bfloat16, device="cpu")
    assert out["a"]["w"].dtype == torch.bfloat16 and tuple(out["b"].shape) == (5,)
    np.testing.assert_array_equal(out["a"]["w"].float().numpy(),
                                  np.asarray(tree["a"]["w"], np.float32))
