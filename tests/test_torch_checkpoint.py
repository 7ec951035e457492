"""The port's checkpointer against the JAX package's on-disk format: a
checkpoint written by either package restores in the other (leaf order,
key paths, shapes, dtypes, bfloat16 leaves as raw 2-byte words, aux and
``latest``), an integrity failure is detected, and the async writer never
lets more than ``window`` snapshots lag."""

import json
import os
import threading
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as JC
from repro_torch.checkpoint import checkpointer as TC


def _state_np(seed=0):
    """One state as numpy arrays (bf16 as its f32 values) with keys that
    sort differently from insertion, a list, a None and mixed dtypes."""
    rng = np.random.default_rng(seed)
    return {
        "params": {"wq": rng.standard_normal((3, 4)).astype(np.float32),
                   "b": rng.standard_normal((5,)).astype(np.float32),
                   "emb": rng.standard_normal((2, 3)).astype(np.float32)},
        "opt": [rng.integers(-9, 9, (4,)).astype(np.int32), None,
                np.asarray(rng.random(3) < 0.5)],
        "a_step": np.asarray(7, np.int32),
    }


def _jax_state(st):
    out = jax.tree_util.tree_map(jnp.asarray, st)
    out["params"]["emb"] = out["params"]["emb"].astype(jnp.bfloat16)
    return out


def _torch_state(st):
    def conv(x):
        return None if x is None else torch.from_numpy(np.array(x))
    out = {"params": {k: conv(v) for k, v in st["params"].items()},
           "opt": [conv(x) for x in st["opt"]], "a_step": conv(st["a_step"])}
    out["params"]["emb"] = out["params"]["emb"].to(torch.bfloat16)
    return out


def _equal(t, j):
    t = t.float() if t.dtype == torch.bfloat16 else t
    j = np.asarray(j)
    if j.dtype.kind == "V":  # JAX's own loader reads a bf16 leaf as raw words
        j = torch.from_numpy(j.view(np.int16)).view(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(t.numpy(), np.asarray(j, dtype=t.numpy().dtype))


def test_manifests_agree_file_for_file(tmp_path):
    """The same state saved by both packages: the same manifest (paths,
    files, shapes, dtypes) and byte-identical shards (equal sha256)."""
    st = _state_np()
    JC.save(str(tmp_path / "jax"), 3, _jax_state(st), aux={"k": [1, 2]})
    TC.save(str(tmp_path / "torch"), 3, _torch_state(st), aux={"k": [1, 2]})
    man = [json.load(open(tmp_path / d / "step_3" / "manifest.json")) for d in ("jax", "torch")]
    assert man[0] == man[1]
    assert [r["dtype"] for r in man[1]["leaves"]] == [
        "int32", "int32", "bool", "float32", "bfloat16", "float32"]
    assert TC.latest_step(str(tmp_path / "torch")) == 3
    assert TC.restore_aux(str(tmp_path / "jax")) == (3, {"k": [1, 2]})


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_restores_across_packages(tmp_path, writer):
    st = _state_np(1)
    d = str(tmp_path / writer)
    if writer == "jax":
        JC.save(d, 5, _jax_state(st))
    else:
        TC.save(d, 5, _torch_state(st))
    step, got = TC.restore(d, _torch_state(_state_np(2)))
    assert step == 5 and got["opt"][1] is None
    assert got["params"]["emb"].dtype == torch.bfloat16
    want = _torch_state(st)
    for k in want["params"]:
        assert torch.equal(got["params"][k], want["params"][k])
    assert torch.equal(got["opt"][0], want["opt"][0]) and torch.equal(got["a_step"],
                                                                       want["a_step"])
    _, jgot = JC.restore(d, _jax_state(_state_np(2)))
    for k in want["params"]:
        _equal(want["params"][k], jgot["params"][k])
    assert jgot["opt"][1] is None
    _equal(want["opt"][2], jgot["opt"][2])


def test_integrity_failure_is_detected(tmp_path):
    d = str(tmp_path)
    TC.save(d, 1, _torch_state(_state_np()))
    shard = os.path.join(d, "step_1", "leaf_00004.npy")
    raw = bytearray(open(shard, "rb").read())
    raw[-1] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="integrity"):
        TC.restore(d, _torch_state(_state_np()))
    with pytest.raises(IOError, match="integrity"):
        JC.restore(d, _jax_state(_state_np()))
    TC.restore(d, _torch_state(_state_np()), verify=False)


def test_async_writer_lag_is_bounded(tmp_path, monkeypatch):
    """A stalled writer holds at most ``window`` snapshots; the rest are
    dropped without blocking, and the retained ones land once it resumes."""
    gate = threading.Event()
    real_save = TC.save

    def slow_save(*a, **kw):
        gate.wait(30)
        return real_save(*a, **kw)

    monkeypatch.setattr(TC, "save", slow_save)
    ck = TC.AsyncCheckpointer(str(tmp_path), window=2)
    st = _torch_state(_state_np())
    oks = [ck.submit(i, st, aux={"i": i}) for i in range(6)]
    assert oks == [True, True, False, False, False, False] and ck.dropped == 4
    gate.set()
    ck.close()
    assert ck.written == [0, 1] and TC.latest_step(str(tmp_path)) == 1
    assert TC.restore_aux(str(tmp_path)) == (1, {"i": 1})


def test_fabric_params_dir_from_a_jax_checkpoint(tmp_path):
    """A params checkpoint written by the JAX package (``{"params": ...}``,
    as its Fabric restores ``params_dir``) loads into the port's Fabric: the
    same weights, and the same tokens as the JAX Fabric from the same
    directory."""
    from repro.configs import get_config
    from repro.fabric import ClassSpec as JSpec
    from repro.fabric import Fabric as JFabric
    from repro.fabric import FabricConfig as JConfig
    from repro.models import init_params
    from repro_torch.fabric import ClassSpec, Fabric, FabricConfig

    jparams = init_params(get_config("yi_6b", smoke=True), jax.random.PRNGKey(3))
    JC.save(str(tmp_path), 0, {"params": jparams})
    kw = dict(arch="yi_6b", smoke=True, params_dir=str(tmp_path), max_batch=2,
              page_size=8, num_pages=16, max_seq=32)
    tfab = Fabric.open(FabricConfig(classes=(ClassSpec("default"),), **kw), device="cpu")
    jfab = JFabric.open(JConfig(classes=(JSpec("default"),), **kw))
    np.testing.assert_array_equal(tfab.params["embed"].numpy(), np.asarray(jparams["embed"]))
    outs = []
    for fab in (jfab, tfab):
        uids = fab.submit_many([[1, 2, 3], [7, 7], [5, 4, 3, 2]], max_new_tokens=4)
        done = fab.drain(max_steps=100)
        outs.append([done[u].output for u in uids])
        fab.close()
    assert outs[0] == outs[1]


class _Pair(NamedTuple):
    step: Any
    mu: Any
    nu: Any


def test_namedtuple_round_trips(tmp_path):
    """A NamedTuple node (the optimizer's ``OptState``) saves under jax's
    ``.field`` key paths and restores as its own type, through ``save`` /
    ``restore`` and through the async writer's host snapshot."""
    st = {"opt_state": _Pair(torch.tensor(3, dtype=torch.int32),
                             {"b": torch.ones(2), "a": torch.zeros(3, dtype=torch.bfloat16)},
                             [torch.arange(4), None])}
    TC.save(str(tmp_path / "s"), 1, st)
    paths = [r["path"] for r in json.load(open(tmp_path / "s" / "step_1" / "manifest.json"))[
        "leaves"]]
    assert paths == ["opt_state/.step", "opt_state/.mu/a", "opt_state/.mu/b",
                     "opt_state/.nu/0"]
    ck = TC.AsyncCheckpointer(str(tmp_path / "a"))
    assert ck.submit(2, st)
    ck.close()
    for d in ("s", "a"):
        _, got = TC.restore(str(tmp_path / d), st)
        g = got["opt_state"]
        assert type(g) is _Pair and g.nu[1] is None and list(g.mu) == ["b", "a"]
        assert torch.equal(g.step, st["opt_state"].step)
        assert g.mu["a"].dtype == torch.bfloat16
        assert torch.equal(g.nu[0], st["opt_state"].nu[0])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_opt_state_crosses_packages(tmp_path, writer):
    """Each package's ``OptState`` (step, mu, nu) restores into the other's,
    with the same manifest."""
    from repro.training import optimizer as JO
    from repro_torch.training import optimizer as TO

    rng = np.random.default_rng(5)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal((4,)).astype(np.float32)}
    jst = JO.OptState(jnp.asarray(7, jnp.int32),
                      jax.tree_util.tree_map(lambda a: jnp.asarray(a * 2), p),
                      jax.tree_util.tree_map(lambda a: jnp.asarray(a * a), p))
    tst = TO.OptState(torch.tensor(7, dtype=torch.int32),
                      {k: torch.from_numpy(a * 2) for k, a in p.items()},
                      {k: torch.from_numpy(a * a) for k, a in p.items()})
    for pkg, st in (("jax", jst), ("torch", tst)):
        (JC if pkg == "jax" else TC).save(str(tmp_path / pkg), 4, {"opt_state": st})
    man = [json.load(open(tmp_path / d / "step_4" / "manifest.json")) for d in ("jax", "torch")]
    assert man[0] == man[1]
    d = str(tmp_path / writer)
    _, tgot = TC.restore(d, {"opt_state": TO.init({k: torch.zeros(a.shape) for k, a in
                                                   p.items()}, TO.OptConfig())})
    assert isinstance(tgot["opt_state"], TO.OptState)
    _, jgot = JC.restore(d, {"opt_state": JO.init(jax.tree_util.tree_map(jnp.asarray, p),
                                                  JO.OptConfig())})
    assert isinstance(jgot["opt_state"], JO.OptState)
    t_st = tgot["opt_state"]
    for t, j, want in zip([t_st.step] + TO.tree_leaves(t_st.mu) + TO.tree_leaves(t_st.nu),
                          jax.tree_util.tree_leaves(jgot["opt_state"]),
                          jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(want))
        np.testing.assert_array_equal(np.asarray(j), np.asarray(want))
