"""The port's sharding rules, meshes, sharded train step and elastic
re-mesh against the JAX package on the CPU.

* ``param_spec`` / ``param_specs`` equal the reference's on every leaf of
  all ten configs at full shapes (the reference on ``jax.eval_shape``
  structs, the port on ``meta`` tensors), in modes 2d/tp/dp, at axis sizes
  16x16, 2x16x16, 4x2 and 2x2; ``batch_specs_for`` and ``cache_specs_for``
  likewise (the reference reads only ``axis_names``, ``shape`` and
  ``devices.shape`` of a mesh, so a stand-in object serves).
* Four ranks (subprocesses over gloo, meeting through a ``FileStore``
  under the test's ``tmp_path``) on a 2x2 (data, model) mesh: a spec with
  a tuple entry shards one dim over both mesh axes in mesh order; the
  sharded Yi-6B smoke train step's loss is within the reference test's
  1e-3 of the JAX package's single-device ``loss_fn`` and within 1e-5 of
  the port's unsharded one (f32), its gradients and updated params within
  1e-5 of the unsharded step's (partial sums reduced in another order);
  a checkpoint saved under a 4x1 mesh restores under 2x2 with equal
  values and the asked placements, and the JAX package's ``restore``
  reads it.
"""

import functools
import os
import pathlib
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as JC
from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import model as JM
from repro.parallel import sharding as JS
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import init_cache, init_params, loss_fn
from repro_torch.parallel import sharding as S
from repro_torch.training import optimizer as O
from repro_torch.tree import tree_leaves, tree_paths, tree_unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "4x2": (("data", "model"), (4, 2)),
          "2x2": (("data", "model"), (2, 2))}

# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

_HEADER = """
import os, sys
import torch
import torch.distributed as dist
RANK, WORLD, OUT = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), os.environ["OUT"]
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], WORLD),
                        rank=RANK, world_size=WORLD)
"""


def run_ranks(body: str, world: int, out: pathlib.Path, timeout: float = 120.0) -> list:
    """``body`` run by ``world`` ranks, each a ``sys.executable -c``
    subprocess over gloo, meeting through a ``FileStore`` in ``out``
    (never a fixed port: several test workers run at once). Fails unless
    every rank exits 0 within ``timeout`` seconds; returns their stdouts."""
    script = _HEADER + textwrap.dedent(body) + "\ndist.destroy_process_group()\n"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE=str(world),
               STORE=str(out / "store"), OUT=str(out), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=ROOT, text=True,
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(world)]
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, results)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{o[-2000:]}\n{e[-4000:]}"
    return [o for o, _ in results]


# ---------------------------------------------------------------------------
# specs at full shapes, all ten configs
# ---------------------------------------------------------------------------


def _jax_mesh(name):
    axes, shape = MESHES[name]
    return SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)),
                           devices=SimpleNamespace(shape=shape))


def _port_mesh(name):
    return dict(zip(*MESHES[name]))


@functools.lru_cache(maxsize=None)
def _structs(arch):
    """(the reference's param structs, the port's meta params) at full shapes."""
    jp = jax.eval_shape(lambda k: jax_init_params(jax_config(arch), k),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    return jp, init_params(get_config(arch), torch.Generator(), "meta")


def _jax_leaves(specs):
    return jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _same(port_specs, jax_specs):
    got = [tuple(s) for s in tree_leaves(port_specs)]
    want = [tuple(s) for s in _jax_leaves(jax_specs)]
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    jp, tp = _structs(arch)
    jpaths = [JS._path_str(p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in tree_paths(tp)] == jpaths
    for (path, x), (_, j) in zip(tree_paths(tp), jax.tree_util.tree_flatten_with_path(jp)[0]):
        assert tuple(x.shape) == tuple(j.shape), path
        assert tuple(S.param_spec(path, x.shape, _port_mesh(mesh))) == tuple(
            JS.param_spec(path, j.shape, dict(zip(*MESHES[mesh]))))
    for mode in ("2d", "tp", "dp"):
        _same(S.param_specs(tp, _port_mesh(mesh), mode),
              JS.param_specs(jp, _jax_mesh(mesh), mode))
    _same(S.param_specs(tp), JS.param_specs(jp))  # the reference's default sizes


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_the_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    for B, T in ((128, 32768), (1, 4096), (32, 64)):
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, T))
        tcache = init_cache(cfg, B, T, "meta")
        jbatch = {"tokens": jax.ShapeDtypeStruct((B, T + 1), jnp.int32),
                  "extra_embeds": jax.ShapeDtypeStruct((B, 5, cfg.d_model), jnp.float32),
                  "pos": jax.ShapeDtypeStruct((B,), jnp.int32)}
        tbatch = {"tokens": torch.empty((B, T + 1), device="meta"),
                  "extra_embeds": torch.empty((B, 5, cfg.d_model), device="meta"),
                  "pos": torch.empty((B,), device="meta")}
        for mesh in MESHES:
            _same(S.cache_specs_for(_port_mesh(mesh), tcache, B),
                  JS.cache_specs_for(_jax_mesh(mesh), jcache, B))
            _same(S.batch_specs_for(_port_mesh(mesh), tbatch),
                  JS.batch_specs_for(_jax_mesh(mesh), jbatch))
            assert S.batch_axes(_port_mesh(mesh)) == JS.batch_axes(_jax_mesh(mesh))


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert S.placements(S.P(None, "data", "model"), mesh) == (Replicate(), Shard(1), Shard(2))
    assert S.placements(S.P("model", "data"), mesh) == (Replicate(), Shard(1), Shard(0))
    # a tuple entry shards one tensor dim over several mesh dims
    assert S.placements(S.P(("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    assert S.placements(S.P(), mesh) == (Replicate(),) * 3
    assert S.P("data", None) == ("data", None) and S.P() == ()


# ---------------------------------------------------------------------------
# four ranks: the sharded step and the re-mesh
# ---------------------------------------------------------------------------

_RANKS = """
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch import tree as T
from repro_torch.checkpoint import checkpointer as C
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import loss_fn
from repro_torch.parallel import sharding as S
from repro_torch.training import optimizer as O
from repro_torch.training.train_loop import make_train_step

mesh = make_debug_mesh(2, 2, device_type="cpu")
res = {}

# a tuple entry: rows over (data, model) in mesh order
x = torch.arange(16.0).reshape(8, 2)
res["tuple_local"] = distribute_tensor(
    x, mesh, S.placements(S.P(("data", "model"), None), mesh)).to_local()

# the sharded train step on Yi-6B smoke
cfg = get_config("yi_6b", smoke=True)
params = S.param_shardings(torch.load(os.path.join(OUT, "params.pt")), mesh)
tokens = torch.load(os.path.join(OUT, "tokens.pt"))
batch = S.distribute({"tokens": tokens}, S.batch_specs_for(mesh, {"tokens": tokens}), mesh)
res["local_shapes"] = {p: tuple(v.to_local().shape) for p, v in T.tree_paths(params)}
live = [p.detach().requires_grad_(True) for p in T.tree_leaves(params)]
with implicit_replication():
    loss, _ = loss_fn(T.tree_unflatten(params, iter(live)), batch, cfg)
    grads = torch.autograd.grad(loss, live)
res["loss"] = loss.detach().full_tensor()
res["grads"] = [g.full_tensor() for g in grads]
opt_cfg = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
step = make_train_step(cfg, opt_cfg, mesh)
new, opt_state, metrics = step(params, O.init(params, opt_cfg), batch)
res["step_loss"] = metrics["loss"].full_tensor()
res["new_params"] = [p.full_tensor() for p in T.tree_leaves(new)]

# elastic re-mesh: save under 4x1, restore under 2x2
mesh_a = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
w = torch.arange(64.0).reshape(8, 8)
b = (torch.arange(32.0).reshape(4, 8) / 7).to(torch.bfloat16)
state = {"w": distribute_tensor(w, mesh_a, S.placements(S.P("data", "model"), mesh_a)),
         "b": distribute_tensor(b, mesh_a, (Shard(0), Replicate()))}
ck = os.path.join(OUT, "ck")
C.save(ck, 3, state)
step_no, back = C.restore(ck, state, shardings={"w": S.P("data", "model"),
                                                "b": (mesh, (Replicate(), Shard(1)))},
                          mesh=mesh)
res["remesh"] = {k: (v.device_mesh.shape, tuple(v.placements), v.full_tensor(),
                     tuple(v.to_local().shape)) for k, v in back.items()}
res["remesh_step"] = step_no
torch.save(res, os.path.join(OUT, f"rank{RANK}.pt"))
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("ranks")
    jcfg = jax_config("yi_6b", smoke=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (8, 17), dtype=np.int32)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               dtype=torch.float32, device="cpu")
    torch.save(params, out / "params.pt")
    torch.save(torch.from_numpy(tokens), out / "tokens.pt")
    run_ranks(_RANKS, 4, out)
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(4)]
    return SimpleNamespace(out=out, ranks=ranks, jcfg=jcfg, jparams=jparams,
                           params=params, tokens=tokens)


def test_tuple_entry_shards_over_both_axes_in_mesh_order(four_ranks):
    x = torch.arange(16.0).reshape(8, 2)
    for r, res in enumerate(four_ranks.ranks):
        assert torch.equal(res["tuple_local"], x[2 * r:2 * r + 2])


def test_params_are_sharded_2d(four_ranks):
    shapes = four_ranks.ranks[0]["local_shapes"]
    assert shapes["embed"] == (256, 32)           # [512, 64] under P("model", "data")
    assert shapes["blocks/0/attn/wq"] == (2, 32, 32)  # [2, 64, 64] under P(None, "data", "model")
    assert shapes["blocks/0/mlp/wd"] == (2, 64, 32)   # [2, 128, 64] under P(None, "model", "data")


def test_sharded_step_loss_matches_jax_single_device(four_ranks):
    f = four_ranks
    loss_ref = JM.loss_fn(f.jparams, {"tokens": jnp.asarray(f.tokens)}, f.jcfg)[0]
    for res in f.ranks:
        assert abs(float(res["loss"]) - float(loss_ref)) < 1e-3
        assert float(res["step_loss"]) == float(res["loss"])


def test_sharded_loss_and_grads_match_unsharded(four_ranks):
    f = four_ranks
    cfg = get_config("yi_6b", smoke=True)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(f.params)]
    loss, _ = loss_fn(tree_unflatten(f.params, iter(leaves)),
                      {"tokens": torch.from_numpy(f.tokens)}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    jloss, jgrads = jax.value_and_grad(lambda p: jax_loss_fn(
        p, {"tokens": jnp.asarray(f.tokens)}, f.jcfg)[0])(f.jparams)
    for res in f.ranks:
        torch.testing.assert_close(res["loss"], loss.detach(), atol=TOL, rtol=TOL)
        for g, want, j in zip(res["grads"], grads, jax.tree_util.tree_leaves(jgrads),
                              strict=True):
            torch.testing.assert_close(g, want, atol=TOL, rtol=TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=TOL, rtol=TOL)


def test_sharded_step_updates_match_unsharded(four_ranks):
    from repro_torch.training.train_loop import make_train_step

    f = four_ranks
    cfg = get_config("yi_6b", smoke=True)
    opt_cfg = O.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    params = torch.load(f.out / "params.pt")
    new, _, _ = make_train_step(cfg, opt_cfg)(params, O.init(params, opt_cfg),
                                              {"tokens": torch.from_numpy(f.tokens)})
    for res in f.ranks:
        for got, want in zip(res["new_params"], tree_leaves(new), strict=True):
            torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)


def test_checkpoint_remeshes_from_4x1_to_2x2(four_ranks):
    from torch.distributed.tensor import Replicate, Shard

    f = four_ranks
    w = torch.arange(64.0).reshape(8, 8)
    b = (torch.arange(32.0).reshape(4, 8) / 7).to(torch.bfloat16)
    for res in f.ranks:
        assert res["remesh_step"] == 3
        mesh_w, pl_w, full_w, local_w = res["remesh"]["w"]
        assert mesh_w == (2, 2) and pl_w == (Shard(0), Shard(1)) and local_w == (4, 4)
        assert torch.equal(full_w, w)
        mesh_b, pl_b, full_b, local_b = res["remesh"]["b"]
        assert pl_b == (Replicate(), Shard(1)) and local_b == (4, 4)
        assert torch.equal(full_b, b)
    # the JAX package reads the file the sharded save wrote
    step, state = JC.restore(str(f.out / "ck"), {"b": np.zeros((4, 8)), "w": np.zeros((8, 8))})
    assert step == 3
    np.testing.assert_array_equal(np.asarray(state["w"]), w.numpy())
    raw = np.asarray(state["b"]).view(np.int16)  # JAX's bfloat16 words
    assert torch.equal(torch.from_numpy(raw).view(torch.bfloat16), b)


_NORM = """
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from repro_torch.training import optimizer as O
O.SLICE = 1000  # leaves of 2,368 elements: three slices each
mesh = init_device_mesh("cpu", (WORLD, 1), mesh_dim_names=("data", "model"))
g = torch.Generator().manual_seed(0)
worst = 0.0
for trial in range(40):
    leaves = [torch.randn(37, 64, generator=g) * 10 ** torch.randn(1, generator=g).item()
              for _ in range(3)]
    plain = O.global_norm(leaves)
    sharded = [distribute_tensor(leaves[0], mesh, [Shard(0), Replicate()]),
               distribute_tensor(leaves[1], mesh, [Replicate(), Shard(1)]),
               # a partial leaf: rank r holds (r + 1) / sum(1..WORLD) of it
               DTensor.from_local(leaves[2] * (RANK + 1) / (WORLD * (WORLD + 1) / 2), mesh,
                                  [Partial(), Replicate()])]
    got = O.global_norm(sharded).full_tensor()
    if WORLD == 1:
        assert torch.equal(got, plain), (trial, got, plain)
    worst = max(worst, float((got - plain).abs() / plain))
print("WORST", worst)
"""


@pytest.mark.parametrize("world", [1, 2])
def test_global_norm_of_sharded_leaves(world, tmp_path):
    """``optimizer.global_norm`` over DTensor leaves (sharded on dim 0, on
    dim 1, and a partial leaf) on a ``world`` x 1 gloo mesh, each leaf of
    several slices: on one rank the plain leaves' norm bit for bit (so the
    sharded step on one rank matches the plain step, as ``chip_smoke.py``
    phase 10 (b) holds it on the card), on two within 1e-6 (the shards'
    sums added in another order)."""
    outs = run_ranks(_NORM, world, tmp_path)
    for out in outs:
        worst = float(out.split("WORST")[-1])
        assert worst <= (0.0 if world == 1 else 1e-6), worst
