"""The port's replica group and fabric session against the JAX package's,
scenario for scenario (tests/test_serving.py's replica-group test and
tests/test_fabric.py's serving tests: a crash restored from a cadence
checkpoint, resize under load, host loss over simulated hosts, snapshot and
restore with device admission). Each scenario runs through both packages
on the yi_6b smoke config (float32, the JAX weights carried over by
repro_torch.bridge, the port on the CPU) and must give the same admitted
set, token-identical outputs and the same per-class completion order. A
snapshot taken in either package restores in the other."""

import json

import jax
import numpy as np
import pytest
import torch

import repro.fabric as jfabric
import repro_torch.fabric as tfabric
from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.sched import QueueClass as JQueueClass
from repro.serving.engine import EngineReplicaGroup as JGroup
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.sched import QueueClass as TQueueClass
from repro_torch.serving.engine import EngineReplicaGroup as TGroup


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("yi_6b", smoke=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return {"jax": (jfabric, jcfg, jparams), "torch": (tfabric, get_config("yi_6b", smoke=True),
                                                       tparams)}


def _config(fab_mod, **kw):
    base = dict(classes=(fab_mod.ClassSpec("hi", priority=1, weight=4.0),
                         fab_mod.ClassSpec("lo", priority=0, weight=1.0)),
                shards_per_class=2, replicas=1, max_replicas=2,
                arch="yi_6b", max_batch=4, page_size=8, num_pages=32,
                kv_window=2, max_seq=64, queue_window=64)
    base.update(kw)
    return fab_mod.FabricConfig(**base)


def _open(models, pkg, **kw):
    fab_mod, mcfg, params = models[pkg]
    extra = {"device": "cpu"} if pkg == "torch" else {}
    return fab_mod.Fabric.open(_config(fab_mod, **kw), params=params, model_cfg=mcfg,
                               **extra)


def _restore_kw(models, pkg):
    _, mcfg, params = models[pkg]
    return dict(params=params, model_cfg=mcfg, **({"device": "cpu"} if pkg == "torch" else {}))


def _drive(fab, max_steps=300):
    """Step to idle; the per-class completion order of this drive."""
    order = {}
    for _ in range(max_steps):
        for r in fab.step():
            order.setdefault(r.qclass, []).append(r.uid)
        if fab.idle():
            break
    return order


def _outputs(done):
    return {u: list(r.output) for u, r in done.items()}


def _same(runs):
    assert runs["torch"] == runs["jax"]


def test_replica_group_serves_and_recovers_as_jax(models):
    """tests/test_serving.py::test_engine_replica_group_serves_and_recovers
    through both packages: the first wave, then a mid-wave exact-seat
    snapshot restored into a fresh group."""
    runs = {}
    for pkg, Group, QC in (("jax", JGroup, JQueueClass), ("torch", TGroup, TQueueClass)):
        _, cfg, params = models[pkg]
        extra = {"device": "cpu"} if pkg == "torch" else {}
        classes = lambda: [QC("hi", priority=1, weight=4.0, num_shards=2, window=64,
                              reclaim_period=32),
                           QC("lo", priority=0, weight=1.0, num_shards=2, window=64,
                              reclaim_period=32)]
        geo = dict(max_batch=4, page_size=8, num_pages=32, max_seq=64)
        grp = Group(cfg, params, num_replicas=2, window=2, classes=classes(), **geo, **extra)
        uids = [grp.submit([i + 1, 2, 3], max_new_tokens=3, qclass="hi") for i in range(3)]
        uids += grp.submit_many([[9, 9 + i] for i in range(3)], max_new_tokens=3,
                                qclass="lo")
        order = _drive(grp, 200)
        assert [e.max_batch for e in grp.engines] == [2, 2]
        grp2 = Group(cfg, params, num_replicas=2, window=2, classes=classes(),
                     forward_fn=grp._fwd, **geo, **extra)
        wave = []
        for i in range(4):
            wave.append(grp2.submit([5 + i, 1], max_new_tokens=3, qclass="hi"))
            wave.append(grp2.submit([7 + i, 2], max_new_tokens=3, qclass="lo"))
        grp2.step()
        grp2.step()
        state = json.loads(json.dumps(grp2.sched_state()))
        before = _outputs(grp2.completed)
        grp3 = Group.from_sched_state(cfg, params, state, forward_fn=grp._fwd, **geo,
                                      **extra)
        order3 = _drive(grp3, 300)
        after = _outputs(grp3.completed)
        assert not set(before) & set(after) and set(before) | set(after) >= set(wave)
        runs[pkg] = (uids, _outputs(grp.completed), order, wave, before, after, order3,
                     state)
    _same(runs)


@pytest.mark.parametrize("device_admission", [False, True])
def test_fabric_killed_midrun_restores_from_cadence_as_jax(models, tmp_path,
                                                          device_admission):
    """A serving fabric killed after its cadence checkpoint restores with
    every tenant at its exact seat, in both packages alike."""
    runs = {}
    for pkg in ("jax", "torch"):
        ck = str(tmp_path / pkg)
        fab = _open(models, pkg, replicas=2, checkpoint_dir=ck, checkpoint_every_n_steps=2,
                    device_admission=device_admission)
        uids = [fab.submit([i + 1, 2, 3], max_new_tokens=3, qclass="hi") for i in range(4)]
        uids += fab.submit_many([[9, 9 + i] for i in range(4)], max_new_tokens=3,
                                qclass="lo")
        fab.step()
        fab.step()  # cadence fires
        fab.flush_checkpoints()
        before = _outputs(fab.completed)
        del fab  # crash
        mod = models[pkg][0]
        fab2 = mod.Fabric.restore(ck, **_restore_kw(models, pkg))
        assert fab2.step_count == 2 and fab2.num_replicas == 2
        order = _drive(fab2)
        after = _outputs(fab2.completed)
        assert not set(before) & set(after)
        assert set(before) | set(after) >= set(uids)
        runs[pkg] = (uids, before, after, order)
        fab2.close()
    _same(runs)


@pytest.mark.parametrize("device_admission", [False, True])
def test_fabric_resize_under_load_as_jax(models, device_admission):
    runs = {}
    for pkg in ("jax", "torch"):
        fab = _open(models, pkg, device_admission=device_admission)
        uids = fab.submit_many([[i + 1, 2] for i in range(8)], max_new_tokens=3,
                               qclass="hi")
        uids += fab.submit_many([[i + 3, 5] for i in range(3)], max_new_tokens=2,
                                qclass="lo")
        order = _drive(fab, 1)
        fab.resize(2)
        assert [e.max_batch for e in fab.engines] == [2, 2]
        assert sum(e.pool.num_pages for e in fab.engines) == 32
        for name, us in _drive(fab).items():
            order.setdefault(name, []).extend(us)
        done = _outputs(fab.completed)
        assert set(done) >= set(uids)
        runs[pkg] = (uids, done, order)
        fab.close()
    _same(runs)


@pytest.mark.parametrize("device_admission", [False, True])
def test_fabric_multihost_host_loss_as_jax(models, device_admission):
    runs = {}
    for pkg in ("jax", "torch"):
        fab = _open(models, pkg, replicas=2, transport="sim", hosts=2,
                    device_admission=device_admission)
        uids = fab.submit_many([[i + 1, 2] for i in range(8)], max_new_tokens=3,
                               qclass="hi")
        order = _drive(fab, 1)
        moved = fab.fail_host(1)
        assert moved > 0 and not fab.replicas[1].alive
        for name, us in _drive(fab).items():
            order.setdefault(name, []).extend(us)
        done = _outputs(fab.completed)
        assert set(done) >= set(uids)
        assert fab.stats_view().transport["dead_hosts"] == [1]
        runs[pkg] = (uids, moved, done, order)
        fab.close()
    _same(runs)


def test_snapshot_restores_across_packages(models):
    """A mid-wave snapshot (device admission on) taken in either package
    restores in either: all four futures serve the same outstanding
    requests with the same tokens in the same per-class order, the same as
    the snapshotting fabric's own future."""
    snaps, own = {}, {}
    for pkg in ("jax", "torch"):
        fab = _open(models, pkg, device_admission=True)
        fab.submit_many([[i + 1, 3] for i in range(6)], max_new_tokens=3, qclass="lo")
        fab.submit_many([[i + 2, 4] for i in range(3)], max_new_tokens=2, qclass="hi")
        fab.step()
        snaps[pkg] = json.loads(json.dumps(fab.snapshot()))
        before = set(fab.completed)
        order = _drive(fab)
        own[pkg] = (order, {u: o for u, o in _outputs(fab.completed).items()
                            if u not in before})
        fab.close()
    assert snaps["jax"] == snaps["torch"]
    for src in ("jax", "torch"):
        for dst in ("jax", "torch"):
            mod = models[dst][0]
            fab = mod.Fabric.from_snapshot(snaps[src], **_restore_kw(models, dst))
            order = _drive(fab)
            assert (order, _outputs(fab.completed)) == own[src], (src, dst)
            fab.close()
