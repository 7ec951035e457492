"""The port's serve driver (``python -m repro_torch.launch.serve``) against
the JAX package's: the same ``--dry-run`` JSON and the same flag errors for
the same flags, one workload through both drivers' ``run_workload`` with
the same weights (carried over by repro_torch.bridge) giving the same
tokens and per-class completion order, and ``--device cpu
--verify-single-host`` passing over the sim and wire transports, with
tenants and with autoscale."""

import argparse
import sys

import jax
import numpy as np
import pytest
import torch

import repro.launch.serve as jserve
import repro_torch.launch.serve as tserve
from repro.configs import get_config as jax_config
from repro.fabric import Fabric as JFabric
from repro.fabric import FabricConfigError as JError
from repro.models import init_params as jax_init_params
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.fabric import Fabric as TFabric
from repro_torch.fabric import FabricConfigError as TError

DRY_RUNS = [
    [],
    ["--multitenant", "--policy", "wfq", "--replicas", "2", "--hosts", "2",
     "--device-admission"],
    ["--tenants", "200", "--tenant-quota", "8", "--replicas", "2", "--hosts", "2"],
    ["--replicas", "1", "--max-replicas", "4", "--autoscale", "dry-run"],
    ["--device-admission", "auto", "--checkpoint-dir", "ck", "--checkpoint-every", "4",
     "--page-size", "128", "--max-batch", "1100"],
    ["--trace", "--metrics-out", "m.txt", "--transport", "wire", "--hosts", "2",
     "--replicas", "2", "--credit", "2", "--transport-rtt-ms", "1.5"],
]


def _main(mod, argv, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    code = None
    try:
        mod.main() if mod is jserve else mod.main(argv)
    except SystemExit as e:
        code = e.code
    out = capsys.readouterr()
    return code, out.out, out.err


@pytest.mark.parametrize("flags", DRY_RUNS, ids=lambda f: " ".join(f) or "defaults")
def test_dry_run_json_matches_jax_driver(flags, monkeypatch, capsys):
    argv = ["--arch", "glm4-9b", "--smoke", "--dry-run"] + flags
    want = _main(jserve, argv, monkeypatch, capsys)
    got = _main(tserve, argv + ["--device", "cpu"], monkeypatch, capsys)
    assert want[0] is None and want[1].startswith("{")
    assert got == want


@pytest.mark.parametrize("flags", [
    ["--verify-single-host"],                      # needs --hosts >= 2
    ["--autoscale", "sometimes"],
    ["--policy", "wfq"],                           # a cross-class policy, one class
    ["--checkpoint-every", "8"],                   # nowhere to write
    ["--checkpoint-dir", "d", "--ckpt-dir", "d"],  # must differ
    ["--tenants", "10", "--multitenant"],
    ["--hosts", "3", "--replicas", "2"],
    ["--transport", "carrier"],
], ids=lambda f: " ".join(f))
def test_serve_flag_combinations_fail_actionably(flags, monkeypatch, capsys):
    """The JAX driver's flag errors (tests/test_fabric.py's
    test_serve_flag_combinations_fail_actionably, and the driver's own
    checks) come out of the port's driver word for word (the usage text
    above them also lists --device)."""
    argv = ["--arch", "glm4-9b", "--smoke"] + flags
    want = _main(jserve, argv, monkeypatch, capsys)
    got = _main(tserve, argv, monkeypatch, capsys)
    assert want[0] == 2 and want[2].startswith("usage: serve")
    error = lambda err: err[err.index("serve: error:"):]
    assert (got[0], got[1], error(got[2])) == (want[0], want[1], error(want[2]))


def test_config_from_args_errors_match():
    def ns(**kw):
        base = dict(arch="glm4-9b", smoke=True, max_batch=4, page_size=16,
                    num_pages=128, window=4, ckpt_dir=None, multitenant=False,
                    policy="strict", replicas=1, checkpoint_dir=None,
                    checkpoint_every=None)
        base.update(kw)
        return argparse.Namespace(**base)

    for kw in (dict(policy="wfq"), dict(checkpoint_dir="/tmp/d", ckpt_dir="/tmp/d"),
               dict(checkpoint_every=8)):
        with pytest.raises(JError) as want:
            jserve.config_from_args(ns(**kw))
        with pytest.raises(TError) as got:
            tserve.config_from_args(ns(**kw))
        assert str(got.value) == str(want.value)
    cfg = tserve.config_from_args(ns(checkpoint_dir="/tmp/d"))
    assert cfg.to_json() == jserve.config_from_args(ns(checkpoint_dir="/tmp/d")).to_json()


def test_run_workload_matches_jax_driver():
    """One multitenant workload over 2 replicas and 2 simulated hosts with
    device admission through both drivers' run_workload, the same weights:
    the same admitted uids, tokens and per-class completion order."""
    argv = ["--arch", "glm4-9b", "--smoke", "--multitenant", "--policy", "wfq",
            "--replicas", "2", "--hosts", "2", "--device-admission", "--requests", "9",
            "--max-new", "5"]
    jcfg = jax_config("glm4-9b", smoke=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    runs = {}
    for mod, Fabric, params, extra in (
            (jserve, JFabric, jparams, {}),
            (tserve, TFabric, tparams, {"device": "cpu"})):
        args = mod.build_parser().parse_args(argv)
        fab = Fabric.open(mod.config_from_args(args), params=params, **extra)
        uids, tenant_of, done, order = mod.run_workload(fab, args)
        runs[mod.__name__] = (uids, tenant_of, {u: done[u].output for u in uids}, order)
        fab.close()
    assert runs["repro_torch.launch.serve"] == runs["repro.launch.serve"]


@pytest.mark.parametrize("flags", [
    ["--multitenant", "--policy", "wfq", "--device-admission"],
    ["--transport", "wire", "--multitenant"],
    ["--tenants", "60"],
    ["--autoscale", "--max-replicas", "4", "--requests", "12"],
], ids=["sim", "wire", "tenants", "autoscale"])
def test_verify_single_host_on_cpu(flags, monkeypatch, capsys):
    argv = ["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--replicas", "2",
            "--hosts", "2", "--requests", "9", "--max-new", "4",
            "--verify-single-host"] + flags
    code, out, err = _main(tserve, argv, monkeypatch, capsys)
    assert code is None, err
    assert "verify-single-host PASS" in out
    transport = "wire" if "wire" in flags else "sim"
    assert f"transport={transport}" in out
