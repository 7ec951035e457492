"""Helpers of the ``test_torch_example_*`` files, which hold each of the
port's examples (``examples/torch_*.py``, run with ``--device cpu``)
against the reference example of the same name on the same weights: the
port's ``Fabric`` and ``Trainer`` take the JAX package's
``init_params(PRNGKey(seed))`` through ``bridge.params_from_numpy``, and
each ``Fabric.drain`` is recorded in both packages."""

import dataclasses
import importlib.util
import pathlib
import re
import sys

import jax
import numpy as np
import torch

import repro.fabric as jfabric
import repro_torch.fabric.session as tsession
from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro_torch.bridge import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_weights(jcfg, seed: int, device="cpu"):
    """The JAX package's ``init_params(jcfg, PRNGKey(seed))`` as port params."""
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             dtype=torch.float32, device=device)


def serve_with_jax_weights(monkeypatch) -> dict:
    """The port's ``Fabric`` made from the JAX package's weights (what the
    reference ``Fabric`` makes of the same config), and every drain of
    either package recorded: {"jax": [...], "torch": [...]}, each a list
    of (uid, qclass, output) in completion order, one a drain."""
    real = tsession.Fabric._model_state

    def model_state(config, model_cfg, params, device):
        if params is None:
            params = jax_weights(jax_config(config.arch, smoke=config.smoke),
                                  config.param_seed, device)
        return real(config, model_cfg, params, device)

    monkeypatch.setattr(tsession.Fabric, "_model_state", staticmethod(model_state))
    drains = {"jax": [], "torch": []}
    for pkg, cls in (("jax", jfabric.Fabric), ("torch", tsession.Fabric)):
        def recorded(self, *a, _real=cls.drain, _log=drains[pkg], **kw):
            done = _real(self, *a, **kw)
            _log.append([(u, r.qclass, list(r.output)) for u, r in done.items()])
            return done

        monkeypatch.setattr(cls, "drain", recorded)
    return drains


def by_class(drain) -> dict:
    """{qclass: [uid, ...]} in completion order, and {uid: output}."""
    order = {}
    for uid, qclass, _ in drain:
        order.setdefault(qclass, []).append(uid)
    return order, {uid: out for uid, _, out in drain}


_TIMES = [re.compile(p) for p in (r"wall=\S+", r"admit_p99_ms=[0-9.e+-]+",
                                  r"headroom_ms=[0-9.e+-]+")]


def printed(capsys, run) -> str:
    """What ``run()`` prints, its wall and latency readings blanked."""
    capsys.readouterr()
    run()
    out = capsys.readouterr().out
    for pat in _TIMES:
        out = pat.sub("", out)
    return out


def run_reference(mod, argv, monkeypatch):
    """The reference example's ``main()`` on ``argv`` (it reads sys.argv)."""
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    return mod.main()


def jax_twin(cfg, cls):
    """The JAX package's dataclass ``cls`` with the fields of the port's
    ``cfg`` (the configs and ``OptConfig`` are field-for-field copies)."""
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
