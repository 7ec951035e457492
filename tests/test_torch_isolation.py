"""The torch port stands alone: it imports neither JAX nor the JAX package
``repro``, at run time or in its sources (``chip_smoke.py`` and the
port's examples, ``examples/torch_*.py``, included) — the serving
fabric's wire transport workers (``python -m repro_torch.net``)
included."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("torch_*.py")))
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)

_PROBE = r"""
import importlib, pkgutil, sys
import torch
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
        if not m.name.endswith(".__main__")]  # a -m entry point runs on import
for name in mods:
    importlib.import_module(name)
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serving.engine import Engine
cfg = get_config("yi_6b", smoke=True)
params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
eng = Engine(cfg, params, max_batch=2, page_size=8, num_pages=16, window=2,
             max_seq=32, device_admission=True, device="cpu")
uid = eng.submit([1, 2, 3], max_new_tokens=2)
eng.step()  # prefill + one decode step completes the request
assert len(eng.completed[uid].output) == 2
from repro_torch.data.pipeline import synth_batch
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import Trainer
tr = Trainer(cfg, OptConfig(warmup_steps=1, total_steps=2), device="cpu")
tr.fit(iter([synth_batch(0, 0, 2, 8, cfg.vocab_size)]), 1)  # one train step
assert tr.step == 1 and tr.history[0] > 0
assert {"repro_torch.training.train_loop", "repro_torch.data.pipeline"} <= set(mods)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(mods), bad)
assert not bad, bad
"""


_WIRE_PROBE = r"""
from repro_torch.fabric import ClassSpec, Fabric, FabricConfig
cfg = FabricConfig(classes=(ClassSpec("default"),), arch="yi_6b", smoke=True,
                   replicas=2, hosts=2, transport="wire", max_batch=2, page_size=8,
                   num_pages=16, max_seq=32, kv_window=2, device_admission=True)
fab = Fabric.open(cfg, device="cpu")
uids = fab.submit_many([[1, 2, 3], [4, 5], [6, 7, 8, 9]], max_new_tokens=3)
done = fab.drain(max_steps=200)
assert set(uids) <= set(done), (uids, list(done))
assert fab.stats_view().transport["kind"] == "wire"
fab.close()
"""


def test_wire_fabric_and_its_workers_load_no_jax():
    """A port Fabric over the wire transport on the CPU: the parent and
    both ``python -m repro_torch.net`` host workers (they inherit the
    environment, so -X importtime lists every module each one imports on
    the shared stderr) load neither jax, jaxlib nor repro."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               PYTHONPROFILEIMPORTTIME="1")
    proc = subprocess.run([sys.executable, "-c", _WIRE_PROBE], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    mods = [line.rsplit("|", 1)[1].strip() for line in proc.stderr.splitlines()
            if line.startswith("import time:") and "|" in line]
    # the package is imported once a process: the parent and two workers
    assert sum(m == "repro_torch.net" for m in mods) == 3, "workers not seen"
    bad = sorted({m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")})
    assert not bad, bad


def test_port_runs_without_jax_or_reference_package():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                          text=True, env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    n_mods = int(proc.stdout.split()[0])
    assert n_mods >= 20, proc.stdout


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_or_reference(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: imports {hits}"


def test_fake_process_group_import_is_confined_to_launch_mesh():
    """torch's fake backend lives in an internal testing module: only
    ``launch/mesh.py`` imports it (for the dry run's 256/512-rank world)."""
    users = sorted(str(p.relative_to(ROOT)) for p in PORT_FILES if "fake_pg" in p.read_text())
    assert users == ["src/repro_torch/launch/mesh.py"], users
