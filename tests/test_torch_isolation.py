"""The torch port stands alone: it imports neither JAX nor the JAX package
``repro``, at run time or in its sources."""

import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)

_PROBE = r"""
import importlib, pkgutil, sys
import torch
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(mods), bad)
assert not bad, bad
"""


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
