"""The port's dry run held to the JAX package's, cell by cell: both
packages' ``launch/dryrun.py`` ``run_cell`` on every arch's smoke config
at ``train_4k`` over a 2x4 (data, model) mesh, and xLSTM's over 2x8 as
well, where its 4 heads do not divide 'model' and its time loops split
the batch rows instead. The reference runs on 8 or 16 host devices of
XLA's CPU backend, the port on torch's fake backend (meta tensors), each
in processes of its own, side by side.

``model_flops_global`` (6 x active params x tokens) and the loop trip
counts are equal in every cell. The per-chip counts are estimates made by
different means (XLA's fused cost analysis against the port's unfused aten
ops), so the test prints their ratios, port / reference, beside the torch
version (run pytest with ``-s`` to read them) and holds none of them.
"""

import json
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from repro_torch.configs import ARCHS

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ("flops_per_chip", "bytes_per_chip", "wire_bytes_per_chip")
CELLS = [(a, "2x4") for a in ARCHS] + [("xlstm_125m", "2x8")]

_PORT = """
import json, sys
from repro_torch.launch import dryrun as D
mesh = D._debug_mesh(sys.argv[1])
out = {}
for arch in sys.argv[2].split(","):
    out[arch] = D.run_cell(arch, "train_4k", mesh=mesh, smoke=True, verbose=False)
print("RESULT" + json.dumps(out))
"""

_REF = """
import json, math, os, sys
from repro.launch import dryrun as JD
# the reference's module asks XLA for 512 host devices; this run needs the mesh's
shape = tuple(int(n) for n in sys.argv[1].split("x"))
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={math.prod(shape)}"
import jax
import numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
JD.get_config = lambda arch: get_config(arch, smoke=True)
mesh = Mesh(np.array(jax.devices()).reshape(shape), ("data", "model"))
out = {}
for arch in sys.argv[2].split(","):
    out[arch] = JD.run_cell(arch, "train_4k", mesh=mesh, verbose=False)
print("RESULT" + json.dumps(out))
"""


def _run(code, mesh, archs):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code, mesh, ",".join(archs)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=400)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.split("RESULT", 1)[1])


@pytest.fixture(scope="module")
def rows():
    """{(arch, mesh): (the port's row, the reference's row)}."""
    half = len(ARCHS) // 2
    jobs = {("port", "2x4", 0): (_PORT, "2x4", ARCHS),
            ("port", "2x8", 0): (_PORT, "2x8", ["xlstm_125m"]),
            ("ref", "2x4", 0): (_REF, "2x4", ARCHS[:half]),
            ("ref", "2x4", 1): (_REF, "2x4", ARCHS[half:]),
            ("ref", "2x8", 0): (_REF, "2x8", ["xlstm_125m"])}
    with ThreadPoolExecutor(len(jobs)) as pool:
        done = dict(zip(jobs, pool.map(lambda job: _run(*job), jobs.values())))
    got = {}
    for (side, mesh, _), out in done.items():
        for arch, row in out.items():
            got.setdefault((arch, mesh), {})[side] = row
    return {cell: (got[cell]["port"], got[cell]["ref"]) for cell in CELLS}


@pytest.mark.parametrize("arch,mesh", CELLS)
def test_dry_run_matches_the_reference_cell(rows, arch, mesh):
    port, ref = rows[(arch, mesh)]
    assert port["ok"], port.get("traceback")
    assert ref["ok"], ref.get("traceback")
    assert port["trips"] == ref["trips"]
    assert port["roofline"]["model_flops_global"] == ref["roofline"]["model_flops_global"]
    ratios = {k: port["roofline"][k] / ref["roofline"][k] for k in KEYS}
    print(f"[parity] torch {torch.__version__} {arch} train_4k mesh {mesh}: port / reference "
          + " ".join(f"{k}={v:.3f}" for k, v in ratios.items()))
    assert all(v > 0 for v in ratios.values())


@pytest.mark.parametrize("mesh,route", [("2x4", "head-parallel: 1 of 4 heads a rank"),
                                        ("2x8", "split over 'model' by batch rows")])
def test_xlstm_loops_take_the_route_the_notes_name(rows, mesh, route):
    """4 heads over 'model' = 4 split by heads; over 8, by the 128 rows of
    a batch shard (256 over 'data' = 2), 16 a rank."""
    port, _ = rows[("xlstm_125m", mesh)]
    notes = [n for n in port["notes"] if "time loops" in n]
    assert len(notes) == 1 and route in notes[0], port["notes"]
