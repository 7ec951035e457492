"""The port's launch tooling against the JAX package's on the CPU: the
roofline's wire-byte formulas (collective records against the reference's
parse of its own test's HLO snippets), its terms under the H100 constants,
``model_flops``; the dry run's FLOP counter on a known sharded matmul (per
GPU: the local shapes) and on the reference's calibration case (a loop of
R=8 tanh-matmuls of 128^2 under ``grad``: 6*M^3*R within [0.95, 1.10]);
``trip_counts``, ``_active_params`` and ``analytic_memory`` equal the
reference's on every arch x shape at 16x16 (exactly: the same products of
the same integers); and a fake-mesh dry run of a smoke config in a
subprocess writes the reference's JSON keys, which both packages'
``launch/report.py`` tabulate."""

import json
import math
import os
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jax_config
from repro.launch import report as JREPORT
from repro.launch import roofline as JR
from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import report as REPORT
from repro_torch.launch import roofline as R
from repro_torch.tree import tree_leaves

# the reference's dry run sets XLA_FLAGS when imported (for its own
# process); this process keeps its own
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as JD  # noqa: E402

if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference test's snippets and the records the dry run would make of them
_HLO_BRACE = """
  %ar = f32[1024,64]{1,0} all-reduce(f32[1024,64] %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[2048,128]{1,0} all-gather(bf16[512,128] %y), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[256]{0} reduce-scatter(f32[1024] %z), replica_groups={{0,1,2,3}}, to_apply=%add
  %cp = f32[64,64]{1,0} collective-permute(f32[64,64] %w), source_target_pairs={{0,1}}
"""
_REC_BRACE = [("all-reduce", 1024 * 64 * 4, 4), ("all-gather", 2048 * 128 * 2, 4),
              ("reduce-scatter", 256 * 4, 4), ("collective-permute", 64 * 64 * 4, 1)]
_HLO_IOTA = """
  %ars = f32[100]{0} all-reduce-start(f32[100] %x), replica_groups=[16,32]<=[512], to_apply=%add
  %ard = f32[100]{0} all-reduce-done(f32[100] %ars)
"""
_REC_IOTA = [("all-reduce", 100 * 4, 32)]


@pytest.mark.parametrize("hlo,records", [(_HLO_BRACE, _REC_BRACE), (_HLO_IOTA, _REC_IOTA)])
def test_wire_bytes_equal_the_reference_parse(hlo, records):
    want = JR.collective_wire_bytes(hlo)
    got = R.collective_wire_bytes(records)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


def test_roofline_terms_dominance_under_the_h100_constants():
    assert (R.PEAK_FLOPS, R.HBM_BW, R.LINK_BW) == (989e12, 3.35e12, 50e9)
    terms = R.roofline_terms({"flops": R.PEAK_FLOPS * 2.0, "bytes accessed": R.HBM_BW * 0.5})
    assert terms["dominant"] == "compute"
    assert abs(terms["compute_s"] - 2.0) < 1e-9 and abs(terms["memory_s"] - 0.5) < 1e-9
    terms = R.roofline_terms({"flops": 1.0, "bytes accessed": 1.0},
                             [("all-gather", R.LINK_BW * 4, 4)])  # 3/4 of it on the wire
    assert terms["dominant"] == "collective" and abs(terms["collective_s"] - 3.0) < 1e-9
    assert terms["step_s_lower_bound"] == terms["collective_s"]


def test_model_flops():
    assert R.model_flops(1000, 10, "train") == 6e4
    assert R.model_flops(1000, 10, "decode") == 2e4


def test_flop_count_calibration_band():
    """The reference's case: grad of a loop of R tanh-matmuls; the count is
    the product's 6*M^3*R but for the first layer's unneeded dx (46/48)."""
    M_, R_ = 128, 8
    ws = torch.randn(R_, M_, M_, requires_grad=True)
    x = torch.randn(M_, M_)

    def grad_step():
        h = x
        for w in ws.unbind(0):
            h = torch.tanh(h @ w)
        return torch.autograd.grad(h.sum(), ws)

    ratio = D.count(grad_step, (), device="cpu")["flops"] / (6 * M_ ** 3 * R_)
    assert 0.95 < ratio < 1.10, ratio


_SHARDED_MATMUL = r"""
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch import dryrun as D
from repro_torch.parallel import sharding as S
mesh = D._debug_mesh("2x2")
x = distribute_tensor(torch.empty(64, 32, device="meta"), mesh, (Shard(0), Replicate()))
w = distribute_tensor(torch.empty(32, 16, device="meta"), mesh, (Replicate(), Shard(1)))
w2 = distribute_tensor(torch.empty(32, 16, device="meta"), mesh, (Shard(0), Shard(1)))
with FlopCounterMode(display=False) as fc:
    x @ w
out = {"local": D.count(lambda: x @ w, ()),       # no collective
       "gather": D.count(lambda: x @ w2, ()),     # w2's rows all-gathered over 'data'
       "flop_counter_mode": fc.get_total_flops(),
       # 6 heads over the 2 'model' ranks split 3 x 2 (r-major GQA): the 3 does not
       # divide, so S.view replicates the heads, then reshapes
       "view": D.count(lambda: S.view(distribute_tensor(
           torch.empty(4, 6, 16, device="meta"), mesh, (Replicate(), Shard(1))), 4, 3, 2, 16), ())}
print("RESULT" + __import__("json").dumps(out))
"""


def _run(code: str, *args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, *args] if not code else [sys.executable, "-c", code],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def test_flop_counter_counts_local_shapes_of_a_sharded_matmul():
    out = json.loads(_run(_SHARDED_MATMUL).split("RESULT", 1)[1])
    local, global_ = 2 * 32 * 32 * 8, 2 * 64 * 32 * 16
    assert out["local"]["flops"] == local and out["local"]["collective_ops"] == 0
    assert out["gather"]["flops"] == local
    # all-gather of w2's [16, 8] shard to [32, 8] f32 over 2 ranks: (n-1)/n of 1 KiB
    assert out["gather"]["wire_all-gather"] == 32 * 8 * 4 / 2
    # FlopCounterMode alone sees the DTensor op at its global shapes: 4x one GPU's share
    assert out["flop_counter_mode"] == global_
    assert out["view"]["collective_ops"] == 1 and out["view"]["wire_all-gather"] > 0


def _jax_mesh():
    return SimpleNamespace(axis_names=("data", "model"), shape={"data": 16, "model": 16},
                           devices=SimpleNamespace(shape=(16, 16)))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_trips_params_and_memory_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert D.trip_counts(cfg, SHAPES[shape]) == JD.trip_counts(jcfg, JSHAPES[shape])
    assert D._active_params(cfg, D.params_struct(cfg)) == JD._active_params(
        jcfg, JD.params_struct(jcfg))
    got = D.analytic_memory(cfg, SHAPES[shape], {"data": 16, "model": 16})
    want = JD.analytic_memory(jcfg, JSHAPES[shape], _jax_mesh())
    assert got.keys() == want.keys()
    for k in want:
        assert math.isclose(got[k], float(want[k]), rel_tol=1e-12), k


_REF_KEYS = {"arch", "shape", "mesh", "ok", "overrides", "memory", "memory_analytic",
             "trips", "raw", "roofline", "compile_seconds"}
_ROOFLINE_KEYS = {"flops_per_chip", "bytes_per_chip", "wire_bytes_per_chip", "wire_breakdown",
                  "collective_ops", "compute_s", "memory_s", "collective_s", "dominant",
                  "step_s_lower_bound", "model_flops_global", "useful_flops_ratio",
                  "n_params", "n_active_params"}


def test_smoke_dry_run_on_a_fake_mesh_writes_the_reference_json(tmp_path):
    """yi-6b smoke, train_4k, on a 2x4 fake mesh (8 ranks; its 2 KV heads
    over 'model' = 4 take ``sharding.view``'s replication), in a process
    of its own as the dry run must be."""
    _run("", "-m", "repro_torch.launch.dryrun", "--arch", "yi-6b", "--shape", "train_4k",
         "--smoke", "--mesh", "2x4", "--out", str(tmp_path), timeout=120)
    row = json.loads((tmp_path / "yi_6b__train_4k__mesh2x4.json").read_text())
    assert row["ok"], row.get("traceback")
    assert _REF_KEYS <= set(row) and set(row["roofline"]) == _ROOFLINE_KEYS
    t = row["roofline"]
    assert t["flops_per_chip"] > 0 and t["bytes_per_chip"] > 0 and t["collective_ops"] > 0
    assert t["wire_bytes_per_chip"] == pytest.approx(sum(t["wire_breakdown"].values()))
    assert t["n_params"] == sum(x.numel() for x in tree_leaves(
        D.params_struct(get_config("yi_6b", smoke=True))))
    for report in (REPORT, JREPORT):
        rows = report.load(str(tmp_path))
        assert "| yi-6b | train_4k | ok |" in report.table(rows, "mesh2x4")
        assert report.summarize(rows, "mesh2x4").startswith("1 compiled")


DRY_CELLS = [(a, "train_4k") for a in ARCHS] + [
    (a, "decode_32k") for a in ("granite_moe", "llama4_maverick", "xlstm_125m")]


@pytest.fixture(scope="module")
def family_dry_runs(tmp_path_factory):
    """Each of DRY_CELLS dry-run by the CLI on the smoke config over a 2x4
    fake mesh, a process a cell (a process has one default group), the
    processes side by side; {cell: (its stdout, its JSON row or None)}."""
    out = tmp_path_factory.mktemp("dry")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

    def run(cell):
        arch, shape = cell
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch.replace("_", "-"),
             "--shape", shape, "--smoke", "--mesh", "2x4", "--out", str(out)],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
        path = out / f"{arch}__{shape}__mesh2x4.json"
        row = json.loads(path.read_text()) if path.exists() else None
        return proc.returncode, proc.stdout + proc.stderr[-3000:], row

    with ThreadPoolExecutor(4) as pool:
        return dict(zip(DRY_CELLS, pool.map(run, DRY_CELLS)))


@pytest.mark.parametrize("arch,shape", DRY_CELLS)
def test_every_family_dry_runs_on_a_fake_mesh(family_dry_runs, arch, shape):
    rc, log, row = family_dry_runs[(arch, shape)]
    assert rc == 0 and row is not None, log
    assert row["ok"] and not row.get("skipped"), row.get("traceback")
    assert _REF_KEYS <= set(row) and set(row["roofline"]) == _ROOFLINE_KEYS
    assert row["roofline"]["flops_per_chip"] > 0
    assert "[dryrun] done: 1/1 cells OK" in log
