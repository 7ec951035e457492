"""The vocab-parallel cross-entropy of the sharded train step
(``sharding.vocab_nll``, which ``loss_fn`` calls), without jax, so the
file also runs where the port runs alone.

* On a fake 2x4 (data, model) mesh (``launch.dryrun._debug_mesh``, meta
  tensors), ``loss_fn``'s head on [B, S, V] logits split by batch and
  vocab, a Partial sum over 'data' with the vocab split, and a Partial
  sum over both axes: its forward and backward gather nothing, and reduce
  nothing shaped by V. The only collectives are all-reduces of at most
  [B/2, S] (three of exactly that a step) and a reduce-scatter for each
  Partial axis, each result no more than its share of the logits.
* On four ranks (subprocesses over gloo, meeting through a ``FileStore``
  under the test's tmp dir) on a 2x2 mesh: the nll, ``loss_fn``'s loss and
  the logits' gradient equal the plain path's on the same full logits
  within 1e-6, 1e-6 and 1e-5, with targets on each vocab shard's first
  and last column, row maxima in the other shard than the target's, and
  frontend positions before the tokens (``n_extra``). Logits whose vocab
  is whole over 'model', or does not divide it, take ``log_softmax`` and
  ``gather`` on the DTensor as they are: bit for bit.
* On plain tensors, ``loss_fn`` is ``log_softmax`` and ``gather`` bit for
  bit (loss and every gradient) on every smoke config.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_unflatten

ROOT = pathlib.Path(__file__).resolve().parents[1]
NLL_TOL = 1e-6
GRAD_TOL = 1e-5


def _python(code: str, env: dict, n: int = 1, timeout: float = 300.0) -> list:
    """``code`` run by ``n`` ``sys.executable -c`` processes (``RANK`` 0
    to n - 1 in their environment) side by side; fails unless each exits
    0 within ``timeout`` seconds. Returns their stdouts."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               WORLD_SIZE=str(n), **env)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                              env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE) for r in range(n)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{o[-2000:]}\n{e[-4000:]}"
    return [o for o, _ in outs]


def _result(out: str):
    return json.loads(out.split("RESULT", 1)[1])


# ---------------------------------------------------------------------------
# the collectives on a fake 2x4 mesh
# ---------------------------------------------------------------------------

B, S, V = 4, 16, 256
LAYOUTS = {"batch_and_vocab": "(Shard(0), Shard(2))",
           "partial_data": "(Partial(), Shard(2))",
           "partial_both": "(Partial(), Partial())"}

_FAKE = """
import json
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.models import model as M

mesh = D._debug_mesh("2x4")
cfg = get_config("yi_6b", smoke=True)
out = {}
for name, pl in LAYOUTS.items():
    pl = eval(pl)
    local = (B // 2 if pl[0] == Shard(0) else B, S, V // 4 if pl[1] == Shard(2) else V)
    logits = DTensor.from_local(torch.empty(local, device="meta"), mesh, pl,
                                run_check=False).requires_grad_()
    M.apply = lambda *a, **kw: (logits, torch.zeros((), device="meta"))
    tokens = DTensor.from_local(torch.zeros((B // 2, S + 1), dtype=torch.int32, device="meta"),
                                mesh, (Shard(0), Replicate()), run_check=False)
    with D.StepCounter() as c, implicit_replication():
        loss, _ = M.loss_fn({}, {"tokens": tokens}, cfg)
        loss.backward()
    out[name] = c.records
print("RESULT" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_records():
    """{layout: [(kind, result bytes, group size)]} of loss_fn's forward and
    backward on the fake 2x4 mesh."""
    code = f"B, S, V = {B}, {S}, {V}\nLAYOUTS = {LAYOUTS!r}\n" + _FAKE
    return _result(_python(code, {})[0])


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_loss_gathers_no_vocab_sharded_logits(fake_records, layout):
    records = fake_records[layout]
    rows = B // 2 * S * 4  # [B/2, S] f32: a rank's rows
    kinds = [kind for kind, _, _ in records]
    assert "all-gather" not in kinds, records
    assert set(kinds) <= {"all-reduce", "reduce-scatter"}, records
    reduces = [n for kind, n, _ in records if kind == "all-reduce"]
    assert max(reduces) <= rows and reduces.count(rows) == 3, records
    scatters = [(n, group) for kind, n, group in records if kind == "reduce-scatter"]
    assert len(scatters) == LAYOUTS[layout].count("Partial"), records
    assert all(n * group <= B * S * V * 4 for n, group in scatters), records  # scattered


# ---------------------------------------------------------------------------
# the values on four gloo ranks, 2x2
# ---------------------------------------------------------------------------

# name: (vocab, placements, n_extra, tokens a DTensor)
CASES = {"batch_and_vocab": (16, "(Shard(0), Shard(2))", 0, True),
         "batch_and_vocab_extra": (16, "(Shard(0), Shard(2))", 3, False),
         "partial_data": (16, "(Partial(), Shard(2))", 2, True),
         "partial_model": (16, "(Shard(0), Partial())", 0, False),
         "partial_both": (16, "(Partial(), Partial())", 1, True),
         "vocab_whole": (16, "(Shard(0), Replicate())", 0, True),
         "vocab_uneven": (17, "(Shard(0), Shard(2))", 2, False)}
PLAIN = ("vocab_whole", "vocab_uneven")

_RANKS = """
import json, os
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.parallel import sharding as S

RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", store=dist.FileStore(os.environ["STORE"], WORLD),
                        rank=RANK, world_size=WORLD)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
cfg = get_config("yi_6b", smoke=True)
B, T = 4, 6


def inputs(v, n_extra):
    # logits [B, n_extra + T, v] and tokens [B, T + 1]: targets on each
    # vocab shard's first and last column, and at some positions the row
    # max put in the other shard than the target's
    rng = np.random.default_rng(v + n_extra)
    logits = rng.normal(0.0, 1.0, (B, n_extra + T, v)).astype(np.float32)
    tokens = rng.integers(0, v, (B, T + 1))
    half = v // 2
    tokens[:, 1:5] = [0, half - 1, half, v - 1]
    for b in range(B):
        for s in range(T):
            row = logits[b, n_extra + s]
            if (b + s) % 2:
                row[(tokens[b, s + 1] + half) % v] = row.max() + 2.0
    return torch.from_numpy(logits), torch.from_numpy(tokens)


def laid_out(full, pl):
    # a DTensor of `full` under `pl`: a Shard axis takes its chunk; the
    # Partial axes hold, in mesh order, a part a bf16 rounding of full and
    # the rest, zeros elsewhere (the parts add up to full exactly)
    if not any(isinstance(p, Partial) for p in pl):
        return distribute_tensor(full, mesh, pl)
    head = full.bfloat16().float()
    parts = [head, full - head]
    coord = mesh.get_coordinate()
    k = 0
    for i, p in enumerate(pl):
        if isinstance(p, Partial):
            k = k * mesh.size(i) + coord[i]
    local = parts[k] if k < 2 else torch.zeros_like(full)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            local = local.chunk(mesh.size(i), p.dim)[coord[i]]
    return DTensor.from_local(local, mesh, pl, run_check=False)


def plain_head(logits, targets):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0]


def loss(logits, tokens, n_extra):
    M.apply = lambda *a, **kw: (logits, torch.zeros(()))
    batch = {"tokens": tokens}
    if n_extra:
        batch["extra_embeds"] = torch.zeros((B, n_extra, 1))
    return M.loss_fn({}, batch, cfg)[0]


res = {}
for name, (v, pl, n_extra, sharded_tokens) in CASES.items():
    pl = eval(pl)
    full, tokens = inputs(v, n_extra)
    targets = tokens[:, 1:].long()
    x = full.clone().requires_grad_()
    want = loss(x, tokens, n_extra)
    want.backward()
    want_nll = plain_head(full[:, n_extra:], targets)
    d = laid_out(full, pl).requires_grad_()
    tok = distribute_tensor(tokens, mesh, (Shard(0), Replicate())) if sharded_tokens else tokens
    with implicit_replication():
        got_nll = S.vocab_nll(d[:, n_extra:], tok[:, 1:].long())
        as_is = plain_head(d[:, n_extra:], tok[:, 1:].long())
        got = loss(d, tok, n_extra)
        got.backward()
    res[name] = {"vocab_parallel": S._vocab_parallel(d),
                 "nll": float((got_nll.full_tensor() - want_nll).abs().max()),
                 "nll_as_is": bool(torch.equal(got_nll.full_tensor(), as_is.full_tensor())),
                 "rows_layout": got_nll.placements == (Shard(0), Replicate()),
                 "loss": abs(float(got.full_tensor()) - float(want)),
                 "grad": float((d.grad.full_tensor() - x.grad).abs().max())}
print("RESULT" + json.dumps(res))
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def rank_results(tmp_path_factory):
    """Each of the four ranks' {case: errors against the plain path}."""
    out = tmp_path_factory.mktemp("vocab_loss")
    code = f"CASES = {CASES!r}\n" + textwrap.dedent(_RANKS)
    return [_result(o) for o in _python(code, {"STORE": str(out / "store")}, n=4)]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_nll_matches_the_plain_path(rank_results, case):
    for res in rank_results:
        got = res[case]
        assert got["vocab_parallel"] == (case not in PLAIN)
        assert got["nll"] <= NLL_TOL and got["loss"] <= NLL_TOL, got
        assert got["grad"] <= GRAD_TOL, got
        if case in PLAIN:
            assert got["nll_as_is"], got
        else:  # split as the rows, whole over 'model'
            assert got["rows_layout"], got


# ---------------------------------------------------------------------------
# the plain path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_plain_loss_is_log_softmax_and_gather(arch):
    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)))
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    live = tree_unflatten(params, iter(leaves))
    loss, _ = M.loss_fn(live, {"tokens": tokens}, cfg)
    logits, aux = M.apply(live, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits, dim=-1)
    want = torch.mean(-torch.gather(logp, -1, tokens[:, 1:, None].long())[..., 0]) + 0.01 * aux
    assert torch.equal(loss, want)
    for g, w in zip(torch.autograd.grad(loss, leaves), torch.autograd.grad(want, leaves),
                    strict=True):
        assert torch.equal(g, w)
