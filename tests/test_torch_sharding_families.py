"""The sharded path of every family on four ranks (subprocesses over gloo,
as ``test_torch_sharding.py`` runs them) on a 2x2 (data, model) mesh: the
MoE configs (granite-moe, llama4-maverick), xLSTM and hymba smoke configs
in float32, one rank run a config.

* The sharded loss is within the reference test's 1e-3 of the JAX
  package's single-device ``loss_fn`` (test_sharding.py:73-75) and every
  sharded gradient within 1e-5 of the port's unsharded one (partial sums
  reduced in another order).
* MoE runs at a capacity factor of 1.0, where the single-device step drops
  claims (the smoke configs' 4.0 drops none, and a rank-local capacity or
  prefix would pass there): the ranks drop exactly the single-device
  step's claims, and still match. granite-moe runs three layouts: its
  4 experts split over 'model' (EP), 5 experts that do not split, so the
  expert FFN dims do (TP), and ``moe_groups=2`` (group-local claims).
* Attention is head-parallel: each rank's queries hold H/2 of the heads;
  with ``kv_block_axis="model"`` the chunked cache attention of a prefill
  splits its queries over 'model' along the sequence instead.
* The mLSTM, sLSTM and SSD time loops split their work over the mesh:
  the (row, head) slices the four ranks' loops run on are disjoint and
  make up the global batch x heads once, by heads where they divide
  'model' (xLSTM and hymba smoke, 4 heads) and by batch rows where they
  do not (xLSTM with one head).
"""

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import init_params as jax_init_params
from repro.models import model as JM
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import loss_fn
from repro_torch.models import moe as MOE
from repro_torch.tree import tree_leaves, tree_unflatten
from test_torch_sharding import run_ranks

TOL = 1e-5
LOSS_TOL = 1e-3
CASES = {
    "granite_moe": {"ep": {"capacity_factor": 1.0},
                    "tp": {"capacity_factor": 1.0, "num_experts": 5},
                    "groups": {"capacity_factor": 1.0, "moe_groups": 2}},
    "llama4_maverick": {"ep": {"capacity_factor": 1.0}},
    "xlstm_125m": {"base": {}, "rows": {"ssm_heads": 1}},
    "hymba_1_5b": {"base": {}},
}
PAIRS = [(a, v) for a, vs in CASES.items() for v in vs]

_RANKS = """
import json
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import layers as L
from repro_torch.models import loss_fn
from repro_torch.models import moe as MOE
from repro_torch.parallel import sharding as S
from torch.distributed.tensor.experimental import implicit_replication

mesh = make_debug_mesh(2, 2, device_type="cpu")
cases = json.loads(CASES)
seen = {"heads": set(), "drops": []}
sdpa = L._sdpa.__wrapped__


def heads(q, k, v, *a, **kw):
    seen["heads"].add(q.shape[2])
    return sdpa(q, k, v, *a, **kw)


L._sdpa = S.per_head_shard(heads)
assign = MOE.assign_slots


def counted(*a, **kw):
    slot, keep = assign(*a, **kw)
    seen["drops"].append(seen["rows"] + (int((~keep).sum()),))
    return slot, keep


MOE.assign_slots = counted


class Rows(S.Rows):
    def __init__(self, x):
        super().__init__(x)
        seen["rows"] = (self.index, self.n)


MOE.Rows = Rows
from repro_torch.models import ssm as SSM


class LoopRows(S.Rows):
    # keeps the first tensor a time loop takes to its rank (the loop's
    # lead input, q / zx / x) as the loop ran on it

    def local(self, x, *h):
        out = super().local(x, *h)
        if seen.get("loop") and seen["loop"] not in seen["loops"]:
            seen["loops"][seen["loop"]] = out.detach().clone()
        return out


def in_loop(name, fn):
    def run(*a, **kw):
        seen["loop"] = name
        try:
            return fn(*a, **kw)
        finally:
            seen["loop"] = None
    return run


S.Rows = LoopRows
for fname in ("mlstm_scan", "_slstm_scan", "ssd_chunked"):
    setattr(SSM, fname, in_loop(fname, getattr(SSM, fname)))
res = {}
for name, over in cases.items():
    seen["heads"], seen["drops"], seen["loops"] = set(), [], {}
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), **over)
    params = S.param_shardings(torch.load(os.path.join(OUT, f"{name}_params.pt")), mesh)
    tokens = torch.load(os.path.join(OUT, "tokens.pt"))
    batch = S.distribute({"tokens": tokens}, S.batch_specs_for(mesh, {"tokens": tokens}), mesh)
    live = [p.detach().requires_grad_(True) for p in T.tree_leaves(params)]
    with implicit_replication():
        loss, _ = loss_fn(T.tree_unflatten(params, iter(live)), batch, cfg)
        grads = torch.autograd.grad(loss, live)
    res[name] = {"loss": loss.detach().full_tensor(), "grads": [g.full_tensor() for g in grads],
                 "heads": sorted(seen["heads"]), "drops": seen["drops"], "loops": seen["loops"]}
if ARCH == "llama4_maverick":
    # prefill through the chunked cache attention (KV blocks of 4 over a
    # cache of 8) with its queries split over 'model' along the sequence
    from repro_torch.models import init_cache, prefill
    chunked = L.chunked_cache_attention.__wrapped__

    def rows(q, *a, **kw):
        seen["heads"].add(q.shape[1:3])
        return chunked(q, *a, **kw)

    L.chunked_cache_attention = S.per_head_shard(rows, seq_args=(0,))
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), attn_chunk_kv=4,
                              kv_block_axis="model")
    plain = torch.load(os.path.join(OUT, "ep_params.pt"))
    tokens = torch.load(os.path.join(OUT, "tokens.pt"))[:, :8]
    want, _ = prefill(plain, tokens, cfg, init_cache(cfg, 8, 8, "cpu"))
    seen["heads"] = set()
    cache = init_cache(cfg, 8, 8, "cpu")
    cache = S.distribute(cache, S.cache_specs_for(mesh, cache, 8), mesh)
    tok = S.distribute({"t": tokens}, S.batch_specs_for(mesh, {"t": tokens}), mesh)["t"]
    with implicit_replication():
        got, _ = prefill(S.param_shardings(plain, mesh), tok, cfg, cache)
    res["prefill"] = {"got": got.full_tensor(), "want": want,
                      "rows_heads": sorted(seen["heads"])}
torch.save(res, os.path.join(OUT, f"rank{RANK}.pt"))
"""


def _cfgs(arch, over):
    return (dataclasses.replace(jax_config(arch, smoke=True), **over),
            dataclasses.replace(get_config(arch, smoke=True), **over))


def _references(arch, out):
    """Each case's params saved for the ranks, and its single-device
    references: JAX's loss, the port's loss and gradients, and the claims
    each MoE layer drops."""
    tokens = np.random.default_rng(1).integers(0, 512, (8, 17), dtype=np.int32)
    torch.save(torch.from_numpy(tokens), out / "tokens.pt")
    ref = {}
    for name, over in CASES[arch].items():
        jcfg, cfg = _cfgs(arch, over)
        jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                   dtype=torch.float32, device="cpu")
        torch.save(params, out / f"{name}_params.pt")
        drops = []
        assign = MOE.assign_slots

        def counted(*a, **kw):
            slot, keep = assign(*a, **kw)
            drops.append(int((~keep).sum()))
            return slot, keep

        MOE.assign_slots = counted
        try:
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            loss, _ = loss_fn(tree_unflatten(params, iter(leaves)),
                              {"tokens": torch.from_numpy(tokens)}, cfg)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            MOE.assign_slots = assign
        jloss = JM.loss_fn(jparams, {"tokens": jnp.asarray(tokens)}, jcfg)[0]
        ref[name] = {"jax_loss": float(jloss), "loss": loss.detach(), "grads": grads,
                     "drops": drops, "cfg": cfg}
    return ref


@pytest.fixture(scope="module")
def families(tmp_path_factory):
    """{arch: {case: (references, the four ranks' results)}}: one 4-rank
    run a family, the four families' runs side by side."""
    outs = {arch: tmp_path_factory.mktemp(arch) for arch in CASES}
    refs = {arch: _references(arch, outs[arch]) for arch in CASES}

    def ranks(arch):
        body = (f"import dataclasses\nARCH = {arch!r}\n"
                f"CASES = {json.dumps(CASES[arch])!r}\n" + _RANKS)
        run_ranks(body, 4, outs[arch], timeout=400)
        return [torch.load(outs[arch] / f"rank{r}.pt") for r in range(4)]

    with ThreadPoolExecutor(len(CASES)) as pool:
        results = dict(zip(CASES, pool.map(ranks, CASES)))
    out = {arch: {name: (refs[arch][name], [r[name] for r in results[arch]])
                  for name in CASES[arch]} for arch in CASES}
    out["prefill"] = [r["prefill"] for r in results["llama4_maverick"]]
    return out


@pytest.mark.parametrize("arch,name", PAIRS)
def test_sharded_loss_matches_jax_single_device(families, arch, name):
    ref, ranks = families[arch][name]
    for res in ranks:
        assert abs(float(res["loss"]) - ref["jax_loss"]) < LOSS_TOL
        torch.testing.assert_close(res["loss"], ref["loss"], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,name", PAIRS)
def test_sharded_grads_match_unsharded(families, arch, name):
    ref, ranks = families[arch][name]
    for res in ranks:
        for g, want in zip(res["grads"], ref["grads"], strict=True):
            torch.testing.assert_close(g, want, atol=TOL, rtol=TOL)


MOE_PAIRS = [(a, v) for a, v in PAIRS if CASES[a][v].get("capacity_factor")]


@pytest.mark.parametrize("arch,name", MOE_PAIRS)
def test_moe_drops_the_single_device_claims(families, arch, name):
    """The single-device step drops claims at this capacity; in each MoE
    layer the ranks' token shards (the ranks that hold the same shard
    counted once) drop as many claims as the single-device step, each
    claim's slot taken over the global token order."""
    ref, ranks = families[arch][name]
    assert sum(ref["drops"]) > 0
    for layer, want in enumerate(ref["drops"]):
        shards = {}
        for res in ranks:
            index, n, drops = res["drops"][layer]
            assert shards.setdefault(index, (n, drops)) == (n, drops)
        assert sorted(shards) == list(range(n)) and n > 1
        assert sum(d for _, d in shards.values()) == want


def test_moe_expert_layouts():
    """4 experts split over 'model' (EP); 5 do not, so the expert FFN dims
    are split instead (TP), as the reference's rules fall back."""
    from repro_torch.parallel import sharding as S

    mesh = {"data": 2, "model": 2}
    assert S.param_spec("blocks/0/moe/wg", (2, 4, 64, 64), mesh) == S.P(None, "model", "data", None)
    assert S.param_spec("blocks/0/moe/wg", (2, 5, 64, 64), mesh) == S.P(None, None, "data", "model")


ATTN_PAIRS = [(a, v) for a, v in PAIRS if a != "xlstm_125m"]


@pytest.mark.parametrize("arch,name", ATTN_PAIRS)
def test_attention_is_head_parallel(families, arch, name):
    """Every rank's attention saw H/2 query heads: wq's column split over
    'model' carried through the head reshape into attention."""
    ref, ranks = families[arch][name]
    for res in ranks:
        assert res["heads"] == [ref["cfg"].num_heads // 2]


def test_kv_block_axis_splits_the_prefill_queries(families):
    """``kv_block_axis="model"``: the chunked cache attention of a
    llama4-maverick smoke prefill (8 tokens, KV blocks of 4) runs each
    rank's 4 of the 8 query positions with every head, and the last
    position's logits equal the unsharded prefill's."""
    for res in families["prefill"]:
        assert res["rows_heads"] == [(4, 4)]
        torch.testing.assert_close(res["got"], res["want"], atol=TOL, rtol=TOL)


# the dim of the heads in each loop's lead input: q [B,H,S,d], zx [B,S,H,hd], x [B,S,H,P]
LOOP_HEAD_DIM = {"mlstm_scan": 1, "_slstm_scan": 2, "ssd_chunked": 2}
LOOP_PAIRS = [(a, v) for a, v in PAIRS if a in ("xlstm_125m", "hymba_1_5b")]


@pytest.mark.parametrize("arch,name", LOOP_PAIRS)
def test_time_loops_split_the_work_over_the_mesh(families, arch, name):
    """Each rank's mLSTM, sLSTM and SSD loop runs on (rows x heads) of
    the global batch x heads: over the 2x2 mesh the ranks' (row, head)
    slices of the loop's input are pairwise distinct and number B x H in
    all, so no slice of the work runs twice (on the 2 'model' ranks of a
    batch shard) and none is left out."""
    ref, ranks = families[arch][name]
    cfg = ref["cfg"]
    loops = {"xlstm_125m": ("mlstm_scan", "_slstm_scan"), "hymba_1_5b": ("ssd_chunked",)}[arch]
    B, H = 8, cfg.ssm_heads
    for loop in loops:
        slices, shapes = [], []
        for res in ranks:
            x = res["loops"][loop].movedim(LOOP_HEAD_DIM[loop], 1)
            shapes.append(tuple(x.shape[:2]))
            slices += [x[r, h] for r in range(x.shape[0]) for h in range(x.shape[1])]
        assert sum(r * h for r, h in shapes) == B * H, (loop, shapes)
        for i, a in enumerate(slices):
            for b in slices[i + 1:]:
                assert not torch.equal(a, b), (loop, shapes)
