"""The model family as a file of its own: the default family reads what the
two cells read before families existed, bit for bit; a stack of dense and
MoE layers in turn, which the default family refuses, runs correct through
a family module written to a directory of its own, and not correct with its
timed path broken; ``Forward`` hands every state argument through."""

import dataclasses
import itertools

import pytest
import torch

from port_bench import files, harness, judge, model_flops, smoke, weights

ARCHS = ["yi-6b", "granite-moe-3b-a800m"]
SEED = 2 ** 31 + 307

# Recorded with the harness as it stood before families (commit 09aa1987),
# at smoke.cell's widths: weights.digest of make_weights(cfg, seed), of the
# reference's logits of REQS, and of the control's; step_flops of STEPS.
RECORDED = {
    ("yi-6b", 1): ("78468c6b8cec176b", "9d871047f48ac7ee", "781f0be8d18367e9"),
    ("yi-6b", 2): ("f645f7c42e39266f", "072b81db631eff1b", "6bee5b6f7006eb37"),
    ("yi-6b", 3): ("ec4706fedc87b798", "c4f430de78712c4c", "b3e02d0a73cec182"),
    ("granite-moe-3b-a800m", 1): ("77c1a1c7028a0e16", "f41b5f55405bd8f9", "09f268c3aebcfbb9"),
    ("granite-moe-3b-a800m", 2): ("b41862fcee93af77", "7bafc442d7803b3f", "57041037490e700a"),
    ("granite-moe-3b-a800m", 3): ("ae3ec436a12b0fdd", "aae44a1789a17d2a", "4e0d8f43865f92a4"),
}
RECORDED_FLOPS = {"yi-6b": (75638784.0, 21848064.0),
                  "granite-moe-3b-a800m": (75823104.0, 21864448.0)}
STEPS = [{"prefill": [37, 5], "dec_ctx": [12, 40, 3]},
         {"prefill": [], "dec_ctx": [100, 7, 64, 1]}]


def reqs(vocab: int) -> list:
    """Two served requests (prompt, output) of fixed tokens; the judge
    gives the MoE's the server's forward calls as segments."""
    toks = torch.randint(0, vocab, (40,), generator=torch.Generator().manual_seed(7)).tolist()
    return [{"prompt": toks[:9], "output": toks[9:20]},
            {"prompt": toks[20:34], "output": toks[34:40]}]


@pytest.fixture(autouse=True)
def one_thread():
    # the runs are small: many threads a test worker only contend
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_nothing_the_cells_read_has_moved(arch, seed):
    cell = smoke.cell(arch)
    cfg, fam = cell.cfg, cell.family
    assert fam is not None and "family" not in cfg
    w = fam.make_weights(cfg, seed, "cpu")
    seqs = judge.sequences(reqs(cfg["vocab_size"]), cfg, fam, fam.capacity(4, cfg))
    assert all(("segments" in s) == weights.moe(cfg) for s in seqs)
    ref = fam.logits(w, cfg, seqs)
    ctl = fam.logits(w, cfg, seqs, low=fam.control_precision(cfg))
    got = (weights.digest(w), weights.digest({str(i): x for i, x in enumerate(ref)}),
           weights.digest({str(i): x for i, x in enumerate(ctl)}))
    assert got == RECORDED[arch, seed]
    assert tuple(fam.step_flops(cfg, s) for s in STEPS) == RECORDED_FLOPS[arch]
    obs = {"family": fam, "cfg": cfg, "steps": STEPS}
    assert model_flops.window_flops(obs) == sum(RECORDED_FLOPS[arch])


def test_the_default_family_builds_one_kind_of_block():
    cfg = smoke.cell("granite-moe-3b-a800m").cfg
    fam = files.family(cfg)
    L = cfg["num_hidden_layers"]
    assert fam.expected_blocks(cfg) == ("moe",)
    assert fam.expected_blocks(dict(cfg, mlp_layer_types=["sparse"] * L)) == ("moe",) * L
    mixed = dict(cfg, layer_types=["full_attention"] * L, mlp_layer_types=["dense", "sparse"])
    assert fam.expected_blocks(mixed) == ("dense", "moe")
    assert fam.expected_blocks(dict(cfg, layer_types=["mamba", "attention"])) == ("mamba", "moe")
    with pytest.raises(ValueError, match="family of its own"):
        fam.make_weights(mixed, 1, "cpu")


# A family module as a later configuration would add it: dense and MoE
# layers in turn (Llama 4's interleave_moe_layer_step of 2), blocks["0"]
# the dense layers and blocks["1"] the MoE layers, as paged_forward reads a
# block pattern of ("dense", "moe").
INTERLEAVED = '''
import torch

from port_bench import files, model_flops, weights
from port_bench.reference import model as ref

llama = files.family({})
STEP = "interleave_moe_layer_step"
control_precision = ref.control_precision
capacity = ref.capacity


def expected_blocks(cfg):
    return tuple("moe" if (i + 1) % cfg[STEP] == 0 else "dense" for i in range(cfg[STEP]))


def halves(cfg):
    moe = dict(cfg, num_hidden_layers=cfg["num_hidden_layers"] // 2)
    dense = {k: v for k, v in moe.items() if k != "num_local_experts"}
    return dict(dense, intermediate_size=cfg["dense_intermediate_size"]), moe


def make_weights(cfg, seed, device):
    dense, moe = halves(cfg)
    d = weights.make_weights(dense, seed, device)
    m = weights.make_weights(moe, seed + 1, device)
    return dict(m, blocks={"0": d["blocks"]["0"], "1": m["blocks"]["0"]})


def logits(w, cfg, seqs, *, low=None, device=None):
    device = device or w["embed"].device
    xs = [w["embed"][torch.as_tensor(s["tokens"])].to(device).float() for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        lw = ref._layer_weights({"blocks": {"0": w["blocks"][str(i % 2)]}}, cfg, i // 2,
                                low, device)
        xs = [ref._block(x, lw, cfg, s.get("segments"), low) for x, s in zip(xs, seqs)]
    head = ref._round(w["lm_head"].to(device).float(), 0, low)
    scale = w["final_norm"]["scale"].to(device).float()
    return [ref._mm(ref.rms_norm(x[s["first"]:], scale, cfg["rms_norm_eps"]), head, low)
            for x, s in zip(xs, seqs)]


def step_flops(cfg, step):
    dense, moe = halves(cfg)
    served = len(step["prefill"]) + len(step["dec_ctx"])
    head = 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * served
    return model_flops.step_flops(dense, step) + model_flops.step_flops(moe, step) - head


def config_fields(cfg, pc):
    return dict(llama.config_fields(cfg, pc),
                dense_intermediate_size=(cfg["dense_intermediate_size"], pc.d_ff))


def config_dict(arch, pc):
    return dict(llama.config_dict(arch, pc), family="interleaved",
                dense_intermediate_size=pc.d_ff, **{STEP: len(pc.block_pattern)})
'''


@pytest.fixture(scope="module")
def interleaved(tmp_path_factory):
    where = tmp_path_factory.mktemp("bench")
    (where / "families").mkdir()
    (where / "families" / "interleaved.py").write_text(INTERLEAVED)
    fam = files.load_module("families", "interleaved", where)
    return smoke.cell("granite-moe-3b-a800m", family=fam, block_pattern=("dense", "moe"))


def run(cell, **kw):
    ticks = itertools.count()
    return harness.run(cell, SEED, 1.0, False, device="cpu",
                       clock=lambda: 0.005 * next(ticks), **kw)


def test_a_mixed_stack_is_refused_without_its_family(interleaved):
    cfg = {k: v for k, v in interleaved.cfg.items() if k != "family"}
    default = dataclasses.replace(interleaved, cfg=cfg, family=None)
    assert default.family.expected_blocks(cfg) == ("moe",)
    bad = harness.config_mismatches(cfg, default.port_cfg)
    assert [m for m in bad if m.startswith("block: ")], bad
    with pytest.raises(SystemExit, match="block: "):
        run(default)
    assert harness.config_mismatches(interleaved.cfg, interleaved.port_cfg,
                                     interleaved.family) == []


@pytest.mark.parametrize("fault", [None, "altered_token", "stale_state"])
def test_a_mixed_stack_runs_through_its_family_file(interleaved, fault):
    r = run(interleaved, fault=fault)
    assert r["correct"] == (fault is None), r["checks"]
    if fault:
        for name in ("max_logit_gap", "logit_err_p50"):
            assert r["checks"][name]["value"] > r["checks"][name]["limit"]
    else:
        assert r["readings"]["tokens"] >= 150 and r["metrics"]["gen_tok_s"]["value"] > 0


def test_forward_hands_every_state_argument_through():
    seen = []

    def fwd(p, t, pc, *state):
        seen.append(state)
        for s in state[:3]:
            s.add_(1)
        logits = torch.arange(t.shape[0] * 16, dtype=torch.float32).view(t.shape[0], 16)
        return (logits, *state[:3])

    t = torch.zeros((2, 1), dtype=torch.int32)
    state = [torch.zeros(2), torch.zeros(3), torch.zeros(1),
             torch.ones(2, dtype=torch.int32), "not a tensor"]
    sound = harness.Forward(None)
    sound.fwd = fwd
    out = sound(None, t, *state)
    assert len(out) == 4 and all(o is s for o, s in zip(out[1:], state))
    assert all(a is b for a, b in zip(seen[0], state))
    assert sound.calls == [(2, 1)] and sound.top[0].indices[0, 0] == 15
    assert float(state[0][0]) == 1.0
    stale = harness.Forward(None, "stale_state")
    stale.fwd = fwd
    before = [s.clone() for s in state[:4]]
    out = stale(None, t, *state)
    assert len(out) == 4 and all(o is s for o, s in zip(out[1:], state))
    assert all(torch.equal(s, b) for s, b in zip(state[:4], before))
    assert all(a is not b for a, b in zip(seen[1][:4], state[:4])) and seen[1][4] is state[4]
