"""The plain reference against the port's CPU path (the kernels' plain
versions) at the smoke configs in float32: a prefill and decode steps
through ``paged_forward``, an MoE call whose capacity drops claims, and the
lane rule the judge relies on."""

import dataclasses

import pytest
import torch

from port_bench import smoke, weights
from port_bench.reference import model as ref

ARCHS = ["yi-6b", "granite-moe-3b-a800m"]


def setup(arch, **replace):
    from repro_torch.configs import get_config

    pc = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **replace)
    cfg = smoke.config_dict(arch, pc)
    return pc, cfg, weights.make_weights(cfg, 2 ** 31 + 11, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_paged_forward(arch):
    from repro_torch.serving.paged_model import paged_forward

    # granite at capacity factor 0.5: the prefill's 24 x 2 claims over 4
    # experts get 8 slots each, so claims drop
    pc, cfg, w = setup(arch, capacity_factor=0.5) if "granite" in arch else setup(arch)
    P, steps, page = 24, 6, 8
    L, KV, hd = pc.num_layers, pc.num_kv_heads, pc.resolved_head_dim
    kp = torch.zeros((L, 5, KV, page, hd))
    vp = torch.zeros_like(kp)
    bt = torch.arange(5, dtype=torch.int32)[None]
    toks = torch.randint(0, pc.vocab_size, (P + steps,), generator=torch.Generator().manual_seed(3))
    got = []
    lg, kp, vp = paged_forward(w, toks[None, :P].int(), pc, kp, vp, bt,
                               torch.zeros(1, dtype=torch.int32))
    got.append(lg[0])
    for i in range(steps - 1):
        lg, kp, vp = paged_forward(w, toks[None, P + i:P + i + 1].int(), pc, kp, vp, bt,
                                   torch.tensor([P + i], dtype=torch.int32))
        got.append(lg[0])
    seq = {"tokens": toks[:P + steps - 1].tolist(), "first": P - 1}
    if weights.moe(cfg):
        cap = ref.capacity(P, cfg)
        seq["segments"] = [(0, P, cap)] + [(p, p + 1, ref.capacity(1, cfg))
                                            for p in range(P, P + steps - 1)]
        assert cap < P * cfg["num_experts_per_tok"] / cfg["num_local_experts"]
    want = ref.logits(w, cfg, [seq])[0]
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-5)


def test_moe_call_with_drops_matches_the_port():
    from repro_torch.models.moe import moe_block

    pc, cfg, w = setup("granite-moe-3b-a800m", capacity_factor=0.5)
    T = 20
    x = torch.randn((T, pc.d_model), generator=torch.Generator().manual_seed(5))
    lw = ref._layer_weights(w, cfg, 1, None, "cpu")
    p = {k: v[1] for k, v in w["blocks"]["0"]["moe"].items()}
    cap = ref.capacity(T, cfg)
    probs = torch.softmax(x @ lw["router"], dim=-1)
    ids = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :cfg["num_experts_per_tok"]]
    assert not ref.kept_claims(ids, [(0, T, cap)], cfg["num_local_experts"]).all()
    y, _ = moe_block(x[None], p, num_experts=pc.num_experts, top_k=pc.num_experts_per_tok,
                     capacity_factor=pc.capacity_factor, act=pc.act)
    torch.testing.assert_close(y[0], ref.moe(x, lw, cfg, [(0, T, cap)], None),
                               rtol=1e-5, atol=1e-6)


def test_a_lane_below_the_capacity_keeps_its_claims():
    # 12 lanes all routed to experts 0 and 1: lane i is the (i+1)-th claim
    ids = torch.tensor([[0, 1]] * 12)
    keep = ref.kept_claims(ids, [(0, 12, 5)], 4)
    assert keep[:5].all() and not keep[5:].any()


def test_control_precision():
    assert ref.control_precision({"torch_dtype": "bfloat16"}) == "fp8"
    assert ref.control_precision({"torch_dtype": "float32"}) == "bf16"
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    for low, rel in (("bf16", 2 ** -8), ("fp8", 2 ** -4)):
        err = (ref._round(x, -1, low) - x).abs() / x.abs().amax(-1, keepdim=True)
        assert 0 < float(err.max()) <= rel
