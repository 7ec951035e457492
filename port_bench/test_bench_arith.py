"""The rooflines, the model FLOPs and the readers' arithmetic on shapes
worked by hand."""

import pytest
import torch

from port_bench import files, model_flops, peaks
from port_bench.reference.model import capacity

CFG = {"num_hidden_layers": 2, "hidden_size": 8, "intermediate_size": 4,
       "num_attention_heads": 2, "num_key_value_heads": 1, "head_dim": 4,
       "vocab_size": 10, "num_local_experts": 4, "num_experts_per_tok": 2,
       "capacity_factor": 1.0, "min_capacity": 1}
DENSE = {k: v for k, v in CFG.items() if k not in ("num_local_experts", "num_experts_per_tok")}
BW, PEAK = peaks.HBM_BYTES_PER_S, peaks.BF16_FLOP_PER_S


def roof(name):
    return files.load_module("rooflines", name)


def test_bound_is_the_longer():
    assert peaks.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.bound_s(0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_paged():
    # 2 lanes of 3 and 5 keys, a third lane idle (1 key): 9 keys of K and V
    # (1 KV head x 4) and q/out of 3 lanes x 2 heads x 4, bf16; 2 layers
    nbytes = 2 * (2 * 9 * 1 * 4 + 2 * 3 * 2 * 4)
    flops = 4 * 2 * 4 * 9
    want = 2 * max(nbytes / BW, flops / PEAK)
    assert roof("paged").bound_s(CFG, 3, [3, 5]) == pytest.approx(want)


def test_flash():
    # S = 3: 6 visible pairs; q, out [3, 2, 4], k, v [3, 1, 4]
    nbytes = 2 * (2 * 3 * 2 * 4 + 2 * 3 * 1 * 4)
    flops = 4 * 2 * 4 * 6
    assert roof("flash").bound_s(CFG, 3) == pytest.approx(2 * max(nbytes / BW, flops / PEAK))


def test_moe_capacity_and_bound():
    assert capacity(4, CFG) == 2          # 4 tokens x 2 / 4 experts
    assert capacity(1, CFG) == 1
    assert capacity(3, dict(CFG, min_capacity=8)) == 6   # capped at T k
    E, C, D, F = 4, 2, 8, 4
    nbytes = 2 * (2 * (E * C * D + E * D * F + E * C * F) + (E * C * F + E * F * D + E * C * D))
    flops = 6 * E * C * D * F
    assert roof("moe_bmm").bound_s(CFG, 4) == pytest.approx(2 * max(nbytes / BW, flops / PEAK))


def test_layer_params():
    attn = 8 * 8 + 2 * 8 * 4 + 8 * 8
    assert model_flops.layer_params(DENSE) == attn + 3 * 8 * 4
    assert model_flops.layer_params(CFG) == attn + 8 * 4 + 2 * 3 * 8 * 4


def test_step_flops():
    # a prefill of 3 tokens and two decode lanes at 4 and 5 keys
    step = {"prefill": [3], "dec_ctx": [4, 5]}
    n = model_flops.layer_params(DENSE)
    want = 2 * (2 * n * 5 + 4 * 2 * 4 * (6 + 9)) + 2 * 8 * 10 * 3
    assert model_flops.step_flops(DENSE, step) == pytest.approx(want)


def obs(**kw):
    steps = [{"ts": 0.0, "te": 0.5, "tokens": 4, "prefill": [3], "dec_ctx": [4, 5], "batch": 3},
             {"ts": 0.5, "te": 0.75, "tokens": 2, "prefill": [], "dec_ctx": [5, 6], "batch": 3},
             {"ts": 0.75, "te": 1.0, "tokens": 2, "prefill": [], "dec_ctx": [6, 7], "batch": 3}]
    o = {"window_s": 1.0, "tokens": 8, "steps": steps, "cfg": DENSE,
         "family": files.family(DENSE), "kv_live": [0.5, 0.25],
         "ttft_ms": [float(i) for i in range(1, 21)], "itl_ms": [1.0] * 19 + [9.0],
         "admit_wait_ms": [2.0], "setup_s": 3.5, "profile": None, "slice_steps": steps}
    o.update(kw)
    return o


def read(name, o):
    return files.load_module("metrics", name).read(o)


def test_host_clock_readers():
    o = obs()
    assert read("gen_tok_s", o) == 8.0
    assert read("setup_s", o) == 3.5
    assert read("ttft_p95_ms.longprompt", o) == 19.0   # nearest rank: the 19th of 20
    assert read("ttft_p95_ms.chat", o) == 19.0
    assert read("itl_p95_ms.longprompt", o) == 1.0
    assert read("itl_p95_ms.chat", o) == 1.0
    assert read("admit_wait_p95_ms", o) == 2.0
    assert read("decode_step_ms", o) == pytest.approx(250.0)
    assert read("kv_live_share", o) == pytest.approx(37.5)


def test_mfu_readers():
    o = obs()
    total = sum(model_flops.step_flops(DENSE, s) for s in o["steps"])
    assert read("serve_mfu", o) == pytest.approx(100 * total / PEAK)


def test_device_readers():
    prof = {"slice_s": 2.0, "busy_s": 0.5, "bmm_s": 1e-6, "launches_per_decode_step": 40.0,
            "kernel_s": {"void paged_mma_kernel<1>": 1e-6, "paged_combine_kernel": 1e-6,
                         "flash_bf16_kernel": 2e-6, "other": 5.0}}
    o = obs(profile=prof, cfg=CFG)
    assert read("idle_share", o) == pytest.approx(75.0)
    assert read("launches_per_decode_step", o) == 40.0
    pb = sum(roof("paged").bound_s(CFG, s["batch"], s["dec_ctx"]) for s in o["steps"])
    assert read("paged_roofline", o) == pytest.approx(100 * pb / 2e-6)
    assert read("flash_roofline", o) == pytest.approx(100 * roof("flash").bound_s(CFG, 3) / 2e-6)
    mb = roof("moe_bmm").bound_s(CFG, 3) * 4
    assert read("moe_bmm_roofline", o) == pytest.approx(100 * mb / 1e-6)


def test_readers_say_nothing_without_a_trace():
    o = obs()
    for name in ("idle_share", "launches_per_decode_step", "paged_roofline",
                 "flash_roofline", "moe_bmm_roofline"):
        assert read(name, o) is None


def test_every_metric_has_its_reader():
    bench = files.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(files.load_module("metrics", m["name"]).read), m["name"]


def test_launches_are_counted_inside_decode_calls():
    from types import SimpleNamespace as NS

    from port_bench import profiled

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, s, t, dev=cpu):
        return NS(name=name, time_range=NS(start=s, end=t), device_type=dev)

    # one step: a prefill's 3 launches, then a decode call's 2 launches
    events = [ev(profiled.STEP, 0, 100), ev(profiled.DECODE, 50, 90),
              *[ev("cudaLaunchKernel", s, s + 1) for s in (10, 20, 30, 60, 70)],
              ev("kernel", 12, 40, cuda), ev("kernel", 62, 80, cuda)]
    prof = NS(events=lambda: events, key_averages=lambda: [])
    r = profiled.reduce(prof)
    assert r["decode_calls"] == 1 and r["launches_per_decode_step"] == 2
    assert r["busy_s"] == pytest.approx(46e-6) and r["slice_s"] == pytest.approx(100e-6)
