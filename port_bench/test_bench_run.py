"""The harness end to end on the CPU: a small cell of each configuration
through the same fabric, loop, metrics and judge as the chip's cells. A
sound run is correct; a run whose timed path is broken underneath, or the
control in a lower precision, is not."""

import itertools
import json
import subprocess
import sys

import pytest
import torch

from port_bench import files, harness, smoke

ARCHS = ["yi-6b", "granite-moe-3b-a800m"]
SEED = 2 ** 31 + 101


def run(cell, seed, trace=False, **kw):
    """One run of ``cell`` on the CPU, its loop timed by a clock that moves
    5 ms a reading: about a hundred steps, however loaded the machine."""
    ticks = itertools.count()
    return harness.run(cell, seed, 1.0, trace, device="cpu",
                       clock=lambda: 0.005 * next(ticks), **kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_sound_run_is_correct(arch):
    r = run(smoke.cell(arch), SEED)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"gen_tok_s", "setup_s"}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-2:] == ["checks", "readings"]  # checks last on the line


@pytest.mark.parametrize("arch", ARCHS)
def test_traced_run_reads_the_host_layers(arch):
    workload = "granite.chat" if "granite" in arch else "yi6b.longprompt"
    r = run(smoke.cell(arch, workload=workload), SEED + 1, trace=True)
    assert r["correct"], r["checks"]
    names = {m["name"] for m in files.cell_metrics(files.benchmark(), workload, "per_layer")}
    assert {"launches_per_decode_step", "kv_live_share", "serve_mfu"} <= set(r["metrics"]) <= names
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["altered_token", "stale_state"])
@pytest.mark.parametrize("arch", ARCHS)
def test_broken_timed_path_is_not_correct(arch, fault):
    r = run(smoke.cell(arch), SEED, fault=fault)
    assert not r["correct"]
    for name in ("max_logit_gap", "logit_err_p50"):
        assert r["checks"][name]["value"] > r["checks"][name]["limit"]


def test_a_token_changed_after_the_logits_is_not_correct(monkeypatch):
    # the served token is not the program's own best: the greedy check
    from repro_torch.serving import engine

    real = torch.argmax
    monkeypatch.setattr(engine.torch, "argmax",
                        lambda x, dim=None: (real(x, dim=dim) + 1) % x.shape[-1])
    r = run(smoke.cell("yi-6b"), SEED)
    assert not r["correct"] and r["checks"]["served_not_greedy"]["value"] > 0


@pytest.mark.parametrize("seed", [SEED, SEED + 7])
@pytest.mark.parametrize("arch", ARCHS)
def test_control_in_lower_precision_is_rejected(arch, seed):
    r = run(smoke.cell(arch), seed, control=True)
    assert r["correct"], r["checks"]
    rd, ck = r["readings"], r["checks"]
    assert rd["gap"] <= ck["max_logit_gap"]["limit"] < rd["control_gap"]
    assert rd["logit_err"] <= ck["logit_err_p50"]["limit"] < rd["control_logit_err"]


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, str(files.HERE / "run.py"), "--workload",
                        "yi6b.longprompt", "--seed", "1", "--seconds", "1"],
                       capture_output=True, text=True, cwd=files.ROOT, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


# the file as it is, and with each per-layer key of the family's
# expected_blocks written out for a stack of one kind: each layer's entry
# for that kind, and one that changes a layer
PER_LAYER = {"layer_types": ({"dense": "full_attention", "moe": "attention"},
                             {"dense": "mamba", "moe": "mamba"}),
             "mlp_layer_types": ({"dense": "dense", "moe": "sparse"},
                                 {"dense": "sparse", "moe": "dense"})}


@pytest.mark.parametrize("name,key", [
    pytest.param(c["name"], key, id=c["name"] if key is None else f"{c['name']}-{key}")
    for c in files.benchmark()["configs"] for key in (None, *PER_LAYER)])
def test_config_files_match_the_program(name, key):
    from repro_torch.configs import get_config

    cfg = files.load_json("configs", name)
    pc = get_config(cfg["arch"])
    if key is not None:
        fam, L = files.family(cfg), cfg["num_hidden_layers"]
        (kind,) = fam.expected_blocks(cfg)
        same, other = (entry[kind] for entry in PER_LAYER[key])
        cfg = dict(cfg, **{key: [same] * L})
        assert fam.expected_blocks(cfg) == (kind,) * L
        changed = dict(cfg, **{key: [same] * (L - 1) + [other]})
        assert any(m.startswith("block: ") for m in harness.config_mismatches(changed, pc))
    assert harness.config_mismatches(cfg, pc) == []
    assert harness.config_mismatches(dict(cfg, hidden_size=cfg["hidden_size"] + 1), pc)


def test_benchmark_file_finds_its_files():
    bench = files.benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        f = json.loads((files.ROOT / c["file"]).read_text())
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        wl = files.load_json("workloads", w["name"])
        assert (wl["config"], wl["traffic"], wl["why"]) == (w["config"], w["traffic"], w["why"])
        assert w["config"] in configs and len(w["why"]) <= 200
        files.load_json("traffic", w["traffic"])
        reported = {m["name"] for m in files.cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in reported and len(reported) >= 2
        for m in files.cell_metrics(bench, w["name"], "per_layer"):
            assert m["moves"] in e2e and m["moves"] in reported, (w["name"], m["name"])
