"""The step spans' readings (``spans.py``) on events and totals worked by
hand, and on the CPU's smoke cells through ``tools/step_spans.py``; the
benchmark's own runs attach no recorder."""

import importlib.util
import itertools
from types import SimpleNamespace as NS

import pytest
import torch

from port_bench import files, harness, profiled, smoke, spans

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SEED = 2 ** 31 + 211


def ev(name, s, t, dev=CPU, annotation=False):
    return NS(name=name, time_range=NS(start=s, end=t), device_type=dev,
              is_user_annotation=annotation)


def rng(name, s, t):
    return ev("repro." + name, s, t, annotation=True)


def prof(events):
    return NS(events=lambda: events, key_averages=lambda: [])


# one step of 100 us: admit 0-40 (a prefill 10-35 inside it), grow 40-45,
# decode 45-80, read 80-90, retire 90-96; kernels at 12-30 and 50-70 and
# 82-88; the device's own annotation of the decode range is no kernel
STEP = [ev(profiled.STEP, 0, 100), rng("fabric.step", 0, 100), rng("engine.step", 1, 99),
        rng("engine.admit", 2, 40), rng("admit.prefill", 10, 35), rng("engine.grow", 40, 45),
        rng("engine.decode", 45, 80), rng("engine.read", 80, 90), rng("engine.retire", 90, 96),
        ev("kernel", 12, 30, CUDA), ev("kernel", 50, 70, CUDA), ev("kernel", 82, 88, CUDA),
        ev("repro.engine.decode", 50, 70, CUDA, annotation=True)]


def test_idle_goes_to_the_innermost_range():
    r = spans.idle_by_span(prof(STEP))
    inner = {k: round(v * 1e6, 6) for k, v in r["innermost"].items()}
    assert inner == {"fabric.step": 2.0, "engine.step": 4.0, "engine.admit": 13.0,
                     "admit.prefill": 7.0, "engine.grow": 5.0, "engine.decode": 15.0,
                     "engine.read": 4.0, "engine.retire": 6.0}
    assert r["admit_s"] == pytest.approx(20e-6)     # the prefill's idle is admission's
    assert r["decode_s"] == pytest.approx(15e-6)
    assert r["other_s"] == pytest.approx(21e-6)
    assert r["slice_s"] == pytest.approx(100e-6) and r["idle_s"] == pytest.approx(56e-6)


@pytest.mark.parametrize("events", [
    STEP,
    # two steps; a range open across the slice's start, a kernel across
    # its end, time outside every range, overlapping kernels
    [ev(profiled.STEP, 10, 60), ev(profiled.STEP, 60, 130), rng("engine.step", 5, 58),
     rng("engine.decode", 20, 50), rng("engine.step", 62, 125), rng("engine.admit", 62, 90),
     rng("admit.ring", 63, 64), ev("kernel", 0, 15, CUDA), ev("kernel", 30, 45, CUDA),
     ev("kernel", 40, 52, CUDA), ev("kernel", 70, 140, CUDA)],
])
def test_the_three_idle_shares_partition_idle_share(events):
    p = prof(events)
    shares = spans.idle_shares(spans.idle_by_span(p))
    idle = files.load_module("metrics", "idle_share").read({"profile": profiled.reduce(p)})
    assert set(shares) == {"idle_admit_share", "idle_decode_share", "idle_other_share"}
    assert sum(shares.values()) == pytest.approx(idle)
    inner = spans.idle_by_span(p)["innermost"]
    assert sum(inner.values()) == pytest.approx(idle / 100 * spans.idle_by_span(p)["slice_s"])


def totals(admit_s, decode_s, steps, decodes, reads):
    return {"span_n": {"engine.step": steps, "engine.decode": decodes},
            "span_s": {"engine.admit": admit_s, "engine.decode": decode_s},
            "span_counters": {("host_reads", k): v for k, v in reads.items()}}


def test_window_readings_difference_the_totals():
    a = totals(1.0, 0.5, 10, 9, {"admit.prefill": 40, "engine.read": 9, "fabric.step": 3})
    b = totals(4.0, 0.9, 14, 13, {"admit.prefill": 52, "engine.read": 13, "fabric.step": 7,
                                  None: 5})
    m = spans.step_metrics(a, b)
    assert m["steps"] == 4
    assert m["admit_ms_per_step"] == pytest.approx(750.0)
    assert m["decode_enqueue_ms"] == pytest.approx(100.0)
    assert m["host_reads_per_step"] == pytest.approx(4.0)   # the engine's spans only
    assert m["reads_per_step"]["fabric.step"] == 1.0


def test_readings_are_none_without_spans():
    assert spans.step_metrics(None, None) is None
    assert spans.step_metrics(totals(0, 0, 3, 3, {}), totals(0, 0, 3, 3, {})) is None
    no_spans = [e for e in STEP if not e.name.startswith("repro.")]
    assert spans.idle_by_span(prof(no_spans)) is None
    assert spans.idle_shares(None) == {}


def tool():
    path = files.ROOT / "tools" / "step_spans.py"
    spec = importlib.util.spec_from_file_location("step_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-3b-a800m"])
def test_smoke_cell_with_spans_reports_the_step_readings(arch):
    ticks = itertools.count()
    r = tool().run(smoke.cell(arch), SEED, 0.5, slice_s=0.05, device="cpu",
                   clock=lambda: 0.005 * next(ticks))
    w = r["window"]
    assert w["steps"] == r["steps"] > 0
    assert w["admit_ms_per_step"] > 0 and w["decode_enqueue_ms"] > 0
    # at least the grow pass's and the decode's read each step
    assert w["host_reads_per_step"] >= 2
    assert sum(r[k] for k in ("idle_admit_share", "idle_decode_share",
                              "idle_other_share")) == pytest.approx(r["idle_share"])
    assert r["slice"]["steps"] > 0


def test_benchmark_runs_attach_no_recorder(monkeypatch):
    from repro_torch.obs import MetricsHub

    def boom(*a, **k):
        raise AssertionError("a recorder was attached")

    monkeypatch.setattr(MetricsHub, "__init__", boom)
    ticks = itertools.count()
    for trace in (False, True):
        r = harness.run(smoke.cell("yi-6b"), SEED, 0.3, trace, device="cpu",
                        clock=lambda: 0.005 * next(ticks))
        assert r["correct"], r["checks"]
    off = tool().run(smoke.cell("yi-6b"), SEED, 0.3, spans=False, slice_s=0, device="cpu",
                     clock=lambda: 0.005 * next(ticks))
    assert off["window"] is None and off["gen_tok_s"] > 0
