"""The serving loop's step spans and host-read counter in the port's obs
plane (``repro_torch.obs``), on the CPU: the spans' nesting and totals, the
hand-counted device->host reads of a scripted run, the off path (no
recorder, no profiler range), the ranges a ``torch.profiler`` sees, the
Perfetto export and the serve driver's trace file. Port only: nothing here imports JAX or the JAX package."""

import json
import re
import threading

import pytest
import torch

from repro_torch.fabric import Fabric, FabricConfig
from repro_torch.obs import FlightRecorder, MetricsHub, ObsConfig, perfetto_trace
from repro_torch.obs import stage_breakdown
from repro_torch.obs.recorder import (ADMIT_PREFILL, ADMIT_RING, ENGINE_ADMIT,
                                      ENGINE_DECODE, ENGINE_GROW, ENGINE_READ,
                                      ENGINE_RETIRE, ENGINE_STEP, FABRIC_STEP,
                                      HOST_READS, RANGE_PREFIX, SPAN, SPAN_PARENTS)
from repro_torch.serving import engine as engine_mod

PROMPTS = [[(7 * i + 3 * j) % 97 + 1 for j in range(5 + 3 * i)] for i in range(6)]


def open_fabric(obs=None, **kw):
    """The yi-6b smoke config on the CPU with device admission."""
    cfg = dict(arch="yi-6b", smoke=True, device_admission=True, max_batch=4,
               page_size=8, num_pages=64, max_seq=64, obs=obs)
    cfg.update(kw)
    return Fabric.open(FabricConfig(**cfg), device="cpu")


def serve(fab, prompts=PROMPTS, max_new=6):
    uids = [fab.submit(p, max_new_tokens=max_new) for p in prompts]
    steps = 0
    while not fab._group.idle():
        fab.step()
        steps += 1
        assert steps < 200
    done = fab._group.completed
    return {u: list(done[u].output) for u in uids}, steps


def spans(events):
    return [ev for ev in events if ev[1] == SPAN]


@pytest.fixture(scope="module")
def traced():
    """One served workload with spans on (every lifecycle traced), its
    forward calls counted."""
    calls = []
    real = engine_mod.paged_forward

    def counted(p, t, cfg, *rest):
        calls.append(tuple(t.shape))
        return real(p, t, cfg, *rest)

    engine_mod.paged_forward = counted
    try:
        fab = open_fabric(ObsConfig(trace_rate=1.0, ring_capacity=1 << 16))
        out, steps = serve(fab)
    finally:
        engine_mod.paged_forward = real
    events = fab.obs.events()
    totals = fab.obs.totals()
    fab.close()
    return {"out": out, "steps": steps, "events": events, "calls": calls,
            "totals": totals}


def test_recorder_attached_serves_the_same_tokens(traced):
    plain, steps = serve(open_fabric())
    assert traced["out"] == plain and traced["steps"] == steps
    assert all(len(v) == 6 for v in plain.values())


def test_every_step_has_one_fabric_and_one_engine_span(traced):
    sp = spans(traced["events"])
    by_sid = {ev[6].sid: ev for ev in sp}
    names = [ev[6].name for ev in sp]
    assert names.count(FABRIC_STEP) == names.count(ENGINE_STEP) == traced["steps"]
    for ev in sp:
        t0, info = ev[0], ev[6]
        assert t0 <= info.end and info.name in SPAN_PARENTS
        want = SPAN_PARENTS[info.name]
        if want is None:
            assert info.parent is None
            continue
        parent = by_sid[info.parent]
        assert parent[6].name == want
        assert parent[0] <= t0 and info.end <= parent[6].end
    # one engine.step in each fabric.step, and the phases in step order
    kids = {}
    for ev in sorted(sp, key=lambda ev: ev[0]):
        kids.setdefault(ev[6].parent, []).append(ev[6].name)
    for ev in sp:
        if ev[6].name == FABRIC_STEP:
            assert kids[ev[6].sid] == [ENGINE_STEP]
        elif ev[6].name == ENGINE_STEP:
            phases = kids[ev[6].sid]
            assert phases[:2] == [ENGINE_ADMIT, ENGINE_GROW]
            assert phases[2:] in ([], [ENGINE_DECODE, ENGINE_READ, ENGINE_RETIRE])
    t = traced["totals"]
    assert t["span_n"][ENGINE_STEP] == traced["steps"]
    assert t["span_s"][FABRIC_STEP] >= t["span_s"][ENGINE_STEP] > 0


def test_prefill_spans_match_the_prefill_calls_and_carry_the_request(traced):
    sp = spans(traced["events"])
    prefills = [ev for ev in sp if ev[6].name == ADMIT_PREFILL]
    assert len(prefills) == sum(s > 1 for _, s in traced["calls"]) == len(PROMPTS)
    assert sorted(ev[6].uid for ev in prefills) == sorted(traced["out"])
    # the lifecycle's lane_prefill of the same (class, seq) lies inside it
    lane = {(ev[2], ev[3]): ev[0] for ev in traced["events"] if ev[1] == "lane_prefill"}
    for t0, _, cls, seq, _, _, info in prefills:
        assert cls == "default" and t0 <= lane[(cls, seq)] <= info.end
    assert traced["totals"]["span_n"][ADMIT_PREFILL] == len(PROMPTS)


def test_host_reads_match_a_hand_count():
    """Three steps, two lanes, pages of 4. A (7 tokens) and B (5) take the
    lanes in step 1, C (6) waits in the ring's look-ahead buffer.
    Step 1: the ring's fused call (1); each prefill's page grab (the
    slot pool's read of ``valid`` and the engine's read of the ids, 2),
    paged_forward's read of seq_lens and the first token (2); the grow
    pass's read of seq_lens (1; lengths 7 and 5 cross no page); the
    decode's read (1): 1 + 8 + 1 + 1 = 11.
    Step 2: no free lane, no ring call; grow reads seq_lens (1) and A at
    8 crosses a page: free_pages (1) and a grab (2); decode (1); A and B
    finish: one read of seq_lens each (2): 7.
    Step 3: C comes from the buffer (no ring call); its prefill (4); grow
    (1); decode (1); C finishes (1): 7."""
    fab = open_fabric(ObsConfig(trace_rate=0.0), max_batch=2, page_size=4,
                      num_pages=32, max_seq=32)
    for prompt, n in (([3, 1, 4, 1, 5, 9, 2], 3), ([2, 7, 1, 8, 2], 3), ([1, 6, 1, 8, 0, 3], 2)):
        fab.submit(prompt, max_new_tokens=n)
    def reads():
        return sum(v for k, v in fab.obs.totals()["span_counters"].items()
                   if k[0] == HOST_READS)

    per_step = []
    for _ in range(3):
        before = reads()
        fab.step()
        per_step.append(reads() - before)
    assert fab._group.idle()
    assert per_step == [11, 7, 7]
    by_span = {k[1]: v for k, v in fab.obs.totals()["span_counters"].items()
               if k[0] == HOST_READS}
    assert by_span == {ADMIT_RING: 1, ADMIT_PREFILL: 12, ENGINE_GROW: 6,
                       ENGINE_READ: 3, ENGINE_RETIRE: 3}
    fab.close()


def test_no_recorder_calls_neither_recorder_nor_profiler(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called with no recorder attached")

    for name in ("span", "count", "emit", "_close"):
        monkeypatch.setattr(FlightRecorder, name, boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    fab = open_fabric()
    assert fab.obs is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out, _ = serve(fab, PROMPTS[:3], max_new=3)
    assert len(out) == 3
    fab.close()


def test_profiler_sees_the_spans_as_nested_ranges():
    fab = open_fabric(ObsConfig(trace_rate=0.0))
    for p in PROMPTS[:3]:
        fab.submit(p, max_new_tokens=3)
    fab.step()  # outside the profiler: spans without ranges
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fab.step()
        fab.step()
    ranges = [(e.time_range.start, e.time_range.end, e.name[len(RANGE_PREFIX):])
              for e in prof.events() if e.name.startswith(RANGE_PREFIX)]
    names = [r[2] for r in ranges]
    assert names.count(FABRIC_STEP) == names.count(ENGINE_STEP) == 2
    assert set(names) <= set(SPAN_PARENTS)
    for s, e, name in ranges:
        parent = SPAN_PARENTS[name]
        if parent is not None:
            assert any(ps <= s and e <= pe and pn == parent for ps, pe, pn in ranges)
    assert fab.obs.totals()["span_n"][FABRIC_STEP] == 3
    fab.close()


def test_perfetto_trace_draws_nested_span_slices(traced, tmp_path):
    path = tmp_path / "trace.json"
    perfetto_trace(traced["events"], path=str(path))
    trace = json.loads(path.read_text())
    slices = [e for e in trace["traceEvents"] if e["ph"] == "X" and "sid" in e["args"]]
    assert len(slices) == len(spans(traced["events"]))
    by_sid = {e["args"]["sid"]: e for e in slices}
    for e in slices:
        assert e["dur"] >= 0 and e["name"] in SPAN_PARENTS
        p = by_sid.get(e["args"]["parent"])
        if p is not None:
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-6
    # on each track the slices nest: sorted by start, each ends before the
    # enclosing open one does
    tracks = {}
    for e in slices:
        tracks.setdefault((e["pid"], e["tid"]), []).append(e)
    for track in tracks.values():
        stack = []
        for e in sorted(track, key=lambda e: (e["ts"], -e["dur"])):
            while stack and stack[-1] <= e["ts"]:
                stack.pop()
            end = e["ts"] + e["dur"]
            assert not stack or end <= stack[-1] + 1e-6
            stack.append(end)
    pre = [e for e in slices if e["name"] == ADMIT_PREFILL]
    assert all(e["cat"] == "default" and {"cls", "seq", "uid"} <= set(e["args"]) for e in pre)
    # the lifecycle chains and their breakdown are drawn as before
    chains = [e for e in trace["traceEvents"] if e["ph"] == "X" and "sid" not in e["args"]]
    assert {e["name"] for e in chains} >= {"submit", "lane_prefill", "complete"}
    assert "lane_prefill->decode" in stage_breakdown(traced["events"])


def test_spans_nest_across_recorders_and_not_across_threads():
    cfg = ObsConfig(trace_rate=0.0)
    outer, inner = FlightRecorder(cfg, rid=-1), FlightRecorder(cfg, rid=0)
    seen = {}

    def other():
        with inner.span(ENGINE_STEP) as sp:
            seen["parent"] = sp.parent

    with outer.span(FABRIC_STEP) as top:
        with inner.span(ENGINE_STEP) as mid:
            inner.count(HOST_READS, 2)
            t = threading.Thread(target=other)
            t.start()
            t.join()
        outer.count(HOST_READS)
    inner.count(HOST_READS)
    assert mid.parent == top.sid and seen["parent"] is None
    assert inner.span_counters == {(HOST_READS, ENGINE_STEP): 2, (HOST_READS, None): 1}
    assert outer.span_counters == {(HOST_READS, FABRIC_STEP): 1}
    assert inner.span_n == {ENGINE_STEP: 2} and outer.span_n == {FABRIC_STEP: 1}
    rec = [ev for ev in inner.events() if ev[6].sid == mid.sid][0]
    assert rec[1] == SPAN and rec[6].parent == top.sid


def test_span_totals_outlive_the_ring_and_leave_the_snapshot_alone():
    hub = MetricsHub(ObsConfig(trace_rate=0.0, ring_capacity=4))
    rec = hub.recorder(0)
    for _ in range(10):
        with rec.span(ENGINE_STEP):
            with rec.span(ENGINE_READ):
                rec.count(HOST_READS)
    assert len(rec.events()) == 4 and rec.dropped == 16
    t = hub.totals()
    assert t["span_n"] == {ENGINE_STEP: 10, ENGINE_READ: 10}
    assert t["span_counters"] == {(HOST_READS, ENGINE_READ): 10}
    # per-stage event totals (the stats view, Prometheus) count no spans
    assert hub.snapshot()["events_total"] == {} and rec.counts == {}
    with pytest.raises(ZeroDivisionError):  # a span closes on an exception too
        with rec.span(ENGINE_STEP):
            1 / 0
    assert hub.totals()["span_n"][ENGINE_STEP] == 11


def test_serve_driver_trace_holds_the_spans(tmp_path, capsys):
    from repro_torch.launch import serve

    path = tmp_path / "trace.json"
    serve.main(["--arch", "glm4-9b", "--smoke", "--device", "cpu", "--requests", "4",
                "--max-new", "3", "--device-admission", "--trace", str(path)])
    out = capsys.readouterr().out
    trace = json.loads(path.read_text())["traceEvents"]
    spans_ = [e for e in trace if "sid" in e["args"]]
    assert {FABRIC_STEP, ENGINE_STEP, ADMIT_PREFILL, ENGINE_DECODE} <= {e["name"] for e in spans_}
    # the printed count is the lifecycle and control events', as before
    n = int(re.search(r"flight-recorder trace: (\d+) events", out).group(1))
    assert n == len(trace) - len(spans_) > 0
