"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the metrics.

The window drives the user-facing entry of the port: a
``repro_torch.fabric.session.Fabric`` serving one engine replica group with
device admission on, built through its public constructor so the group
gets the harness's forward callable (``paged_forward`` itself, with a note
of each call's shape). Each step is ``Fabric.step``; it ends in the
engine's host read, so a token exists when the step that made it returns.

The configuration file names its model family (``families/<family>.py``;
``files.family``), through which the harness reaches the weights, the
plain reference, the model FLOPs, the config check and the MoE capacity.

Set-up: the kernel library (built into ``build/`` of the checkout at its
first run), the weights made on the device from the seed, the fabric, then
the clients' first requests and the steps until each has its lane. The
window then runs whole steps until ``seconds`` have passed; the clients
resubmit as their requests complete. With ``trace`` the window is followed
by a slice of ``trace_slice_s`` seconds of the same loop under
``torch.profiler``, so host-clock numbers never carry the profiler.
"""

from __future__ import annotations

import dataclasses
import gc
import inspect
import sys
import time
from typing import Callable, List, Optional

import torch

from port_bench import files, judge, profiled, traffic, weights
from port_bench.tails import median, percentile

# config-file key -> ModelConfig attribute of the port (a family adds its
# own keys, and overrides these, by its ``config_fields``)
PORT_FIELDS = {
    "num_hidden_layers": "num_layers", "hidden_size": "d_model",
    "num_attention_heads": "num_heads", "num_key_value_heads": "num_kv_heads",
    "head_dim": "resolved_head_dim", "vocab_size": "vocab_size",
    "rope_theta": "rope_theta", "tie_word_embeddings": "tie_embeddings",
    "torch_dtype": "dtype", "hidden_act": "act", "num_local_experts": "num_experts",
    "num_experts_per_tok": "num_experts_per_tok", "capacity_factor": "capacity_factor",
}


@dataclasses.dataclass
class Cell:
    name: str
    cfg: dict
    mix: dict
    engine: dict
    judge: dict
    trace_slice_s: float
    end_to_end: list
    per_layer: list
    port_cfg: object = None  # the program's config; None: get_config(cfg["arch"])
    family: object = None    # the family module; None: the one cfg names

    def __post_init__(self):
        if self.family is None:
            self.family = files.family(self.cfg)


def load_cell(name: str, bench: dict) -> Cell:
    wl = files.load_json("workloads", name)
    return Cell(name, files.load_json("configs", wl["config"]),
                files.load_json("traffic", wl["traffic"]), wl["engine"], wl["judge"],
                wl["trace_slice_s"], files.cell_metrics(bench, name, "end_to_end"),
                files.cell_metrics(bench, name, "per_layer"))


def per_layer(kinds, num_layers: int) -> tuple:
    """A period of block kinds repeated over ``num_layers`` layers (as it
    stands where the period does not divide them)."""
    kinds = tuple(kinds)
    return kinds * (num_layers // len(kinds)) if num_layers % len(kinds) == 0 else kinds


def config_mismatches(cfg: dict, pc, family=None) -> List[str]:
    """Where the program's config ``pc`` departs from the file's copy, by
    the keys of ``PORT_FIELDS``, the block kind of each layer that the
    family expects, and the family's own ``config_fields``."""
    from repro_torch.models import layers

    family = family or files.family(cfg)
    have = {k: getattr(pc, a) for k, a in PORT_FIELDS.items()}
    want = {k: cfg.get(k, 0 if k in ("num_local_experts", "num_experts_per_tok") else None)
            for k in PORT_FIELDS}
    want["block"] = per_layer(family.expected_blocks(cfg), pc.num_layers)
    have["block"] = per_layer(pc.block_pattern, pc.num_layers)
    want["norm"], have["norm"] = "rmsnorm", pc.norm
    want["rms_norm_eps"] = cfg["rms_norm_eps"]
    have["rms_norm_eps"] = inspect.signature(layers.rms_norm).parameters["eps"].default
    for k, (w, h) in family.config_fields(cfg, pc).items():
        want[k], have[k] = w, h
    return [f"{k}: file {want[k]!r}, program {have[k]!r}"
            for k in want if want[k] != have[k]]


def port_config(cfg: dict, family=None, pc=None):
    """The program's config of ``cfg`` (``get_config(arch)`` unless ``pc``
    is given), stopping the run where it departs from the file."""
    from repro_torch.configs import get_config

    pc = pc if pc is not None else get_config(cfg["arch"])
    bad = config_mismatches(cfg, pc, family)
    if bad:
        raise SystemExit("the program's config departs from "
                         f"the configuration file ({cfg['arch']}): " + "; ".join(bad))
    return pc


class Forward:
    """The group's forward callable: ``paged_forward(p, t, pc, *state)``
    with every state argument the engine gives (the KV pages, block
    tables, lengths, and whatever a family's serving path carries),
    returning its output whole. It notes each call's (batch, tokens) on
    the host and keeps on the device the top ``TOP`` values and ids a row
    of the output's first entry, the logits (no host read), which the
    judge compares with the reference's. ``fault`` breaks it for the
    harness's own test: ``"altered_token"`` shifts a decode call's logits
    by one vocab entry, ``"stale_state"`` runs the forward on clones of
    every state tensor and returns the originals, unwritten, in their
    place. With ``ranges`` set (the profiled slice) each decode call runs
    inside a ``pb.decode`` profiler range."""

    TOP = 8

    def __init__(self, pc, fault: Optional[str] = None):
        from repro_torch.serving.paged_model import paged_forward

        self.pc, self.fwd, self.fault = pc, paged_forward, fault
        self.calls: List[tuple] = []
        self.top: List[tuple] = []
        self.ranges = False

    def __call__(self, p, t, *state):
        self.calls.append(tuple(t.shape))
        if not (self.ranges and t.shape[1] == 1):
            return self._call(p, t, state)
        from torch.profiler import record_function

        with record_function(profiled.DECODE):
            return self._call(p, t, state)

    def _call(self, p, t, state):
        if self.fault == "stale_state":
            clones = [s.clone() if isinstance(s, torch.Tensor) else s for s in state]
            out = self.fwd(p, t, self.pc, *clones)
            unwritten = {id(c): s for c, s in zip(clones, state)}
            out = (out[0], *(unwritten.get(id(o), o) for o in out[1:]))
        else:
            out = self.fwd(p, t, self.pc, *state)
        if self.fault == "altered_token" and t.shape[1] == 1:
            out = (out[0].roll(1, dims=-1), *out[1:])
        self.top.append(torch.topk(out[0], self.TOP, dim=-1))
        return out


def build_fabric(cell: Cell, pc, params, fwd: Forward, device):
    from repro_torch.fabric.config import FabricConfig
    from repro_torch.fabric.session import Fabric
    from repro_torch.serving.engine import EngineReplicaGroup

    e = cell.engine
    geometry = dict(max_batch=e["max_batch"], page_size=e["page_size"],
                    num_pages=e["num_pages"], max_seq=e["max_seq"])
    config = FabricConfig(arch=cell.cfg["arch"], smoke=cell.port_cfg is not None,
                          kv_window=e["kv_window"], device_admission=True, **geometry)
    group = EngineReplicaGroup(pc, params, num_replicas=1, window=e["kv_window"],
                               forward_fn=fwd, device_admission=True, device=device,
                               **geometry)
    return Fabric(config, group=group, model_cfg=pc, params=params, device=device)


class Loop:
    """The closed loop around ``Fabric.step``, and the record of every
    request and step on the host clock."""

    def __init__(self, fabric, gen: traffic.ClosedLoop, fwd: Forward,
                 clock: Callable[[], float] = time.perf_counter):
        self.fabric, self.eng, self.gen, self.fwd, self.clock = (
            fabric, fabric.engines[0], gen, fwd, clock)
        self.reqs: dict = {}
        self.steps: List[dict] = []
        self.next_i = 0
        self.refused = 0
        self.kv_live: List[float] = []

    def submit(self, client: int) -> Optional[int]:
        prompt, n_out = self.gen.request(self.next_i)
        self.next_i += 1
        t = self.clock()
        uid = self.fabric.submit(prompt, max_new_tokens=n_out)
        if uid is None:
            self.refused += 1
            return None
        self.reqs[uid] = {"uid": uid, "client": client, "prompt": prompt,
                          "max_new": n_out, "t_submit": t, "lane": None, "seen": 0,
                          "t_first": None, "ts_first": None, "t_last": None,
                          "gaps": [], "t_done": None, "output": None, "preempted": False,
                          "src": []}
        return uid

    def _tokens(self, req, lane, ts: float, te: float, dec_call, admitted) -> int:
        """Stamp ``req``'s new tokens and note for each the forward call and
        row that made it: a decode token the decode call's row ``lane``; a
        first token a prefill call, matched after the step (``admitted``)."""
        rec = self.reqs.get(req.uid)
        if rec is None:
            return 0
        if lane is not None and rec["lane"] is None:
            rec["lane"] = lane
        if req.preemptions:
            rec["preempted"] = True
        new = len(req.output) - rec["seen"]
        if new <= 0:
            rec["seen"] = len(req.output)
            return 0
        if rec["seen"] == 0:
            rec["t_first"], rec["ts_first"] = te, ts
            admitted.append(rec)
            rec["src"].append(None)
        else:
            rec["gaps"].append((rec["t_last"], te))
        # a prefill and the same step's decode return two tokens at once
        rec["gaps"].extend([(te, te)] * (new - 1))
        rec["src"].extend([(dec_call, rec["lane"])] * (len(req.output) - len(rec["src"])))
        rec["t_last"], rec["seen"] = te, len(req.output)
        return new

    def _match_prefills(self, admitted: list, free: list, pre_calls: list, dec_call) -> None:
        """The engine takes admitted requests in FIFO (uid) order onto the
        lanes that were free, ascending, prefilling each as it goes: the
        j-th prefill call is the j-th admitted request's, on lane free[j].
        A step where the lanes seen disagree is left unmatched (those
        requests are not judged)."""
        admitted = sorted(admitted, key=lambda r: r["uid"])
        if len(admitted) != len(pre_calls) or len(admitted) > len(free) or any(
                r["lane"] not in (None, free[j]) for j, r in enumerate(admitted)):
            return
        for j, rec in enumerate(admitted):
            rec["lane"] = free[j]
            rec["src"] = [(pre_calls[j], 0)] + [(dec_call, free[j])] * (len(rec["src"]) - 1)

    def step(self, sample_kv: bool = False) -> dict:
        k = len(self.fwd.calls)
        free = [i for i, r in enumerate(self.eng.active) if r is None]
        ts = self.clock()
        done = self.fabric.step()
        te = self.clock()
        calls = self.fwd.calls[k:]
        # the engine prefills each admitted request with a [1, S] call, then
        # decodes every lane in one [max_batch, 1] call
        dec_call = (k + len(calls) - 1 if calls and calls[-1] == (self.eng.max_batch, 1)
                    else None)
        pre_calls = [k + j for j in range(len(calls)) if k + j != dec_call]
        tokens, ctx, admitted = 0, [], []
        for lane, req in enumerate(self.eng.active):
            if req is not None:
                tokens += self._tokens(req, lane, ts, te, dec_call, admitted)
                ctx.append(len(req.prompt) + len(req.output) - 1)
        for req in done:
            tokens += self._tokens(req, None, ts, te, dec_call, admitted)
            ctx.append(len(req.prompt) + len(req.output) - 1)
        self._match_prefills(admitted, free, pre_calls, dec_call)
        for req in done:
            rec = self.reqs.get(req.uid)
            if rec is not None:
                rec["t_done"], rec["output"] = te, list(req.output)
                self.submit(rec["client"])
        rec = {"ts": ts, "te": te, "tokens": tokens,
               "prefill": [calls[c - k][1] for c in pre_calls],
               "dec_ctx": ctx if dec_call is not None else [],
               "batch": calls[-1][0] if dec_call is not None else 0}
        self.steps.append(rec)
        if sample_kv:
            self.kv_live.append(self.eng.pool.live_pages() / self.eng.pool.num_pages)
        return rec

    def ramp(self, max_steps: int = 64) -> None:
        """The clients' first requests, then steps until each has had its
        lane and first token: the loop is full (a lane that frees in a step
        takes the next request in the step after)."""
        first = [self.submit(c) for c in range(self.gen.clients)]
        for _ in range(max_steps):
            self.step()
            if all(self.reqs[u]["t_first"] is not None for u in first if u is not None):
                return
        raise RuntimeError(f"first requests still waiting after {max_steps} ramp steps")

    def window(self, seconds: float, sample_kv: bool) -> None:
        self.t0 = self.clock()
        self.first = len(self.steps)
        while True:
            rec = self.step(sample_kv)
            if rec["te"] - self.t0 >= seconds:
                break
        self.t_end, self.last = rec["te"], len(self.steps)

    def profile(self, seconds: float, cuda: bool) -> dict:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        mark = len(self.steps)
        self.fwd.ranges = True
        with profile(activities=acts) as prof:
            t = self.clock()
            while True:
                with record_function(profiled.STEP):
                    self.step()
                if self.clock() - t >= seconds:
                    break
            if cuda:
                torch.cuda.synchronize()
        self.fwd.ranges = False
        self.slice_steps = self.steps[mark:]
        return profiled.reduce(prof)

    def observations(self) -> dict:
        """What the metric readers read: the window's steps, tokens, and
        each request's first token, gaps and admission wait (ms)."""
        t0, t1 = self.t0, self.t_end
        steps = self.steps[self.first:self.last]
        ttft, itl, wait = [], [], []
        for r in self.reqs.values():
            if r["t_first"] is not None and t0 < r["t_first"] <= t1:
                ttft.append((r["t_first"] - r["t_submit"]) * 1e3)
                wait.append((r["ts_first"] - r["t_submit"]) * 1e3)
            itl.extend((b - a) * 1e3 for a, b in r["gaps"] if a >= t0 and b <= t1)
        return {"window_s": t1 - t0, "tokens": sum(s["tokens"] for s in steps),
                "steps": steps, "ttft_ms": ttft, "itl_ms": itl, "admit_wait_ms": wait,
                "kv_live": self.kv_live, "refused": self.refused,
                "preempted": sum(r["preempted"] for r in self.reqs.values())}

    def finished(self) -> List[dict]:
        """Requests that completed inside the window, never preempted."""
        return [r for r in self.reqs.values()
                if r["t_done"] is not None and self.t0 < r["t_done"] <= self.t_end
                and not r["preempted"] and None not in r["src"]
                and all(row is not None for _, row in r["src"])]

    def program_top(self, rec: dict) -> tuple:
        """The program's top logits (values, ids) [served, TOP] at each of
        ``rec``'s served tokens."""
        vals = torch.stack([self.fwd.top[c].values[row] for c, row in rec["src"]])
        ids = torch.stack([self.fwd.top[c].indices[row] for c, row in rec["src"]])
        return vals, ids


def judged(cell: Cell, loop: Loop, seed: int) -> tuple:
    """The sample to compare, and the decode capacity of the MoE's steps.

    An MoE decode step gives each expert ``capacity(max_batch)`` slots,
    claimed in lane order, and a lane's claims meet at most one of each
    earlier lane's on an expert; so a request that held a lane below the
    capacity had every decode claim kept, whatever its batch-mates routed,
    and only such requests are judged (the prefill is the request's own
    call). Without expert slots (the family's capacity 0) lanes do not
    interact."""
    fin = loop.finished()
    cap = cell.family.capacity(cell.engine["max_batch"], cell.cfg)
    if cap:
        fin = [r for r in fin if r["lane"] is not None and r["lane"] < cap]
    return judge.pick(fin, seed, cell.judge), cap


def compare(cell: Cell, params, sample: List[dict], tops: List[tuple], cap: int, device,
            control: bool = False) -> dict:
    """The readings of the judged requests against the reference (and with
    ``control`` the control's at the same positions)."""
    fam = cell.family
    seqs = judge.sequences(sample, cell.cfg, fam, cap)
    ref_logits = fam.logits(params, cell.cfg, seqs, device=device)
    tops = [(v.to(device), i.to(device)) for v, i in tops]
    out = {"gap": judge.served_gap(ref_logits, sample),
           "logit_err": judge.logit_err(ref_logits, tops),
           "not_greedy": judge.not_greedy(sample, tops),
           "requests": len(sample), "tokens": sum(len(r["output"]) for r in sample),
           "in_vocab": all(0 <= t < cell.cfg["vocab_size"]
                           for r in sample for t in r["output"])}
    if control:
        ctl = fam.logits(params, cell.cfg, seqs, low=fam.control_precision(cell.cfg),
                         device=device)
        out["control_gap"] = judge.control_gap(ref_logits, ctl)
        out["control_logit_err"] = judge.logit_err(
            ref_logits, [torch.topk(c, Forward.TOP, dim=-1) for c in ctl])
    return out


def verdict(limits: dict, readings: Optional[dict], n_judged: int) -> tuple:
    """(correct, checks): every compared number beside its limit. A limit
    of None: the number is read and shown, not compared."""
    r = readings or {}
    checks = {
        "max_logit_gap": {"value": r.get("gap"), "limit": limits["max_logit_gap"]},
        "logit_err_p50": {"value": r.get("logit_err"), "limit": limits["logit_err_p50"]},
        "served_not_greedy": {"value": r.get("not_greedy"), "limit": 0},
        "served_in_vocab": {"value": r.get("in_vocab"), "limit": True},
        "judged_requests": {"value": n_judged, "min": 1},
    }
    ok = bool(readings) and n_judged >= 1 and r["in_vocab"] and r["not_greedy"] == 0
    for name, key in (("max_logit_gap", "gap"), ("logit_err_p50", "logit_err")):
        if limits[name] is not None:
            ok = ok and r[key] <= limits[name]
    return ok, checks


def read_metrics(entries: list, obs: dict) -> dict:
    out = {}
    for m in entries:
        v = files.load_module("metrics", m["name"]).read(obs)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
        t_start: Optional[float] = None, fault: Optional[str] = None,
        control: bool = False, clock: Callable[[], float] = time.perf_counter) -> dict:
    """One run; returns the result line's object (and ``compare``'s
    readings under ``"readings"``). ``clock`` times the loop: a test's
    clock that ticks a fixed amount a reading gives a fixed number of
    steps on a slow machine as on a fast one."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False  # the reference's float32 stays float32
    torch.backends.cudnn.allow_tf32 = False
    pc = port_config(cell.cfg, cell.family, cell.port_cfg)
    if cuda:
        from repro_torch.kernels import _build

        _build.lib()
    params = cell.family.make_weights(cell.cfg, seed, device)
    params_digest = weights.digest(params)
    fwd = Forward(pc, fault)
    fabric = build_fabric(cell, pc, params, fwd, device)
    gen = traffic.ClosedLoop(cell.mix, cell.cfg["vocab_size"], seed)
    loop = Loop(fabric, gen, fwd, clock)
    loop.ramp()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"[setup] {cell.name}: {cell.cfg['arch']}, {weights.nbytes(params) / 1e9:.3f} GB "
        f"of weights (digest {params_digest}), {gen.clients} clients, "
        f"{len(loop.steps)} ramp steps, {setup_s:.3f} s")
    loop.window(seconds, sample_kv=trace)
    obs = loop.observations()
    obs.update(setup_s=setup_s, cfg=cell.cfg, family=cell.family, engine=cell.engine,
               profile=None)
    prof = loop.profile(cell.trace_slice_s, cuda) if trace else None
    if prof is not None:
        obs.update(profile=prof, slice_steps=loop.slice_steps)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    sample, cap = judged(cell, loop, seed)
    tops = [loop.program_top(r) for r in sample]
    fwd.top = []
    n_steps, n_pre = len(obs["steps"]), sum(bool(s["prefill"]) for s in obs["steps"])
    log(f"[window] {obs['window_s']:.3f} s, {n_steps} steps ({n_pre} with a prefill), "
        f"{obs['tokens']} tokens, {len(loop.finished())} requests finished, "
        f"{obs['refused']} refused, {obs['preempted']} preempted")
    for name in ("ttft_ms", "itl_ms", "admit_wait_ms"):
        vals = obs[name]
        log(f"[tail] {name}: n {len(vals)}, median {median(vals)}, p95 {percentile(vals, 95)}")
    # the program's state goes before the reference runs
    fabric.close(final_checkpoint=False)
    del fabric, loop.fabric, loop.eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = compare(cell, params, sample, tops, cap, device, control) if sample else None
    if cuda:
        torch.cuda.synchronize()
    correct, checks = verdict(cell.judge, readings, len(sample))
    log(f"[reference] {len(sample)} requests, "
        f"{readings['tokens'] if readings else 0} served tokens, "
        f"{time.perf_counter() - t_ref:.3f} s")
    entries = cell.per_layer if trace else cell.end_to_end
    result = {"correct": correct,
              "attempted": sum(1 for r in loop.reqs.values()
                               if r["t_submit"] <= loop.t_end
                               and (r["t_done"] is None or r["t_done"] > loop.t0)),
              "failed": obs["refused"],
              "metrics": read_metrics(entries, obs),
              "device": device_info(cuda, peak, prof)}
    if prof is not None:
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    result["readings"] = readings
    return result


def device_info(cuda: bool, peak: int, prof: Optional[dict]) -> dict:
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if prof is not None:
        out.update(busy_s=prof["busy_s"], window_s=prof["slice_s"])
    return out
