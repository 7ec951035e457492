"""Serving driver: the whole system — class queues, scheduler replicas,
engine group, transport, checkpoint cadence, obs plane, autoscaler — stood
up through one declarative `FabricConfig` and driven through one `Fabric`
session (DESIGN.md §10-11, §14). The engines run on the card (``--device
cuda``, the default) or, with ``--device cpu``, on the CPU through the
kernels' plain versions; every other flag is the JAX package's driver's.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \\
      --requests 8 --max-new 8

  # the same on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \\
      --device cpu --requests 8 --max-new 8

  # 3-class mixed traffic (interactive/batch/background) under a policy:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \\
      --multitenant --policy wfq --requests 9

  # 2 steal-rebalanced engine replicas, frontier checkpoint every 8 steps:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \\
      --multitenant --replicas 2 --checkpoint-dir /tmp/serve_ckpt \\
      --checkpoint-every 8

  # 4 replicas over 2 simulated hosts (host-addressed seats, serialized
  # wire envelopes), self-asserting delivery equality vs one host:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \\
      --replicas 4 --hosts 2 --verify-single-host

  # ten-thousand-tenant fabric (DESIGN.md §16): 2000 declared tenants
  # hashed onto 32 class groups, heavy-tailed traffic, per-tenant FIFO
  # order asserted identical across host layouts:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \\
      --tenants 2000 --replicas 2 --hosts 2 --verify-single-host

  # closed-loop autoscaling (DESIGN.md §14): start at 1 replica, let the
  # controller grow toward --max-replicas under load ('--autoscale
  # dry-run' records decisions without actuating):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch glm4-9b --smoke \\
      --replicas 1 --max-replicas 4 --autoscale --requests 16

Flag conventions: optional-value flags follow ``--flag [value]`` —
``--policy [strict|wfq|fifo]`` (bare = wfq), ``--device-admission
[true|false|auto]`` (bare = true), ``--trace [PATH]`` (bare =
reports/trace.json), ``--autoscale [dry-run]`` (bare = actuating).
``--dry-run`` prints the resolved FabricConfig JSON and exits.
"""

from __future__ import annotations

import argparse
import json
import time

TENANTS = ("interactive", "batch", "background")


def config_from_args(args) -> "FabricConfig":  # noqa: F821
    """Flags -> one validated FabricConfig. Conflicting combinations that
    the old hand-wired driver accepted silently (a cross-class --policy
    without --multitenant, a checkpoint cadence with nowhere to write,
    --checkpoint-dir shadowing --ckpt-dir, --hosts without enough replicas)
    raise FabricConfigError with the fix spelled out."""
    from repro_torch.fabric import (ClassSpec, FabricConfig, FabricConfigError,
                              TenantSpec, tiered_classes)
    tenants = None
    if getattr(args, "tenants", None):
        if args.multitenant:
            raise FabricConfigError(
                "--tenants and --multitenant are exclusive: --tenants "
                "derives its own group x tier class grid")
        tenants = TenantSpec(num_tenants=args.tenants,
                             num_groups=getattr(args, "tenant_groups", 32),
                             page_quota=getattr(args, "tenant_quota", None))
    classes = tiered_classes() if args.multitenant else (ClassSpec("default"),)
    hosts = getattr(args, "hosts", 1)
    transport = getattr(args, "transport", "auto")
    if transport == "auto":
        transport = "sim" if hosts > 1 else "local"
    obs = None
    if (getattr(args, "trace", None) or getattr(args, "metrics_out", None)
            or getattr(args, "stats_interval", None)):
        from repro_torch.obs import ObsConfig
        obs = ObsConfig(trace_rate=getattr(args, "trace_rate", 0.01))
    control = None
    autoscale = getattr(args, "autoscale", False)
    max_replicas = getattr(args, "max_replicas", None)
    if autoscale:
        from repro_torch.control import ControlConfig
        control = ControlConfig(dry_run=(autoscale == "dry-run"))
        if obs is None:  # the controller's sensor input (config.validate
            from repro_torch.obs import ObsConfig  # enforces obs-with-control)
            obs = ObsConfig(trace_rate=0.0)
        if max_replicas is None:  # headroom for the loop to grow into
            max_replicas = max(args.replicas * 2, hosts)
    return FabricConfig(
        obs=obs, control=control,
        classes=classes, tenants=tenants,
        replicas=args.replicas, max_replicas=max_replicas,
        policy=args.policy,
        hosts=hosts, transport=transport,
        transport_drop=getattr(args, "transport_drop", 0.0),
        transport_delay=getattr(args, "transport_delay", 0.0),
        transport_rtt_ms=getattr(args, "transport_rtt_ms", 0.0),
        transport_credit=getattr(args, "credit", 4),
        arch=args.arch, smoke=args.smoke, params_dir=args.ckpt_dir,
        max_batch=args.max_batch, page_size=args.page_size,
        num_pages=args.num_pages, max_seq=256, kv_window=args.window,
        device_admission=getattr(args, "device_admission", False),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every_n_steps=args.checkpoint_every)


def tenant_of_request(i: int, num_tenants: int) -> int:
    """Deterministic heavy-tailed tenant popularity: hash the request index
    to a log-uniform draw over [0, T) — a handful of tenants get most of
    the traffic, the long tail gets a trickle, and the mapping is identical
    across host layouts (no RNG state to diverge)."""
    h = (i * 2654435761) & 0xFFFFFFFF  # Knuth multiplicative hash
    u = h / 2 ** 32
    return int(num_tenants ** u) - 1 if num_tenants > 1 else 0


def run_workload(fab, args):
    """Submit the flag-shaped request wave and drain it, recording the
    *completion order* (the delivery-order signal --verify-single-host
    compares across host layouts). All requests are submitted before any
    step runs, so admission decisions (including tenant sheds) are
    layout-independent."""
    uids, tenant_of = [], {}
    num_tenants = getattr(args, "tenants", None)
    for i in range(args.requests):
        plen = 3 + i % 5
        prompt = [(7 * i + j) % (fab.model_cfg.vocab_size - 1) + 1
                  for j in range(plen)]
        if num_tenants:
            tid = tenant_of_request(i, num_tenants)
            uid = fab.submit(prompt, max_new_tokens=args.max_new,
                             tenant=f"t{tid}", tier=TENANTS[i % 3])
            label = f"t{tid}"
        else:
            qclass = TENANTS[i % 3] if args.multitenant else None
            uid = fab.submit(prompt, max_new_tokens=args.max_new,
                             qclass=qclass)
            label = qclass or "default"
        if uid is not None:
            uids.append(uid)
            tenant_of[uid] = label
    order = []
    interval = getattr(args, "stats_interval", None)
    for step in range(1, 2001):
        order.extend(r.uid for r in fab.step())
        if interval and step % interval == 0:
            from repro_torch.obs import format_class_lines
            for line in format_class_lines(fab.stats_view(),
                                           prefix=f"[serve] step {step}"):
                print(line)
        if fab.idle():
            break
    done = dict(fab.completed)
    return uids, tenant_of, done, order


def _free_device_memory(device) -> None:
    """Return a closed fabric's weights and pages to the device before the
    next one is made."""
    import gc

    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def verify_single_host(args, config) -> dict:
    """Run the identical workload under the multi-host layout and under one
    host, and assert the runs are indistinguishable to every tenant: same
    admitted requests, token-identical outputs, and the same per-class
    completion order (the host split is a transparent implementation
    detail of the seat protocol — exactly the tentpole claim). With
    --autoscale, the controller runs in both layouts: per-class delivery
    order must be controller-invariant too (resize preserves seat order).
    Each layout's fabric is closed and its weights freed before the next
    is opened. Returns {"layouts": each layout's (uids, tenant_of, done,
    order), "steps": each layout's fabric steps}."""
    import dataclasses
    from repro_torch.fabric import Fabric
    # Throwaway self-test runs: never write (or resume) the user's real
    # frontier checkpoints with the synthetic verify workload.
    config = dataclasses.replace(config, checkpoint_dir=None,
                                 checkpoint_every_n_steps=None)
    if config.tenants is not None:
        # Pin the quota ledger's host-cap split to the multi-host layout so
        # quota admission decisions are identical in both runs (otherwise
        # hosts=1 pools the whole budget and can admit what hosts=N sheds).
        config = dataclasses.replace(
            config, tenants=dataclasses.replace(
                config.tenants, quota_hosts=config.hosts))
    runs, steps = {}, {}
    for label, cfg in (("multi", config),
                       ("single", dataclasses.replace(
                           config, hosts=1, transport="local",
                           transport_drop=0.0, transport_delay=0.0,
                           transport_reorder=False, transport_rtt_ms=0.0))):
        fab = Fabric.open(cfg, device=args.device)
        uids, tenant_of, done, order = run_workload(fab, args)
        runs[label] = (uids, tenant_of, done, order)
        steps[label] = fab.step_count
        view = fab.stats_view()
        line = (f"[serve] verify[{label}]: hosts={cfg.hosts} "
                f"replicas={fab.num_replicas} completed={len(done)} "
                f"transport={view.transport['kind']}")
        if view.control and view.control.get("enabled"):
            line += (f" control_decisions={view.control['decisions']}"
                     f" resizes={view.resizes}")
        print(line)
        fab.close(final_checkpoint=False)
        del fab, view
        _free_device_memory(args.device)
    (u_m, t_m, d_m, o_m), (u_s, t_s, d_s, o_s) = runs["multi"], runs["single"]
    assert u_m == u_s, "admitted request sets diverged across host layouts"
    assert set(d_m) == set(d_s), (
        f"completion sets diverged: multi-only="
    f"{sorted(set(d_m) - set(d_s))} single-only={sorted(set(d_s) - set(d_m))}")
    for u in d_m:
        assert d_m[u].output == d_s[u].output, (
            f"req {u}: outputs diverged across host layouts")
    for name in set(t_m.values()):
        o_mc = [u for u in o_m if t_m[u] == name]
        o_sc = [u for u in o_s if t_s[u] == name]
        assert o_mc == o_sc, (
            f"class {name}: completion order diverged "
            f"(multi={o_mc}, single={o_sc})")
    print(f"[serve] verify-single-host PASS: {len(d_m)} requests, "
          f"per-class delivery order identical at hosts={config.hosts} "
          f"vs hosts=1")
    return {"layouts": runs, "steps": steps}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="CMP serving fabric driver (one FabricConfig in, one "
                    "Fabric session out)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the resolved FabricConfig JSON and exit "
                         "without opening a fabric")

    model = ap.add_argument_group("model")
    model.add_argument("--arch", default="glm4-9b")
    model.add_argument("--smoke", action="store_true")
    model.add_argument("--ckpt-dir", default=None,
                       help="model-params checkpoint to restore weights "
                            "from")
    model.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the engines, KV pages and weights live: "
                            "the card (CUDA kernels) or the CPU (their plain "
                            "PyTorch versions)")

    work = ap.add_argument_group("workload")
    work.add_argument("--requests", type=int, default=8)
    work.add_argument("--max-new", type=int, default=8)
    work.add_argument("--multitenant", action="store_true",
                      help="3 priority classes (interactive/batch/"
                           "background) instead of one FIFO queue")
    work.add_argument("--tenants", type=int, default=None, metavar="N",
                      help="tenant fabric: declare N tenants hashed onto "
                           "--tenant-groups class groups (3 tiers each, "
                           "hierarchical drain, O(active) cost); requests "
                           "get heavy-tailed tenant popularity and "
                           "--verify-single-host checks per-tenant FIFO "
                           "order")
    work.add_argument("--tenant-groups", type=int, default=32, metavar="G",
                      help="class groups the tenant hash space maps onto "
                           "(with --tenants; default 32)")
    work.add_argument("--tenant-quota", type=int, default=None, metavar="P",
                      help="per-tenant KV page quota (with --tenants); "
                           "over-quota admissions are denied, lowest tier "
                           "counts them as 429-style sheds")
    work.add_argument("--verify-single-host", action="store_true",
                      help="run the workload under --hosts N and under one "
                           "host and assert identical per-class delivery "
                           "order and token-identical outputs (self-test; "
                           "skips checkpoint resume)")

    fabric = ap.add_argument_group("fabric")
    fabric.add_argument("--replicas", type=int, default=1,
                        help="N steal-rebalanced engine replicas (live-"
                             "resized to this count when resuming a "
                             "checkpoint)")
    fabric.add_argument("--max-replicas", type=int, default=None,
                        help="live-resize ceiling (seats are provisioned "
                             "at open); defaults to --replicas, or 2x with "
                             "--autoscale")
    fabric.add_argument("--hosts", type=int, default=1,
                        help="spread the replicas over N simulated hosts "
                             "(host-addressed seats over the sim "
                             "transport; 1 = in-process local transport)")
    fabric.add_argument("--transport", default="auto",
                        choices=("auto", "local", "sim", "wire"),
                        help="seat transport: 'sim' = in-process simulated "
                             "hosts, 'wire' = real per-host worker "
                             "processes over localhost TCP (DESIGN.md "
                             "§15); 'auto' picks sim when --hosts > 1 "
                             "else local")
    fabric.add_argument("--transport-drop", type=float, default=0.0,
                        metavar="P",
                        help="chaos: drop each remote data-plane message "
                             "with probability P before it changes state "
                             "(sim and wire transports)")
    fabric.add_argument("--transport-delay", type=float, default=0.0,
                        metavar="P",
                        help="chaos: park each remote fetch batch with "
                             "probability P until the next quiesce")
    fabric.add_argument("--transport-rtt-ms", type=float, default=0.0,
                        help="inject a deterministic per-op round-trip "
                             "time in milliseconds (sim: sleeps per op; "
                             "wire: server delays responses, so "
                             "pipelined fetches overlap the RTT)")
    fabric.add_argument("--credit", type=int, default=4,
                        help="wire transport prefetch credit: fetches "
                             "kept in flight per (class, shard); 1 = "
                             "synchronous request/response")
    fabric.add_argument("--policy", nargs="?", const="wfq", default="strict",
                        choices=("strict", "wfq", "fifo", "hier"),
                        help="cross-class drain policy (with "
                             "--multitenant/--tenants); bare --policy = "
                             "wfq; --tenants defaults to hier (WFQ across "
                             "groups, strict within)")
    fabric.add_argument("--device-admission", dest="device_admission",
                        nargs="?", const=True, default=False,
                        type=lambda s: {"true": True, "false": False,
                                        "auto": "auto"}[s.lower()],
                        help="route engine admission through the device-"
                             "resident CMP ring (DESIGN.md §12): bare flag "
                             "forces the ring, 'auto' uses it only when a "
                             "CUDA device is present, 'false' keeps the "
                             "host path")

    engine = ap.add_argument_group("engine geometry")
    engine.add_argument("--max-batch", type=int, default=4)
    engine.add_argument("--page-size", type=int, default=16)
    engine.add_argument("--num-pages", type=int, default=128)
    engine.add_argument("--window", type=int, default=4)

    auto = ap.add_argument_group("autoscale (DESIGN.md §14)")
    auto.add_argument("--autoscale", nargs="?", const=True, default=False,
                      metavar="dry-run",
                      help="arm the closed-loop controller inside "
                           "Fabric.step (grow/shrink replicas toward "
                           "--max-replicas on backlog + SLO headroom); "
                           "'--autoscale dry-run' records decisions "
                           "without actuating")

    ckpt = ap.add_argument_group("checkpoint")
    ckpt.add_argument("--checkpoint-dir", default=None,
                      help="frontier-checkpoint directory: resumes every "
                           "tenant at its exact FIFO seat if a snapshot "
                           "exists; one is written at close")
    ckpt.add_argument("--checkpoint-every", type=int, default=None,
                      help="also write a frontier snapshot every N engine "
                           "steps (bounded in-loop recovery point)")

    obs = ap.add_argument_group("observability")
    obs.add_argument("--trace", nargs="?", const="reports/trace.json",
                     default=None, metavar="PATH",
                     help="enable the flight recorder and write a Chrome/"
                          "Perfetto trace.json after the run: the sampled "
                          "request lifecycles and every engine step's phase "
                          "spans (bare flag = reports/trace.json; load at "
                          "ui.perfetto.dev)")
    obs.add_argument("--trace-rate", type=float, default=0.01,
                     help="head-sampling rate for lifecycle tracing "
                          "(1.0 = every envelope; default 0.01)")
    obs.add_argument("--metrics-out", default=None, metavar="PATH",
                     help="write Prometheus text exposition of the final "
                          "fabric stats to PATH")
    obs.add_argument("--stats-interval", type=int, default=None, metavar="N",
                     help="print a per-class stats line every N fabric "
                          "steps")
    return ap


def main(argv=None) -> dict:
    """Run the driver on ``argv`` (the command line when None). Returns
    what the run served: with --verify-single-host, verify_single_host's
    result; otherwise the run's (uids, tenant_of, done, order) under "run"
    and the fabric's step count under "steps"."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.autoscale not in (False, True, "dry-run"):
        ap.error(f"--autoscale takes no value or 'dry-run' "
                 f"(got {args.autoscale!r})")
    if args.verify_single_host and args.hosts < 2:
        ap.error("--verify-single-host compares a multi-host layout "
                 "against one host; it needs --hosts >= 2 (with --hosts 1 "
                 "both runs would be identical and the PASS vacuous)")
    from repro_torch.fabric import Fabric, FabricConfigError
    try:
        config = config_from_args(args)
    except FabricConfigError as e:
        ap.error(str(e))

    if args.dry_run:
        print(json.dumps(config.to_json(), indent=2, sort_keys=True))
        return {}

    if args.verify_single_host:
        return verify_single_host(args, config)

    from repro_torch.checkpoint.checkpointer import latest_step
    fab = None
    if args.checkpoint_dir and latest_step(args.checkpoint_dir) is not None:
        # The seat structure (classes/shards/replica count) comes from the
        # snapshot; knobs that rebuild fresh on restore keep following the
        # flags, as the pre-fabric driver did — including the transport and
        # host layout (seat owners re-address by replica on restore).
        overrides = dict(policy=config.policy, kv_window=config.kv_window,
                         max_batch=config.max_batch,
                         page_size=config.page_size,
                         num_pages=config.num_pages,
                         max_seq=config.max_seq,
                         device_admission=config.device_admission,
                         hosts=config.hosts, transport=config.transport,
                         transport_drop=config.transport_drop,
                         transport_delay=config.transport_delay,
                         transport_rtt_ms=config.transport_rtt_ms,
                         transport_credit=config.transport_credit,
                         params_dir=config.params_dir,
                         obs=config.obs, control=config.control,
                         checkpoint_every_n_steps=(
                             config.checkpoint_every_n_steps))
        try:
            fab = Fabric.restore(args.checkpoint_dir, overrides=overrides,
                                 device=args.device)
        except (FabricConfigError, FileNotFoundError, KeyError) as e:
            # e.g. a params-only or pre-fabric snapshot format, or flags
            # incompatible with the snapshot's class structure
            print(f"[serve] WARNING: cannot resume from "
                  f"{args.checkpoint_dir}: {e}; starting fresh (snapshot "
                  f"left untouched)")
        if fab is not None:
            need = {c.name for c in config.classes}
            have = {c.name for c in fab.config.classes}
            if need != have:
                print(f"[serve] WARNING: frontier checkpoint has classes "
                      f"{sorted(have)} but this run needs {sorted(need)}; "
                      f"starting fresh (snapshot left untouched)")
                fab.close(final_checkpoint=False)
                fab = None
        if fab is not None:
            print(f"[serve] resumed {fab.num_replicas} replicas over "
                  f"{fab.transport.num_hosts} host(s) from frontier "
                  f"checkpoint step {fab.step_count}: "
                  f"{fab.pending()} seats pending")
            if fab.num_replicas != args.replicas:  # live reseat, no restart
                try:
                    fab.resize(args.replicas)
                    print(f"[serve] live-resized to {args.replicas} "
                          f"replicas")
                except FabricConfigError as e:
                    print(f"[serve] WARNING: --replicas {args.replicas} "
                          f"ignored ({e}); keeping {fab.num_replicas}")
    if fab is None:
        fab = Fabric.open(config, device=args.device)

    t0 = time.time()
    uids, tenant_of, done, order = run_workload(fab, args)
    dt = time.time() - t0
    total_tokens = sum(len(done[u].output) for u in uids)
    for u in uids:
        r = done[u]
        print(f"[serve] req {u} ({tenant_of[u]}): {len(r.output)} tokens "
              f"(preemptions={r.preemptions}) -> {r.output[:8]}")
    free = sum(e.pool.free_pages() for e in fab.engines)
    total = sum(e.pool.num_pages for e in fab.engines)
    print(f"[serve] {len(uids)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s); fabric steps={fab.step_count}; "
          f"free pages={free}/{total}")
    view = fab.stats_view()
    if args.hosts > 1:
        ts = view.transport
        print(f"[serve] transport: hosts={ts['hosts']} "
              f"remote_msgs={ts['remote_msgs']} "
              f"remote_bytes={ts['remote_bytes']} "
              f"remote_claims={ts['remote_claims']}")
    if fab.num_replicas > 1 or args.replicas > 1:
        for rid, rs in view.replicas.items():
            print(f"[serve] replica {rid} (host {rs['host']}): "
                  f"steals={rs['steals']} "
                  f"stolen_cycles={rs['stolen_cycles']} "
                  f"empty_drains={rs['empty_drains']}")
    if args.multitenant:
        for name, cs in view.classes.items():
            slo = view.slo[name]
            print(f"[serve] class {name}: submitted={cs.submitted} "
                  f"requeued={cs.requeued} p50_ms={cs.admit_p50_ms} "
                  f"p99_ms={cs.admit_p99_ms} "
                  f"slo_target_ms={slo.target_ms} slo_ok={slo.ok}")
    if args.tenants:
        tv = view.tenants or {}
        tot = tv.get("totals", {})
        print(f"[serve] tenants: declared={tv.get('declared')} "
              f"groups={tv.get('groups')} tracked={tv.get('tracked')} "
              f"active_classes={tv.get('active_classes')} "
              f"submitted={tot.get('submitted')} "
              f"delivered={tot.get('delivered')} shed={tot.get('shed')} "
              f"rejected={tot.get('rejected')}")
        for row in tv.get("top", []):
            print(f"[serve]   top tenant {row['tenant']}: "
                  f"backlog={row['backlog']} submitted={row['submitted']} "
                  f"delivered={row['delivered']}")
    if args.autoscale:
        ctl = view.control or {}
        print(f"[serve] control: decisions={ctl.get('decisions', 0)} "
              f"applied={ctl.get('applied')} resizes={view.resizes} "
              f"final_replicas={view.num_replicas} "
              f"hosts={view.num_hosts} dry_run={ctl.get('dry_run')}")
        for d in ctl.get("last", []):
            print(f"[serve]   step {d['step']}: {d['kind']}"
                  f"{' (dry-run)' if not d['applied'] else ''} — "
                  f"{d['reason']}")
    if fab.obs is not None:
        from repro_torch.obs import perfetto_trace, prometheus_text, stage_breakdown
        from repro_torch.obs.recorder import SPAN
        events = fab.obs.events()
        if args.trace:
            # the trace holds the engine's step spans too; the line counts
            # the lifecycle and control events, as the JAX driver's does
            perfetto_trace(events, path=args.trace)
            n_events = sum(ev[1] != SPAN for ev in events)
            print(f"[serve] flight-recorder trace: {n_events} events "
                  f"(trace_rate={fab.obs.config.trace_rate}) -> {args.trace}")
            for pair, row in stage_breakdown(events).items():
                print(f"[serve]   {pair}: n={row['n']} "
                      f"p50={row['p50_ms']:.3f}ms p99={row['p99_ms']:.3f}ms")
        if args.metrics_out:
            import os
            d = os.path.dirname(args.metrics_out)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(args.metrics_out, "w") as f:
                f.write(prometheus_text(view))
            print(f"[serve] metrics exposition -> {args.metrics_out}")
    fab.close()  # writes the final frontier snapshot when --checkpoint-dir
    if args.checkpoint_dir:
        print(f"[serve] frontier checkpoint written: step {fab.step_count} "
              f"in {args.checkpoint_dir}")
    return {"run": (uids, tenant_of, done, order), "steps": fab.step_count}


if __name__ == "__main__":
    main()
