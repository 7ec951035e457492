"""Multi-tenant serving on the PyTorch port's fabric API: mixed
interactive/batch/background traffic through one declarative config,
class-aware preemption, per-class admission telemetry and the SLO view.
``examples/serve_multitenant.py`` on ``repro_torch``, on the card unless
``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_multitenant.py [--policy strict|wfq|fifo] \
      [--device cuda|cpu]

Interactive requests preempt background lanes under pool pressure; the
victims re-enter their own class at their original cycle seat (strict FIFO
within the class survives preemption). Compare policies with --policy; the
scheduler benchmark (benchmarks/run.py --only sched) quantifies the
latency separation. Self-asserting.
"""

import argparse
import sys
import time

sys.path.insert(0, "src")

from repro_torch.fabric import Fabric, FabricConfig, tiered_classes  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="strict",
                    choices=("strict", "wfq", "fifo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    # The standard 3-tier tenant set; background gets a finite admission
    # window — beyond 6 in flight the class rejects (backpressure) instead
    # of growing without bound. Tight page pool on purpose: interactive
    # arrivals preempt background lanes, the CMP window recycles the pages.
    config = FabricConfig(
        classes=tiered_classes(background_window=6,
                               interactive_slo_ms=30000.0,
                               batch_slo_ms=120000.0),
        policy=args.policy, arch="glm4-9b", smoke=True, max_batch=3,
        page_size=8, num_pages=24, kv_window=3, max_seq=64)
    fab = Fabric.open(config, device=args.device)

    t0 = time.time()
    uids = {"interactive": [], "batch": [], "background": []}
    # background + batch load first, interactive bursts arriving on top
    for i in range(8):
        u = fab.submit([40 + i, 3, 7], max_new_tokens=5, qclass="background")
        if u is not None:
            uids["background"].append(u)
    uids["batch"] = [u for u in
                     fab.submit_many([[20 + i, 5, 9] for i in range(4)],
                                     max_new_tokens=5, qclass="batch")
                     if u is not None]
    for i in range(4):
        uids["interactive"].append(
            fab.submit([i + 1, 2, 3], max_new_tokens=4, qclass="interactive"))
        fab.step()  # interactive arrives mid-flight, not as a pre-load

    done = fab.drain(max_steps=800)
    dt = time.time() - t0

    rejected = 8 - len(uids["background"])
    print(f"policy={args.policy}  wall={dt:.1f}s  steps={fab.step_count}")
    for name, us in uids.items():
        served = [done[u] for u in us if u in done]
        pre = sum(r.preemptions for r in served)
        print(f"  {name:12s} served={len(served)}/{len(us)} "
              f"preemptions={pre}")
    print(f"  background rejected by admission window: {rejected}")
    view = fab.stats_view()
    for name, cs in view.classes.items():
        slo = view.slo[name]
        print(f"  [{name}] submitted={cs.submitted} "
              f"delivered={cs.delivered} requeued={cs.requeued} "
              f"rejected={cs.rejected} "
              f"admit_p99_ms={cs.admit_p99_ms and round(cs.admit_p99_ms, 2)} "
              f"slo_target_ms={slo.target_ms} slo_ok={slo.ok}")
    assert all(u in done for us in uids.values() for u in us), \
        "an admitted request was dropped"
    # the SLO view is wired end to end: targets configured on the latency
    # tiers, measured p99 reported against them
    assert view.slo["interactive"].target_ms == 30000.0
    assert view.slo["interactive"].ok is not None
    assert view.slo["background"].target_ms is None
    pool = fab.engines[0].pool
    print("all admitted requests served; within-class FIFO kept through "
          f"preemption; pages free {pool.free_pages()}/{pool.num_pages}")
    fab.close()


if __name__ == "__main__":
    main()
