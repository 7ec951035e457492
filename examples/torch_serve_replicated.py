"""Live replica elasticity + in-loop frontier checkpointing through the
PyTorch port's fabric API (DESIGN.md §9-10). ``examples/serve_replicated.py``
on ``repro_torch``, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_replicated.py [--replicas 2] [--ckpt-dir DIR] \
      [--device cuda|cpu]

One declarative config opens a single-replica fabric serving a 3-class
wave; mid-wave it live-resizes to N replicas (a batch of seat claims plus a
lane/page budget re-split — producers never pause), the checkpoint cadence
writes exact-seat frontier snapshots as it runs, the whole group is killed
(replica crash), and `Fabric.restore` resumes from the cadence checkpoint
to finish the wave — every tenant at its exact FIFO seat; nothing lost or
served twice. Self-asserting.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, "src")

from repro_torch.fabric import Fabric, FabricConfig, tiered_classes  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "torch_serve_replicated_ckpt"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    config = FabricConfig(
        classes=tiered_classes(), replicas=1, max_replicas=args.replicas,
        arch="glm4-9b", smoke=True, max_batch=2 * args.replicas,
        page_size=8, num_pages=24 * args.replicas, kv_window=3, max_seq=64,
        checkpoint_dir=args.ckpt_dir, checkpoint_every_n_steps=2)
    fab = Fabric.open(config, device=args.device)

    t0 = time.time()
    uids, tenant_of = [], {}
    wave = [("interactive", 4), ("batch", 4), ("background", 4)]
    for name, n in wave:
        for u in fab.submit_many([[10 + i, 3, 7] for i in range(n)],
                                 max_new_tokens=4, qclass=name):
            uids.append(u)
            tenant_of[u] = name

    fab.step()                      # part of the wave decodes on 1 replica,
    fab.resize(args.replicas)       # ...then: live resize under load,
    fab.step()                      # cadence checkpoint fires (step 2),
    fab.step()
    fab.flush_checkpoints()         # snapshots durably on disk,
    ck_step = max(fab.stats_view().checkpoint["written"])
    done_before = dict(fab.completed)
    del fab                         # crash,

    fab2 = Fabric.restore(args.ckpt_dir, device=args.device)  # restore from the cadence ckpt.
    assert fab2.step_count == ck_step
    assert fab2.num_replicas == args.replicas, "resize survived checkpoint"
    pending = fab2.pending()
    done_after = fab2.drain(max_steps=400)
    dt = time.time() - t0

    served = {**done_before, **done_after}
    missing = [u for u in uids if u not in served]
    dup = [u for u in done_before if u in done_after]
    assert not missing, f"lost across restore: {missing}"
    assert not dup, f"served twice across restore: {dup}"
    print(f"replicas=1->{args.replicas} (live)  wall={dt:.1f}s  "
          f"cadence checkpoint@step {ck_step} ({pending} seats resumed)")
    view = fab2.stats_view()
    for name, _ in wave:
        mine = sorted(u for u in uids if tenant_of[u] == name)
        cs = view.classes[name]
        print(f"  {name:12s} served={sum(1 for u in mine if u in served)}"
              f"/{len(mine)} requeued-at-seat={cs.requeued}")
    for rid, r in view.replicas.items():
        print(f"  replica {rid}: steals={r['steals']} "
              f"stolen_cycles={r['stolen_cycles']} "
              f"empty_drains={r['empty_drains']}")
    fab2.close()
    print("every tenant resumed at its exact FIFO seat; "
          f"{len(done_before)} served pre-crash, {len(done_after)} "
          f"post-restore")


if __name__ == "__main__":
    main()
