"""Serve a small model with batched requests through the PyTorch port's
CMP paged-KV engine — one declarative config, one `Fabric` session —
including an overload phase that demonstrates preemption + window
recovery. ``examples/serve_batched.py`` on ``repro_torch``, on the card
unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cuda|cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.fabric import Fabric, FabricConfig          # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    # Tight page pool on purpose: overload will trigger preemption, and the
    # CMP window recycles the preempted request's pages automatically.
    config = FabricConfig(arch="glm4-9b", smoke=True, max_batch=3,
                          page_size=8, num_pages=24, kv_window=3, max_seq=64)
    prompts = [[i + 1, (3 * i) % 40 + 2, 7] for i in range(9)]
    with Fabric.open(config, device=args.device) as fab:
        # One batched submission for the whole burst: a single
        # class-cycle-range fetch-add and one splice per shard.
        uids = fab.submit_many(prompts, max_new_tokens=6)
        done = fab.drain(max_steps=500)
        preempted = sum(done[u].preemptions for u in uids)
        for u in uids:
            print(f"req {u}: {done[u].output} "
                  f"(preemptions={done[u].preemptions})")
        pool = fab.engines[0].pool
        print(f"\nall {len(uids)} requests served; {preempted} preemptions "
              f"recovered via the protection window; "
              f"free pages {pool.free_pages()}/{pool.num_pages}")
        assert all(u in done for u in uids), "a request was dropped"


if __name__ == "__main__":
    main()
