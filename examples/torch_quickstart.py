"""Quickstart on the PyTorch port: the whole CMP serving stack — class
queues, scheduler replicas, paged-KV engine — from one declarative config,
in ~15 lines. ``examples/quickstart.py`` on ``repro_torch``, on the card
unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]
"""

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.fabric import ClassSpec, Fabric, FabricConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    config = FabricConfig(classes=(ClassSpec("chat", slo_ms=60000.0),),
                          arch="glm4-9b", smoke=True, max_batch=2,
                          page_size=8, num_pages=32, kv_window=3, max_seq=48)
    with Fabric.open(config, device=args.device) as fab:
        uids = fab.submit_many([[i + 1, 7, 3] for i in range(4)],
                               max_new_tokens=4, qclass="chat")
        done = fab.drain(max_steps=200)
        for u in uids:
            print(f"req {u}: {done[u].output}")
        print(f"slo: {fab.stats_view().slo['chat']}")
        assert all(u in done for u in uids)
    print("quickstart OK")


if __name__ == "__main__":
    main()
