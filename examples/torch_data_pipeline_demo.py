"""The CMP queue as a production input pipeline of the PyTorch port:
coordination-free producer/consumer flow, straggler absorption, bounded
memory, exact resume. ``examples/data_pipeline_demo.py`` on
``repro_torch``: the consumer moves each batch's tokens to the card, as
the trainer does, unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_data_pipeline_demo.py [--device cuda|cpu]
"""

import argparse
import sys
import time

import torch

sys.path.insert(0, "src")

from repro_torch.data.pipeline import DataPipeline         # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device; pass --device cpu "
                           "to run on the CPU")

    def to_device(b):
        return torch.as_tensor(b["tokens"]).to(args.device)

    # num_shards > 1: producers shard by batch_id hash, the consumer drains
    # its home shard and steals from the deepest sibling (DESIGN.md §8)
    pipe = DataPipeline(batch=4, seq=128, vocab=32000, num_producers=3,
                        window=32, num_shards=2)
    it = iter(pipe)

    print("== phase 1: steady state ==")
    t0 = time.time()
    for i in range(20):
        b = next(it)
        to_device(b)
    print(f"20 batches in {time.time()-t0:.3f}s; queue nodes: "
          f"{pipe.shards.live_nodes()} (bounded by window+backpressure); "
          f"steal stats: {pipe.steal_stats()}")

    print("== phase 2: producer 0 stalls 0.5s (straggler) ==")
    pipe.stall_producer(0, 0.5)
    t0 = time.time()
    got = []
    for _ in range(15):
        b = next(it)
        to_device(b)
        got.append(b["batch_id"])
    dt = time.time() - t0
    print(f"15 batches in {dt:.3f}s while producer 0 was stalled "
          f"({'NOT blocked' if dt < 0.5 else 'BLOCKED!'}) — the window "
          f"absorbed the straggler")

    print("== phase 3: checkpoint + exact resume ==")
    state = pipe.state()
    pipe.close()
    pipe2 = DataPipeline.from_state(state, batch=4, seq=128, vocab=32000,
                                    window=32)
    b = next(iter(pipe2))
    to_device(b)
    print(f"resumed; first batch id {b['batch_id']} continues the frontier "
          f"{state['cursors']}")
    pipe2.close()
    print("demo OK")


if __name__ == "__main__":
    main()
