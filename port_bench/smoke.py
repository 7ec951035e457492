"""Small cells of the benchmark for the CPU tests: the port's smoke configs
(the kernels' plain versions run on the CPU), served by the same harness,
loop and judge as the chip's cells."""

from __future__ import annotations

import dataclasses

from port_bench import files
from port_bench.harness import Cell

def config_dict(arch: str, pc) -> dict:
    """The configuration-file form of the port's config ``pc``, as the
    default family (the Llama-style stack) writes it."""
    return files.family({}).config_dict(arch, pc)


# the smoke configs, wider: logits whose near ties a lower precision flips
WIDE = {"d_model": 256, "head_dim": 64, "vocab_size": 8192}
# the limits at these sizes in bfloat16, from CPU readings of the program
# and of the control (float8) on seeds 1-3 of both configs: the widest
# logit gap 0.0007-0.0091 against 0.035-0.091, the median logit error
# 0.0042-0.0044 against 0.033-0.041
LIMITS = {"max_logit_gap": 0.02, "logit_err_p50": 0.012}


def cell(arch: str, *, dtype: str = "bfloat16", workload: str = None, family=None,
         **replace) -> Cell:
    """A small cell of ``arch`` in ``dtype`` (the smoke config at ``WIDE``
    widths, updated by ``replace``) of the family module ``family``
    (default: the Llama-style stack), reporting the metrics that
    BENCHMARK.json gives ``workload`` (default: yi6b.longprompt's)."""
    from repro_torch.configs import get_config

    pc = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype,
                             **{**WIDE, **replace})
    bench = files.benchmark()
    workload = workload or "yi6b.longprompt"
    mix = {"loop": "closed", "clients": 4, "block": 8,
           "prompt": {"dist": "loguniform", "min": 8, "max": 40},
           "output": {"dist": "uniform", "min": 24, "max": 48}}
    engine = {"max_batch": 4, "page_size": 8, "max_seq": 96, "kv_window": 2,
              "num_pages": 4 * 12 + 24 + 1}
    judge = dict(LIMITS, min_served=150, min_requests=3, max_requests=6)
    family = family or files.family({})
    return Cell(f"smoke.{arch}", family.config_dict(arch, pc), mix, engine, judge, 0.3,
                files.cell_metrics(bench, workload, "end_to_end"),
                files.cell_metrics(bench, workload, "per_layer"), port_cfg=pc, family=family)
