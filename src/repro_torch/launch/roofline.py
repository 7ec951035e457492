"""Three-term roofline of a dry-run step, per GPU:

    compute term    = FLOPs_per_gpu / peak_FLOP/s
    memory term     = bytes_per_gpu / HBM_bw
    collective term = wire_bytes_per_gpu / link_bw

Hardware model: one NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit,
NVIDIA's data-sheet figures (dense, no sparsity):

* PEAK_FLOPS  989 TFLOP/s bf16 on the tensor cores;
* HBM_BW      3.35 TB/s HBM3;
* NVLINK_BW   900 GB/s NVLink 4 per GPU in total (both directions, all 18
  links), inside one node of 8 GPUs;
* LINK_BW     50 GB/s: one 400 Gb/s NDR InfiniBand NIC per GPU (the DGX
  H100 layout), between nodes.

The collective term assumes LINK_BW, the InfiniBand NIC: the 16x16
production mesh (and 2x16x16) spans 32 (64) nodes of 8 GPUs, so every
'data' and 'pod' group, and each 16-wide 'model' group (two nodes), crosses
InfiniBand, and its ring runs at the NIC's rate, not NVLink's.

The dry run (``launch/dryrun.py``) counts FLOPs and bytes of the aten ops
each GPU runs, and records each collective as ``(kind, result bytes, group
size)``; :func:`collective_wire_bytes` converts the records to
per-participant ring wire bytes, with the JAX package's formulas:

    all-reduce         2 * bytes * (n-1)/n     (reduce-scatter + all-gather)
    all-gather         bytes * (n-1)/n
    reduce-scatter     bytes * (n-1)           (operand = result * n)
    all-to-all         bytes * (n-1)/n
    collective-permute bytes
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12   # bf16 dense / GPU: H100 80GB HBM3 (SXM) data sheet, 700 W limit
HBM_BW = 3.35e12      # bytes/s / GPU: HBM3, H100 80GB HBM3 (SXM) data sheet, 700 W limit
NVLINK_BW = 900e9     # bytes/s / GPU, NVLink 4 total: H100 80GB HBM3 (SXM) data sheet
LINK_BW = 50e9        # bytes/s / GPU: one 400 Gb/s InfiniBand NIC a GPU (DGX H100)

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


def collective_wire_bytes(records: Iterable[Tuple[str, float, int]]) -> Dict[str, float]:
    """Per-participating-GPU ring wire bytes by collective kind, from
    ``(kind, result bytes, group size)`` records."""
    out: Dict[str, float] = dict.fromkeys(KINDS, 0.0)
    out["ops"] = 0
    for kind, result_bytes, n in records:
        if n <= 1 and kind != "collective-permute":
            continue
        if kind == "all-reduce":
            wire = 2 * result_bytes * (n - 1) / n
        elif kind == "all-gather":
            wire = result_bytes * (n - 1) / n
        elif kind == "reduce-scatter":
            wire = result_bytes * (n - 1)
        elif kind == "all-to-all":
            wire = result_bytes * (n - 1) / n
        else:  # collective-permute
            wire = result_bytes
        out[kind] += wire
        out["ops"] += 1
    out["total"] = sum(out[k] for k in KINDS)
    return out


def roofline_terms(cost: dict, records: Iterable[Tuple[str, float, int]] = (), *,
                   links: int = 1) -> Dict[str, float]:
    """cost: {"flops", "bytes accessed"} of one GPU's share of the step;
    records: its collectives (see :func:`collective_wire_bytes`)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    wire = collective_wire_bytes(records)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = wire["total"] / (LINK_BW * links)
    dominant = max(
        [("compute", compute_s), ("memory", memory_s), ("collective", collective_s)],
        key=lambda kv: kv[1])[0]
    return {
        "flops_per_chip": flops,
        "bytes_per_chip": byts,
        "wire_bytes_per_chip": wire["total"],
        "wire_breakdown": {k: wire[k] for k in KINDS},
        "collective_ops": wire["ops"],
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "step_s_lower_bound": max(compute_s, memory_s, collective_s),
    }


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D for a train step (fwd+bwd), 2*N*D for inference."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens
