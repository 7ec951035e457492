"""The MoE block's three expert products (torch.bmm over the E experts'
capacity buffers [E, C, D]: gate and up [E, D, F], down [E, F, D]) of one
forward call of ``tokens`` tokens, every layer: each product's inputs read
once and output written once, 2 E C D F FLOPs each. C is the call's
capacity (reference/model.py)."""

from port_bench import peaks
from port_bench.reference.model import capacity


def bound_s(cfg: dict, tokens: int) -> float:
    E, D, F = cfg["num_local_experts"], cfg["hidden_size"], cfg["intermediate_size"]
    C = capacity(tokens, cfg)
    el = 2  # bf16
    up = E * C * D + E * D * F + E * C * F       # one of gate / up
    down = E * C * F + E * F * D + E * C * D
    nbytes = el * (2 * up + down)
    flops = 3 * 2.0 * E * C * D * F
    return cfg["num_hidden_layers"] * peaks.bound_s(nbytes, flops)
