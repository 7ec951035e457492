"""Paged decode attention (paged_mma_kernel + paged_combine_kernel), one
call a layer: the live context's K and V read once, q read and the output
written once; 4 H hd FLOPs a key a lane. ``ctx``: each active lane's keys;
the other lanes of the batch see one key each."""

from port_bench import peaks


def bound_s(cfg: dict, batch: int, ctx: list) -> float:
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    el = 2  # bf16
    keys = sum(ctx) + (batch - len(ctx))
    nbytes = el * (2 * keys * KV * hd + 2 * batch * H * hd)
    flops = 4.0 * H * hd * keys
    return cfg["num_hidden_layers"] * peaks.bound_s(nbytes, flops)
