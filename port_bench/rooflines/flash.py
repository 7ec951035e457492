"""Causal flash prefill (flash_bf16_kernel), one call a layer over a prompt
of S tokens: q, k, v read once and the output written once; S (S + 1) / 2
visible (query, key) pairs at 4 hd FLOPs a head."""

from port_bench import peaks


def bound_s(cfg: dict, S: int) -> float:
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    el = 2  # bf16
    nbytes = el * (2 * S * H * hd + 2 * S * KV * hd)
    flops = 4.0 * H * hd * S * (S + 1) / 2
    return cfg["num_hidden_layers"] * peaks.bound_s(nbytes, flops)
