"""Model FLOPs of the work a step does, from the configuration file's
widths: 2 x the active parameters of the layers for every token a forward
call processes (prompt tokens, and each lane's one token in a decode), the
attention's 4 H hd FLOPs for every key a query sees (causal: a prompt of S
tokens sees S (S + 1) / 2 in all), and the head's 2 D V for every token
served (the server computes logits at one position a lane a call)."""

from __future__ import annotations


def layer_params(cfg: dict) -> int:
    """Active parameters of one layer a token (norm scales left out)."""
    D, H, KV, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    F = cfg["intermediate_size"]
    attn = D * H * hd + 2 * D * KV * hd + H * hd * D
    if cfg.get("num_local_experts", 0):
        return attn + D * cfg["num_local_experts"] + cfg["num_experts_per_tok"] * 3 * D * F
    return attn + 3 * D * F


def step_flops(cfg: dict, step: dict) -> float:
    """``step``: the harness's record of one ``Fabric.step``: ``prefill``
    (each prefill call's prompt length) and ``dec_ctx`` (each active lane's
    keys in the decode call)."""
    L, H, hd = cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["head_dim"]
    pre, ctx = step["prefill"], step["dec_ctx"]
    tokens = sum(pre) + len(ctx)
    keys = sum(s * (s + 1) // 2 for s in pre) + sum(ctx)
    served = len(pre) + len(ctx)
    return (L * (2.0 * layer_params(cfg) * tokens + 4.0 * H * hd * keys)
            + 2.0 * cfg["hidden_size"] * cfg["vocab_size"] * served)


def window_flops(obs: dict) -> float:
    """The model FLOPs of the window's steps (``obs["steps"]``), by the
    cell's family's ``step_flops``."""
    return sum(obs["family"].step_flops(obs["cfg"], s) for s in obs["steps"])
