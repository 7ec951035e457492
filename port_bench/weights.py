"""Seeded random weights, made by the benchmark on the device in the type
they are served in, one call a stacked leaf, in the layout the port's
``paged_forward`` reads (``embed``, ``final_norm``, ``blocks.0.*`` with a
leading layer dim, ``lm_head``). The same tensors go to the program and to
the plain reference.

Distributions: matrices normal(0, 0.02), output projections normal(0, 0.02
/ sqrt(2 L)), norm scales 1 + normal(0, 0.1) (so a reference that drops a
scale shows), the router float32.
"""

from __future__ import annotations

import torch


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def make_weights(cfg: dict, seed: int, device) -> dict:
    dt = getattr(torch, cfg["torch_dtype"])
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    F = cfg["intermediate_size"]
    out_std = 0.02 / max(1.0, (2 * L) ** 0.5)
    gen = generator(seed, device)

    def normal(shape, std, dtype=dt):
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, std, generator=gen)

    def scale(shape):
        return normal(shape, 0.1).add_(1.0)

    block = {
        "ln1": {"scale": scale((L, D))},
        "attn": {"wq": normal((L, D, H * hd), 0.02), "wk": normal((L, D, KV * hd), 0.02),
                 "wv": normal((L, D, KV * hd), 0.02), "wo": normal((L, H * hd, D), out_std)},
        "ln2": {"scale": scale((L, D))},
    }
    if moe(cfg):
        E = cfg["num_local_experts"]
        block["moe"] = {"router": normal((L, D, E), 0.02, torch.float32),
                        "wg": normal((L, E, D, F), 0.02), "wu": normal((L, E, D, F), 0.02),
                        "wd": normal((L, E, F, D), out_std)}
    else:
        block["mlp"] = {"wg": normal((L, D, F), 0.02), "wu": normal((L, D, F), 0.02),
                        "wd": normal((L, F, D), out_std)}
    params = {"embed": normal((V, D), 0.02), "final_norm": {"scale": scale((D,))},
              "blocks": {"0": block}}
    if not cfg["tie_word_embeddings"]:
        params["lm_head"] = normal((D, V), 0.02)
    return params


def moe(cfg: dict) -> bool:
    return cfg.get("num_local_experts", 0) > 0


def nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
