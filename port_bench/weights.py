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

import hashlib

import torch

DIGEST_ROW = 2 ** 16     # 32-bit words a row: |word| x 1..ROW summed stays inside int64
DIGEST_SLAB = 2 ** 10    # rows a pass, which bounds the pass's int64 copies


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


def digest(tree) -> str:
    """A digest of the bits of ``tree``'s leaves (nested dicts of tensors),
    computed where they lie: each leaf's bytes as 32-bit words, in rows of
    ``DIGEST_ROW`` summed with the weights 1 .. ``DIGEST_ROW`` by position
    (exact in int64), the rows' sums, with each leaf's name, shape and type,
    hashed on the host (SHA-256; the first 16 hex digits)."""
    h = hashlib.sha256()

    def walk(name, t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(f"{name}/{k}", t[k])
            return
        h.update(f"{name}:{tuple(t.shape)}:{t.dtype};".encode())
        b = t.detach().contiguous().view(-1).view(torch.uint8)
        words = b.view(torch.int32) if b.numel() % 4 == 0 else b
        pos = torch.arange(1, DIGEST_ROW + 1, dtype=torch.int64, device=t.device)
        step = DIGEST_ROW * DIGEST_SLAB
        for s in range(0, words.numel(), step):
            w = words[s:s + step].to(torch.int64)
            pad = -w.numel() % DIGEST_ROW
            if pad:
                w = torch.cat([w, w.new_zeros(pad)])
            h.update((w.view(-1, DIGEST_ROW) * pos).sum(dim=1).cpu().numpy().tobytes())

    walk("", tree)
    return h.hexdigest()[:16]
