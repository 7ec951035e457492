"""Paged decode/prefill forward: attention reads and writes CMP-managed KV
pages instead of a dense per-request cache.

Pages allocated to a request are sequential in position (page j covers
positions [j*page, (j+1)*page)), so the gathered page sequence is position
ordered and the attention mask is a length mask.

The JAX package's ``paged_forward`` runs gathered attention and calls no
kernel; its Pallas paged and flash kernels compute the same function. Here
attention goes through the kernels (:mod:`repro_torch.kernels.ops`):

* S == 1 (decode): the paged kernel, after the page write, over
  ``seq_lens + 1`` positions;
* S > 1 with every ``seq_lens == 0`` (prefill): the flash kernel, causal,
  on the freshly projected K/V cast to the page dtype (exactly what the
  page write stores);
* S > 1 past position 0 (a chunked prefill): the paged kernel over B*S
  query rows, row (b, s) with lane b's block table and ``position + 1``
  positions. It runs after the page write has written the chunk, so each
  row's length is its causal mask.

A config's ``attn_softcap`` goes to whichever kernel runs. The chains
around attention are kernels too: each RMSNorm one launch with the
residual add before it folded in (the MLP's add into the next layer's
``ln1``, the last one's into the final norm), and RoPE on q and k with the
page write of k and v one launch a layer (``ops.rms_norm``,
``ops.rope_write``); a layernorm config keeps ``layers.norm`` and its adds.

A block is ``dense`` (SwiGLU MLP) or ``moe`` (:func:`repro_torch.models.moe.moe_block`
after the attention, as the reference's ``_paged_block``). Like the
reference, the paged path ignores ``cfg.sliding_window``.
The page tensors are updated in place; ``paged_forward`` returns them as
the reference does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.parallel.sharding import view


def _attention(q, k_new, v_new, k_pages, v_pages, block_tables, positions,
               seq_lens, cfg: ModelConfig, prefill: bool):
    B, S, H, hd = q.shape
    cap = cfg.attn_softcap
    if S == 1:
        return ops.paged_attention(q[:, 0], k_pages, v_pages, block_tables,
                                   seq_lens, softcap=cap)[:, None]
    if prefill:
        return ops.flash_attention(q, k_new.to(k_pages.dtype), v_new.to(v_pages.dtype),
                                   causal=True, softcap=cap)
    rows = ops.paged_attention(q.reshape(B * S, H, hd), k_pages, v_pages,
                               block_tables.repeat_interleave(S, dim=0),
                               (positions + 1).reshape(B * S).to(torch.int32), softcap=cap)
    return rows.reshape(B, S, H, hd)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _norm(x, p: dict, cfg: ModelConfig, residual=None):
    """norm(x), or with ``residual`` (x + residual, norm(x + residual)): the
    RMSNorm kernel, the add folded in; a layernorm config's plain ops."""
    if cfg.norm != "layernorm":
        return ops.rms_norm(x, p["scale"], residual=residual)
    if residual is None:
        return L.norm(x, p, cfg.norm)
    x = x + residual
    return x, L.norm(x, p, cfg.norm)


def _paged_block(x, h, p, next_norm: dict, cfg: ModelConfig, kind: str, k_pages, v_pages,
                 block_tables, positions, inv_freq, lens, prefill: bool):
    """One layer on the residual stream x and its normed h = ln1(x): returns
    (x', next_norm(x')), x' the layer's output."""
    B, S = x.shape[0], x.shape[1]
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    a = p["attn"]
    q = view(h @ a["wq"], B, S, H, hd)
    k_new = view(h @ a["wk"], B, S, KV, hd)
    v_new = view(h @ a["wv"], B, S, KV, hd)
    q, k_new = ops.rope_write(q, k_new, v_new, positions, inv_freq, block_tables, k_pages,
                              v_pages)
    attn = _attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                      positions, lens, cfg, prefill)
    x, h = _norm(x, p["ln2"], cfg, attn.reshape(B, S, H * hd) @ a["wo"])
    if kind == "moe":
        y, _ = MOE.moe_block(h, p["moe"], num_experts=cfg.num_experts,
                             top_k=cfg.num_experts_per_tok,
                             capacity_factor=cfg.capacity_factor, act=cfg.act)
    else:
        y = L.swiglu(h, p["mlp"], cfg.act)
    return _norm(x, next_norm, cfg, y)


def paged_forward(params, tokens, cfg: ModelConfig, k_pages, v_pages,
                  block_tables, seq_lens) -> Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """Shared prefill/decode body. tokens [B, S] start at position seq_lens
    (S=prompt for prefill with seq_lens=0, S=1 for decode).
    k/v_pages: [L_attn, P, KV, pg, hd] stacked over attention layers,
    updated in place. Returns (last-token logits [B, V] f32, k_pages,
    v_pages)."""
    assert all(kind in ("dense", "moe") for kind in cfg.block_pattern), (
        "paged serving supports attention-based families only")
    x = params["embed"][tokens.long()]
    B, S = tokens.shape
    steps = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = seq_lens[:, None] + steps[None, :]
    lens = seq_lens + S
    inv_freq = L.rope_freqs(cfg.resolved_head_dim, cfg.rope_theta, tokens.device)
    # one host read per prefill call (decode needs none)
    prefill = S > 1 and not bool(seq_lens.any())
    n_pat = len(cfg.block_pattern)
    blocks = [(cfg.block_pattern[j], _layer(params["blocks"][str(j)], i))
              for i in range(cfg.pattern_repeats) for j in range(n_pat)]
    h = _norm(x, blocks[0][1]["ln1"], cfg)
    for layer, (kind, p) in enumerate(blocks):
        nxt = blocks[layer + 1][1]["ln1"] if layer + 1 < len(blocks) else params["final_norm"]
        x, h = _paged_block(x, h, p, nxt, cfg, kind, k_pages[layer], v_pages[layer],
                            block_tables, positions, inv_freq, lens, prefill)
    logits = M._logits(h[:, -1:], params, cfg)[:, 0]
    return logits, k_pages, v_pages
