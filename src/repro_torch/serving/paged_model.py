"""Paged decode/prefill forward: attention reads and writes CMP-managed KV
pages instead of a dense per-request cache.

Pages allocated to a request are sequential in position (page j covers
positions [j*page, (j+1)*page)), so the gathered page sequence is position
ordered and the attention mask is a length mask.

The JAX package's ``paged_forward`` runs gathered attention and calls no
kernel; its Pallas paged and flash kernels compute the same function. Here
attention goes through the kernels (:mod:`repro_torch.kernels.ops`):

* S == 1 (decode): the paged kernel, after the scatter, over
  ``seq_lens + 1`` positions;
* S > 1 with every ``seq_lens == 0`` (prefill): the flash kernel, causal,
  on the freshly projected K/V cast to the page dtype (exactly what the
  scatter stores);
* anything else (chunked prefill, or a config with ``attn_softcap``, which
  neither kernel has): the plain gathered path on the CPU; on the card it
  raises ``NotImplementedError``.

Like the reference, the paged path ignores ``cfg.sliding_window``.
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


def _proj_qkv(x, p, cfg: ModelConfig, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _scatter_pages(k_pages, v_pages, k_new, v_new, block_tables, positions):
    """k_pages [P,KV,pg,hd]; k_new [B,S,KV,hd]; positions [B,S] absolute.
    Writes in place. ``k_pages[rows, :, slots]`` is [B,S,KV,hd]: the two
    index tensors are split by a slice, so their broadcast dims come first,
    as in numpy and JAX. Idle lanes all write scratch page 0, slot 0; those
    duplicate writes land in no live page."""
    pg = k_pages.shape[2]
    rows = torch.gather(block_tables, 1, positions // pg).long()
    slots = (positions % pg).long()
    k_pages[rows, :, slots] = k_new.to(k_pages.dtype)
    v_pages[rows, :, slots] = v_new.to(v_pages.dtype)
    return k_pages, v_pages


def _gathered_attention(q, k_pages, v_pages, block_tables, positions, seq_lens,
                        softcap: float = 0.0):
    """Gather each request's pages and run masked attention (the reference's
    formulation). q [B,S,H,hd]; returns [B,S,H,hd]."""
    B = q.shape[0]
    P, KV, pg, hd = k_pages.shape
    pps = block_tables.shape[1]
    bt = block_tables.long()
    kg = k_pages[bt].movedim(2, 3).reshape(B, pps * pg, KV, hd)
    vg = v_pages[bt].movedim(2, 3).reshape(B, pps * pg, KV, hd)
    k_pos = torch.arange(pps * pg, dtype=torch.int32, device=q.device)[None, :]
    k_pos = torch.where(k_pos < seq_lens[:, None], k_pos, -1)
    return L.cache_attention(q, kg, vg, positions, k_pos, softcap=softcap)


def _attention(q, k_new, v_new, k_pages, v_pages, block_tables, positions,
               seq_lens, cfg: ModelConfig, prefill: bool):
    S = q.shape[1]
    if cfg.attn_softcap > 0.0 or not (S == 1 or prefill):
        if q.is_cuda:
            raise NotImplementedError(
                "paged attention on the card covers decode (S=1) and prefill "
                "from position 0 without softcap")
        return _gathered_attention(q, k_pages, v_pages, block_tables, positions,
                                   seq_lens, cfg.attn_softcap)
    if S == 1:
        return ops.paged_attention(q[:, 0], k_pages, v_pages, block_tables,
                                   seq_lens)[:, None]
    return ops.flash_attention(q, k_new.to(k_pages.dtype), v_new.to(v_pages.dtype),
                               causal=True)


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _paged_block(x, p, cfg: ModelConfig, k_pages, v_pages, block_tables,
                 positions, seq_lens, prefill: bool):
    h_in = L.norm(x, p["ln1"], cfg.norm)
    q, k_new, v_new = _proj_qkv(h_in, p["attn"], cfg, positions)
    _scatter_pages(k_pages, v_pages, k_new, v_new, block_tables, positions)
    attn = _attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                      positions, seq_lens, cfg, prefill)
    B, S = x.shape[0], x.shape[1]
    attn = attn.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim) @ p["attn"]["wo"]
    x = x + attn
    return x + L.swiglu(L.norm(x, p["ln2"], cfg.norm), p["mlp"], cfg.act)


def paged_forward(params, tokens, cfg: ModelConfig, k_pages, v_pages,
                  block_tables, seq_lens) -> Tuple[torch.Tensor, torch.Tensor,
                                                   torch.Tensor]:
    """Shared prefill/decode body. tokens [B, S] start at position seq_lens
    (S=prompt for prefill with seq_lens=0, S=1 for decode).
    k/v_pages: [L_attn, P, KV, pg, hd] stacked over attention layers,
    updated in place. Returns (last-token logits [B, V] f32, k_pages,
    v_pages)."""
    for kind in cfg.block_pattern:
        if kind == "moe":
            raise NotImplementedError("MoE blocks are not ported yet")
        assert kind == "dense", "paged serving supports attention-based families only"
    x = params["embed"][tokens.long()]
    B, S = tokens.shape
    steps = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = seq_lens[:, None] + steps[None, :]
    # one host read per prefill call (decode needs none)
    prefill = S > 1 and not bool(seq_lens.any())
    n_pat = len(cfg.block_pattern)
    for i in range(cfg.pattern_repeats):
        for j in range(n_pat):
            layer = i * n_pat + j
            x = _paged_block(x, _layer(params["blocks"][str(j)], i), cfg,
                             k_pages[layer], v_pages[layer], block_tables,
                             positions, seq_lens + S, prefill)
    x = L.norm(x, params["final_norm"], cfg.norm)
    logits = M._logits(x[:, -1:], params, cfg)[:, 0]
    return logits, k_pages, v_pages
