"""Plain float32 forward of the served models (Llama-style dense blocks, and
MoE blocks with FIFO capacity slots), from the published descriptions.

A block: RMSNorm, q/k/v projections, RoPE on the two halves of each head,
causal grouped-query attention scaled by 1 / sqrt(head_dim) (query head
h reads key/value head h // (H / KV), as the published Llama code does, or
h % KV where the config file's ``kv_head_map`` says so), the output projection, the
residual; RMSNorm, then a SwiGLU MLP (silu(x Wg) * (x Wu)) Wd, or the MoE:
a float32 router, softmax, the top k experts by a stable descending sort,
their gates renormalised to sum to 1, each claim taking a capacity slot of
its expert in token order within one forward call of the server (the
earliest claim wins, a claim past the capacity is dropped and adds
nothing), the kept claims' expert SwiGLU outputs summed with their gates.
A call of T tokens gives each expert min(T k, max(min_capacity,
floor(T k capacity_factor / E))) slots. The final RMSNorm and the head give
the logits.

Only weights and token ids come in; everything else is worked out here.
``low`` names the low-precision control: every product computed one
precision below the one the program states for it. The model's bfloat16
products (the projections, the MLP and the experts, the head, and
attention's q k^T and p v) take operands rounded to float8 e4m3 (``low=
"fp8"``; a scale a row of activations, of q and k, and of the softmax's p,
a scale an output column of the weights and of v); the router, float32 with
TF32 off, takes TF32 operands (10-bit mantissas). For a float32 model
(``low="bf16"``) the products' operands are rounded to bfloat16.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn
HEAD_CHUNK = 8   # attention heads a pass, which bounds the score matrix


def _round(x: torch.Tensor, dim: int, low) -> torch.Tensor:
    """``x`` rounded to the precision ``low`` (None: unchanged); float8
    with one scale along ``dim``."""
    if low is None:
        return x
    if low == "bf16":
        return x.to(torch.bfloat16).float()
    if low == "tf32":  # round to nearest on the 10-bit mantissa
        bits = x.contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def control_precision(cfg: dict) -> str:
    """The precision below the one the configuration states."""
    return {"bfloat16": "fp8", "float16": "fp8", "float32": "bf16"}[cfg["torch_dtype"]]


def _mm(x: torch.Tensor, w: torch.Tensor, low) -> torch.Tensor:
    """x [T, in] @ w [in, out]; ``w`` already rounded to ``low``."""
    return _round(x, -1, low) @ w


def capacity(tokens: int, cfg: dict) -> int:
    k, e = cfg["num_experts_per_tok"], cfg["num_local_experts"]
    return min(tokens * k, max(cfg["min_capacity"], int(tokens * k * cfg["capacity_factor"] / e)))


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x [T, h, hd] rotated at positions ``pos`` [T], the two halves of each
    head as the pairs."""
    hd = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd))
    ang = pos.float()[:, None, None] * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              modulo: bool = False, low=None) -> torch.Tensor:
    """Causal GQA: q [T, H, hd], k/v [T, KV, hd] -> [T, H, hd]; query head
    h reads key/value head h % KV when ``modulo``, else h // (H / KV)."""
    T, H, hd = q.shape
    KV = k.shape[1]
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for h0 in range(0, H, HEAD_CHUNK):
        hs = torch.arange(h0, min(H, h0 + HEAD_CHUNK), device=q.device)
        qh = _round(q[:, hs].transpose(0, 1), -1, low)     # [h, T, hd]
        kv = hs % KV if modulo else hs // (H // KV)
        kh = _round(k[:, kv].transpose(0, 1), -1, low)
        vh = _round(v[:, kv].transpose(0, 1), -2, low)
        s = (qh @ kh.transpose(1, 2)) / math.sqrt(hd)
        s = s.masked_fill(~mask, float("-inf"))
        p = _round(torch.softmax(s, dim=-1), -1, low)
        out[:, hs] = (p @ vh).transpose(0, 1)
    return out


def _swiglu(x, wg, wu, wd, low):
    return _mm(F.silu(_mm(x, wg, low)) * _mm(x, wu, low), wd, low)


def kept_claims(ids: torch.Tensor, segments: Sequence[Tuple[int, int, int]],
                num_experts: int) -> torch.Tensor:
    """ids [T, k]: each token's experts. ``segments`` (start, end, capacity)
    are the server's forward calls over these positions: within one, the
    j-th claim on an expert, in token order, is kept when j < capacity.
    Returns keep [T, k]."""
    keep = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    for s, e, cap in segments:
        flat = ids[s:e].reshape(-1)
        onehot = F.one_hot(flat, num_experts)
        pos = (onehot.cumsum(0) - onehot).gather(1, flat[:, None])[:, 0]
        keep[s:e] = (pos < cap).view(e - s, -1)
    return keep


def moe(x: torch.Tensor, lw: dict, cfg: dict, segments, low) -> torch.Tensor:
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    router_low = None if low is None else "tf32"
    probs = torch.softmax(_round(x, -1, router_low) @ _round(lw["router"], 0, router_low), dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[:, :k], ids[:, :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    keep = kept_claims(ids, segments, E)
    y = torch.zeros_like(x)
    for ex in range(E):
        t_idx, j_idx = torch.nonzero((ids == ex) & keep, as_tuple=True)
        if t_idx.numel() == 0:
            continue
        out = _swiglu(x[t_idx], lw["wg"][ex], lw["wu"][ex], lw["wd"][ex], low)
        y.index_add_(0, t_idx, out * gates[t_idx, j_idx, None])
    return y


def _layer_weights(w: dict, cfg: dict, i: int, low, device) -> dict:
    b = w["blocks"]["0"]

    def mat(t, dim):
        t = t[i].to(device=device, dtype=torch.float32)
        return _round(t, dim, low)

    lw = {"ln1": b["ln1"]["scale"][i].to(device).float(),
          "ln2": b["ln2"]["scale"][i].to(device).float()}
    for name in ("wq", "wk", "wv", "wo"):
        lw[name] = mat(b["attn"][name], 0)
    if "moe" in b:
        lw["router"] = b["moe"]["router"][i].to(device).float()
        for name in ("wg", "wu", "wd"):
            lw[name] = mat(b["moe"][name], 1)
    else:
        for name in ("wg", "wu", "wd"):
            lw[name] = mat(b["mlp"][name], 0)
    return lw


def _block(x, lw, cfg, segments, low):
    T = x.shape[0]
    H, KV, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps = cfg["rms_norm_eps"]
    pos = torch.arange(T, device=x.device)
    h = rms_norm(x, lw["ln1"], eps)
    q = rope(_mm(h, lw["wq"], low).view(T, H, hd), pos, cfg["rope_theta"])
    kk = rope(_mm(h, lw["wk"], low).view(T, KV, hd), pos, cfg["rope_theta"])
    v = _mm(h, lw["wv"], low).view(T, KV, hd)
    att = attention(q, kk, v, modulo=cfg.get("kv_head_map") == "h % KV", low=low)
    x = x + _mm(att.reshape(T, H * hd), lw["wo"], low)
    h = rms_norm(x, lw["ln2"], eps)
    if "router" in lw:
        return x + moe(h, lw, cfg, segments, low)
    return x + _swiglu(h, lw["wg"], lw["wu"], lw["wd"], low)


def logits(w: dict, cfg: dict, seqs: List[dict], *, low=None,
           device=None) -> List[torch.Tensor]:
    """Each of ``seqs`` is {"tokens": [ids], "first": p, "segments": [(s, e,
    capacity), ...] (MoE only)}: the float32 logits [len - p, V] at
    positions p .. len - 1. Layer by layer, all sequences a layer, so one
    layer's float32 weights are on ``device`` at a time."""
    device = device or w["embed"].device
    xs = [w["embed"][torch.as_tensor(s["tokens"], device=w["embed"].device)]
          .to(device).float() for s in seqs]
    for i in range(cfg["num_hidden_layers"]):
        lw = _layer_weights(w, cfg, i, low, device)
        xs = [_block(x, lw, cfg, s.get("segments"), low) for x, s in zip(xs, seqs)]
        del lw
    head = (w["embed"].T if cfg["tie_word_embeddings"] else w["lm_head"]).to(device).float()
    head = _round(head, 0, low)
    scale = w["final_norm"]["scale"].to(device).float()
    out = []
    for x, s in zip(xs, seqs):
        h = rms_norm(x[s["first"]:], scale, cfg["rms_norm_eps"])
        out.append(_mm(h, head, low))
    return out
