"""The paged block's fused chains on the CPU: the plain versions of the
``rms_norm`` and ``rope_write`` kernels (``kernels/norm_rope.py``) bit for
bit against the unfused ops they replace (``layers.rms_norm``, the add in
the activations' dtype, ``layers.apply_rope`` and the page scatter), and
``paged_forward`` bit for bit against the block as it was written before
them. The kernels themselves are held to these plain versions on the card
(tests/test_torch_cuda.py)."""

import inspect

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import norm_rope, ops
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.serving import paged_model as PM

DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
HEAD_DIMS = [8, 16, 64, 96, 128]
# (lanes, tokens a lane, first position): a decode step, a prefill from 0,
# a chunk past position 0
MODES = {"decode": (5, 1, None), "prefill": (2, 40, 0), "chunk": (2, 12, 37)}


def _scatter_pages(k_pages, v_pages, k_new, v_new, block_tables, positions):
    """The page write as ``serving/paged_model.py`` had it before the fused
    kernel."""
    pg = k_pages.shape[2]
    rows = torch.gather(block_tables, 1, positions // pg).long()
    slots = (positions % pg).long()
    k_pages[rows, :, slots] = k_new.to(k_pages.dtype)
    v_pages[rows, :, slots] = v_new.to(v_pages.dtype)


def test_eps_is_layers_rms_norm_eps():
    eps = inspect.signature(L.rms_norm).parameters["eps"].default
    assert inspect.signature(norm_rope.rms_norm).parameters["eps"].default == eps
    assert inspect.signature(norm_rope.plain_rms_norm).parameters["eps"].default == eps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 1536), (4, 1, 4096)])
def test_plain_rms_norm_is_layers_rms_norm(dtype, shape):
    g = torch.Generator().manual_seed(sum(shape))
    x = (torch.randn(shape, generator=g) * 3).to(DT[dtype])
    scale = (1 + 0.1 * torch.randn(shape[-1], generator=g)).to(DT[dtype])
    got = ops.rms_norm(x, scale)
    assert got.dtype == x.dtype and torch.equal(got, L.rms_norm(x, scale))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 1536), (4, 1, 4096)])
def test_plain_rms_norm_with_residual_is_the_add_then_the_norm(dtype, shape):
    g = torch.Generator().manual_seed(7 + sum(shape))
    x, r = ((torch.randn(shape, generator=g) * s).to(DT[dtype]) for s in (2.0, 0.5))
    scale = (1 + 0.1 * torch.randn(shape[-1], generator=g)).to(DT[dtype])
    s, y = ops.rms_norm(x, scale, residual=r)
    want = x + r
    assert s.dtype == x.dtype and torch.equal(s, want)
    assert torch.equal(y, L.rms_norm(want, scale))


def _rope_case(hd: int, mode: str, dtype, H: int = 4, KV: int = 2, pg: int = 8):
    """q, k, v, positions, block tables and pages of one call: lanes hold
    distinct pages; in the decode step two lanes are idle (block table row
    of scratch page 0, position 0), as the engine leaves them."""
    B, S, start = MODES[mode]
    g = torch.Generator().manual_seed(hd * 131 + len(mode))
    pps = 8
    P = 1 + B * pps
    bt = (1 + torch.arange(B * pps, dtype=torch.int32)).view(B, pps)
    bt = bt[:, torch.randperm(pps, generator=g)].contiguous()
    if mode == "decode":
        pos = torch.randint(0, pps * pg, (B, 1), generator=g, dtype=torch.int32)
        idle = torch.tensor([1, 3])
        bt[idle] = 0
        pos[idle] = 0
    else:
        pos = (start + torch.arange(S, dtype=torch.int32))[None].expand(B, S).contiguous()
    q = torch.randn(B, S, H, hd, generator=g).to(dtype)
    k, v = (torch.randn(B, S, KV, hd, generator=g).to(dtype) for _ in range(2))
    pages = [torch.randn(P, KV, pg, hd, generator=g).to(dtype) for _ in range(2)]
    return q, k, v, pos, bt, pages


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_plain_rope_write_is_apply_rope_and_the_scatter(hd, mode, dtype):
    theta = 5e6 if hd == 128 else 1e4
    q, k, v, pos, bt, (kp, vp) = _rope_case(hd, mode, DT[dtype])
    want_k, want_v = kp.clone(), vp.clone()
    want_q, want_kr = L.apply_rope(q, pos, theta), L.apply_rope(k, pos, theta)
    _scatter_pages(want_k, want_v, want_kr, v, bt, pos)
    got_q, got_k = ops.rope_write(q, k, v, pos, L.rope_freqs(hd, theta), bt, kp, vp)
    assert got_q.dtype == q.dtype and torch.equal(got_q, want_q)
    assert torch.equal(got_k, want_kr)
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)  # every page, scratch 0 too
    # each live token at its page and slot; idle lanes' tokens at scratch page 0, slot 0
    pg = kp.shape[2]
    for b in range(pos.shape[0]):
        for s in range(pos.shape[1]):
            p = int(pos[b, s])
            page = int(bt[b, p // pg])
            if page == 0:
                assert p == 0
                continue
            assert torch.equal(kp[page, :, p % pg], got_k[b, s])
            assert torch.equal(vp[page, :, p % pg], v[b, s])
    idle = [b for b in range(bt.shape[0]) if not bt[b].any()]
    if idle:
        assert any(torch.equal(vp[0, :, 0], v[b, 0]) for b in idle)
        assert any(torch.equal(kp[0, :, 0], got_k[b, 0]) for b in idle)


# ---------------------------------------------------------------------------
# paged_forward against the block as written before the fused chains
# ---------------------------------------------------------------------------


def _block_as_before(x, p, cfg, kind, k_pages, v_pages, block_tables, positions, seq_lens,
                     prefill):
    h_in = L.norm(x, p["ln1"], cfg.norm)
    q, k_new, v_new = L.project_qkv(h_in, p["attn"], num_heads=cfg.num_heads,
                                    num_kv_heads=cfg.num_kv_heads,
                                    head_dim=cfg.resolved_head_dim, positions=positions,
                                    rope_theta=cfg.rope_theta)
    _scatter_pages(k_pages, v_pages, k_new, v_new, block_tables, positions)
    attn = PM._attention(q, k_new, v_new, k_pages, v_pages, block_tables, positions, seq_lens,
                         cfg, prefill)
    B, S = x.shape[0], x.shape[1]
    x = x + attn.reshape(B, S, cfg.num_heads * cfg.resolved_head_dim) @ p["attn"]["wo"]
    if kind == "moe":
        y, _ = MOE.moe_block(L.norm(x, p["ln2"], cfg.norm), p["moe"],
                             num_experts=cfg.num_experts, top_k=cfg.num_experts_per_tok,
                             capacity_factor=cfg.capacity_factor, act=cfg.act)
        return x + y
    return x + L.swiglu(L.norm(x, p["ln2"], cfg.norm), p["mlp"], cfg.act)


def _forward_as_before(params, tokens, cfg, k_pages, v_pages, block_tables, seq_lens):
    x = params["embed"][tokens.long()]
    B, S = tokens.shape
    positions = seq_lens[:, None] + torch.arange(S, dtype=torch.int32)[None, :]
    prefill = S > 1 and not bool(seq_lens.any())
    n_pat = len(cfg.block_pattern)
    for i in range(cfg.pattern_repeats):
        for j in range(n_pat):
            layer = i * n_pat + j
            x = _block_as_before(x, PM._layer(params["blocks"][str(j)], i), cfg,
                                 cfg.block_pattern[j], k_pages[layer], v_pages[layer],
                                 block_tables, positions, seq_lens + S, prefill)
    x = L.norm(x, params["final_norm"], cfg.norm)
    return M._logits(x[:, -1:], params, cfg)[:, 0]


def _serve_both_ways(arch: str):
    """A two-lane prefill from 0, a 5-token chunk past it, then three decode
    steps over three lanes (the third idle), by ``paged_forward`` and by the
    forward as it was; each call's logits and the pages after it equal."""
    cfg = get_config(arch, smoke=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    layers, KV, hd, pg = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim, 8
    kp = torch.zeros(layers, 13, KV, pg, hd, dtype=getattr(torch, cfg.dtype))
    pages = [(kp.clone(), kp.clone()) for _ in range(2)]
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], dtype=torch.int32)
    rng = np.random.default_rng(0)
    calls = [(2, 9, [0, 0]), (2, 5, [9, 9])] + [(3, 1, [14 + i, 14 + i, 0]) for i in range(3)]
    for B, S, lens in calls:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))).int()
        sl = torch.tensor(lens, dtype=torch.int32)
        got, _, _ = PM.paged_forward(params, toks, cfg, *pages[0], bt[:B], sl)
        want = _forward_as_before(params, toks, cfg, *pages[1], bt[:B], sl)
        assert torch.equal(got, want), (arch, B, S, lens)
        assert all(torch.equal(a, b) for a, b in zip(pages[0], pages[1]))
    return cfg


@pytest.mark.parametrize("arch", ["yi_6b", "granite_moe"])
def test_paged_forward_keeps_its_tokens(arch):
    assert _serve_both_ways(arch).norm == "rmsnorm"


def test_layernorm_config_keeps_its_plain_norm(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a layernorm config reached the RMSNorm kernel")

    monkeypatch.setattr(ops, "rms_norm", refuse)
    assert _serve_both_ways("musicgen_large").norm == "layernorm"
