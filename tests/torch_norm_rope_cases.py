"""The paged block's fused chains (``kernels/norm_rope.py``) at the
benchmark's shapes: one case builder and one tolerance, shared by the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``'s phase 3.

``NR_MODELS`` holds the heads, widths and RoPE theta of yi-6b and
granite-moe; ``NR_CALLS`` the calls the serving cells make (decode steps of
320 and 512 lanes, a 4,000-token prefill, a 2 x 64 chunk at position 100).
``rope_case`` and ``norm_case`` build one call's inputs from a generator;
``ulps`` is the largest difference from the plain version in bf16 ulps
(float32: in units of 1e-6 of the plain output's largest magnitude), and
``within_one_ulp`` holds it to 1.
"""

import torch

# (H, KV, hd, D, rope theta)
NR_MODELS = {"yi_6b": (32, 4, 128, 4096, 5e6), "granite_moe": (24, 8, 64, 1536, 1e4)}
# (lanes, tokens a lane, first position; None: a decode step at random positions)
NR_CALLS = {"decode320": (320, 1, None), "decode512": (512, 1, None),
            "prefill4000": (1, 4000, 0), "chunk64at100": (2, 64, 100)}


def rope_case(gen, dev, model, call, dtype, pg=16, pps=256):
    """q, k, v, positions, inv_freq, block tables and pages (of q's dtype)
    of one call: each lane its own pages; in a decode step every ninth lane
    idle (block table row of scratch page 0, position 0), as the engine
    leaves them."""
    from repro_torch.models import layers

    H, KV, hd, _, theta = NR_MODELS[model]
    B, S, start = NR_CALLS[call]
    P = 1 + B * pps if B < 8 else 1 + B
    if start is None:
        pos = torch.randint(0, pps * pg, (B, 1), generator=gen, device=dev, dtype=torch.int32)
        bt = torch.zeros(B, pps, dtype=torch.int32, device=dev)
        bt[torch.arange(B, device=dev), (pos[:, 0] // pg).long()] = torch.arange(
            1, B + 1, dtype=torch.int32, device=dev)
        bt[::9], pos[::9] = 0, 0
    else:
        pos = (start + torch.arange(S, dtype=torch.int32, device=dev))[None].repeat(B, 1)
        bt = torch.stack([1 + b * pps + torch.randperm(pps, generator=gen, device=dev)
                          for b in range(B)]).to(torch.int32)
    q = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype) for _ in "kv")
    kp, vp = (torch.randn(P, KV, pg, hd, generator=gen, device=dev).to(dtype) for _ in "kv")
    return q, k, v, pos, layers.rope_freqs(hd, theta, dev), bt, kp, vp


def norm_case(gen, dev, model, call, dtype):
    """x [B, S, D], the residual (std 0.5) and the scale (1 + 0.1 N(0, 1))
    of one call's norm at the model's width."""
    D = NR_MODELS[model][3]
    B, S, _ = NR_CALLS[call]
    x = torch.randn(B, S, D, generator=gen, device=dev).to(dtype)
    scale = (1 + 0.1 * torch.randn(D, generator=gen, device=dev)).to(dtype)
    r = (0.5 * torch.randn(B, S, D, generator=gen, device=dev)).to(dtype)
    return x, r, scale


def ulps(got, want) -> float:
    """The largest difference of ``got`` from ``want`` in bf16 ulps of the
    larger magnitude (subnormals' step at least); float32: in units of 1e-6
    of ``want``'s largest magnitude (the rotation's difference of products
    cancels near zero)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float(), want.float()
    if got.dtype == torch.float32:
        unit = 1e-6 * max(float(w.abs().max()), 1e-30)
    else:
        _, e = torch.frexp(torch.maximum(g.abs(), w.abs()))
        unit = torch.ldexp(torch.ones_like(g), e - 8).clamp_min(2.0 ** -133)
    return float(((g - w).abs() / unit).max()) if g.numel() else 0.0


def within_one_ulp(what, got, want) -> float:
    """Hold ``got`` within one unit of :func:`ulps` of ``want``; returns the
    largest difference in those units."""
    worst = ulps(got, want)
    if not worst <= 1.0:
        raise AssertionError(f"{what}: {worst:.3g} units off its plain version (1 allowed)")
    return worst
