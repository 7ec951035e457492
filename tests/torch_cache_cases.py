"""The cache attention kernel's tile plan and walk, mirrored in numpy and
torch (``kernels/csrc/cache_attention.cu``), for the CPU tests.

A CTA of the bf16 kernel takes 128 query rows of one head, in two groups
of 64 (one a consumer warpgroup), and lists the K/V tiles of 128 slots its
rows' positions can see, each flagged, a group at a time, where every slot
of the tile is visible to every row of the group (no per-element mask).
(its producer warp walks the ring's tiles in slot order and hands each one
it keeps to the consumers with its flags). The CUDA-core kernel lists its
tiles first, with one group of 64 rows and 64-slot tiles. ``plan_tiles`` is
that plan as the kernels compute it (from each group's position range, not
row by row); ``check_plan`` holds it to the
visibility mask built from the positions; ``tiled_attention`` walks the
listed tiles with an online softmax, masking only where a tile is not
flagged for a row's group, as the kernel does, in float64;
``dense_attention`` is the function itself in float64, its oracle.

    PYTHONPATH=src python tests/torch_cache_cases.py

prints, for each of ``CASES``, the CTAs, listed tiles, tiles flagged full
for each group, and the mirror's largest difference from the oracle.
"""

import numpy as np
import torch

ROWS = 64  # query rows a group
BF16 = dict(groups=2, tile=128)  # cache_bf16_kernel: 128 rows a CTA, 128-slot tiles
SCALAR = dict(groups=1, tile=64)  # cache_scalar_kernel: 64 rows a CTA, 64-slot tiles
NEG = -1e30


def visible(qp, kp, window):
    """Which slots each query sees: [..., S, T] from q_pos [..., S] and k_pos
    [..., T] (-1 an empty slot)."""
    qp, kp = np.asarray(qp)[..., :, None], np.asarray(kp)[..., None, :]
    ok = (kp >= 0) & (qp >= kp)
    return ok & (qp - kp < window) if window > 0 else ok


def plan_tiles(q_pos, k_pos, q0, window, groups, tile):
    """The plan of the CTA whose rows start at q0, for one batch row's q_pos
    [S] and k_pos [T]: [(tile, (full for group 0, ...)), ...] in slot order.
    A group without a row below S counts as needing no mask."""
    S, T = len(q_pos), len(k_pos)
    ranges = []
    for g in range(groups):
        rows = np.asarray(q_pos[q0 + g * ROWS:min(q0 + (g + 1) * ROWS, S)], np.int64)
        ranges.append((int(rows.min()), int(rows.max())) if len(rows) else None)
    live = [r for r in ranges if r is not None]
    qmin, qmax = min(r[0] for r in live), max(r[1] for r in live)
    plan = []
    for i in range(-(-T // tile)):
        t = i * tile + np.arange(tile)
        p = np.where(t < T, np.asarray(k_pos, np.int64)[np.minimum(t, T - 1)], -1)
        near = (p >= 0) & (p <= qmax)
        if window > 0:
            near &= qmin - p < window
        if not near.any():
            continue
        flags = []
        for r in ranges:
            if r is None:
                flags.append(True)
                continue
            lo, hi = r
            all_in = (p >= 0) & (p <= lo)
            if window > 0:
                all_in &= hi - p < window
            flags.append(bool(all_in.all()))
        plan.append((i, tuple(flags)))
    return plan


def check_plan(q_pos, k_pos, window, groups, tile):
    """Every CTA's plan over one batch row: tiles listed once each in slot
    order; every visible (row, slot) pair in a listed tile; every tile
    flagged full for a group with all its slots inside T and visible to
    every row of the group below S. Returns (CTAs, listed tiles, flagged
    (tile, group) pairs)."""
    S, T = len(q_pos), len(k_pos)
    vis = visible(q_pos, k_pos, window)
    ctas = listed = flagged = 0
    for q0 in range(0, S, groups * ROWS):
        plan = plan_tiles(q_pos, k_pos, q0, window, groups, tile)
        tiles = [i for i, _ in plan]
        assert tiles == sorted(set(tiles)), tiles
        rows = slice(q0, min(q0 + groups * ROWS, S))
        need = set((np.nonzero(vis[rows])[1] // tile).tolist())
        assert need <= set(tiles), sorted(need - set(tiles))
        for i, flags in plan:
            for g, full in enumerate(flags):
                r = slice(q0 + g * ROWS, min(q0 + (g + 1) * ROWS, S))
                if full and r.start < S:
                    assert (i + 1) * tile <= T, (i, g)
                    assert vis[r, i * tile:(i + 1) * tile].all(), (q0, i, g)
                flagged += full
        ctas, listed = ctas + 1, listed + len(plan)
    return ctas, listed, flagged


def tiled_attention(q, k, v, q_pos, k_pos, window=0, softcap=0.0, groups=2, tile=128):
    """The kernel's walk in float64: q [B,S,H,hd], k, v [B,T,KV,hd], q_pos
    [B,S], k_pos [B,T] (torch); each CTA's listed tiles in order, slots
    past T read as zeros (the TMA's fill) and masked through their -1
    position, a tile masked element by element only for the groups it is
    not flagged full for; an online softmax from m = -1e30, out = acc /
    max(l, 1e-30). -> [B,S,H,hd] float64."""
    q, k, v = (t.double() for t in (q, k, v))
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    pad = -(-T // tile) * tile - T
    kz, vz = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    kpz = torch.nn.functional.pad(k_pos, (0, pad), value=-1).numpy()
    qp = q_pos.numpy()
    out = torch.zeros_like(q)
    for b in range(B):
        for q0 in range(0, S, groups * ROWS):
            plan = plan_tiles(qp[b], k_pos[b].numpy(), q0, window, groups, tile)
            rows = torch.arange(q0, min(q0 + groups * ROWS, S))
            group = ((rows - q0) // ROWS).numpy()
            for h in range(H):
                kh, vh = kz[b, :, h % KV], vz[b, :, h % KV]
                m = torch.full((len(rows),), NEG, dtype=torch.float64)
                l, acc = torch.zeros_like(m), torch.zeros(len(rows), hd, dtype=torch.float64)
                for i, flags in plan:
                    t = slice(i * tile, (i + 1) * tile)
                    s = q[b, rows, h] @ kh[t].T / hd ** 0.5
                    if softcap > 0:
                        s = softcap * torch.tanh(s / softcap)
                    masked = ~np.asarray(flags)[group]
                    hide = masked[:, None] & ~visible(qp[b, rows.numpy()], kpz[b, t], window)
                    s = s.masked_fill(torch.from_numpy(hide), NEG)
                    mn = torch.maximum(m, s.max(dim=1).values)
                    corr = torch.exp(m - mn)
                    p = torch.where(s == NEG, 0.0, torch.exp(s - mn[:, None]))
                    l, acc, m = l * corr + p.sum(dim=1), acc * corr[:, None] + p @ vh[t], mn
                out[b, rows, h] = acc / l.clamp_min(1e-30)[:, None]
    return out


def dense_attention(q, k, v, q_pos, k_pos, window=0, softcap=0.0):
    """The function itself in float64, over the whole ring at once: a
    softmax over the slots each query sees (``visible``), 0 for a query
    that sees none. -> [B,S,H,hd] float64."""
    q, k, v = (t.double() for t in (q, k, v))
    H, KV = q.shape[2], k.shape[2]
    idx = torch.arange(H) % KV  # r-major GQA
    s = torch.einsum("bshd,bthd->bhst", q, k[:, :, idx]) / q.shape[-1] ** 0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    vis = torch.from_numpy(visible(q_pos.numpy(), k_pos.numpy(), window))[:, None]
    s = s.masked_fill(~vis, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    return torch.einsum("bhst,bthd->bshd", p, v[:, :, idx])


def ring(rng, B, S, T, kind):
    """q_pos [B,S] and k_pos [B,T] int32 of a ring of T slots: ``prefix``, a
    prefill of S into a ring that held T // 3 positions, in slot order
    (llava's prefill has none before it); ``wrap``, a ring written up to
    position N > T (slot t the latest p = t mod T), a sixth of its slots
    emptied at random, queries at the last S positions, and query 0 of row 0
    at position 0, which sees no slot; ``chunk2``, the second chunk of a
    windowed prefill (hymba's): positions 0..2S-1 written into a ring of T
    = the window, queries at S..2S-1; ``blind``, slots holding positions
    S.. and queries at 0..S-1 (no query sees a slot)."""
    if kind == "blind":
        k_pos = np.broadcast_to(np.arange(S, S + T), (B, T)).copy()
        q_pos = np.broadcast_to(np.arange(S), (B, S)).copy()
    elif kind == "prefix":
        n = min(T, T // 3 + S)
        k_pos = np.broadcast_to(np.where(np.arange(T) < n, np.arange(T), -1), (B, T)).copy()
        q_pos = np.broadcast_to(np.arange(n - S, n), (B, S)).copy()
    elif kind == "chunk2":
        n = 2 * S
        t = np.arange(T)
        p = n - 1 - (n - 1 - t) % T
        k_pos = np.broadcast_to(np.where(p >= 0, p, -1), (B, T)).copy()
        q_pos = np.broadcast_to(np.arange(S, n), (B, S)).copy()
    else:
        N = T + T // 2 + 5
        k_pos = np.stack([N - 1 - (N - 1 - np.arange(T)) % T for _ in range(B)])
        k_pos[rng.random((B, T)) < 1 / 6] = -1
        q_pos = np.broadcast_to(np.arange(N - S, N), (B, S)).copy()
        q_pos[0, 0] = 0
    return q_pos.astype(np.int32), k_pos.astype(np.int32)


# (S, T, window, kind): S below, at and past 64 and 128; a prefill into an
# empty ring (llava's, cut); wrapped rings with empty slots, windows; the
# second chunk of a windowed prefill (hymba's, cut); no visible slot
CASES = {
    "prefix-S1": (1, 300, 0, "prefix"),
    "prefix-S63": (63, 200, 0, "prefix"),
    "prefix-S64": (64, 256, 0, "prefix"),
    "prefix-S65": (65, 257, 0, "prefix"),
    "prefix-S127": (127, 400, 0, "prefix"),
    "prefix-S129": (129, 391, 0, "prefix"),
    "llava-cut": (300, 332, 0, "prefix"),
    "wrap": (70, 200, 0, "wrap"),
    "wrap-window": (130, 257, 48, "wrap"),
    "wrap-window-S200": (200, 384, 100, "wrap"),
    "chunk2-window": (256, 256, 256, "chunk2"),
    "chunk2-window-ragged": (150, 150, 150, "chunk2"),
    "blind": (70, 100, 0, "blind"),
}


def main() -> None:
    rng = np.random.default_rng(0)
    for name, (S, T, window, kind) in CASES.items():
        q_pos, k_pos = ring(rng, 2, S, T, kind)
        stats = [check_plan(q_pos[b], k_pos[b], window, **BF16) for b in range(2)]
        g = torch.Generator().manual_seed(S + T)
        q = torch.randn(2, S, 4, 16, generator=g, dtype=torch.float64)
        k, v = (torch.randn(2, T, 2, 16, generator=g, dtype=torch.float64) for _ in range(2))
        qp, kp = torch.from_numpy(q_pos), torch.from_numpy(k_pos)
        got = tiled_attention(q, k, v, qp, kp, window)
        want = dense_attention(q, k, v, qp, kp, window)
        print(f"{name}: (CTAs, listed, flagged) by batch row {stats}; mirror - dense "
              f"{(got - want).abs().max().item():.3e}")


if __name__ == "__main__":
    main()
