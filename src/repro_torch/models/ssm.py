"""Recurrent and state-space blocks in torch: xLSTM (mLSTM + sLSTM) and
Mamba2-style SSD. Twins of the JAX package's ``models/ssm.py`` functions
of the same names, with its layouts, its float32 states and its bfloat16
rounding points (the key scale cast to the key's dtype, each step's output
cast to the input's dtype, the SSD input cast to the model's dtype before
the chunked scan).

The reference's three ``lax.scan`` time loops, mLSTM's, sLSTM's and SSD's
chunk loop, go through ``kernels.ops`` (``kernels/xlstm_scan.py``,
``kernels/ssd_scan.py``), and so does SSD's one-token decode step: CUDA
kernels on the card, forward and backward, and the plain loops of
``kernels/ref.py`` (a step per token or per chunk, ordinary autograd) on
the CPU and on ``meta``. The reference's
``unroll`` (of its scans) and ``shard_axis`` (its mesh) have no
counterpart here. On DTensors the projections stay DTensor
products, the head reshapes go through ``sharding.view``, and each scan
runs on each rank's batch shard (``sharding.per_batch_shard``), so a
time step costs plain-tensor ops, no DTensor dispatch. Each scan names
its tensors' head dims there, and its work is split over 'model' as
well: by heads where they divide it (sLSTM's recurrent matrices split
with them), else by the batch shard's rows.
"""

from __future__ import annotations

import math
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.parallel.sharding import per_batch_shard, reduced, view

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _f32(shape, device, fill: float = 0.0) -> torch.Tensor:
    return torch.full(shape, fill, dtype=torch.float32, device=device)


@per_batch_shard(heads=dict(q=1, k=1, v=1, i_pre=1, f_pre=1, state=1), out_heads=(1, 1))
def mlstm_scan(q, k, v, i_pre, f_pre, state=None):
    """Stabilized mLSTM recurrence over q, k, v [B,H,S,d] and the gate
    preactivations i_pre, f_pre [B,H,S]. Returns (h [B,H,S,d], final state
    (C [B,H,d,d], n [B,H,d], m [B,H], a 0-dim dummy)). The stabiliser m
    starts at -inf; the first step's forget term is zero."""
    B, H, S, d = q.shape
    k = k / torch.tensor(math.sqrt(d), dtype=torch.float32).to(k.dtype)
    if state is None:
        C, n, m = (_f32((B, H, d, d), q.device), _f32((B, H, d), q.device),
                   _f32((B, H), q.device, -math.inf))
    else:
        C, n, m = state[0], state[1], state[2]
    h, C, n, m = kops.mlstm_scan(q, k, v, i_pre.float(), F.logsigmoid(f_pre.float()), C, n, m)
    return h, (C, n, m, _f32((), q.device))


def mlstm_block(x, p: dict, *, num_heads: int, state=None):
    """x [B,S,D]. Params: wq/wk/wv [D,D], wi/wf [D,H], wo [D,D], ogate [D,D].
    Returns (out [B,S,D], new state)."""
    B, S, D = x.shape
    hd = D // num_heads

    def split(y):
        return view(y, B, S, num_heads, hd).transpose(1, 2)

    q, k, v = split(x @ p["wq"]), split(x @ p["wk"]), split(x @ p["wv"])
    i_pre = (x @ p["wi"]).transpose(1, 2)  # [B,H,S]
    f_pre = (x @ p["wf"]).transpose(1, 2)
    h, new_state = mlstm_scan(q, k, v, i_pre, f_pre, state)
    h = view(h.transpose(1, 2), B, S, D)
    o = torch.sigmoid(x @ p["ogate"])
    return reduced((o * h) @ p["wo"]), new_state


def mlstm_init_state(batch: int, num_heads: int, head_dim: int, device="cuda"):
    return (_f32((batch, num_heads, head_dim, head_dim), device),
            _f32((batch, num_heads, head_dim), device),
            _f32((batch, num_heads), device, -math.inf),
            _f32((), device))


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


@per_batch_shard(whole=("r",), heads=dict(zx=2, ix=2, fx=2, ox=2, r=0, state=1),
                 out_heads=(2, 1))
def _slstm_scan(zx, ix, fx, ox, r, state):
    """The sLSTM recurrence over the input preactivations [B,S,H,hd] and
    the recurrent matrices r [H,hd,4hd] from ``state``; (h [B,S,H,hd] in
    the inputs' dtype, the final state)."""
    hs, c, n, h, m = kops.slstm_scan(zx, ix, fx, ox, r, *state)
    return hs, (c, n, h, m)


def slstm_block(x, p: dict, *, num_heads: int, state=None):
    """Stabilized sLSTM with block-diagonal (per-head) recurrence.

    Params: wz/wi/wf/wo [D,D] input projections; rz/ri/rf/ro [H,hd,hd]
    recurrent mixing; wout [D,D]. State: (c, n, h) [B,H,hd] and m [B,H].
    The four recurrent products of a step are one batched product over
    the four matrices side by side."""
    B, S, D = x.shape
    H = num_heads
    hd = D // H
    if state is None:
        state = slstm_init_state(B, H, hd, x.device)
    zx, ix, fx, ox = (view(x @ p[k], B, S, H, hd) for k in ("wz", "wi", "wf", "wo"))
    r = torch.cat([p[k].float() for k in ("rz", "ri", "rf", "ro")], dim=-1)  # [H,hd,4hd]
    hs, new_state = _slstm_scan(zx, ix, fx, ox, r, state)
    return reduced(view(hs, B, S, D) @ p["wout"]), new_state


def slstm_init_state(batch: int, num_heads: int, head_dim: int, device="cuda"):
    z = _f32((batch, num_heads, head_dim), device)
    return (z, z, z, _f32((batch, num_heads), device, -math.inf))


# ---------------------------------------------------------------------------
# SSD (Mamba2-style, scalar per-head decay), chunkwise parallel
# ---------------------------------------------------------------------------


@per_batch_shard(heads=dict(x=2, b=2, c=2, log_a=2, state=1), out_heads=(2, 1))
def ssd_chunked(x, b, c, log_a, *, chunk: int = 256, state=None):
    """y[t] = C[t] . h[t], h[t] = a[t] h[t-1] + B[t] (x) x[t], over x
    [B,S,H,P], b, c [B,S,H,N], log_a [B,S,H] (<= 0), from ``state``
    [B,H,P,N] (zeros when None). Quadratic within chunks, a loop across
    them. Returns (y [B,S,H,P] in x's dtype, final state f32).

    The intra-chunk decay exp(la_t - la_s) is taken only where s <= t: the
    reference exponentiates every (t, s) and masks the product after, which
    gives the same values but, once a chunk's summed decay passes ~88
    (hymba-1.5b's 256-token chunks), an inf in the masked corner whose
    gradient is NaN. Masking the exponent first keeps the gradient finite;
    wherever the reference's is finite, the two agree (``kernels/ref.py``'s
    ``ref_ssd_chunked`` is the plain loop)."""
    return kops.ssd_chunked(x, b, c, log_a, chunk=chunk, state=state)


@per_batch_shard(heads=dict(x=1, b=1, c=1, log_a=1, state=1), out_heads=(1, 1))
def ssd_decode_step(x, b, c, log_a, state):
    """One-token recurrence. x [B,H,P]; b, c [B,H,N]; log_a [B,H]; state
    [B,H,P,N] f32."""
    return kops.ssd_decode(x, b, c, log_a, state)


def mamba_block(x, p: dict, *, num_heads: int, ssm_state: int, chunk: int = 256,
                state=None, decode: bool = False):
    """Mamba2-style block. Params: win [D, 2*Di + 2*H*N + H] fused input
    projection (x-path, z-gate, B, C, dt), a_log [H] and d_skip [H] (f32),
    wout [Di, D], Di = H * P. ``decode`` takes one token through
    :func:`ssd_decode_step`; otherwise :func:`ssd_chunked` over the
    sequence. Returns (out [B,S,D], new state)."""
    B, S, D = x.shape
    H, N = num_heads, ssm_state
    Di = p["wout"].shape[0]
    P = Di // H
    xin, z, bc, dt = (x @ p["win"]).split([Di, Di, 2 * H * N, H], dim=-1)
    bpart, cpart = bc.chunk(2, dim=-1)
    xin = view(xin, B, S, H, P)
    bpart = view(bpart, B, S, H, N)
    cpart = view(cpart, B, S, H, N)
    dt = F.softplus(dt.float())  # [B, S, H]
    log_a = -dt * torch.exp(p["a_log"].float())[None, None, :]
    xin_dt = xin.float() * dt[..., None]
    if decode:
        y, new_state = ssd_decode_step(xin_dt[:, 0], bpart[:, 0], cpart[:, 0],
                                       log_a[:, 0], state)
        y = y[:, None]
    else:
        y, new_state = ssd_chunked(xin_dt.to(x.dtype), bpart, cpart, log_a,
                                   chunk=min(chunk, S), state=state)
    y = y + xin.float() * p["d_skip"].float()[None, None, :, None]
    y = view(y, B, S, Di).to(x.dtype) * F.silu(z)
    return y @ p["wout"], new_state


def mamba_init_state(batch: int, num_heads: int, head_dim: int, ssm_state: int,
                     device="cuda") -> torch.Tensor:
    return _f32((batch, num_heads, head_dim, ssm_state), device)
