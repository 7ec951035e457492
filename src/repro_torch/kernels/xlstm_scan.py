"""The xLSTM time loops, mLSTM and sLSTM, forward and backward: CUDA kernels
(``csrc/mlstm_scan.cu``, ``csrc/slstm_scan.cu``) and their wrappers.

Replaces the reference's two ``lax.scan`` sites, which XLA runs as one loop
on the device each (and their gradients as reverse scans):
``repro/models/ssm.py`` :: ``mlstm_scan`` (the scan at :90) and
``slstm_block`` (the scan at :170). The kernels compute the plain loops
of ``ref.py`` (``ref_mlstm_scan``, ``ref_slstm_scan``) in float32, each h
cast to the input's dtype as it is written, within the plain loops'
tolerances (float32: a relative L2 of 1e-4; bf16: 2e-2 + 2e-2 |plain|),
not bit for bit.

The mLSTM forward is chunkwise parallel: the stabiliser m is a max-plus
recurrence of the gates alone and the state update is linear, so the
kernel runs S / ``kernel_chunk()`` chunks (of 32), each a warp's scan for
m and the in-chunk weights, then the chunk's products (Q K^T, P V, Q C0,
K^T (w V)) on the tensor cores in bf16, the float32 operands as two bf16
parts (hi + lo), or on the CUDA cores in float32. Its value columns are
split over CTAs (32 each), every CTA keeping its slice of C in mma
accumulators and recomputing the O(chunk) chain alike, so no CTA waits on
another. The chunk is the checkpoint interval, so each chunk's entry
state is the checkpoint the backward reads. The sLSTM's chain is real (h
feeds the gates through r): a cluster of 8 CTAs a head and up to 4 batch
rows keeps the z and o columns of r in registers, every CTA forms the two
per-head gate means itself from the whole h it holds (mean(ix + h r_i) =
mean(ix) + h . w_i, w_i = r_i summed over its columns), and a step's h goes
round the cluster through distributed shared memory into a
double-buffered h: one cluster barrier a step. See the sources for the
layouts.

Backward: the forward saves what the backward kernels read (the mLSTM's C
every ``kernel_chunk()`` steps and its O(S d) vectors; the sLSTM's
per-step states and gates), and each backward is two launches: the
reverse loop, then a fixed-order reduction. The mLSTM's is chunkwise like
its forward: the chunks walked backwards, each one's weights from the
saved m_t (no chain inside a chunk), the forward's four products reversed
on the tensor cores (dv = P^T dNum + w_last K dC, dq = (w dP) K + c dNum
C0^T, dk = (w dP)^T Q + w_last V dC^T, the entry dC = Q^T (c dNum) +
c_last dC) with each CTA's slice of dC in mma accumulators, and the gate
gradients formed as di i and df f, never divided by a gate; its second
launch sums the value blocks' partials in order and runs the stabiliser
chain. The sLSTM's is its forward transposed: each CTA holds the rows of
r's z and o blocks for its elements, the i and f blocks enter through
their column sums alone, a step's z and o gradients and partial sums go
round the cluster once (one cluster barrier a step), and each CTA forms
dh_{t-1} for its own elements; its second launch forms dr, the z and o
blocks a tiled product, the i and f blocks one sum each. No float
atomics, so a gradient is the same bits run after run.

On a CPU or ``meta`` tensor the entry points run the plain loop with
ordinary autograd (the dry run traces on ``meta``); on a CUDA tensor they
launch the kernels or raise. Where autograd records, the call goes through
:class:`MLSTM` / :class:`SLSTM` (``torch.autograd.Function``s whose
forward saves and whose backward launches the backward kernels; on CPU
tensors they run ``ref.py``'s plain forward-with-saves and backward, which
the tests hold to autograd); elsewhere the forward kernel runs without
saving. ``launches`` counts kernel launches by kernel:
``LAUNCHES_PER_CALL`` of them a call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

KERNELS = ("mlstm_fwd", "mlstm_bwd", "slstm_fwd", "slstm_bwd")
LAUNCHES_PER_CALL = {"mlstm_fwd": 1, "mlstm_bwd": 2, "slstm_fwd": 1, "slstm_bwd": 2}
launches = dict.fromkeys(KERNELS, 0)
# The plain path's checkpoint interval (CPU and ``meta`` tensors). On the
# card the interval is the forward kernel's chunk, whose entry states it
# saves for the backward, and the library reports it: ``kernel_chunk()``.
CHECKPOINT_EVERY = 32


def kernel_chunk() -> int:
    """The mLSTM kernels' chunk (32: a chunk's products on whole m16n8k16
    tiles, its in-chunk weights one warp's scan), the checkpoint interval
    of the saves the forward writes and the chunk the backward walks."""
    return _build.lib().rt_mlstm_chunk()

plain_mlstm = ref.ref_mlstm_scan
plain_slstm = ref.ref_slstm_scan


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def _mlstm_args(q, k, v, log_i, log_f, C, n, m):
    B, H, S, d = q.shape
    f32 = torch.float32
    _build.check_args("mlstm", q.device, {
        "k": (k, q.shape, q.dtype), "v": (v, q.shape, q.dtype),
        "log_i": (log_i, (B, H, S), f32), "log_f": (log_f, (B, H, S), f32),
        "C": (C, (B, H, d, d), f32), "n": (n, (B, H, d), f32), "m": (m, (B, H), f32)},
        q.dtype)
    top = _build.lib().rt_mlstm_max_d()
    _build.require(1 <= d <= top, f"mlstm: head dim {d} not in 1..{top}")
    return _build.contiguous(q, k, v, log_i, log_f, C, n, m)


def mlstm_fwd(q, k, v, log_i, log_f, C, n, m, *, save: bool = False):
    """The forward kernel: (h, C, n, m, saved) with ``saved`` as
    ``ref.ref_mlstm_fwd_saved`` gives it, or None without ``save``."""
    q, k, v, log_i, log_f, C, n, m = _mlstm_args(q, k, v, log_i, log_f, C, n, m)
    B, H, S, d = q.shape
    h = torch.empty_like(q)
    out = (torch.empty_like(C), torch.empty_like(n), torch.empty_like(m))
    saved = None
    if save:
        saved = (_build.empty(-(-S // kernel_chunk()), B, H, d, d, like=q),
                 _build.empty(B, H, S + 1, d, like=q), _build.empty(B, H, S + 1, like=q),
                 _build.empty(B, H, S, like=q), _build.empty(B, H, S, d, like=q))
    if B * H == 0:
        return (h, *(t.copy_(s) for t, s in zip(out, (C, n, m))), saved)
    lib = _build.lib()
    sv = [None] * 5 if saved is None else [t.data_ptr() for t in saved]
    err = lib.rt_mlstm_fwd(*(t.data_ptr() for t in (q, k, v, log_i, log_f, C, n, m, h, *out)),
                           *sv, B, H, S, d, _build.DTYPE_CODES[q.dtype],
                           _build.stream_ptr(q.device))
    _build.check(err, "mlstm_fwd")
    launches["mlstm_fwd"] += LAUNCHES_PER_CALL["mlstm_fwd"]
    return (h, *out, saved)


def mlstm_bwd(q, k, v, log_i, log_f, saved, dh, dC, dn, dm):
    """The backward kernels: the gradients of (q, k, v, log_i, log_f, C, n,
    m) from the forward's ``saved`` and the gradients of (h, C, n, m), as
    ``ref.ref_mlstm_bwd`` computes them."""
    q, k, v, log_i, log_f = _build.contiguous(q, k, v, log_i, log_f)
    B, H, S, d = q.shape
    _build.check_args("mlstm_bwd", q.device, {"dh": (dh, q.shape, q.dtype)}, q.dtype)
    dh, dC, dn, dm = _build.contiguous(dh, dC, dn, dm)
    lib = _build.lib()
    nx = -(-d // lib.rt_mlstm_block_v())
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dli, dlf = torch.empty_like(log_i), torch.empty_like(log_f)
    dC0, dn0, dm0 = torch.empty_like(dC), torch.empty_like(dn), torch.empty_like(dm)
    if B * H == 0:
        return dq, dk, dv, dli, dlf, dC0, dn0, dm0
    scratch = (_build.empty(nx, B, H, S, d, like=q), _build.empty(nx, B, H, S, d, like=q),
               _build.empty(nx, B, H, S, like=q), _build.empty(nx, B, H, S, like=q),
               _build.empty(B, H, S, like=q), _build.empty(B, H, S, like=q))
    err = lib.rt_mlstm_bwd(*(t.data_ptr() for t in (
        q, k, v, log_i, log_f, *saved, dh, dC, dn, dm, dq, dk, dv, dli, dlf, dC0, dn0, dm0,
        *scratch)), B, H, S, d, _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    _build.check(err, "mlstm_bwd")
    launches["mlstm_bwd"] += LAUNCHES_PER_CALL["mlstm_bwd"]
    return dq, dk, dv, dli, dlf, dC0, dn0, dm0


class MLSTM(torch.autograd.Function):
    """The mLSTM recurrence with a backward of its own: the kernels on CUDA
    tensors, ``ref.py``'s plain forward-with-saves and backward on CPU ones."""

    @staticmethod
    def forward(ctx, q, k, v, log_i, log_f, C, n, m):
        if q.is_cuda:
            h, C, n, m, saved = mlstm_fwd(q, k, v, log_i, log_f, C, n, m, save=True)
        else:
            h, C, n, m, saved = ref.ref_mlstm_fwd_saved(q, k, v, log_i, log_f, C, n, m,
                                                        CHECKPOINT_EVERY)
        ctx.save_for_backward(q, k, v, log_i, log_f, *saved)
        return h, C, n, m

    @staticmethod
    def backward(ctx, dh, dC, dn, dm):
        q, k, v, log_i, log_f, *saved = ctx.saved_tensors
        if q.is_cuda:
            grads = mlstm_bwd(q, k, v, log_i, log_f, saved, dh, dC, dn, dm)
        else:
            grads = ref.ref_mlstm_bwd(q, k, v, log_i, log_f, saved, dh, dC, dn, dm,
                                      CHECKPOINT_EVERY)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def mlstm(q, k, v, log_i, log_f, C, n, m):
    """The mLSTM recurrence: (h [B,H,S,d] in q's dtype, C, n, m). q, k, v
    [B,H,S,d] (k scaled by 1/sqrt(d) in its dtype), log_i, log_f [B,H,S]
    float32, the state C [B,H,d,d], n [B,H,d], m [B,H] float32."""
    args = (q, k, v, log_i, log_f, C, n, m)
    if _build.on_host(q):
        return plain_mlstm(*args)
    if _build.records(*args):
        return MLSTM.apply(*args)
    return mlstm_fwd(*args)[:4]


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def _slstm_args(zx, ix, fx, ox, r, c, n, h, m):
    B, S, H, hd = zx.shape
    f32 = torch.float32
    _build.check_args("slstm", zx.device, {
        "ix": (ix, zx.shape, zx.dtype), "fx": (fx, zx.shape, zx.dtype),
        "ox": (ox, zx.shape, zx.dtype), "r": (r, (H, hd, 4 * hd), f32),
        "c": (c, (B, H, hd), f32), "n": (n, (B, H, hd), f32), "h": (h, (B, H, hd), f32),
        "m": (m, (B, H), f32)}, zx.dtype)
    top = _build.lib().rt_slstm_max_hd()
    _build.require(1 <= hd <= top, f"slstm: head dim {hd} not in 1..{top}")
    return _build.contiguous(zx, ix, fx, ox, r, c, n, h, m)


def slstm_fwd(zx, ix, fx, ox, r, c, n, h, m, *, save: bool = False):
    """The forward kernel: (hs, c, n, h, m, saved) with ``saved`` as
    ``ref.ref_slstm_fwd_saved`` gives it, or None without ``save``."""
    zx, ix, fx, ox, r, c, n, h, m = _slstm_args(zx, ix, fx, ox, r, c, n, h, m)
    B, S, H, hd = zx.shape
    hs = torch.empty_like(zx)
    out = tuple(torch.empty_like(t) for t in (c, n, h, m))
    saved = None
    if save:
        saved = (*(_build.empty(B, S + 1, H, hd, like=zx) for _ in range(3)),
                 *(_build.empty(B, S, H, hd, like=zx) for _ in range(2)),
                 *(_build.empty(B, S, H, like=zx) for _ in range(2)),
                 _build.empty(B, S + 1, H, like=zx))
    if B * H == 0:
        return (hs, *(t.copy_(s) for t, s in zip(out, (c, n, h, m))), saved)
    lib = _build.lib()
    sv = [None] * 8 if saved is None else [t.data_ptr() for t in saved]
    err = lib.rt_slstm_fwd(*(t.data_ptr() for t in (zx, ix, fx, ox, r, c, n, h, m, hs, *out)),
                           *sv, B, S, H, hd, _build.DTYPE_CODES[zx.dtype],
                           _build.stream_ptr(zx.device))
    _build.check(err, "slstm_fwd")
    launches["slstm_fwd"] += LAUNCHES_PER_CALL["slstm_fwd"]
    return (hs, *out, saved)


def slstm_bwd(r, saved, dhs, dc, dn, dh, dm):
    """The backward kernels: the gradients of (zx, ix, fx, ox, r, c, n, h,
    m) from the forward's ``saved`` and the gradients of (hs, c, n, h, m),
    as ``ref.ref_slstm_bwd`` computes them."""
    B, S, H, hd = dhs.shape
    _build.check_args("slstm_bwd", dhs.device, {"r": (r, (H, hd, 4 * hd), torch.float32)},
                      dhs.dtype)
    r, dhs, dc, dn, dh, dm = _build.contiguous(r, dhs, dc, dn, dh, dm)
    dx = tuple(torch.empty_like(dhs) for _ in range(4))
    dr = torch.empty_like(r)
    d0 = tuple(torch.empty_like(t) for t in (dc, dn, dh, dm))
    if B * H == 0:
        return (*dx, dr.zero_(), *d0)
    drec = _build.empty(H, B, S, 2 * hd + 2, like=dhs)  # a step's gz, go, gi, gf
    lib = _build.lib()
    err = lib.rt_slstm_bwd(*(t.data_ptr() for t in (r, *saved, dhs, dc, dn, dh, dm, *dx, dr,
                                                    *d0, drec)),
                           B, S, H, hd, _build.DTYPE_CODES[dhs.dtype],
                           _build.stream_ptr(dhs.device))
    _build.check(err, "slstm_bwd")
    launches["slstm_bwd"] += LAUNCHES_PER_CALL["slstm_bwd"]
    return (*dx, dr, *d0)


class SLSTM(torch.autograd.Function):
    """The sLSTM recurrence with a backward of its own: the kernels on CUDA
    tensors, ``ref.py``'s plain forward-with-saves and backward on CPU ones."""

    @staticmethod
    def forward(ctx, zx, ix, fx, ox, r, c, n, h, m):
        fwd = slstm_fwd if zx.is_cuda else ref.ref_slstm_fwd_saved
        kw = {"save": True} if zx.is_cuda else {}
        hs, c, n, h, m, saved = fwd(zx, ix, fx, ox, r, c, n, h, m, **kw)
        ctx.save_for_backward(r, *saved)
        return hs, c, n, h, m

    @staticmethod
    def backward(ctx, dhs, dc, dn, dh, dm):
        r, *saved = ctx.saved_tensors
        bwd = slstm_bwd if r.is_cuda else ref.ref_slstm_bwd
        grads = bwd(r, saved, dhs, dc, dn, dh, dm)
        return tuple(g if need else None for g, need in zip(grads, ctx.needs_input_grad))


def slstm(zx, ix, fx, ox, r, c, n, h, m):
    """The sLSTM recurrence: (hs [B,S,H,hd] in zx's dtype, c, n, h, m). zx,
    ix, fx, ox [B,S,H,hd]; r [H,hd,4hd], c, n, h [B,H,hd], m [B,H] float32."""
    args = (zx, ix, fx, ox, r, c, n, h, m)
    if _build.on_host(zx):
        return plain_slstm(*args)
    if _build.records(*args):
        return SLSTM.apply(*args)
    return slstm_fwd(*args)[:5]
