"""SSD's chunk loop and its one-token decode step, forward and backward:
CUDA kernels (``csrc/ssd_scan.cu``) and their wrappers.

Replaces the reference's third ``lax.scan`` site, which XLA runs as one
loop over chunks on the device (and its gradient as a reverse scan):
``repro/models/ssm.py`` :: ``ssd_chunked`` (the scan at :236), and its
``ssd_decode_step`` (:241). The kernels compute the plain loop of
``ref.py`` (``ref_ssd_chunked``, ``ref_ssd_decode_step``) in float32, y
cast to x's dtype once, the intra-chunk decay exp(la_t - la_s) formed only
where s <= t.

What bounds them: a chunk of a head is the causal [L, L] matrix (C B^T)
o decay against N + P columns (~3 MFLOP at 256 tokens), and the chunks of
a head are a chain. So each chunk's products run on the tensor cores
(mma.sync, the float32 operands as bf16 hi + lo parts; float32 inputs
split alike) with the [L, L] matrix kept in registers, 16 x 16 tiles on
and below the diagonal, the 16-row strips dealt to the warps in balanced
pairs. A CTA takes one chunk of 64 value columns and 16 state columns of a
(head, row), and the CTAs of up to 4 consecutive chunks form a cluster:
each forms its chunk's own change of the state, and after one cluster
barrier every CTA walks the chain over the cluster's chunks in order
through distributed shared memory, so the chunks of a head run side by
side and the chain keeps its order and bits. The forward is one launch;
past N = 16 the state tiles' partial y are summed by a second launch. The
decode step is one launch that reads x, b, c and log_a in place through
their strides (hymba's b and c are views into its fused projection) and
the state's rows coalesced, a few threads a value column.

Backward: the forward saves the state at each chunk's start ([nc, B, H,
P, N] float32, nothing per token). The same clusters walk dh back from
the last chunk, each chunk recomputed from its saved state: a row pass
(dc, the row sums of d la) while the cluster's changes of dh come in, then
a column pass (dx, db, the column sums), d log_a a warp scan. Where one
CTA holds all of P and N (P <= 64, N <= 16: hymba-1.5b) that is the whole
backward, one launch; otherwise a second launch sums the float32 partials
of db, dc and d log_a over the value blocks (and of dx's and d log_a's
over the state tiles) in a fixed order. No float atomics, so a gradient is
the same bits run after run.

On a CPU or ``meta`` tensor the entry points run the plain loop with
ordinary autograd (the dry run traces on ``meta``); on a CUDA tensor they
launch the kernels or raise. Where autograd records, the chunked scan goes
through :class:`SSD` (a ``torch.autograd.Function`` whose forward saves
and whose backward launches the backward kernels; on CPU tensors it runs
``ref.py``'s plain forward-with-saves and backward, which the tests hold
to autograd); elsewhere the forward kernel runs alone. The reference's
``ssd_decode_step`` is plain jnp that ``jax.grad`` differentiates (no
Pallas kernel), so a decode step on CUDA tensors that autograd records
goes through :class:`SSDDecode`: the decode kernel forward, and a backward
that recomputes the plain step's vjp from the saved inputs. ``launches``
counts kernel launches by kernel: ``LAUNCHES_PER_CALL`` of them a call,
one more where a call's state is wider than 16 (and, for the backward,
where P is wider than 64).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

KERNELS = ("ssd_fwd", "ssd_bwd", "ssd_decode")
LAUNCHES_PER_CALL = {"ssd_fwd": 1, "ssd_bwd": 1, "ssd_decode": 1}
launches = dict.fromkeys(KERNELS, 0)

plain_chunked = ref.ref_ssd_chunked
plain_decode = ref.ref_ssd_decode_step


def _chunk_args(x, b, c, log_a, state, chunk):
    B, S, H, P = x.shape
    N = b.shape[-1]
    f32 = torch.float32
    _build.check_args("ssd", x.device, {
        "b": (b, (B, S, H, N), x.dtype), "c": (c, (B, S, H, N), x.dtype),
        "log_a": (log_a, (B, S, H), f32), "state": (state, (B, H, P, N), f32)}, x.dtype)
    top = _build.lib().rt_ssd_max_chunk()
    _build.require(1 <= chunk <= top, f"ssd: chunk {chunk} not in 1..{top}")
    _build.require(N >= 1, "ssd: state width N=0")
    return _build.contiguous(x, b, c, log_a, state)


def _tiles(N: int) -> int:
    """The state tiles of width rt_ssd_block_n() the kernels split N into."""
    return -(-N // _build.lib().rt_ssd_block_n())


def ssd_fwd(x, b, c, log_a, state, *, chunk: int, save: bool = False):
    """The forward kernel: (y, final state, saved) with ``saved`` as
    ``ref.ref_ssd_fwd_saved`` gives it, or None without ``save``."""
    x, b, c, log_a, state = _chunk_args(x, b, c, log_a, state, chunk)
    B, S, H, P = x.shape
    y, h = torch.empty_like(x), torch.empty_like(state)
    saved = _build.empty(-(-S // chunk), B, H, P, b.shape[-1], like=x) if save else None
    if B * S * H * P == 0:
        return y, h.copy_(state), saved
    nt = _tiles(b.shape[-1])
    ypart = _build.empty(nt, B, S, H, P, like=x) if nt > 1 else None
    err = _build.lib().rt_ssd_fwd(*(t.data_ptr() for t in (x, b, c, log_a, state, y, h)),
                                  *(None if t is None else t.data_ptr() for t in (saved, ypart)),
                                  B, S, H, P, b.shape[-1], chunk, _build.DTYPE_CODES[x.dtype],
                                  _build.stream_ptr(x.device))
    _build.check(err, "ssd_fwd")
    launches["ssd_fwd"] += LAUNCHES_PER_CALL["ssd_fwd"] + (nt > 1)  # + the tiles' sum
    return y, h, saved


def ssd_bwd(x, b, c, log_a, saved, dy, dh, *, chunk: int):
    """The backward kernels: the gradients of (x, b, c, log_a, state) from
    the forward's ``saved`` and the gradients of (y, final state), as
    ``ref.ref_ssd_bwd`` computes them."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    x, b, c, log_a, dh = _chunk_args(x, b, c, log_a, dh, chunk)
    _build.check_args("ssd_bwd", x.device, {
        "dy": (dy, x.shape, x.dtype),
        "saved": (saved, (-(-S // chunk), B, H, P, N), torch.float32)}, x.dtype)
    dy, saved = _build.contiguous(dy, saved)
    dx, db, dc = torch.empty_like(x), torch.empty_like(b), torch.empty_like(c)
    dla, dh0 = torch.empty_like(log_a), torch.empty_like(dh)
    if B * S * H * P == 0:
        return dx, db.zero_(), dc.zero_(), dla.zero_(), dh0.copy_(dh)
    lib = _build.lib()
    npb, nt = -(-P // lib.rt_ssd_block_p()), _tiles(N)
    split = npb > 1 or nt > 1  # partials, and the second launch that sums them
    scratch = ((_build.empty(npb, B, S, H, N, like=x), _build.empty(npb, B, S, H, N, like=x),
                _build.empty(nt * npb, B, S, H, like=x)) if split else (None,) * 3)
    dx_part = _build.empty(nt, B, S, H, P, like=x) if nt > 1 else None
    err = lib.rt_ssd_bwd(*(t.data_ptr() for t in (x, b, c, log_a, saved, dy, dh, dx, db, dc,
                                                  dla, dh0)),
                         *(None if t is None else t.data_ptr() for t in (*scratch, dx_part)),
                         B, S, H, P, N, chunk, _build.DTYPE_CODES[x.dtype],
                         _build.stream_ptr(x.device))
    _build.check(err, "ssd_bwd")
    launches["ssd_bwd"] += LAUNCHES_PER_CALL["ssd_bwd"] + split
    return dx, db, dc, dla, dh0


class SSD(torch.autograd.Function):
    """SSD's chunked scan with a backward of its own: the kernels on CUDA
    tensors, ``ref.py``'s plain forward-with-saves and backward on CPU ones."""

    @staticmethod
    def forward(ctx, x, b, c, log_a, state, chunk):
        if x.is_cuda:
            y, h, saved = ssd_fwd(x, b, c, log_a, state, chunk=chunk, save=True)
        else:
            y, h, saved = ref.ref_ssd_fwd_saved(x, b, c, log_a, state, chunk)
        ctx.chunk = chunk
        ctx.save_for_backward(x, b, c, log_a, saved)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, b, c, log_a, saved = ctx.saved_tensors
        if x.is_cuda:
            grads = ssd_bwd(x, b, c, log_a, saved, dy, dh, chunk=ctx.chunk)
        else:
            grads = ref.ref_ssd_bwd(x, b, c, log_a, saved, dy, dh, ctx.chunk)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)), None)


def ssd_chunked(x, b, c, log_a, *, chunk: int, state=None):
    """SSD's chunked scan: (y [B, S, H, P] in x's dtype, final state [B, H,
    P, N] float32) over x [B, S, H, P], b, c [B, S, H, N] (x's dtype),
    log_a [B, S, H] float32 from ``state`` (zeros when None). The chunk
    orders the sums only: the recurrence is exact at any chunk, so on the
    card a chunk past the kernels' 256 runs as the fewest equal sub-chunks
    of at most 256 (the padded tail adds nothing to y or the state)."""
    if _build.on_host(x):
        return plain_chunked(x, b, c, log_a, chunk=chunk, state=state)
    if state is None:
        B, _, H, P = x.shape
        state = torch.zeros((B, H, P, b.shape[-1]), dtype=torch.float32, device=x.device)
    top = _build.lib().rt_ssd_max_chunk()
    if chunk > top:  # the fewest equal sub-chunks the kernels take
        chunk = -(-chunk // -(-chunk // top))
    if _build.records(x, b, c, log_a, state):
        return SSD.apply(x, b, c, log_a, state, chunk)
    return ssd_fwd(x, b, c, log_a, state, chunk=chunk)[:2]


def decode(x, b, c, log_a, state):
    """The decode kernel: (y [B, H, P] in x's dtype, the new state)."""
    B, H, P = x.shape
    N = b.shape[-1]
    _build.check_args("ssd_decode", x.device, {
        "b": (b, (B, H, N), b.dtype), "c": (c, (B, H, N), b.dtype),
        "log_a": (log_a, (B, H), torch.float32), "state": (state, (B, H, P, N), torch.float32)},
        x.dtype)
    _build.require(b.dtype in _build.DTYPE_CODES, f"ssd_decode: b, c dtype {b.dtype} not "
                   "float32/bfloat16")
    lib = _build.lib()
    state = state.contiguous()
    y = torch.empty((B, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty_like(state)
    if B * H * P * N == 0:
        return y.zero_(), h
    # x, b, c and log_a are read where they lie, through their element strides
    strides = (ctypes.c_int64 * 11)(*x.stride(), *b.stride(), *c.stride(), *log_a.stride())
    err = lib.rt_ssd_decode(*(t.data_ptr() for t in (x, b, c, log_a, state, y, h)),
                            ctypes.addressof(strides), B, H, P, N, _build.DTYPE_CODES[x.dtype],
                            _build.DTYPE_CODES[b.dtype], _build.stream_ptr(x.device))
    _build.check(err, "ssd_decode")
    launches["ssd_decode"] += LAUNCHES_PER_CALL["ssd_decode"]
    return y, h


class SSDDecode(torch.autograd.Function):
    """The decode kernel forward with the plain step's vjp as its backward,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, b, c, log_a, state):
        ctx.save_for_backward(x, b, c, log_a, state)
        with torch.no_grad():
            return decode(x, b, c, log_a, state)

    @staticmethod
    def backward(ctx, dy, dh):
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            outs = plain_decode(*leaves)
        grads = iter(torch.autograd.grad(outs, [t for t in leaves if t.requires_grad],
                                         (dy, dh), allow_unused=True))
        return tuple(next(grads) if t.requires_grad else None for t in leaves)


def ssd_decode(x, b, c, log_a, state):
    """One token of SSD: (y [B, H, P] in x's dtype, the new state) from x
    [B, H, P], b, c [B, H, N], log_a [B, H] float32 and the state [B, H, P,
    N] float32."""
    if _build.on_host(x):
        return plain_decode(x, b, c, log_a, state)
    if _build.records(x, b, c, log_a, state):
        return SSDDecode.apply(x, b, c, log_a, state)
    return decode(x, b, c, log_a, state)
