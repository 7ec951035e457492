"""The paged block's elementwise chain: RMSNorm (with the residual add
before it) and RoPE with the page write, as CUDA kernels
(``csrc/norm_rope.cu``) and their wrappers.

Replaces no TPU kernel: the JAX package leaves these chains to XLA, which
fuses each into one loop on the device. Run op by op in PyTorch they were
~58 launches a dense layer of ``serving/paged_model.py``, each issued by
the host and most writing a float32 tensor, so a forward's issue set the
pace of serving; here each chain is one launch. Both kernels are bound by
bytes: each input read once, each output written once.

* :func:`rms_norm` — ``models/layers.py``'s ``rms_norm`` of x [..., D]
  (f32 inside, one rounding), a CTA a row held in registers; with
  ``residual`` it first forms s = x + residual rounded to x's dtype (the
  unfused add) and returns (s, rms_norm(s)).
* :func:`rope_write` — ``apply_rope`` on q [B,S,H,hd] and k [B,S,KV,hd] at
  positions [B,S] with the frequencies ``inv_freq`` (``rope_freqs``, built
  once a forward by the caller), and the RoPE'd k and v written into the
  pages [P,KV,pg,hd] at (block_tables[b, pos // pg], :, pos % pg), in place.
  A CTA a token, its angles' sinf and cosf once for all heads.

Both round where the plain chains round (each product and sum its own
IEEE operation, float32). On a CPU or ``meta`` tensor the wrappers run the
plain versions (``ref.ref_rms_norm``, ``ref.ref_rope_write``); on a CUDA
tensor they launch the kernel or raise. They are forward-only: the
training and cache paths keep ``models/layers.py``'s autograd ops.
``launches`` counts kernel launches by kernel, one a call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

KERNELS = ("rms_norm", "rope_write")
launches = dict.fromkeys(KERNELS, 0)

plain_rms_norm = ref.ref_rms_norm
plain_rope_write = ref.ref_rope_write


def _vec(n: int, elem: int, *ts) -> int:
    """The widest load (elements, 16 bytes at most) that divides ``n`` and
    the address of each of ``ts``."""
    v = 16 // elem
    while v > 1 and (n % v or any(t.data_ptr() % (v * elem) for t in ts)):
        v //= 2
    return v


def _require_contiguous(what: str, dev, *groups) -> None:
    """Each tensor of each (dtype, {name: tensor}) group contiguous, of that
    dtype, on ``dev``; else raise naming the first that is not (the message
    is formed only then: these checks run on every call of the serving
    path)."""
    for dtype, ts in groups:
        for name, t in ts.items():
            if not (t.device == dev and t.dtype == dtype and t.is_contiguous()):
                raise ValueError(f"{what}: {name} must be contiguous {dtype} on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             residual: torch.Tensor = None):
    """rms_norm(x) [..., D] over the last dim with ``scale`` [D]; with
    ``residual`` (x's shape) the pair (x + residual, its rms_norm). ``eps``
    is ``layers.rms_norm``'s."""
    if _build.on_host(x):
        return plain_rms_norm(x, scale, eps=eps, residual=residual)
    dev, dt, D = x.device, x.dtype, x.shape[-1]
    if dev.type != "cuda" or dt not in _build.DTYPE_CODES:
        raise ValueError(f"rms_norm: {dt} on {dev}: needs float32/bfloat16 on a CUDA device")
    if scale.shape != (D,) or (residual is not None and residual.shape != x.shape):
        raise ValueError(f"rms_norm: scale must be [{D}] and the residual x's shape")
    ts = {"x": x, "scale": scale} if residual is None else {"x": x, "scale": scale,
                                                            "residual": residual}
    _require_contiguous("rms_norm", dev, (dt, ts))
    y = torch.empty_like(x)
    s = None if residual is None else torch.empty_like(x)
    rows = x.numel() // D if D else 0
    if rows:
        vec = _vec(D, x.element_size(), *ts.values(), y, *([s] if s is not None else []))
        lib = _build.lib()
        _build.require(D // vec <= lib.rt_rms_norm_max_d(),
                       "rms_norm: D too wide for a CTA's registers")
        err = lib.rt_rms_norm(x.data_ptr(), None if s is None else residual.data_ptr(),
                              scale.data_ptr(), None if s is None else s.data_ptr(),
                              y.data_ptr(), rows, D, vec, eps, _build.DTYPE_CODES[dt],
                              _build.stream_ptr(dev))
        _build.check(err, "rms_norm")
        launches["rms_norm"] += 1
    return y if s is None else (s, y)


def rope_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, block_tables: torch.Tensor, k_pages: torch.Tensor,
               v_pages: torch.Tensor):
    """(q, k) RoPE'd at ``positions``, and the RoPE'd k and v written into
    ``k_pages``/``v_pages`` (in place) at each token's page and slot. On
    the card the pages are of q's dtype (the engine's pool is of the
    config's, as the activations are)."""
    if _build.on_host(q):
        return plain_rope_write(q, k, v, positions, inv_freq, block_tables, k_pages, v_pages)
    dev, dt = q.device, q.dtype
    B, S, H, hd = q.shape
    KV, pg, pps = k.shape[2], k_pages.shape[2], block_tables.shape[1]
    if dev.type != "cuda" or dt not in _build.DTYPE_CODES:
        raise ValueError(f"rope_write: {dt} on {dev}: needs float32/bfloat16 on a CUDA device")
    lib = _build.lib()
    if not (k.shape == (B, S, KV, hd) and v.shape == k.shape and k_pages.dim() == 4
            and k_pages.shape[1] == KV and k_pages.shape[3] == hd
            and v_pages.shape == k_pages.shape and positions.shape == (B, S)
            and block_tables.dim() == 2 and block_tables.shape[0] == B
            and inv_freq.shape == (hd // 2,) and hd % 2 == 0
            and hd <= lib.rt_rope_write_max_hd()):
        raise ValueError(f"rope_write: need q [B,S,H,hd], k, v [B,S,KV,hd], pages "
                         f"[P,KV,pg,hd], positions [B,S], block_tables [B,pps], inv_freq "
                         f"[hd/2], hd even and <= {lib.rt_rope_write_max_hd()}; got "
                         f"{[tuple(t.shape) for t in (q, k, v, k_pages, positions)]}, "
                         f"{tuple(block_tables.shape)}, {tuple(inv_freq.shape)}")
    _require_contiguous("rope_write", dev, (dt, {"q": q, "k": k, "v": v, "k_pages": k_pages,
                                                 "v_pages": v_pages}),
                        (torch.int32, {"positions": positions, "block_tables": block_tables}),
                        (torch.float32, {"inv_freq": inv_freq}))
    q_out, k_out = torch.empty_like(q), torch.empty_like(k)
    if B * S:
        vec = _vec(hd // 2, q.element_size(), q, k, v, q_out, k_out, k_pages, v_pages)
        err = lib.rt_rope_write(
            *(t.data_ptr() for t in (q, k, v, positions, inv_freq, block_tables, q_out, k_out,
                                     k_pages, v_pages)),
            B * S, S, H, KV, hd, pg, pps, vec, _build.DTYPE_CODES[dt], _build.stream_ptr(dev))
        _build.check(err, "rope_write")
        launches["rope_write"] += 1
    return q_out, k_out
