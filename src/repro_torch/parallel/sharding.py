"""Sharding rules: param-path -> spec, activation & cache specs, and their
DTensor placements on a ``torch.distributed`` ``DeviceMesh``.

Mesh axes:
  single-pod:  (data=16, model=16)                  -> 256 GPUs
  multi-pod:   (pod=2, data=16, model=16)           -> 512 GPUs

Strategy (1000+ node posture, DESIGN.md §3):
  * 2-D FSDP x TP on weights: rows -> 'data', cols -> 'model'. DTensor's
    sharding propagation all-gathers weights for the forward (FSDP) and
    reduces grads back to the weights' layout; the optimizer state takes
    the params' placements (ZeRO-3-equivalent).
  * experts -> 'model' (EP); router replicated over 'model'.
  * batch   -> ('pod', 'data') when multi-pod, else 'data'. The 'pod' axis
    carries ONLY gradient all-reduce traffic (hierarchical reduction).
  * decode KV cache: time dim -> 'model' (sequence-sharded cache; softmax
    reductions over the sharded axis become cross-shard collectives).

The rules, their candidate fallback and the mode stripping are the JAX
package's ``parallel/sharding.py`` verbatim, over :class:`P`, a spec with
one entry per tensor dim, each a mesh axis name, a tuple of names (that dim
sharded over several mesh axes, in mesh order) or ``None``. A mesh is a
``DeviceMesh`` with ``mesh_dim_names`` or a mapping of axis name to size.
:func:`placements` turns a spec into DTensor placements: mesh dim ``a``
gets ``Shard(d)`` where tensor dim ``d`` names ``a``, ``Replicate()``
otherwise.

The sharded train step (``training/train_loop.make_train_step(..., mesh)``)
runs ``loss_fn`` and AdamW on DTensors under DTensor's
``implicit_replication``, which treats the plain tensors a layer makes for
itself (RoPE positions and frequencies, the causal mask, the aux-loss
zero, the optimizer's step and learning rate) as replicated. Where DTensor
has no rule for an op, its input is redistributed explicitly (a no-op for
plain tensors):

* the head reshapes of ``models/layers.py`` (``project_qkv``'s split into
  heads, ``attention_block``'s merge of them) go through :func:`view`,
  which replicates a sharded dim that a reshape cannot split evenly over
  its mesh axis;
* ``_sdpa`` and ``chunked_cache_attention`` run on each rank's batch
  shard (:func:`per_batch_shard`): their einsums flatten the batch with
  the head dims, which DTensor refuses where a head dim is sharded (torch
  2.11, forward and backward: "Attempted to flatten multiple dimensions,
  with dimension 1 being sharded"), so attention runs data-parallel, its
  heads replicated over 'model';
* ``model._embed`` gathers a DTensor table whole (FSDP's all-gather; its
  gradient reduce-scattered back) and looks the tokens up on each batch
  shard: torch 2.11 has no rule for the indexing gather's backward, and
  2.13's embedding rule leaves a vocab-sharded table's output in a partial
  state it cannot reduce-scatter;
* ``cache_insert`` (the KV ring's scatter, ``index_put``, which DTensor
  cannot run on a sharded cache) replicates the cache and the new entries
  first (:func:`replicate`): a sharded cache is gathered on each insert;
* ``training/optimizer._slices`` takes a DTensor leaf whole (a split along
  a sharded leading dim would gather it).
"""

from __future__ import annotations

import functools
import math
import re
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

from repro_torch import tree as T


class P:
    """A partition spec: ``P("data", None)`` shards dim 0 over 'data' and
    replicates dim 1; ``P()`` replicates every dim. It iterates, indexes and
    compares as the tuple of its entries, and is a leaf of a ``tree``. A
    one-name tuple entry is that name, as JAX normalizes it."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        return self.entries == (other.entries if isinstance(other, P) else other)

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh):
    return ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)


# (regex on '/'-joined param path) -> CANDIDATE specs, first whose sharded
# dims all divide evenly wins (e.g. 40 experts can't split 16-way EP -> fall
# back to TP over the expert FFN dims; 49155-row vocab -> shard d_model only).
# Paths look like: blocks/0/attn/wq, blocks/1/moe/wg, embed, lm_head, ...
_PARAM_RULES = [
    (r"embed$",               [P("model", "data"), P(None, "data")]),
    (r"lm_head$",             [P("data", "model"), P("data", None)]),
    (r"final_norm/",          [P()]),
    (r"ln\d*/|norm_attn/|norm_ssm/",  [P(None)]),
    (r"attn/w[qkv]$",         [P(None, "data", "model"), P(None, "data", None)]),
    (r"attn/wo$",             [P(None, "model", "data"), P(None, None, "data")]),
    (r"mlp/w[gu]$",           [P(None, "data", "model"), P(None, "data", None)]),
    (r"mlp/wd$",              [P(None, "model", "data"), P(None, None, "data")]),
    (r"moe/router$",          [P(None, "data", None)]),
    (r"moe/w[gu]$",           [P(None, "model", "data", None), P(None, None, "data", "model")]),
    (r"moe/wd$",              [P(None, "model", None, "data"), P(None, None, "model", "data")]),
    (r"mlstm/(wq|wk|wv|ogate)$", [P(None, "data", "model"), P(None, "data", None)]),
    (r"mlstm/wo$",            [P(None, "model", "data"), P(None, None, "data")]),
    (r"mlstm/w[if]$",         [P(None, "data", None)]),
    (r"slstm/w[zifo]$",       [P(None, "data", "model"), P(None, "data", None)]),
    (r"slstm/r[zifo]$",       [P(None)]),
    (r"slstm/wout$",          [P(None, "model", "data"), P(None, None, "data")]),
    (r"mamba/win$",           [P(None, "data", "model"), P(None, "data", None)]),
    (r"mamba/wout$",          [P(None, "model", "data"), P(None, None, "data")]),
    (r"mamba/(a_log|d_skip)$", [P(None)]),
]

_DEFAULT_AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


def _spec_fits(spec: P, shape, axis_sizes) -> bool:
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        div = 1
        for nme in names:
            div *= axis_sizes.get(nme, 1)
        if i >= len(shape) or shape[i] % div != 0 or shape[i] < div:
            return False
    return True


def param_spec(path_str: str, shape=None, axis_sizes=None) -> P:
    axis_sizes = axis_sizes or _DEFAULT_AXIS_SIZES
    for pat, candidates in _PARAM_RULES:
        if re.search(pat, path_str):
            if shape is None:
                return candidates[0]
            for spec in candidates:
                if _spec_fits(spec, shape, axis_sizes):
                    return spec
            # last resort: strip whichever entries don't divide
            base = candidates[0]
            entries = list(base) + [None] * (len(shape) - len(base))
            out = []
            for i, entry in enumerate(entries[:len(shape)]):
                one = P(*([None] * i + [entry]))
                out.append(entry if entry and _spec_fits(one, shape, axis_sizes)
                           else None)
            return P(*out)
    return P()  # replicate small leftovers


def _strip_axis(spec: P, axis: str) -> P:
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a != axis)
            out.append(kept if kept else None)
        else:
            out.append(None if entry == axis else entry)
    return P(*out)


def param_specs(params, mesh=None, mode: str = "2d") -> Any:
    """Tree of specs matching the param tree (shape-aware when leaves carry
    shapes; paths as ``tree.tree_paths`` gives them). mode: '2d' FSDPxTP |
    'tp' (replicate over data — stationary decode weights) | 'dp'
    (replicate over model — small models)."""
    sizes = axis_sizes(mesh) if mesh is not None else _DEFAULT_AXIS_SIZES

    def one(path, x):
        spec = param_spec(path, getattr(x, "shape", None), sizes)
        if mode == "tp":
            spec = _strip_axis(spec, "data")
        elif mode == "dp":
            spec = _strip_axis(spec, "model")
        return spec

    return T.tree_map_with_path(one, params)


def placements(spec: P, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, entry in enumerate(spec)
                if entry == name or (isinstance(entry, tuple) and name in entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute(tree, specs, mesh) -> Any:
    """``tree``'s tensors as DTensors on ``mesh`` under ``specs`` (a tree of
    :class:`P` of the same structure)."""
    return T.tree_map(lambda x, s: distribute_tensor(x, mesh, placements(s, mesh)),
                      tree, specs)


def param_shardings(params, mesh, mode: str = "2d") -> Any:
    """The params as DTensors on ``mesh`` under :func:`param_specs`."""
    return distribute(params, param_specs(params, mesh, mode), mesh)


def batch_spec(mesh) -> P:
    """tokens [B, S] (labels etc. follow)."""
    return P(batch_axes(mesh), None)


def batch_specs_for(mesh, batch_like) -> Any:
    bs = batch_spec(mesh)

    def leaf_spec(x):
        if getattr(x, "ndim", 0) >= 2:
            return bs if x.ndim == 2 else P(batch_axes(mesh), *([None] * (x.ndim - 1)))
        return P()

    return T.tree_map(leaf_spec, batch_like)


def cache_specs_for(mesh, cache, batch_size: int) -> Any:
    """Decode-cache leaves. Stacked layout [L, B, T|H, ...]: batch -> data
    when divisible; dim-2 (cache time for KV, heads for SSM state) -> 'model'
    when divisible (sequence-sharded KV cache; softmax reductions over the
    sharded axis lower to cross-shard collectives)."""
    sizes = axis_sizes(mesh)
    ba = batch_axes(mesh)
    n_b = 1
    for a in ba:
        n_b *= sizes[a]
    b_axis = ba if batch_size % n_b == 0 and batch_size >= n_b else None
    n_model = sizes["model"]

    def leaf_spec(x):
        nd = getattr(x, "ndim", 0)
        if nd < 2:
            return P()
        spec = [None, b_axis] + [None] * (nd - 2)
        if nd >= 3 and x.shape[2] % n_model == 0 and x.shape[2] >= n_model:
            spec[2] = "model"
        return P(*spec)

    return T.tree_map(leaf_spec, cache)


def _carries(src, dst, d: int, m: int) -> bool:
    """Whether reshaping ``src`` to ``dst`` keeps dim ``d``'s even split over
    ``m`` shards: the output dim that starts where ``d`` starts (the same
    product of the dims before it) divides by ``m``."""
    before, acc = math.prod(src[:d]), 1
    for n in dst:
        if acc == before and n != 1:
            return n % m == 0
        acc *= n
    return False


def _fit(x: DTensor, shape) -> DTensor:
    """``x`` replicated on each mesh axis whose split of ``x`` a reshape to
    ``shape`` cannot carry."""
    src = tuple(x.shape)
    pl = [Replicate() if isinstance(p, Shard) and not _carries(src, shape, p.dim, m)
          else p for p, m in zip(x.placements, x.device_mesh.shape)]
    return x.redistribute(x.device_mesh, pl) if pl != list(x.placements) else x


class _View(torch.autograd.Function):
    """A DTensor reshape that fits its input, and in the backward its
    gradient, to the reshape first."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.src = tuple(x.shape)
        return _fit(x, shape).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return _fit(g, ctx.src).reshape(ctx.src), None


def view(x, *shape):
    """``x.reshape(shape)``. DTensor cannot reshape a dim sharded over m
    ranks into one whose leading factor m does not divide (Yi-6B's 4 KV
    heads over a 'model' axis of 16), nor merge it behind another dim; such
    a dim is first replicated on that mesh axis, and so is the gradient's
    in the backward. A plain reshape for plain tensors."""
    if isinstance(x, DTensor):
        return _View.apply(x, shape)
    return x.reshape(shape)


def per_batch_shard(fn):
    """``fn`` run on each rank's batch shard where its arguments are
    DTensors. The first DTensor argument's batch (dim 0) sets the layout:
    every tensor argument of that batch is brought to its batch sharding
    alone (other placements replicated, Partial sums reduced; a plain one
    is taken as replicated and sliced), every other DTensor argument is
    replicated whole (its gradient then a Partial sum over the batch's mesh
    axes); ``fn`` runs on the local tensors, and its output is the DTensor
    of those shards. Plain arguments alone call ``fn`` as it is."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        lead = next((a for a in args if isinstance(a, DTensor)), None)
        if lead is None:
            return fn(*args, **kwargs)
        mesh, batch = lead.device_mesh, lead.shape[0]
        target = [p if p == Shard(0) else Replicate() for p in lead.placements]
        whole = [Replicate()] * mesh.ndim
        partial = [Partial() if p == Shard(0) else Replicate() for p in target]

        def local(x):
            if not isinstance(x, torch.Tensor) or x.dim() == 0:
                return x
            if x.shape[0] == batch:
                if not isinstance(x, DTensor):
                    if batch == 1:
                        return x
                    x = DTensor.from_local(x, mesh, whole, run_check=False)
                return x.redistribute(mesh, target).to_local()
            if isinstance(x, DTensor):
                return x.redistribute(mesh, whole).to_local(grad_placements=partial)
            return x

        out = fn(*map(local, args), **kwargs)
        return DTensor.from_local(out, mesh, target, run_check=False)

    return wrapped


def replicate(*xs):
    """Each DTensor of ``xs`` replicated on every mesh axis (Partial sums
    reduced); plain tensors as they are."""
    return tuple(x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
                 if isinstance(x, DTensor) else x for x in xs)
