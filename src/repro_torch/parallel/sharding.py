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
zero, the optimizer's step and learning rate) as replicated. The
projections and the expert products are DTensor products; what DTensor
has no rule for, or would run once on every rank of an axis, runs on
local tensors under an explicit layout (each a no-op for plain tensors):

* the head reshapes (``project_qkv``'s split into heads, the merge after
  attention, the mLSTM, sLSTM and Mamba head splits) go through
  :func:`view`, which replicates a sharded dim that a reshape cannot split
  evenly over its mesh axis (Yi-6B's 4 KV heads over a 'model' axis of 16;
  xLSTM's 4 heads);
* attention (``_sdpa``, ``chunked_cache_attention``) is head-parallel
  (:func:`per_head_shard`): each rank attends with its batch shard and its
  own query heads, split over 'model' as ``wq``'s columns are; K and V
  are replicated over 'model' (unless KV == H) and each rank takes the KV
  heads its query heads read (r-major GQA, h % KV). The explicit head
  rule: where H does not divide 'model' (llama4-maverick's 40 heads over
  16), the heads are not split and every rank of 'model' attends with
  all of them (over the batch split 'model' may already carry), and the
  dry run's JSON ``notes`` say so. ``kv_block_axis`` splits the queries
  and the softmax state of ``chunked_cache_attention`` over that axis
  along the sequence instead, as the reference does. Local einsums also
  keep clear of torch 2.11's refusal to flatten a batch with a sharded
  head dim ("Attempted to flatten multiple dimensions, with dimension 1
  being sharded");
* MoE routing and dispatch (``models/moe.py``) run on each rank's tokens
  (:class:`Rows`): the claim positions are offset by the other ranks'
  claims (an all-gather of E integers a group), the expert buffers are a
  Partial sum of each rank's claims, and each rank reads its claims'
  outputs from the replicated result; ``bincount`` (no DTensor rule, no
  meta kernel) is a ``scatter_add``;
* the mLSTM, sLSTM and SSD time loops run on each rank's batch shard
  (:func:`per_batch_shard`), so a time step costs plain-tensor ops, and
  split over 'model' too: by heads where they divide it, else by the
  batch shard's rows where those do, else (the dry run's ``notes`` say
  so) whole on every rank of 'model'; the xLSTM blocks' output
  projections are reduced (:func:`reduced`), so the next block's
  products split over 'model' rather than repeat on each rank;
* ``model._embed`` gathers a DTensor table whole (FSDP's all-gather; its
  gradient reduce-scattered back) and looks the tokens up on each batch
  shard: torch 2.11 has no rule for the indexing gather's backward, and
  2.13's embedding rule leaves a vocab-sharded table's output in a partial
  state it cannot reduce-scatter;
* the loss (``model.loss_fn``) is vocab-parallel (:func:`vocab_nll`):
  logits split over 'model' along the vocab, or a Partial sum there, are
  never gathered whole, as ``log_softmax`` would; each rank takes its
  rows' max, sum of exponentials and target logit on its vocab shard,
  and three all-reduces of [rows, S] over 'model' combine them (a Partial
  sum is reduce-scattered first: over a batch axis into its rows, over
  'model' into vocab shards);
* ``cache_insert`` (the KV ring's scatter, ``index_put``, for which torch
  2.11 has no DTensor rule at all) writes each rank's batch shard of the
  ring (:func:`per_batch_shard`): a ring split over 'model' along time is
  gathered there on each insert;
* ``training/optimizer._slices`` takes a DTensor leaf whole (a split along
  a sharded leading dim would gather it).

A rank's batch shard is split over each batch axis ('pod', 'data') the
batch divides, whatever split DTensor's propagation gave the tensor there
(and over another axis it already comes split over), so the layout does
not change with the shapes.
"""

from __future__ import annotations

import functools
import inspect
import math
import re
from typing import Any, Dict

import torch
import torch.distributed._functional_collectives as funcol
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


def reduced(x):
    """``x`` with its Partial sums reduced (replicated over those mesh
    dims); a plain tensor, or a DTensor without a Partial placement, as it
    is. A block's output projection (rows split over 'model') gives a
    Partial sum; left so, the residual stream stays Partial, and each
    product of the next block then runs with the whole weight on every
    rank of 'model' (DTensor gathers the weight rather than reduce the
    activation)."""
    if isinstance(x, DTensor) and any(isinstance(p, Partial) for p in x.placements):
        return x.redistribute(x.device_mesh, [Replicate() if isinstance(p, Partial) else p
                                              for p in x.placements])
    return x


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


def _row_dims(x: DTensor, skip: tuple = (), take: tuple = ()) -> list:
    """The mesh dims, in mesh order, over which ``x``'s rows (its dim 0)
    are split for code that runs on each rank's rows: each batch axis
    ('pod', 'data') and each axis in ``take`` whose split the rows divide,
    and each other axis (not in ``skip``) over which ``x`` comes split
    already. The batch axes are taken whatever split DTensor's propagation
    gave ``x``, so the layout does not change with the shapes."""
    dims, n = [], 1
    for i, (name, p) in enumerate(zip(x.device_mesh.mesh_dim_names, x.placements)):
        m = x.device_mesh.size(i)
        if (name in ("pod", "data", *take) or (p == Shard(0) and name not in skip)) \
                and x.shape[0] % (n * m) == 0:
            dims.append(i)
            n *= m
    return dims


class Rows:
    """The split of a tensor's rows (its dim 0: a batch, or tokens) over
    its mesh, for code that runs on each rank's rows. A rank's rows are
    the chunk of the row order at :attr:`index` of :attr:`n` (its
    coordinates over the row dims, in mesh order; ``skip`` and ``take`` as
    :func:`_row_dims` has them). With ``heads``, mesh axis names that are
    not row dims, each tensor is also split over those axes along the dim
    given to each method as ``h`` (a tensor without ``h`` is whole there).
    For a plain tensor one rank holds every row and each method is the
    identity.

    * :meth:`local`: a tensor of these rows (a DTensor, or a plain tensor
      taken as replicated) as this rank's rows, other placements
      replicated and Partial sums reduced; its gradient flows back;
    * :meth:`wrap`: the DTensor whose rows are each rank's local rows;
    * :meth:`whole`: a DTensor replicated over the row dims and taken
      local, its gradient a Partial sum over them (each rank's rows add
      their part);
    * :meth:`sum`: the DTensor that is the sum of every rank's local
      tensor, Partial over the row dims (its gradient the whole one);
    * :meth:`before`: of an integer tensor each rank holds, the sum of the
      ranks' before this one in row order (an all-gather over the row
      dims)."""

    def __init__(self, x, *, skip: tuple = (), take: tuple = (), heads: tuple = ()):
        self.mesh = x.device_mesh if isinstance(x, DTensor) else None
        self.n, self.index = 1, 0
        if self.mesh is None:
            return
        self.dims = _row_dims(x, skip, take)
        self.head_dims = [i for i, name in enumerate(self.mesh.mesh_dim_names)
                          if name in heads and i not in self.dims]
        self.rows = self._placements(None, Shard(0))
        self.partial = self._placements(None, Partial())
        coord = self.mesh.get_coordinate()
        for i in self.dims:
            m = self.mesh.size(i)
            self.n, self.index = self.n * m, self.index * m + coord[i]

    def _placements(self, h, row) -> tuple:
        """``row`` on the row dims, Shard(h) on the head dims (with ``h``),
        Replicate elsewhere."""
        return tuple(row if i in self.dims
                     else Shard(h) if h is not None and i in self.head_dims else Replicate()
                     for i in range(self.mesh.ndim))

    def local(self, x, h=None):
        if self.mesh is None or not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh, (Replicate(),) * self.mesh.ndim,
                                   run_check=False)
        return x.redistribute(self.mesh, self._placements(h, Shard(0))).to_local()

    def wrap(self, x, h=None):
        if self.mesh is None or not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        return DTensor.from_local(x, self.mesh, self._placements(h, Shard(0)),
                                  run_check=False)

    def whole(self, x, h=None):
        if self.mesh is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, self._placements(h, Replicate())).to_local(
            grad_placements=self._placements(h, Partial()))

    def sum(self, x):
        if self.mesh is None:
            return x
        return _SumShards.apply(x, self.mesh, self.partial)

    def before(self, x):
        if self.mesh is None:
            return torch.zeros_like(x)
        stacked = DTensor.from_local(x[None], self.mesh, self.rows, run_check=False)
        return stacked.full_tensor()[:self.index].sum(0)


class _SumShards(torch.autograd.Function):
    """Each rank's local tensor as one term of a Partial sum; the gradient
    of each term is the whole gradient."""

    @staticmethod
    def forward(ctx, x, mesh, partial):
        ctx.mesh = mesh
        return DTensor.from_local(x, mesh, partial, run_check=False)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, [Replicate()] * ctx.mesh.ndim).to_local(), None, None


def _loop_rows(x: DTensor, h: int) -> Rows:
    """The layout of a time loop over ``x`` [B, ..., H at dim ``h``, ...]:
    split by heads over 'model' where H divides it (the heads come split
    so from the projections, as ``wq``'s columns are), else by rows over
    'model' where the rank's batch shard divides it, else the batch shard
    whole on every rank of 'model' (the loop then runs on each)."""
    m = axis_sizes(x.device_mesh).get("model", 1)
    if m == 1:
        return Rows(x)
    if x.shape[h] % m == 0:
        return Rows(x, skip=("model",), heads=("model",))
    return Rows(x, take=("model",))


def _prefix_map(fn, prefix, tree):
    """``fn(leaf, p)`` over ``tree``, ``p`` the entry of ``prefix`` (a tree
    prefix of ``tree``: a sequence for a sequence node) above the leaf."""
    if isinstance(prefix, (tuple, list)) and isinstance(tree, (tuple, list)):
        return T.rebuild(tree, [_prefix_map(fn, p, t) for p, t in zip(prefix, tree, strict=True)])
    return T.tree_map(lambda x: fn(x, prefix), tree)


def per_batch_shard(fn=None, *, whole: tuple = (), heads: dict = None, out_heads=None):
    """``fn`` run on each rank's batch shard where its arguments hold
    DTensors. The first DTensor among the tensors of the arguments (trees
    of them included) sets the layout: its batch (dim 0) is split over the
    batch axes it divides and any other axis it comes split over
    (:class:`Rows`). Each tensor argument of that batch is brought
    to its batch shard alone (a plain one is taken as replicated and
    sliced); the arguments named in ``whole`` are replicated whole (their
    gradients then Partial sums over the batch's mesh dims); others, and
    0-dim tensors, pass as they are. ``fn`` runs on the local tensors, and
    each tensor of its output with a batch dim becomes the DTensor of
    those shards. Plain arguments alone call ``fn`` as it is.

    A time loop names the head dim of its arguments' tensors in ``heads``
    ({argument: dim}, trees of them included; ``whole`` ones too) and of
    its outputs' in ``out_heads`` (a prefix of the output's tree), and its
    work is laid over 'model' as well (:func:`_loop_rows`): split by heads,
    the outputs keep that split; split by rows, the outputs are brought
    back whole over 'model' (the layout the inputs came in, which the next
    op expects)."""
    if fn is None:
        return functools.partial(per_batch_shard, whole=whole, heads=heads, out_heads=out_heads)
    sig = inspect.signature(fn)
    heads = heads or {}

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if not any(isinstance(a, DTensor) for a in T.tree_leaves([args, kwargs])):
            return fn(*args, **kwargs)  # plain tensors: no binding on the hot path
        bound = sig.bind(*args, **kwargs)
        name, lead = next(((k, a) for k, v in bound.arguments.items() if k not in whole
                           for a in T.tree_leaves(v) if isinstance(a, DTensor)), (None, None))
        if lead is None:
            return fn(*args, **kwargs)
        rows = _loop_rows(lead, heads[name]) if heads else Rows(lead)
        batch = lead.shape[0]

        def local(x, h):
            if isinstance(x, torch.Tensor) and x.dim() > 0 and x.shape[0] == batch:
                if batch == 1 and not isinstance(x, DTensor) and not rows.head_dims:
                    return x
                return rows.local(x, h)
            return x

        for k, v in bound.arguments.items():
            bound.arguments[k] = _prefix_map(rows.whole if k in whole else local, heads.get(k), v)
        out = _prefix_map(rows.wrap, out_heads, fn(*bound.args, **bound.kwargs))
        spread = [i for i in rows.dims if lead.placements[i] != Shard(0)
                  and lead.device_mesh.mesh_dim_names[i] not in ("pod", "data")]
        if not spread:
            return out

        def back(x):  # whole again over the axes only the loop split the rows over
            if not isinstance(x, DTensor):
                return x
            pl = [Replicate() if i in spread else p for i, p in enumerate(x.placements)]
            return x.redistribute(x.device_mesh, pl)

        return T.tree_map(back, out)

    return wrapped


def per_head_shard(fn=None, *, seq_args: tuple = ()):
    """Attention ``fn(q, k, v, *rest, **kw)`` (q [B,S,H,hd], k, v
    [B,T,KV,hd], r-major GQA: head h reads KV head h % KV) run on each
    rank's batch shard and its own heads where q is a DTensor:

    * q goes split by batch (Shard(0)) over 'pod' and 'data' where the
      batch divides them (and over any other axis but 'model' it comes
      split over), and by heads (Shard(2)) over 'model', as
      the columns of ``wq`` are; where H does not divide 'model' (e.g.
      llama4-maverick's 40 heads over 16) the heads stay whole, and q
      keeps its split over 'model' if it came batch-split there, else is
      replicated over it;
    * with ``kv_block_axis=`` a mesh axis name, the queries go split over
      that axis along the sequence (Shard(1); ``seq_args`` names the
      positional arguments of ``rest``, e.g. the query positions, whose
      dim 1 is that sequence) and K, V are replicated over it, as the
      reference's ``chunked_cache_attention`` lays them out;
    * k and v take q's split of the heads where KV == H; otherwise they
      are replicated over the head dims, and each rank takes the KV heads
      its query heads read: KV of them in rotated order (h0 + i) % KV when
      its H_loc heads are a multiple of KV, else one a head;
    * the other tensors of the batch are brought to the batch shard (their
      dim 1 split with the queries' for ``seq_args``).

    The output [B,S,H,hd] has q's layout, but for a sequence split, which
    is gathered whole again. Plain tensors alone call ``fn`` as it is."""
    if fn is None:
        return functools.partial(per_head_shard, seq_args=seq_args)

    @functools.wraps(fn)
    def wrapped(q, k, v, *rest, kv_block_axis=None, **kw):
        lead = next((a for a in (q, k, v, *rest) if isinstance(a, DTensor)), None)
        if lead is None:
            return fn(q, k, v, *rest, **kw)
        mesh = lead.device_mesh
        B, S, H, _ = q.shape
        KV = k.shape[2]
        rep = [Replicate()] * mesh.ndim
        if not isinstance(q, DTensor):
            q = DTensor.from_local(q, mesh, rep, run_check=False)
        names, n_head = mesh.mesh_dim_names, 1
        batch = _row_dims(q, skip=("model",))
        qt, kt, kg, st = [], [], [], []
        for i, p in enumerate(q.placements):
            m = mesh.size(i)
            if i in batch:
                qt.append(Shard(0)), kt.append(Shard(0)), kg.append(Shard(0))
                st.append(Shard(0))
            elif names[i] == kv_block_axis and S % m == 0:
                qt.append(Shard(1)), kt.append(Replicate()), kg.append(Partial())
                st.append(Shard(1))
            elif names[i] == "model" and H % (n_head * m) == 0:
                n_head *= m
                qt.append(Shard(2)), st.append(Replicate())
                kt.append(Shard(2) if KV == H else Replicate())
                kg.append(Shard(2) if KV == H else Partial())
            elif p == Shard(0) and B % (math.prod(mesh.size(j) for j in batch) * m) == 0:
                # heads that do not divide 'model': a batch split there kept
                batch.append(i)
                qt.append(p), kt.append(p), kg.append(p), st.append(p)
            else:
                qt.append(Replicate()), kt.append(Replicate()), kg.append(Replicate())
                st.append(Replicate())
        heads = [i for i, p in enumerate(qt) if p == Shard(2)]
        coord, h_index, n_heads = mesh.get_coordinate(), 0, 1
        for i in heads:
            n_heads, h_index = n_heads * mesh.size(i), h_index * mesh.size(i) + coord[i]
        h_loc = H // n_heads
        h0 = h_index * h_loc

        def kv_local(x):
            if not isinstance(x, DTensor):
                x = DTensor.from_local(x, mesh, rep, run_check=False)
            x = x.redistribute(mesh, kt).to_local(grad_placements=kg)
            if KV == H or not heads:
                return x
            kv_loc = KV if h_loc % KV == 0 else h_loc
            if kv_loc == KV and h0 % KV == 0:
                return x
            idx = (h0 + torch.arange(kv_loc, device=x.device)) % KV
            return x.index_select(2, idx)

        def rest_local(j, x):
            if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.shape[0] != B:
                return x
            if not isinstance(x, DTensor):
                x = DTensor.from_local(x, mesh, rep, run_check=False)
            pl = st if j in seq_args else [p if p == Shard(0) else Replicate() for p in st]
            return x.redistribute(mesh, pl).to_local()

        out = fn(q.redistribute(mesh, qt).to_local(), kv_local(k), kv_local(v),
                 *(rest_local(j, x) for j, x in enumerate(rest)), **kw)
        out = DTensor.from_local(out, mesh, qt, run_check=False)
        if Shard(1) in qt:  # torch 2.11 cannot flatten [B, S, ...] with S split, as wo's product does
            out = out.redistribute(mesh, [Replicate() if p == Shard(1) else p for p in qt])
        return out

    return wrapped


def _vocab_parallel(x) -> bool:
    """Whether logits ``x`` [..., V] come split over 'model' (of more than
    one rank) along the vocab, evenly, or as a Partial sum there."""
    if not isinstance(x, DTensor) or "model" not in x.device_mesh.mesh_dim_names:
        return False
    i = x.device_mesh.mesh_dim_names.index("model")
    m, p = x.device_mesh.size(i), x.placements[i]
    return m > 1 and x.shape[-1] % m == 0 and (p == Shard(x.ndim - 1) or isinstance(p, Partial))


class _VocabNLL(torch.autograd.Function):
    """The nll of :func:`vocab_nll` on each rank's rows and vocab shard:
    the row max and the sum of exponentials reduced over 'model', and the
    target's logit from the rank whose shard holds it. The gradient,
    ``(softmax - onehot) * g``, is taken on the shard and needs no
    collective; it keeps the layout the forward worked in."""

    @staticmethod
    def forward(ctx, logits, targets, rows):
        mesh, v = rows.mesh, logits.ndim - 1
        i = mesh.mesh_dim_names.index("model")
        group = (mesh, i)
        local = rows.local(logits, v)  # a Partial reduce-scattered into rows or vocab shards
        t = rows.local(targets).long()
        lo = mesh.get_coordinate()[i] * local.shape[-1]
        hit = (t >= lo) & (t < lo + local.shape[-1])
        idx = torch.where(hit, t - lo, 0)[..., None]
        mx = funcol.all_reduce(local.amax(-1), "max", group)
        e = torch.exp(local - mx[..., None])
        total = funcol.all_reduce(e.sum(-1), "sum", group)
        tgt = funcol.all_reduce(torch.where(hit, local.gather(-1, idx)[..., 0], 0.0), "sum",
                                group)
        ctx.save_for_backward(e, total, idx, hit)
        ctx.rows, ctx.layout = rows, rows._placements(v, Shard(0))
        nll = torch.log(total) - (tgt - mx)  # log_softmax's order: -((x - max) - log(sum))
        return DTensor.from_local(nll, mesh, rows.rows, run_check=False)

    @staticmethod
    def backward(ctx, g):
        e, total, idx, hit = ctx.saved_tensors
        grad = e / total[..., None]
        grad.scatter_add_(-1, idx, -hit[..., None].to(grad.dtype))
        grad = grad * ctx.rows.local(g)[..., None]
        return DTensor.from_local(grad, ctx.rows.mesh, ctx.layout, run_check=False), None, None


def vocab_nll(logits, targets):
    """Each token's negative log-likelihood [B, S] of ``targets`` [B, S]
    under ``logits`` [B, S, V], ``-log_softmax(logits)[targets]``.

    Logits split over 'model' along an even vocab, or a Partial sum there
    (:func:`_vocab_parallel`), go vocab-parallel: each rank works on its
    rows (:class:`Rows`, 'model' its vocab shard) and three all-reduces
    of [rows, S] over 'model' stand for the gather of the logits that
    ``log_softmax`` would make. A Partial sum is reduce-scattered first:
    over a batch axis into its rows, over 'model' into vocab shards. The
    result is split as the rows, replicated over 'model'. Other logits (a
    plain tensor, one rank on 'model', the vocab whole over 'model' or
    uneven there) take ``log_softmax`` and ``gather`` as they are."""
    if _vocab_parallel(logits):
        return _VocabNLL.apply(logits, targets, Rows(logits, skip=("model",), heads=("model",)))
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets[..., None])[..., 0]
