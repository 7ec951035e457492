"""Multi-pod dry run on the meta device: build every (architecture x
input-shape) cell's step on the production mesh (16x16 = 256 GPUs, or
2x16x16 = 512), on DTensors of ``device="meta"`` (no memory, no kernel),
count what one GPU of the mesh does, prove the cell fits (analytic budget)
and extract the three roofline terms under the H100 constants
(``launch/roofline.py``).

MUST run as its own process, as the JAX package's dry run does: it
initialises a default process group of 256/512 ranks on torch's fake
backend (``launch/mesh.init_fake_world``; no collective moves data), and a
process has one default group.

What is counted, on rank 0's shards (one GPU's share of the step):

* FLOPs: ``torch.utils.flop_counter``'s formulas (its ``flop_registry``,
  the table ``FlopCounterMode`` counts with) applied to the local aten ops
  each DTensor op desugars into. ``FlopCounterMode`` itself, entered around
  a DTensor step, sees each op at the DTensor's global shapes (a 64x32 @
  32x16 matmul sharded over a 2x2 mesh: 65,536, where one GPU's product is
  16,384); dividing that by the mesh size would assume every op evenly
  sharded, which replicated work (the heads ``sharding.view`` replicates)
  is not. Both are held in the tests, with the JAX package's calibration
  case;
* bytes: each local aten op's input and output bytes (views excluded).
  Unfused torch ops each read and write their operands, so this OVER-counts
  XLA's fused "bytes accessed" of the reference: the memory term is an
  upper bound, not a like-for-like number;
* collectives: ``CommDebugMode`` sees each collective DTensor issues; each
  is recorded as ``(kind, result bytes, group size)`` for
  :func:`roofline.collective_wire_bytes`.

Python loops run every trip, so the reference's unroll-knob extrapolation
(``_measure_cfg`` there) has no counterpart: the layer loop, the chunked
attention's KV blocks and hymba's SSD chunks are counted as they run. The
one exception is the per-token time loop of mLSTM/sLSTM (xLSTM): over
:data:`SSM_TRIPS_DIRECT` trips (``trip_counts``) the cell is counted at two
short sequence lengths and extrapolated linearly in the length (xLSTM has
no attention, so every cost of its step is linear in it). The lengths, 64
and 128 tokens, are long enough that an activation outweighs a
projection's weight, as at the cell's own length, so DTensor lays both
out as it would the cell (at 32 tokens it reduced the gradients
otherwise); a cell whose longer count is smaller on some key was laid out
differently at the two lengths, and fails rather than extrapolate.

These are estimates of a step on a 256/512-GPU mesh, made on one host:
not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out reports/dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k \\
      --smoke --mesh 2x2            # a smoke config on a 4-rank fake mesh
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import flop_registry

from repro_torch import tree as T
from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable, get_config
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import init_fake_world, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.blocks import cache_len
from repro_torch.models.frontends import num_frontend_embeds
from repro_torch.models.layers import kv_chunks
from repro_torch.parallel import sharding as S
from repro_torch.training import optimizer as O
from repro_torch.training.train_loop import make_train_step

SSM_TRIPS_DIRECT = 64        # per-token recurrent trips counted as they run
SSM_LENGTHS = (64, 128)      # the two lengths an xLSTM cell is counted at beyond that
BYTES_NOTE = ("bytes_per_chip sums each unfused aten op's input and output bytes: an "
              "over-count of a fused compiler's bytes accessed (memory_s is an upper bound)")
ESTIMATE_NOTE = "estimates for the mesh from a meta-device trace on one host, not measurements"

# c10d functional collectives (what DTensor issues) -> roofline kinds
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


# ---------------------------------------------------------------------------
# the counter
# ---------------------------------------------------------------------------


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in T.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _is_view(func) -> bool:
    """An op whose output aliases an input without writing it (moves no bytes)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _on(device: str, tree) -> bool:
    return any(isinstance(x, torch.Tensor) and x.device.type == device
               for x in T.tree_leaves(tree))


class StepCounter(CommDebugMode):
    """``CommDebugMode`` that also counts, on the local (per-GPU) aten ops
    DTensor desugars into, FLOPs by ``flop_registry``, bytes moved, and
    each collective as ``(kind, result bytes, group size)``. Only ops on
    tensors of ``device`` count: DTensor's own bookkeeping (the shard sizes
    it works out with small host tensors) runs beside the step's ops."""

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device
        self.flops = 0.0
        self.bytes = 0.0
        self.records: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not (any(issubclass(t, DTensor) for t in types)
                or func.namespace == "_c10d_functional" or _on(self.device, args)):
            return func(*args, **(kwargs or {}))
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(func, torch._ops.HigherOrderOperator):
            return out  # a DTensor op: counted as the local ops it becomes
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                group = args[-1] if isinstance(args[-1], str) else kwargs["group_name"]
                n = _resolve_process_group(group).size()
                self.records.append((kind, float(_nbytes([out])), n))
            return out
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs, out_val=out))
        if not _is_view(func):
            self.bytes += _nbytes([args, kwargs, out])
        return out


def count(fn, args, device: str = "meta") -> Dict[str, Any]:
    """Run ``fn(*args)`` under a :class:`StepCounter`; its per-GPU counts."""
    with StepCounter(device) as c:
        fn(*args)
    wire = R.collective_wire_bytes(c.records)
    assert wire["ops"] <= c.get_total_counts(), (wire["ops"], c.get_total_counts())
    return {"flops": c.flops, "bytes": c.bytes,
            **{f"wire_{k}": wire[k] for k in R.KINDS},
            "wire_total": wire["total"], "collective_ops": wire["ops"]}


# ---------------------------------------------------------------------------
# abstract inputs (meta tensors only - no allocation)
# ---------------------------------------------------------------------------


def params_struct(cfg: ModelConfig):
    return M.init_params(cfg, torch.Generator(), "meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta stand-ins for every model input of this cell."""
    B, Ssz = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)

    def embeds():
        return torch.empty((B, num_frontend_embeds(cfg), cfg.d_model), dtype=dt, device="meta")

    if shape.kind == "train":
        batch = {"tokens": torch.empty((B, Ssz + 1), dtype=torch.int32, device="meta")}
        if cfg.frontend == "vision":
            batch["extra_embeds"] = embeds()
        return {"batch": batch}
    cache = M.init_cache(cfg, B, Ssz, "meta")
    if shape.kind == "prefill":
        spec = {"tokens": torch.empty((B, Ssz), dtype=torch.int32, device="meta"),
                "cache": cache}
        if cfg.frontend == "vision":
            spec["extra_embeds"] = embeds()
        return spec
    # decode: one new token against a cache of shape.seq_len
    return {"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta"), "cache": cache}


def make_step(cfg: ModelConfig, shape: InputShape, opt_cfg: O.OptConfig):
    if shape.kind == "train":
        return make_train_step(cfg, opt_cfg)  # loss_fn + backward + apply_updates
    if shape.kind == "prefill":
        def prefill_step(params, tokens, cache, extra_embeds=None):
            return M.prefill(params, tokens, cfg, cache, extra_embeds=extra_embeds)
        return implicit_replication()(prefill_step)

    def serve_step(params, tokens, cache):
        return M.decode_step(params, tokens, cfg, cache)
    return implicit_replication()(serve_step)


# ---------------------------------------------------------------------------
# laying one variant out on the mesh
# ---------------------------------------------------------------------------


def lower_cell(cfg: ModelConfig, shape: InputShape, mesh,
               opt_cfg: Optional[O.OptConfig] = None):
    """(step, args): this cfg variant's step and its DTensor inputs on
    ``mesh`` (params and moments under ``cfg.param_mode``, the batch over
    the batch axes where it divides, the cache by ``cache_specs_for``)."""
    opt_cfg = opt_cfg or O.OptConfig(moment_dtype=cfg.optimizer_state_dtype)
    sizes = S.axis_sizes(mesh)
    ba = tuple(cfg.batch_axes) if cfg.batch_axes is not None else S.batch_axes(mesh)
    n_b = math.prod(sizes[a] for a in ba)
    specs = input_specs(cfg, shape)
    step = make_step(cfg, shape, opt_cfg)

    def batch_spec(x):
        b_ok = x.shape[0] % n_b == 0 and x.shape[0] >= n_b
        return S.P(ba if b_ok else None, *([None] * (x.dim() - 1)))

    def shard_batch(tree):
        return S.distribute(tree, T.tree_map(batch_spec, tree), mesh)

    params = S.param_shardings(params_struct(cfg), mesh, cfg.param_mode)
    if shape.kind == "train":
        return step, (params, O.init(params, opt_cfg), shard_batch(specs["batch"]))
    cache = S.distribute(specs["cache"], S.cache_specs_for(mesh, specs["cache"],
                                                           shape.global_batch), mesh)
    args = [params, shard_batch(specs["tokens"]), cache]
    if "extra_embeds" in specs:
        args.append(shard_batch(specs["extra_embeds"]))
    return step, tuple(args)


# ---------------------------------------------------------------------------
# loop trip counts per cell (must mirror model dispatch exactly)
# ---------------------------------------------------------------------------


def trip_counts(cfg: ModelConfig, shape: InputShape) -> Dict[str, int]:
    trips = {"layer": cfg.pattern_repeats, "attn": 0, "ssm": 0}
    Ssz = shape.seq_len
    if shape.kind == "prefill":
        s_q = Ssz + (num_frontend_embeds(cfg) if cfg.frontend == "vision" else 0)
        t_cache = cache_len(cfg, Ssz)
        if any(k in ("dense", "moe", "hymba") for k in cfg.block_pattern):
            trips["attn"] = kv_chunks(s_q, t_cache, cfg.attn_chunk_kv)
    s_time = Ssz if shape.kind in ("train", "prefill") else 1
    if shape.kind == "train":
        s_time = Ssz  # loss_fn trains on tokens[:, :-1] -> S positions
        if cfg.frontend == "vision":
            s_time += num_frontend_embeds(cfg)
    if s_time > 1:
        if any(k in ("mlstm", "slstm") for k in cfg.block_pattern):
            trips["ssm"] = s_time
        if "hymba" in cfg.block_pattern:
            trips["ssm"] = -(-s_time // min(cfg.ssd_chunk, s_time))
    return trips


def _measure_cfg(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, Any]:
    """Count the cell; an xLSTM cell past SSM_TRIPS_DIRECT time steps at
    the two SSM_LENGTHS, extrapolated linearly to its length."""
    trips = trip_counts(cfg, shape)
    recurrent = any(k in ("mlstm", "slstm") for k in cfg.block_pattern)
    if not (recurrent and trips["ssm"] > SSM_TRIPS_DIRECT):
        base = count(*lower_cell(cfg, shape, mesh))
        return {"trips": trips, "raw": {"base": base}, "corrected": dict(base)}
    raw = {f"seq{n}": count(*lower_cell(cfg, dataclasses.replace(shape, seq_len=n), mesh))
           for n in SSM_LENGTHS}
    (n1, m1), (n2, m2) = zip(SSM_LENGTHS, raw.values())
    shrunk = [k for k in m1 if m2[k] < m1[k]]
    if shrunk:  # DTensor's propagation laid the two lengths out differently
        raise AssertionError(f"the {n1}- and {n2}-token counts were laid out differently "
                             f"(the longer counts less on {shrunk}): no linear extrapolation")
    frac = (shape.seq_len - n1) / (n2 - n1)
    total = {k: m1[k] + (m2[k] - m1[k]) * frac for k in m1}
    total["collective_ops"] = round(total["collective_ops"])
    return {"trips": trips, "raw": raw, "corrected": total,
            "note": f"counted at {n1} and {n2} tokens and extrapolated linearly in the length"}


# ---------------------------------------------------------------------------
# analytic per-GPU memory budget
# ---------------------------------------------------------------------------


def _itemsize(dtype: str) -> int:
    return getattr(torch, dtype).itemsize


def analytic_memory(cfg: ModelConfig, shape: InputShape, mesh) -> Dict[str, float]:
    p_struct = params_struct(cfg)
    specs = S.param_specs(p_struct)
    axis_sizes = S.axis_sizes(mesh)

    def shard_div(spec):
        d = 1
        for entry in spec:
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            for nme in names:
                d *= axis_sizes[nme]
        return d

    def bytes_of(tree, spec_tree):
        tot = 0.0
        for leaf, spec in zip(T.tree_leaves(tree), T.tree_leaves(spec_tree), strict=True):
            tot += math.prod(leaf.shape) * leaf.element_size() / shard_div(spec)
        return tot

    param_b = bytes_of(p_struct, specs)
    out = {"params": param_b}
    if shape.kind == "train":
        mom = _itemsize(cfg.optimizer_state_dtype)
        out["optimizer"] = 2 * param_b * mom / _itemsize(cfg.dtype)
        out["grads_transient"] = param_b * 4 / _itemsize(cfg.dtype)
        n_b = math.prod([axis_sizes[a] for a in S.batch_axes(mesh)])
        b_loc = max(1, shape.global_batch // n_b)
        # remat residuals: one [B,S,D] per super-layer + current layer temps
        out["residuals"] = (cfg.pattern_repeats * b_loc * shape.seq_len
                            * cfg.d_model * _itemsize(cfg.dtype))
        v_shard = axis_sizes.get("model", 1)
        out["logits_f32"] = b_loc * shape.seq_len * cfg.vocab_size * 4 / v_shard
    else:
        cache = M.init_cache(cfg, shape.global_batch, shape.seq_len, "meta")
        cspecs = S.cache_specs_for(mesh, cache, shape.global_batch)
        out["kv_cache"] = bytes_of(cache, cspecs)
    out["total"] = sum(v for k, v in out.items())
    return out


# ---------------------------------------------------------------------------
# cell runner
# ---------------------------------------------------------------------------


def _mesh_name(sizes: Dict[str, int]) -> str:
    shape = tuple(sizes.values())
    if shape == (16, 16):
        return "pod16x16"
    if shape == (2, 16, 16):
        return "pod2x16x16"
    return "mesh" + "x".join(map(str, shape))


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             mesh=None, verbose: bool = True, smoke: bool = False,
             overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    t0 = time.time()
    cfg = get_config(arch, smoke=smoke)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if mesh is None:
        if not dist.is_initialized():
            init_fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    mesh_name = _mesh_name(S.axis_sizes(mesh))
    result: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                              "mesh": mesh_name, "ok": False}
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        result.update(skipped=True, reason=why, ok=True)
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: SKIP ({why})")
        return result
    result["overrides"] = overrides or {}
    try:
        m = _measure_cfg(cfg, shape, mesh)
        result["memory"] = {"error": "not measured: the step runs on meta tensors, which "
                                     "allocate nothing (see memory_analytic)"}
        result["memory_analytic"] = analytic_memory(cfg, shape, mesh)
        c = m["corrected"]
        terms = {
            "flops_per_chip": c["flops"],
            "bytes_per_chip": c["bytes"],
            "wire_bytes_per_chip": c["wire_total"],
            "wire_breakdown": {k: c[f"wire_{k}"] for k in R.KINDS},
            "collective_ops": c["collective_ops"],
            "compute_s": c["flops"] / R.PEAK_FLOPS,
            "memory_s": c["bytes"] / R.HBM_BW,
            "collective_s": c["wire_total"] / R.LINK_BW,
        }
        terms["dominant"] = max(
            [("compute", terms["compute_s"]), ("memory", terms["memory_s"]),
             ("collective", terms["collective_s"])], key=lambda kv: kv[1])[0]
        terms["step_s_lower_bound"] = max(terms["compute_s"], terms["memory_s"],
                                          terms["collective_s"])
        # useful-FLOPs ratio
        p_struct = params_struct(cfg)
        n_total = sum(math.prod(x.shape) for x in T.tree_leaves(p_struct))
        n_active = _active_params(cfg, p_struct)
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        mf = R.model_flops(n_active, tokens, shape.kind)
        n_chips = math.prod(S.axis_sizes(mesh).values())
        terms["model_flops_global"] = mf
        hlo_global = terms["flops_per_chip"] * n_chips
        terms["useful_flops_ratio"] = mf / hlo_global if hlo_global else 0.0
        terms["n_params"] = n_total
        terms["n_active_params"] = n_active
        result["trips"] = m["trips"]
        result["raw"] = m["raw"]  # per-length counts (xLSTM) or the one count
        result["roofline"] = terms
        result["notes"] = [ESTIMATE_NOTE, BYTES_NOTE, *layout_notes(cfg, mesh, shape),
                           *([m["note"]] if "note" in m else [])]
        result["compile_seconds"] = time.time() - t0  # the trace's seconds (the reference's key)
        result["ok"] = True
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
                  f"compute={terms['compute_s']:.4f}s memory={terms['memory_s']:.4f}s "
                  f"collective={terms['collective_s']:.4f}s dominant={terms['dominant']} "
                  f"useful={terms['useful_flops_ratio']:.2f} "
                  f"(trace {result['compile_seconds']:.0f}s)")
    except Exception as e:
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAIL {result['error']}")
    return result


def layout_notes(cfg: ModelConfig, mesh, shape: InputShape) -> list:
    """How attention, the experts and the recurrent time loops are laid out
    over 'model' in this cell (``sharding.per_head_shard``, the MoE rules'
    EP/TP fallback, ``sharding.per_batch_shard``'s loop routes)."""
    sizes = S.axis_sizes(mesh)
    m = sizes.get("model", 1)
    notes = []
    loops = [k for k in ("mlstm", "slstm", "hymba") if k in cfg.block_pattern]
    if loops and m > 1:
        H = cfg.ssm_heads or cfg.num_heads
        B = shape.global_batch
        n_b = math.prod(sizes[a] for a in (cfg.batch_axes or S.batch_axes(mesh)))
        rows = B // n_b if B % n_b == 0 else B
        what = "the SSD scan" if loops == ["hymba"] else "the mLSTM/sLSTM time loops"
        if H % m == 0:
            notes.append(f"{what} head-parallel: {H // m} of {H} heads a rank over 'model'")
        elif rows % m == 0:
            notes.append(f"{what} split over 'model' by batch rows ({rows // m} of the {rows} "
                         f"rows of a batch shard a rank): {H} heads do not divide its {m} ranks")
        else:
            notes.append(f"{what} repeated on every rank of 'model': neither its {H} heads nor "
                         f"the {rows} rows of a batch shard divide its {m} ranks")
    if any(k in ("dense", "moe", "hymba") for k in cfg.block_pattern):
        H, KV = cfg.num_heads, cfg.num_kv_heads
        if H % m == 0:
            kv = "split with them" if KV == H else "replicated over 'model'"
            notes.append(f"attention head-parallel: {H // m} of {H} query heads a rank over "
                         f"'model'; K and V ({KV} heads) {kv}")
        else:
            notes.append(f"attention heads replicated over 'model' (explicit rule, "
                         f"sharding.per_head_shard): {H} query heads do not divide its {m} "
                         f"ranks, so each rank attends with every head")
        if cfg.kv_block_axis:
            notes.append(f"chunked cache attention: queries and the softmax state split over "
                         f"'{cfg.kv_block_axis}' along the sequence, KV blocks read whole")
    if cfg.num_experts:
        E = cfg.num_experts
        notes.append(f"experts split over 'model' (EP, {E // m} of {E} a rank)" if E % m == 0
                     else f"expert FFN dims split over 'model' (TP): {E} experts do not "
                          f"divide its {m} ranks")
    return notes


def _active_params(cfg: ModelConfig, p_struct) -> int:
    active = 0
    for pstr, leaf in T.tree_paths(p_struct):
        size = math.prod(leaf.shape)
        if "/moe/" in pstr and "router" not in pstr:
            active += size * cfg.num_experts_per_tok // max(1, cfg.num_experts)
        else:
            active += size
    return active


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _debug_mesh(spec: str):
    """A fake world and mesh of ``DxM`` (data, model) or ``PxDxM``."""
    shape = tuple(int(x) for x in spec.lower().split("x"))
    axes = ("pod", "data", "model")[-len(shape):]
    init_fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="reports/dryrun")
    ap.add_argument("--variant", default=None,
                    help="cfg overrides key=val[,key=val...], e.g. "
                         "param_mode=tp or moe_groups=16 (named in output)")
    ap.add_argument("--tag", default=None, help="suffix for the output file")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced same-family configs (CPU tests)")
    ap.add_argument("--mesh", default=None,
                    help="a small fake mesh DxM or PxDxM in place of the production one")
    args = ap.parse_args()
    overrides = {}
    if args.variant:
        import ast
        for kv in args.variant.split(";"):
            k, v = kv.split("=", 1)
            try:
                overrides[k] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                overrides[k] = v

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all required"
        cells = [(args.arch, args.shape)]

    if args.mesh:
        mesh = _debug_mesh(args.mesh)
    else:
        init_fake_world(512 if args.multi_pod else 256)
        mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
    mesh_name = _mesh_name(S.axis_sizes(mesh))
    n_fail = 0
    for arch, shape in cells:
        res = run_cell(arch, shape, multi_pod=args.multi_pod, mesh=mesh,
                       smoke=args.smoke, overrides=overrides)
        tag = f"__{args.tag}" if args.tag else ""
        fname = f"{arch.replace('-', '_')}__{shape}__{mesh_name}{tag}.json"
        with open(os.path.join(args.out, fname), "w") as f:
            json.dump(res, f, indent=1)
        n_fail += 0 if res["ok"] else 1
    print(f"[dryrun] done: {len(cells) - n_fail}/{len(cells)} cells OK")
    dist.destroy_process_group()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
