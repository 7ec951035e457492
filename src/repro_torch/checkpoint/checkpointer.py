"""Sharded checkpointing with async write-behind on a CMP-windowed buffer pool.

* Leaves are written as .npy shards + a manifest (path, shape, dtype,
  sha256 per shard) — torn writes are detected, saves are atomic (tmp dir +
  rename), and ``latest`` moves only after a complete save.
* ``AsyncCheckpointer`` snapshots to host and hands off to a writer thread
  through a bounded cyclic pool: if the writer stalls (slow blob store — the
  'stalled thread' of the paper), at most W snapshots are retained and the
  *training loop is never blocked*; excess snapshots are dropped oldest-first
  (bounded reclamation instead of unbounded retention).

The on-disk format is the JAX package's (``repro.checkpoint.checkpointer``),
so a checkpoint written by either package restores in the other:

* leaves are numbered in ``jax.tree_util`` flatten order — dict keys
  sorted, lists, tuples and ``NamedTuple`` fields in order, ``None``
  holding no leaf — with the same ``/``-joined key paths (a ``NamedTuple``
  field as ``.name``, as jax names it);
* a bfloat16 leaf is stored as raw 2-byte words under the ``.npy`` descr
  ``'<V2'``, with ``"bfloat16"`` in the manifest, as JAX writes it; it is
  read back as a uint16 view reinterpreted as ``torch.bfloat16`` (numpy has
  no bfloat16).

Leaves may be torch tensors (any device), DTensors (saved as their global
arrays), numpy arrays or Python scalars; :func:`restore` gives each leaf
back as a torch tensor on the device of the template's leaf (a numpy array
where the template's leaf is not a tensor), and with ``shardings`` as
DTensors on another mesh: a checkpoint written on one mesh restores onto
any other mesh shape (elastic re-mesh).
"""

from __future__ import annotations

import hashlib
import json
import os
import queue as pyqueue
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import tree as T
from repro_torch.parallel import sharding as S

BF16 = "bfloat16"


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as (numpy array to write, manifest dtype). bfloat16 tensors
    become their raw 2-byte words; a DTensor is gathered to its global
    array first (a collective: every rank of its mesh calls this)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _write_leaf(path: str, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:  # JAX's header for a bfloat16 leaf
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.require(arr, requirements="C").tobytes())


def save(ckpt_dir: str, step: int, state: Dict[str, Any],
         aux: Optional[Dict[str, Any]] = None) -> str:
    """state: arbitrary tree dict (params, opt_state, data_state, ...).

    ``aux`` is an optional JSON-able side-channel saved atomically with the
    same step — scheduler frontier snapshots (``QueueClass.state()`` /
    ``ReplicaSet.state()``), data-pipeline cursors, uid counters: the
    exact-seat resume state that is *structure*, not arrays. It rides the
    same tmp-dir + rename, so a step either has both its leaves and its
    frontiers or neither.

    A state with DTensor leaves is saved by every rank of the default
    process group together: each such leaf is written as its global array,
    which every rank takes part in gathering; rank 0 writes, and all ranks
    return once the step is complete on disk."""
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    sharded = any(isinstance(x, DTensor) for x in T.tree_leaves(state))
    if sharded and dist.get_rank() != 0:
        for leaf in T.tree_leaves(state):
            _host_array(leaf)
        dist.barrier()
        return final
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    if aux is not None:
        with open(os.path.join(tmp, "aux.json"), "w") as f:
            json.dump(aux, f)

    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(T.tree_paths(state)):
        arr, dtype = _host_array(leaf)
        fname = f"leaf_{i:05d}.npy"
        _write_leaf(os.path.join(tmp, fname), arr, dtype)
        with open(os.path.join(tmp, fname), "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest["leaves"].append({
            "path": path, "file": fname, "shape": list(arr.shape),
            "dtype": dtype, "sha256": digest,
        })
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(str(step))
    os.replace(os.path.join(ckpt_dir, "latest.tmp"),
               os.path.join(ckpt_dir, "latest"))
    if sharded:
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def restore_aux(ckpt_dir: str, step: Optional[int] = None
                ) -> Tuple[int, Optional[Dict[str, Any]]]:
    """Load the aux (frontier) side-channel of a checkpoint; None when the
    step was saved without one."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    p = os.path.join(ckpt_dir, f"step_{step}", "aux.json")
    if not os.path.exists(p):
        return step, None
    with open(p) as f:
        return step, json.load(f)


def _read_leaf(path: str, dtype: str, like, sharding, mesh):
    arr = np.load(path)
    if not isinstance(like, torch.Tensor):
        return arr
    arr = np.require(arr, requirements="C")
    if dtype == BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    t = t.to(like.device)
    if isinstance(sharding, tuple):
        return distribute_tensor(t, *sharding)
    if sharding is not None:
        return distribute_tensor(t, mesh, S.placements(sharding, mesh))
    if isinstance(like, DTensor):
        return distribute_tensor(t, like.device_mesh, like.placements)
    return t


def _is_sharding(s) -> bool:
    """A ``(mesh, placements)`` pair or a spec (any leaf of a tree)."""
    return (isinstance(s, tuple) and len(s) == 2 and isinstance(s[0], DeviceMesh)) or (
        not T.is_node(s))


def _per_leaf(tree, shardings) -> list:
    """The sharding of each leaf of ``tree`` (None where there is none)
    from ``shardings``, a prefix tree of it: a sharding at a node applies
    to every leaf below it; a missing dict key or ``None`` gives none."""
    if shardings is None or _is_sharding(shardings):
        return [shardings] * len(T.tree_leaves(tree))
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in _per_leaf(tree[k], shardings.get(k))]
    return [s for c, sc in zip(T.children(tree), T.children(shardings), strict=True)
            for s in _per_leaf(c, sc)]


def restore(ckpt_dir: str, template: Dict[str, Any], step: Optional[int] = None,
            shardings: Any = None, verify: bool = True, mesh=None
            ) -> Tuple[int, Dict[str, Any]]:
    """Restore into the structure of ``template``: a leaf comes back as a
    torch tensor on the device of the template's tensor leaf (its dtype
    the checkpoint's; a DTensor in the template's placements where the
    template's leaf is one), else as a numpy array.

    ``shardings`` re-lays-out onto a new mesh (elastic re-mesh): a prefix
    tree of ``state`` (params-only is fine) whose leaves are ``(mesh,
    placements)`` pairs or partition specs (``parallel.sharding.P``, laid
    out on ``mesh``); the tensors it reaches come back as DTensors there.
    Every rank of that mesh calls it."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat_t = T.tree_leaves(template)
    leaves = manifest["leaves"]
    assert len(leaves) == len(flat_t), (
        f"checkpoint has {len(leaves)} leaves, template {len(flat_t)}")
    out = []
    for rec, like, sharding in zip(leaves, flat_t, _per_leaf(template, shardings)):
        fp = os.path.join(d, rec["file"])
        if verify:
            with open(fp, "rb") as f:
                if hashlib.sha256(f.read()).hexdigest() != rec["sha256"]:
                    raise IOError(f"integrity failure in {fp} ({rec['path']})")
        out.append(_read_leaf(fp, rec["dtype"], like, sharding, mesh))
    return step, T.tree_unflatten(template, iter(out))


def _host_leaf(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def _host_copy(tree):
    """Host snapshot of a state tree: tensors copied to the CPU, so the
    caller's buffers may be reused while the writer drains."""
    return T.tree_map(_host_leaf, tree)


class AsyncCheckpointer:
    """Write-behind checkpointing with CMP-bounded snapshot retention."""

    def __init__(self, ckpt_dir: str, window: int = 2):
        os.makedirs(ckpt_dir, exist_ok=True)
        self.ckpt_dir = ckpt_dir
        self.window = window
        self._q: pyqueue.Queue = pyqueue.Queue()
        self._pending = 0
        self._lock = threading.Lock()
        self.dropped = 0
        self.written = []
        self._writer = threading.Thread(target=self._run, daemon=True)
        self._writer.start()

    def submit(self, step: int, state: Dict[str, Any],
               aux: Optional[Dict[str, Any]] = None) -> bool:
        """Never blocks. Returns False if dropped (writer lag > window).

        ``aux`` (frontier snapshots etc.) is deep-copied through JSON at
        submit time, so the caller's live scheduler state may keep mutating
        while the writer drains — the async part is only the file I/O."""
        if aux is not None:
            # Deep-copy (and fail on non-JSON-able aux) BEFORE reserving a
            # window slot — a raise here must not leak the reservation.
            aux = json.loads(json.dumps(aux))
        with self._lock:
            if self._pending >= self.window:
                self.dropped += 1
                return False
            self._pending += 1
        try:
            snapshot = _host_copy(state)  # host copy: buffers reusable
            self._q.put((step, snapshot, aux))
        except BaseException:
            with self._lock:
                self._pending -= 1
            raise
        return True

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            step, snapshot, aux = item
            try:
                save(self.ckpt_dir, step, snapshot, aux=aux)
                self.written.append(step)
            finally:
                with self._lock:
                    self._pending -= 1

    def drain(self, timeout: float = 60.0) -> None:
        t0 = time.time()
        while True:
            with self._lock:
                if self._pending == 0:
                    return
            if time.time() - t0 > timeout:
                raise TimeoutError("checkpoint writer did not drain")
            time.sleep(0.01)

    def close(self) -> None:
        self.drain()
        self._q.put(None)
