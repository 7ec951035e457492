"""Fault-tolerant training loop, in torch.

The JAX package's ``training/train_loop.py`` on one device:

* deterministic resume — the checkpoint carries (params, opt state, step,
  data frontier) in the JAX package's on-disk format, so a run restores
  from a checkpoint that either package wrote;
* async write-behind checkpoints (never block the step; CMP-bounded lag);
* straggler detection — slow steps are counted by a robust median filter.

The step runs eagerly and updates the params and moments in place, the
counterpart of the reference's ``donate_argnums``. It reads one number
back to the host a step, the loss, where the reference waits on it with
``block_until_ready``.

Sharded: with params and moments as DTensors (``parallel.sharding.
param_shardings``) and the batch sharded by ``batch_specs_for``, the same
step runs on every rank of the mesh. DTensor's sharding propagation plays
GSPMD's part; the step runs under ``implicit_replication``, so the plain
tensors a layer or the optimizer makes (positions, masks, the step and
the learning rate) count as replicated, and each gradient is brought to
its param's layout before the update. The ``mesh`` argument is inert,
as in the reference, where jit follows the shardings of the params it is
given.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.training import optimizer as O


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its param's layout (Partial sums reduced and
    scattered, as GSPMD gives a gradient its param's sharding); the
    optimizer then combines moments, gradients and params shard by shard
    (torch 2.11 cannot take a Shard moment to a Partial gradient's
    layout). Plain gradients as they are."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: O.OptConfig, mesh=None) -> Callable:
    """Returns (params, opt_state, batch) -> (params, opt_state, metrics):
    the loss and its gradients by autograd, then :func:`O.apply_updates`,
    which writes the new params and moments over the old. Plain tensors or
    DTensors alike (``mesh`` is accepted and unused, as in the reference)."""

    @implicit_replication()
    def step_fn(params, opt_state, batch):
        # leaves that share the params' storage and record the graph, so
        # the params themselves never require grad
        live = [p.detach().requires_grad_(True) for p in O.tree_leaves(params)]
        loss, metrics = M.loss_fn(O.tree_unflatten(params, iter(live)), batch, cfg)
        grads = [_like(g, p) for g, p in zip(torch.autograd.grad(loss, live), live)]
        del loss, live
        metrics = {k: v.detach() for k, v in metrics.items()}
        params, opt_state, opt_m = O.apply_updates(
            params, O.tree_unflatten(params, iter(grads)), opt_state, opt_cfg)
        metrics.update(opt_m)
        return params, opt_state, metrics

    return step_fn


class Trainer:
    def __init__(self, cfg: ModelConfig, opt_cfg: O.OptConfig, *,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
                 ckpt_window: int = 2, seed: int = 0,
                 straggler_factor: float = 3.0, device="cuda"):
        self.cfg, self.opt_cfg = cfg, opt_cfg
        self.ckpt_dir, self.ckpt_every = ckpt_dir, ckpt_every
        self.seed = seed
        self.straggler_factor = straggler_factor
        self.device = torch.device(device)
        self.step = 0
        self.params = M.init_params(cfg, torch.Generator(self.device).manual_seed(seed),
                                    self.device)
        self.opt_state = O.init(self.params, opt_cfg)
        self.train_step = make_train_step(cfg, opt_cfg)
        self.async_ckpt = (ckpt.AsyncCheckpointer(ckpt_dir, window=ckpt_window)
                           if ckpt_dir else None)
        self.stragglers = 0
        self.step_times: list = []
        self.history: list = []

    # ------------------------------------------------------------- recovery
    def try_restore(self, data_pipe=None) -> bool:
        if not self.ckpt_dir:
            return False
        step = ckpt.latest_step(self.ckpt_dir)
        if step is None:
            return False
        template = {"params": self.params, "opt_state": self.opt_state,
                    "data_state": data_pipe.state() if data_pipe else {}}
        step, state = ckpt.restore(self.ckpt_dir, template)
        self.params = state["params"]
        self.opt_state = state["opt_state"]
        self.step = step
        self._restored_data_state = state.get("data_state")
        return True

    # ------------------------------------------------------------- main loop
    def fit(self, data_iter, num_steps: int,
            failure_hook: Optional[Callable[[int], None]] = None,
            data_pipe=None) -> Dict[str, Any]:
        """Runs ``num_steps`` more steps. ``failure_hook(step)`` may raise to
        simulate a node failure — the loop checkpoints such that a fresh
        Trainer + try_restore continues exactly."""
        for _ in range(num_steps):
            batch = next(data_iter)
            tb = {"tokens": torch.as_tensor(batch["tokens"]).to(self.device)}
            if "extra_embeds" in batch:
                tb["extra_embeds"] = torch.as_tensor(batch["extra_embeds"]).to(self.device)
            if failure_hook is not None:
                failure_hook(self.step)
            t0 = time.perf_counter()
            self.params, self.opt_state, metrics = self.train_step(
                self.params, self.opt_state, tb)
            loss = float(metrics["loss"])  # waits for the step's device work
            dt = time.perf_counter() - t0
            self._track_straggler(dt)
            self.step += 1
            self.history.append(loss)
            if self.async_ckpt and self.step % self.ckpt_every == 0:
                self._save(data_pipe)
        if self.async_ckpt:
            self._save(data_pipe)
            self.async_ckpt.drain()
        return {"final_loss": self.history[-1] if self.history else None,
                "stragglers": self.stragglers,
                "ckpt_dropped": self.async_ckpt.dropped if self.async_ckpt else 0}

    def _save(self, data_pipe=None) -> None:
        state = {"params": self.params, "opt_state": self.opt_state,
                 "data_state": data_pipe.state() if data_pipe else {}}
        self.async_ckpt.submit(self.step, state)

    def _track_straggler(self, dt: float) -> None:
        self.step_times.append(dt)
        if len(self.step_times) >= 8:
            med = sorted(self.step_times[-32:])[len(self.step_times[-32:]) // 2]
            if dt > self.straggler_factor * med:
                self.stragglers += 1
