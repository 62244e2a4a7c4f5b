"""Training loop (PyTorch port of `repro.train.trainer`): gradient
accumulation, checkpoint / restart, preemption, straggler events.

  * microbatch gradient accumulation: the gradients of each microbatch
    summed in f32, then divided once (JAX's scan), before one optimizer
    update;
  * step-atomic checkpoints (async by default) and a deterministic data
    cursor: a killed run resumes from LATEST bit-identically;
  * preemption hook: a flag file checked every step triggers a final
    checkpoint, then the loop stops;
  * straggler detection: a step slower than `straggler_factor` x the
    trailing median emits a STRAGGLER event.

The loss and gradients come from `torch.autograd.grad` over the
parameter leaves; the optimizer updates the leaves in place.  On the
card the step is deterministic: the backward passes of the embedding
gather, the loss's gather and the MoE combine are written without float
atomics (`models.common.take_rows`, `cross_entropy_loss`), and TF32
stays off (PyTorch's default for matrix products).

Initial parameters come from the port's own `init_params` with
`torch.Generator().manual_seed(0)`, drawn on the CPU leaf by leaf and
moved to the device, at the spec dtypes as in JAX (bf16 unless a caller
passes its own parameters to `run`).  The port cannot re-create the
`jax.random` draws: to compare with the JAX trainer, pass its
parameters in through `repro_torch.convert`.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import DecoderLM, init_params
from repro_torch.models.common import map_specs

from . import checkpoint as ckpt_lib
from .adamw import AdamW, AdamWState, tree_leaves, tree_unflatten


@dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1          # grad-accumulation factor
    log_every: int = 10
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    preempt_flag: Optional[str] = None   # path; existence => preemption
    straggler_factor: float = 3.0
    async_checkpoint: bool = True


def make_train_step(model: DecoderLM, opt: AdamW,
                    microbatches: int = 1) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, state,
    loss), `params` updated in place.

    With microbatches > 1, `batch` has a leading accumulation dim and
    the gradients are averaged before a single optimizer update."""

    def loss_and_grads(params, leaves, batch):
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        # a leaf the loss does not read (a frontend-stub arch's unused
        # table) has a zero gradient, as under jax.grad
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def train_step(params, opt_state: AdamWState, batch):
        leaves = tree_leaves(params)
        if microbatches == 1:
            loss, grads = loss_and_grads(params, leaves, batch)
        else:
            grads = None
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for j in range(microbatches):
                loss_j, g_j = loss_and_grads(
                    params, leaves, {k: v[j] for k, v in batch.items()})
                if grads is None:
                    grads = [g.to(torch.float32) for g in g_j]
                else:
                    for a, g in zip(grads, g_j):
                        a.add_(g)
                loss = loss + loss_j
            for g in grads:
                g.div_(microbatches)
            loss = loss / microbatches
        opt_state = opt.update(tree_unflatten(params, grads), opt_state,
                               params)
        return params, opt_state, loss

    return train_step


@dataclass
class TrainEvent:
    kind: str                      # STEP | CKPT | PREEMPT | STRAGGLER
    step: int
    payload: Dict[str, Any] = field(default_factory=dict)


class Trainer:
    """`device`: where the step runs (CUDA unless the caller asks for
    another, `repro_torch.resolve_device`)."""

    def __init__(self, model: DecoderLM, opt: AdamW, data, tc: TrainConfig,
                 shard: int = 0, n_shards: int = 1,
                 event_hook: Optional[Callable[[TrainEvent], None]] = None,
                 device=None):
        self.model = model
        self.opt = opt
        self.data = data
        self.tc = tc
        self.shard = shard
        self.n_shards = n_shards
        self.events: List[TrainEvent] = []
        self.event_hook = event_hook
        self.device = resolve_device(device)
        self._step_times: List[float] = []
        self.train_step = make_train_step(model, opt, tc.microbatches)

    # ------------------------------------------------------------------
    def _emit(self, ev: TrainEvent):
        self.events.append(ev)
        if self.event_hook:
            self.event_hook(ev)

    def _preempted(self) -> bool:
        return bool(self.tc.preempt_flag
                    and os.path.exists(self.tc.preempt_flag))

    def _check_straggler(self, dt: float, step: int):
        self._step_times.append(dt)
        hist = self._step_times[-20:]
        if len(hist) >= 5:
            med = float(np.median(hist[:-1]))
            if dt > self.tc.straggler_factor * med:
                self._emit(TrainEvent("STRAGGLER", step,
                                      {"dt": dt, "median": med}))

    def _batch_at(self, index: int) -> Dict[str, torch.Tensor]:
        if self.tc.microbatches == 1:
            b = self.data.batch(index, self.shard, self.n_shards)
        else:
            mbs = [self.data.batch(index * self.tc.microbatches + j,
                                   self.shard, self.n_shards)
                   for j in range(self.tc.microbatches)]
            b = {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def init_params(self) -> Any:
        """The seed-0 parameters on the trainer's device."""
        return init_params(self.model.param_specs(),
                           torch.Generator().manual_seed(0), "cpu",
                           leaf_fn=lambda _, x: x.to(self.device))

    # ------------------------------------------------------------------
    def run(self, params=None, opt_state=None, start_step: int = 0,
            resume: bool = False) -> Dict[str, Any]:
        tc = self.tc
        if resume and tc.ckpt_dir and \
                ckpt_lib.latest_step(tc.ckpt_dir) is not None:
            # restore into the layout of the seed params, built on the
            # meta device (no memory)
            p0 = map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                 device="meta"),
                           self.model.param_specs())
            like = {"params": p0, "opt": tuple(self.opt.init(p0))}
            tree, meta = ckpt_lib.restore(tc.ckpt_dir, like,
                                          device=self.device)
            params, opt_state = tree["params"], AdamWState(*tree["opt"])
            start_step = int(meta["step"])
        if params is None:
            params = self.init_params()
        for p in tree_leaves(params):
            if not p.requires_grad:
                p.requires_grad_(True)
        if opt_state is None:
            opt_state = self.opt.init(params)

        losses: List[float] = []
        pending = None
        step = start_step
        while step < tc.steps:
            t0 = time.monotonic()
            batch = self._batch_at(step)
            params, opt_state, loss = self.train_step(params, opt_state,
                                                      batch)
            loss = float(loss)
            losses.append(loss)
            dt = time.monotonic() - t0
            self._check_straggler(dt, step)
            step += 1

            if step % tc.log_every == 0 or step == tc.steps:
                self._emit(TrainEvent("STEP", step,
                                      {"loss": loss, "dt": dt}))
            preempt = self._preempted()
            if tc.ckpt_dir and (step % tc.ckpt_every == 0
                                or step == tc.steps or preempt):
                if pending is not None:
                    pending.join()
                tree = {"params": params, "opt": tuple(opt_state)}
                pending = ckpt_lib.save(
                    tc.ckpt_dir, step, tree,
                    metadata={"data_seed": self.data.cfg.seed,
                              "next_batch_index": step},
                    blocking=not tc.async_checkpoint)
                self._emit(TrainEvent("CKPT", step, {}))
            if preempt:
                self._emit(TrainEvent("PREEMPT", step, {}))
                break
        if pending is not None:
            pending.join()
        return {"params": params, "opt_state": opt_state, "step": step,
                "losses": losses}
