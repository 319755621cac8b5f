"""Replicated data-parallel train and eval steps (counterpart of the DP
core of ``tpuframe/parallel/step.py``).

The JAX package traces the whole step into one program and lets the
``pmean`` of the loss emit the gradient reduction.  Here the step runs
eagerly: forward and backward per microbatch, then one in-place mean of
the gradients over the ``torch.distributed`` world (a world of one when no
group is initialised), then the optimizer.  The same contract holds:

  - every rank starts from the same parameters and applies the same
    averaged gradients, so parameters stay in lockstep;
  - ``accum_steps`` SPLITS the per-rank batch into that many microbatches
    (the effective batch is unchanged; f32 gradient sums, one reduction
    and one update per step), as the JAX step does, not Horovod's
    aggregation of loader batches;
  - the reported loss and metrics are means over the world, and
    ``grad_norm`` is the reduced gradients' global norm before clipping;
  - BatchNorm running statistics (the model's float buffers) update in
    each replica's forward from its own batch, once per microbatch in
    order, and are then averaged over the world, which keeps them
    single-valued as the JAX step's ``pmean`` of ``model_state`` does.

With ``distributed=False`` the steps run no collective even in a process
group: each process trains alone, as the JAX package's unmapped step on
one device does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from tpuframe_torch.parallel import collectives
from tpuframe_torch.utils.optim import Optimizer

# loss_fn(model, batch, dropout_seed) -> (loss, {metric: tensor})
LossFn = Callable[[nn.Module, dict, int], tuple]


@dataclass
class TrainState:
    """The model (its parameters), the optimizer (its moments and update
    count), the step count and the seed the per-step dropout seeds come
    from.  The step updates it in place."""

    model: nn.Module
    opt: Optimizer
    step: int = 0
    seed: int = 0

    def to_tree(self) -> dict:
        """The checkpoint's leaf tree: ``model/<state_dict name>``
        (parameters and buffers, BatchNorm running statistics among
        them), ``opt/count``, ``opt/<mu|nu|trace>/<parameter name>``,
        ``step`` and ``seed``.  The tensors are the live ones, not
        copies."""
        return {"model": dict(self.model.state_dict()),
                "opt": self.opt.state_dict(),
                "step": self.step, "seed": self.seed}

    def load_tree(self, tree: dict) -> None:
        """Take a tree of :meth:`to_tree`'s structure, copying into the
        live tensors in place."""
        self.model.load_state_dict(tree["model"])
        self.opt.load_state_dict(tree["opt"])
        self.step = int(tree["step"])
        self.seed = int(tree["seed"])


def dropout_seed(seed: int, step: int, rank: int, micro: int = 0) -> int:
    """The step's dropout seed: one per (seed, step, rank, microbatch), so
    replicas draw different masks while their parameters stay in lockstep
    (the JAX step folds the step and the replica index into its key)."""
    return int(np.random.SeedSequence([seed, step, rank, micro])
               .generate_state(1, np.uint64)[0] >> 1)


def make_train_step(loss_fn: LossFn, *, accum_steps: int = 1,
                    grad_reduce: str = "mean", distributed: bool = True):
    """``train_step(state, batch) -> metrics``: forward, backward, the
    world's gradient mean (none unless ``distributed``) and the optimizer
    update, in place on ``state``.  ``metrics`` holds ``loss``,
    ``grad_norm`` and the loss function's metrics, as 0-d tensors on the
    model's device."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if grad_reduce != "mean":
        raise NotImplementedError(
            f"grad_reduce={grad_reduce!r} is not ported yet (adasum: "
            f"ROADMAP.md queue 1, item 6)")

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        grp = collectives.group() if distributed else None
        rank = collectives.world()[1] if distributed else 0
        for p in model.parameters():
            p.grad = None
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"accum_steps={accum_steps} does not divide "
                             f"the per-rank batch {n}")
        m = n // accum_steps
        loss_sum, metric_sums = 0.0, {}
        for i in range(accum_steps):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, metrics = loss_fn(model, micro, dropout_seed(
                state.seed, state.step, rank, i))
            (loss / accum_steps).backward()
            loss_sum = loss_sum + loss.detach()
            for k, v in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + v.detach()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        stats = [b for b in model.buffers() if b.is_floating_point()]
        out = {k: v / accum_steps for k, v in metric_sums.items()}
        out["loss"] = loss_sum / accum_steps
        collectives.mean_(grads + stats + list(out.values()), grp)
        out["grad_norm"] = state.opt.step()
        state.step += 1
        return out

    return train_step


def make_eval_step(metric_fn: Callable[[nn.Module, dict], dict], *,
                   distributed: bool = True):
    """``eval_step(state, batch) -> metrics``: forward only, in eval
    mode, each metric averaged over the world (unless not
    ``distributed``)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        out = metric_fn(state.model, batch)
        if distributed:
            collectives.mean_(list(out.values()), collectives.group())
        return out

    return eval_step


def broadcast_parameters(model: nn.Module, root: int = 0) -> None:
    """Every rank takes ``root``'s parameters (Horovod's
    ``broadcast_parameters`` at start-up)."""
    grp = collectives.group()
    if grp is None:
        return
    import torch.distributed as dist

    with torch.no_grad():
        for p in model.parameters():
            dist.broadcast(p, root, group=grp)
