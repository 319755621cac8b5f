"""Replicated data-parallel train and eval steps (counterpart of the DP
core of ``tpuframe/parallel/step.py``).

The JAX package traces the whole step into one program and lets the
``pmean`` of the loss emit the gradient reduction.  Here the step runs
eagerly: forward and backward per microbatch, then one in-place reduction
of the gradients over the ``torch.distributed`` world (a world of one when
no group is initialised), then the optimizer.  The reduction is the mean
(Horovod's averaged allreduce) or, with ``grad_reduce="adasum"``, Adasum
of the local gradients (``collectives.adasum_``), the identity in a world
of one.  The same contract holds:

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
    single-valued as the JAX step's ``pmean`` of ``model_state`` does
    (under Adasum too).  In the sharded-state mode (``layout``) the
    statistics are the batch group's (``parallel/fsdp.py``), the same on
    every rank, and are not averaged, as the JAX jit step keeps its
    logical ``model_state``.

With ``distributed=False`` the steps run no collective even in a process
group: each process trains alone, as the JAX package's unmapped step on
one device does.

With ``fusion_threshold`` (``TPUFRAME_FUSION_THRESHOLD``) the mean runs in
fusion buckets (``parallel/fusion.py``): the gradients through a
``StagedReducer`` whose buckets start from gradient hooks during the last
microbatch's backward, then the statistics and the metrics through
``fused_mean_`` at the same threshold (the eager counterpart of XLA's
combiner on the JAX step's per-leaf ``pmean``).  The values are those of
the per-tensor path.

``weight_update="zero1"`` (``TPUFRAME_WEIGHT_UPDATE``, ``parallel/zero1.py``)
runs no gradient all-reduce: the local gradients go to
``zero1.sharded_update`` (reduce-scatter, the update of this rank's chunk,
all-gather), with ``fusion_threshold`` bucketing both of its collectives;
the statistics and the metrics keep their mean.  ``wire_format=
"int8-block"`` (``TPUFRAME_WIRE_FORMAT``, ``parallel/quantwire.py``) sends
the gradients over the block-quantized wire: ``quantwire.all_reduce_mean``
on the replicated path, the quantized scatter and delta gather on the
zero1 one.  Both refuse Adasum, the int8 wire refuses a fusion threshold
(the buckets pack full-precision payloads) and zero1 needs a world
(``distributed``; a world of one process is n=1), as the JAX step does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from tpuframe_torch.parallel import (collectives, fusion, quantwire, tp,
                                     zero1)
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
        copies.  An optimizer in the ZeRO-1 layout gives its moments as
        ``ckpt.FlatShard`` leaves (``zero1.opt_tree``); a model cut by
        ``fsdp.shard_`` (or to a pipeline stage's layers by
        ``pp_lm.shard_``) gives its split parameters and their moments
        as ``ckpt.Shard`` leaves."""
        model = dict(self.model.state_dict())
        opt = zero1.opt_tree(self.opt)
        specs = getattr(self.model, "shard_specs", {})
        layout = getattr(self.model, "layout", None)
        if specs and layout is not None:
            # fsdp, tensor and expert parallelism: each split parameter
            # and its moments are this rank's block (``ckpt.Shard``)
            model = tp.ckpt_tree(model, specs, layout)
            opt = {k: v if k == "count" else tp.ckpt_tree(v, specs, layout)
                   for k, v in opt.items()}
        return {"model": model, "opt": opt, "step": self.step,
                "seed": self.seed}

    def load_tree(self, tree: dict) -> None:
        """Take a tree of :meth:`to_tree`'s structure, copying into the
        live tensors in place."""
        self.model.load_state_dict(tree["model"])
        self.opt.load_state_dict(zero1.load_opt_tree(tree["opt"]))
        self.step = int(tree["step"])
        self.seed = int(tree["seed"])


def dropout_seed(seed: int, step: int, rank: int, micro: int = 0) -> int:
    """The step's dropout seed: one per (seed, step, rank, microbatch), so
    replicas draw different masks while their parameters stay in lockstep
    (the JAX step folds the step and the replica index into its key)."""
    return int(np.random.SeedSequence([seed, step, rank, micro])
               .generate_state(1, np.uint64)[0] >> 1)


def make_train_step(loss_fn: LossFn, *, accum_steps: int = 1,
                    grad_reduce: str = "mean", distributed: bool = True,
                    fusion_threshold: int | None = None,
                    weight_update: str = "replicated",
                    wire_format: str = "fp", layout=None):
    """``train_step(state, batch) -> metrics``: forward, backward, the
    world's gradient reduction (none unless ``distributed``): the mean,
    or Adasum with ``grad_reduce="adasum"``, and the optimizer update, in
    place on ``state``.  ``metrics`` holds ``loss``, ``grad_norm`` and the
    loss function's metrics, as 0-d tensors on the model's device.

    Adasum needs each rank's own gradients, so its loss must be local (no
    reduction inside the loss function); with ``accum_steps`` the
    microbatches' gradients are accumulated locally in the parameters'
    f32 and one Adasum runs at the end, as in the JAX step.

    ``fusion_threshold``: the byte size of the fusion buckets of the mean
    (module docstring; <= 0 is a bucket a tensor, through the same staged
    pass); None reduces one tensor at a time.  The step's ``reducer`` is
    the ``StagedReducer`` of its last run (None before one), for its
    ``early`` count and its census.  Adasum takes no threshold, as in the
    JAX step.

    ``weight_update`` (``"replicated"`` or ``"zero1"``, whose state comes
    from ``zero1.make_state``) and ``wire_format`` (``"fp"`` or
    ``"int8-block"``): see the module docstring.  The zero1 step has no
    ``reducer``.

    ``layout``: the sharded-state mode's ``mesh.Layout`` (None: the
    world is the data group).  The statistics and metrics are then
    averaged over its batch group (data x fsdp: the ranks that take other
    rows), and so is each parameter's gradient that is whole over fsdp;
    a parameter split over fsdp (``parallel/fsdp.py``) has had its
    gradient reduce-scattered, summed over the fsdp ranks, in the
    backward, so its block is averaged over the data group and divided by
    the fsdp degree: either way the gradient of the global batch's mean
    (no reduction for a degree of 1).  The dropout seeds take the batch
    index in place of the world rank, so that ranks holding other blocks
    of the same rows draw the same masks; and with ``accum_steps``
    microbatch ``i`` is rows ``[i B / a, (i + 1) B / a)`` of the global
    batch (the batch ranks' batches in order), each rank taking its block
    of them, as the JAX jit step splits its logical batch, where
    otherwise each rank splits its own rows."""
    wire_format = quantwire.validate_format(wire_format)
    weight_update = zero1.validate_mode(weight_update)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if grad_reduce not in ("mean", "adasum"):
        raise ValueError(f"grad_reduce must be 'mean' or 'adasum', "
                         f"got {grad_reduce!r}")
    if grad_reduce == "adasum" and fusion_threshold is not None:
        raise ValueError("grad_reduce='adasum' does not compose with "
                         "fusion_threshold — the butterfly is its own wire "
                         "pattern")
    if wire_format != "fp":
        if grad_reduce == "adasum":
            raise ValueError(f"wire_format={wire_format!r} does not compose "
                             f"with adasum — the butterfly is its own wire "
                             f"pattern")
        if fusion_threshold is not None:
            raise ValueError(f"wire_format={wire_format!r} does not compose "
                             f"with fusion_threshold — the fusion buffers "
                             f"pack full-precision payloads")
    if weight_update == "zero1":
        if not distributed:
            raise ValueError("weight_update='zero1' needs a world "
                             "(distributed=True) — a step with no "
                             "collective has nothing to shard the update "
                             "over")
        if grad_reduce == "adasum":
            raise ValueError("weight_update='zero1' does not compose with "
                             "adasum — the butterfly needs full gradients "
                             "on every replica")

    def staged(model: nn.Module, grp) -> fusion.StagedReducer:
        reducer = train_step.reducer
        if reducer is None or reducer.model is not model:
            if reducer is not None:
                reducer.remove()
            reducer = train_step.reducer = fusion.StagedReducer(
                model, grp, threshold_bytes=fusion_threshold)
        return reducer

    def train_step(state: TrainState, batch: dict) -> dict:
        model = state.model
        if not distributed:
            grp, rank = None, 0
        elif layout is None:
            grp, rank = collectives.group(), collectives.world()[1]
        else:
            grp, rank = layout.batch_group, layout.batch_index
        reducer = (staged(model, grp) if fusion_threshold is not None
                   and grp is not None and weight_update == "replicated"
                   else None)
        for p in model.parameters():
            p.grad = None
        n = next(iter(batch.values())).shape[0]
        if n % accum_steps:
            raise ValueError(f"accum_steps={accum_steps} does not divide "
                             f"the per-rank batch {n}")
        m = n // accum_steps
        if layout is not None and accum_steps > 1 and grp is not None:
            batch = _global_micro(batch, grp, accum_steps)
        loss_sum, metric_sums = 0.0, {}
        for i in range(accum_steps):
            micro = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            loss, metrics = loss_fn(model, micro, dropout_seed(
                state.seed, state.step, rank, i))
            if reducer is not None and i == accum_steps - 1:
                reducer.arm()
            (loss / accum_steps).backward()
            loss_sum = loss_sum + loss.detach()
            for k, v in metrics.items():
                metric_sums[k] = metric_sums.get(k, 0.0) + v.detach()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        stats = [b for b in model.buffers() if b.is_floating_point()]
        out = {k: v / accum_steps for k, v in metric_sums.items()}
        out["loss"] = loss_sum / accum_steps
        if weight_update == "zero1":
            # no gradient all-reduce: the reduce-scatter is the one
            # gradient-sized reduction
            if fusion_threshold is not None and grp is not None:
                fusion.fused_mean_(stats + list(out.values()), grp,
                                   threshold_bytes=fusion_threshold)
            else:
                collectives.mean_(stats + list(out.values()), grp)
            out["grad_norm"] = zero1.sharded_update(
                state.opt, grp, wire_format=wire_format,
                fusion_threshold=fusion_threshold)
            state.step += 1
            return out
        if reducer is not None:
            reducer.finish()
            fusion.fused_mean_(stats + list(out.values()), grp,
                               threshold_bytes=fusion_threshold)
        elif grad_reduce == "adasum":
            collectives.adasum_(grads, grp)
            collectives.mean_(stats + list(out.values()), grp)
        elif wire_format == "int8-block":
            with torch.no_grad():
                for g, m in zip(grads, quantwire.all_reduce_mean(grads, grp)):
                    g.copy_(m)
            collectives.mean_(stats + list(out.values()), grp)
        elif layout is not None and layout.fsdp is not None:
            split = [p.grad for p in model.parameters()
                     if p.grad is not None and hasattr(p, "fsdp")]
            whole = [p.grad for p in model.parameters()
                     if p.grad is not None and not hasattr(p, "fsdp")]
            # the reduce-scatter summed the fsdp ranks' gradients
            collectives.mean_(split, layout.data_group)
            for g in split:
                g.div_(layout.fsdp.size)
            # the running statistics are the batch group's already
            collectives.mean_(whole + list(out.values()), grp)
        else:
            collectives.mean_(grads + stats + list(out.values()), grp)
        out["grad_norm"] = state.opt.step()
        state.step += 1
        return out

    train_step.reducer = None
    return train_step


def _global_micro(batch: dict, grp, accum_steps: int) -> dict:
    """This rank's rows of each global microbatch, in microbatch order:
    the group's batches gathered (rank order: the global batch), then
    block ``r`` of each of the ``accum_steps`` row blocks."""
    import torch.distributed as dist

    size, r = dist.get_world_size(grp), dist.get_rank(grp)
    out = {}
    for k, v in batch.items():
        whole = collectives.allgather(v, grp)
        m = v.shape[0] // accum_steps
        out[k] = torch.cat([whole[(i * size + r) * m:(i * size + r + 1) * m]
                            for i in range(accum_steps)])
    return out


def make_eval_step(metric_fn: Callable[[nn.Module, dict], dict], *,
                   distributed: bool = True, layout=None):
    """``eval_step(state, batch) -> metrics``: forward only, in eval
    mode, each metric averaged over the world, or over the batch group
    of the sharded-state ``layout`` (unless not ``distributed``)."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict) -> dict:
        out = metric_fn(state.model, batch)
        if distributed:
            collectives.mean_(list(out.values()),
                              collectives.group() if layout is None
                              else layout.batch_group)
        return out

    return eval_step

