"""The pipeline-parallel train and eval steps of ``ScanBlockLM``
(counterpart of ``tpuframe/parallel/pp_lm.py``): GPipe over the ``pipe``
axis (``parallel/pp.py``), composed with data parallelism over ``data``.

Layout: the model's layer-stacked ``blocks.*`` parameters, and their
optimizer moments, split their leading (layer) dim over pipe
(:func:`state_partition`): stage ``s`` holds layers ``[s L / S, (s + 1)
L / S)``.  The embedding, the final LayerNorm and the head are whole on
every stage.  The batch's rows split over data; the stages of one data
index take the same rows.

A step: stage 0 embeds its rows and feeds their microbatches to the
pipeline; the last stage runs the head and the loss, the JAX one: the
valid-token mean (labels -100 ignored) over the whole batch of the data
group, not a mean of per-microbatch means; the backward pipeline runs
(the other stages start it from a zero cotangent); each gradient is
averaged over the data group; the replicated leaves' gradients, the
embedding's from stage 0 and the head's and final LayerNorm's from the
last stage, are broadcast over the pipe group, so every stage applies the
same update to them and they stay bit-identical; the gradient norm sums
each stage's block squares over the pipe group and counts the replicated
leaves once (the JAX ``pp_clip_by_global_norm``; :func:`global_sq`, the
optimizer's ``global_sq`` hook), and ``grad_clip_norm`` clips by it.

Where the JAX program computes the head on every stage (the loss then
lives everywhere), the port computes it on the last stage alone and
broadcasts the metrics: the head is the costliest op of the LM at long
sequence lengths.  Dropout and a layer count that the pipe degree does
not divide are refused with the JAX messages.
"""

from __future__ import annotations

import torch

from tpuframe_torch.models import losses
from tpuframe_torch.ops import fused_xent as fx
from tpuframe_torch.parallel import collectives, pp, tp


def state_partition(model) -> dict:
    """``{parameter name: spec}``: every ``blocks.*`` parameter splits its
    leading (layer) dim over pipe; everything else is replicated (not
    named)."""
    return {name: ("pipe",) + (None,) * (p.dim() - 1)
            for name, p in model.named_parameters()
            if name.startswith("blocks.")}


def shard_(model, layout) -> dict:
    """Cut ``model`` (whole, the same on every rank) to this stage's
    layers in place and mark it with its ``shard_specs`` and ``layout``
    (so that ``TrainState.to_tree`` gives the block leaves as
    ``ckpt.Shard``); returns the specs."""
    check(model.cfg, layout.pipe_size)
    specs = state_partition(model)
    tp.cut_(model, specs, layout)
    model.shard_specs = specs
    model.layout = layout
    return specs


def check(cfg, n_stages: int) -> None:
    """The JAX ``make_pp_lm_step``'s refusals."""
    if cfg.num_layers % n_stages:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"pipe={n_stages}")
    if cfg.dropout > 0:
        raise ValueError("make_pp_lm_step does not support dropout>0 yet; "
                         "set dropout=0.0 in the LMConfig")


def global_sq(sq: list, specs: list, layout) -> torch.Tensor:
    """The sum of squares of the whole gradient tree: ``sq`` holds each
    local tensor's sum of squares (f32 0-d), ``specs`` its spec (None:
    replicated).  The stage-split tensors' squares are summed over the
    pipe group (one number), the replicated ones' counted once, so every
    stage gets the same norm."""
    zero = sq[0].new_zeros(()) if sq else torch.zeros(())
    split = sum((s for s, spec in zip(sq, specs) if spec is not None), zero)
    whole = sum((s for s, spec in zip(sq, specs) if spec is None), zero)
    return collectives.pipe_sum(split, layout.pipe) + whole


def _owner(name: str, n_stages: int) -> int:
    """The stage that computes a replicated leaf's gradient."""
    return 0 if name.startswith("embed.") else n_stages - 1


def _head_loss_acc(model, fused_xent: bool, x_last, labels, reduce):
    """(mean CE loss, token accuracy) from the last stage's hidden states
    over the valid tokens of the data group's batch: the dense head, or
    the chunked fused softmax-xent (the logits never materialize).  One
    definition for the train and eval steps."""
    if fused_xent:
        hidden = model(x_last, head_only=True, hidden_only=True)
        return fx.mean_xent_and_accuracy(
            hidden, model.head_weight().T, labels, ignore_index=-100,
            reduce=reduce)
    logits = model(x_last, head_only=True)
    return (losses.softmax_cross_entropy(logits, labels, ignore_index=-100,
                                         reduce=reduce),
            losses.accuracy(logits.detach(), labels, ignore_index=-100,
                            reduce=reduce))


def _forward(model, layout, ids, labels, n_micro: int, fused_xent: bool,
             train: bool):
    """The pipeline's forward on this stage: ``(out, (loss, accuracy) on
    the last stage, else None)``."""
    pipe = layout.pipe
    c = model.cfg
    if pipe.index == 0:
        x = model(ids, embed_only=True)
    else:
        # only stage 0 reads the feed's values
        x = torch.empty((*ids.shape, c.hidden_size), dtype=c.torch_dtype,
                        device=ids.device)
    out = pp.pipeline_apply(
        lambda xm: model(xm, stage=True, train=train),
        pp.microbatch(x, n_micro), pipe)
    if pipe.index < pipe.size - 1:
        return out, None
    return out, _head_loss_acc(model, fused_xent, out.reshape(x.shape),
                               labels, layout.data_group)


def make_pp_lm_step(cfg, layout, *, n_micro: int, fused_xent: bool = False):
    """``train_step(state, batch) -> metrics`` on this stage (the
    module docstring), updating ``state`` in place; ``cfg`` is the
    model's ``LMConfig``, ``layout`` the rank's ``mesh.Layout`` (a pipe
    degree above 1).  ``metrics``: ``loss``, ``accuracy`` and
    ``grad_norm``, 0-d tensors, the same on every rank."""
    check(cfg, layout.pipe_size)
    pipe, data = layout.pipe, layout.data_group

    def train_step(state, batch: dict) -> dict:
        model = state.model
        for p in model.parameters():
            p.grad = None
        out, head = _forward(model, layout, batch["input_ids"],
                             batch["labels"], n_micro, fused_xent, True)
        if head is None:
            pp.backward_from(out)
            metrics = out.new_zeros(2, dtype=torch.float32)
        else:
            loss, acc = head
            loss.backward()
            metrics = torch.stack([loss.detach(), acc.detach()]).float()
        del out, head
        specs = model.shard_specs
        params = list(model.named_parameters())
        for _, p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        collectives.mean_([p.grad for n, p in params if n in specs], data)
        for n, p in params:
            if n in specs:
                continue
            owner = _owner(n, pipe.size)
            if pipe.index == owner:
                collectives.mean_([p.grad], data)
            collectives.pipe_broadcast_(p.grad, pipe, owner)
        metrics = collectives.last_stage_value(metrics, pipe)
        norm = state.opt.step()
        state.step += 1
        return {"loss": metrics[0], "accuracy": metrics[1],
                "grad_norm": norm}

    return train_step


def make_pp_lm_eval(cfg, layout, *, n_micro: int, fused_xent: bool = False):
    """``eval_step(state, batch) -> metrics``: the forward pipeline alone,
    ``loss``, ``accuracy`` and ``perplexity = exp(loss)`` over the data
    group's batch, the same on every rank."""
    pipe = layout.pipe

    @torch.no_grad()
    def eval_step(state, batch: dict) -> dict:
        _, head = _forward(state.model, layout, batch["input_ids"],
                           batch["labels"], n_micro, fused_xent, False)
        if head is None:
            m = torch.zeros(3, dtype=torch.float32,
                            device=batch["input_ids"].device)
        else:
            loss, acc = head
            m = torch.stack([loss, acc, torch.exp(loss)]).float()
        m = collectives.last_stage_value(m, pipe)
        return {"loss": m[0], "accuracy": m[1], "perplexity": m[2]}

    return eval_step
