"""Model FLOPs of a training step: the port's counterpart of the JAX
harness's ``_step_costs``, which reads XLA's cost analysis of the lowered
step.  PyTorch has no such analysis, so the port counts the model's
matmuls and convolutions; ``run_start``'s ``flops_per_step`` (with
``flops_source: "model"``), the offline MFU and ``chip_smoke.py``'s MFU
lines all come from here.

  LM     6 x (matmul params, embeddings excluded, the LM head included)
         x tokens + 3 x 4 x D x (causal query-key pairs) x N x L
  BERT   6 x (encoder matmul params) x tokens, the pooler and classifier
         on one row an example, and 3 x 4 x D x (kept query-key pairs)
         x N x L
  images 3 x the forward's convolution and matmul FLOPs (2 x multiply-
         adds, counted over a one-image forward)

The factor 3 (6 = 3 x 2) is the forward and the backward's two products
a matmul.  Elementwise work, norms, softmax and the optimizer are left
out, where XLA's count of the same step has them, and XLA counts a
convolution's backward by its own rules: on the tiny models of
``tests/test_torch_run_events.py`` XLA's count is 1.21x this one for the
LM, 1.23x for BERT, 0.87x for ResNet-18 and 0.98x for the ConvNet.  A
model with none of these counts gets the dense 6·N·D estimate,
``"analytic_6nd"`` (``goodput.flops_fallback``, tokens a sequence for
the LM).
"""

from __future__ import annotations

import torch
from torch import nn

SOURCE_MODEL = "model"
SOURCE_6ND = "analytic_6nd"


def lm_step_flops(cfg, batch: int, seq: int) -> float:
    """One step of a dense causal LM (``LMConfig``) on ``batch`` sequences
    of ``seq`` tokens."""
    h, inter, layers = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    matmul_params = layers * (4 * h * h + 2 * h * inter) + h * cfg.vocab_size
    pairs = batch * seq * (seq + 1) // 2
    return float(6 * matmul_params * batch * seq
                 + 3 * 4 * cfg.head_dim * pairs * cfg.num_heads * layers)


def bert_step_flops(cfg, batch: int, seq: int, pairs: float) -> float:
    """One step of BERT (``BertConfig``) on ``batch`` rows of ``seq``
    tokens whose attention keeps ``pairs`` query-key pairs in all (every
    query row times its row's unmasked keys)."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    enc = cfg.num_layers * (4 * h * h + 2 * h * inter)
    head = h * h + h * cfg.num_classes
    return float(6 * enc * batch * seq + 6 * head * batch
                 + 3 * 4 * cfg.head_dim * pairs * cfg.num_heads
                 * cfg.num_layers)


def bert_pairs(attention_mask: torch.Tensor) -> int:
    """Kept query-key pairs of a batch: every query row (padding rows
    too) times the unmasked keys of its row."""
    return int(attention_mask.shape[-1]) * int(attention_mask.sum())


def image_forward_flops(model: nn.Module, image_shape) -> int:
    """Forward FLOPs of one ``[H, W, C]`` image: 2 x the multiply-adds of
    every convolution and matmul that one eval forward of a zero image
    dispatches on the model's device (``torch.utils.flop_counter``, which
    sees the functional convolutions of the ConvNet and of the fused
    conv+BN Bottlenecks that module hooks miss)."""
    from torch.utils.flop_counter import FlopCounterMode

    device = next(model.parameters()).device
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(torch.zeros((1, *image_shape), device=device))
    return int(counter.get_total_flops())


def step_flops(cfg, model: nn.Module, batch: dict,
               seq_shards: int = 1) -> tuple[float | None, str | None]:
    """``(flops of one global step, "model")`` for a config of the
    trainer (``TrainConfig``), its model and one local batch, or
    ``(None, None)`` when the model has no count here.  ``seq_shards``:
    the seq ranks the batch's sequence is split over, so that the step
    counts the whole sequence's tokens and causal pairs once, not a
    rank's block a rank."""
    from tpuframe_torch.models.bert import BertForSequenceClassification
    from tpuframe_torch.models.transformer_lm import (ScanBlockLM,
                                                      TransformerLM)

    # ScanBlockLM (transformer-lm-pp) is the LM with its layers stacked:
    # the same step (the pipeline's bubbles are idle time, not work)
    if isinstance(model, (TransformerLM, ScanBlockLM)):
        if model.cfg.moe_experts:
            return None, None
        seq = int(batch["input_ids"].shape[-1]) * seq_shards
        return lm_step_flops(model.cfg, cfg.global_batch, seq), SOURCE_MODEL
    if isinstance(model, BertForSequenceClassification):
        mask = batch["attention_mask"]
        local, seq = int(mask.shape[0]), int(mask.shape[-1])
        pairs = bert_pairs(mask) * cfg.global_batch / local
        return (bert_step_flops(model.cfg, cfg.global_batch, seq, pairs),
                SOURCE_MODEL)
    if "image" in batch:
        h, w, c = batch["image"].shape[1:]
        if cfg.augment == "crop_flip" and cfg.augment_crop:
            h = w = cfg.augment_crop
        fwd = image_forward_flops(model, (h, w, c))
        return float(3 * fwd * cfg.global_batch), SOURCE_MODEL
    return None, None


def param_count(model: nn.Module) -> int:
    """The model's parameters, each counted whole where this rank holds a
    block of it (tensor, expert and pipeline parallelism:
    ``shard_specs``)."""
    specs = getattr(model, "shard_specs", {})
    layout = getattr(model, "layout", None)
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        for axis in (specs.get(name) or ()) if layout is not None else ():
            if axis is not None:
                n *= layout.sizes.get(axis, 1)
        total += n
    return total


def step_flops_or_fallback(cfg, model: nn.Module, batch: dict | None, *,
                           seq_shards: int = 1) -> tuple[float, str]:
    """:func:`step_flops`, else the dense 6·N·D estimate (``batch`` None:
    no step left to run)."""
    flops, src = (step_flops(cfg, model, batch, seq_shards)
                  if batch is not None else (None, None))
    if flops:
        return flops, src
    from tpuframe_torch.obs import goodput

    n_params = param_count(model)
    tokens = 1
    if batch is not None and "input_ids" in batch:
        tokens = int(batch["input_ids"].shape[-1]) * seq_shards
    return goodput.flops_fallback(n_params, cfg.global_batch,
                                  tokens), SOURCE_6ND
