#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU (an H100): build, check, serve,
train.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure raises and exits non-zero:

  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel under tpuframe_torch/csrc with nvcc;
  3. hold the forward kernel against its plain PyTorch version at the
     serving shapes and at the training slice's on both routes (bf16 on
     the tensor cores, and the CUDA-core kernel on the same inputs), with
     their shared memory and blocks an SM, and, for correctness only,
     every head_dim and dtype it takes, ragged lengths, key masks with
     fully masked rows and strided inputs, each case asserting the route
     it took; time the kernel, the plain version and one PyTorch library
     call that computes the same function (a yardstick only);
  4. the same for the delta pass and the two backward kernels at the
     training slice's shapes on both routes (bf16 on the tensor cores,
     f32 on the CUDA cores), each beside its bound and the whole backward
     beside SDPA's, with their shared memory and blocks an SM, plus a
     correctness sweep
     (f32, key masks with fully masked rows, ragged lengths, every
     head_dim, strided inputs, an lse cotangent), each case asserting the
     route it took;
  5. the precision probe: its three modes through ``precision_probe.probe``
     (launches read around that run), each mode's error against float64,
     and each kernel mode against its plain version, timed;
  6. prefill + decode logits against the full forward, full width, bf16;
  7. serve 12 requests over the three prompt buckets through run_loadgen
     -> Scheduler -> LMEngine at full width (TransformerLM defaults:
     hidden 768, 12 layers, 12 heads, vocab 32000, bf16, flash attention),
     with every kernel's launch count and the forward's routes read
     around that run;
 7b. the serving fleet (``fleet``): the same engine in two replica
     processes (``--replica-worker``) behind ``serve.router.Router``, 24
     traced Poisson requests: (a) clean, every request's tokens bit-equal
     to an in-process engine's, each replica's flash launches 12 a
     prefill on the tensor cores (counted in the replica, reset after its
     warm-up), its /metrics gauges, the merged traces verified, SIGTERM
     drains to rc 0; (b) the same with ``replica_crash`` on replica 1:
     nothing lost, a drain and a redispatch;
 7c. the live rollout (``rollout``): swap parity at full width (a hot swap
     streams a cold start's tokens); then phase fleet's replicas, 128
     traced requests, and the controller rolling them to seed 1's weights
     once step 1 commits into a watched directory: (a) clean, after an
     A/A gate between the two v0 replicas: done, both on v1, nothing
     lost, one replica in transition at a time, every answer's tokens
     bit-equal to an in-process engine on the version that served it,
     the flash launches counted in the replicas, the traces verified; (b)
     the same with a slow canary: aborted on a gate metric and rolled
     back, both on v0; (c) ``python -m tpuframe_torch.serve --selfcheck``
     on the card;
  8. one training step's loss and gradients at full width in f32, flash
     kernels against the plain einsum attention; then the same in bf16
     (the tensor-core route), both routes held to the f32 gradients;
  9. train lm_long through ``tpuframe_torch.train.main`` (cuts in
     TRAIN_OVERRIDES), with every kernel's launch count and the forward's
     and backward's routes read around that run, then profile one more
     step;
 10. hold the fused 1x1-conv+BN backward kernel against its plain version
     at the 15 shapes a ResNet-50 training step gives it (bf16, batch
     256) on both routes (the tensor cores, and the CUDA-core kernels on
     the same inputs), time them, the plain version and a yardstick (the
     autograd backward of cuDNN's unfused 1x1 conv + batch norm), then a
     correctness sweep (f32, ragged M/K/C, ragged M on the tensor cores,
     a strided downsample), each case asserting its route;
 11. one ResNet-50 training step's loss, gradients and running statistics
     at full width in f32, ``bn="fused"`` (the kernel) against
     ``bn="flax"`` (cuDNN), from the same weights;
 12. train imagenet_resnet50 with ``bn="fused"`` through
     ``tpuframe_torch.train.main`` (cuts in RESNET_CUTS), with every
     kernel's launch count and the fused op's routes read around that
     run, then profile one more step;
 13. BERT-base at full width with dropout 0 (``bert_parity``): the three
     flash kernels against their plain versions at BERT's shapes (key
     masked, not causal; the delta pass timed at batch 8 and 32), then one
     GLUE step's loss and gradients through
     the kernels against the einsum attention, in f32 and in bf16;
 14. serve 16 single-shot requests through ``BertClassifier`` at full
     width in bf16 over buckets 64 and 128 (``bert_serve``), each held
     to a classifier on the einsum path with the same weights and timed;
     time the forward kernel at BERT's eval shape beside its bound, the
     plain version and SDPA with the same mask;
 15. train glue_bert through ``tpuframe_torch.train.main`` at its own
     recipe (cuts in BERT_CUTS: steps only), asserting the reference's
     dispatch (dropout on the einsum in training, the forward kernel in
     eval), profile one more step, then run glue_bert_stsb and
     glue_bert_cola briefly (``bert_train``);
 16. train mnist_single through ``tpuframe_torch.train.main`` at its own
     recipe (MNIST_CUTS: steps only), after holding the ConvNet's logits
     on the card to the same model's on the CPU; profile 20 more steps
     (``mnist_train``);
 17. train cifar10_resnet18 the same way (CIFAR_CUTS: steps and mesh),
     with its MFU against the f32 peak, peak memory, an idle share, and
     the precision its f32 convolutions ran in (``cifar_train``);
 18. ResNet-50 at full width in f32: ``bn="folded"``, the space-to-depth
     stem and ``remat=True``, each against the ``bn="flax"`` 7x7 model
     from the same weights; then train imagenet_resnet50 with bn
     "fused", the s2d stem, remat and lars (VARIANT_CUTS), asserting
     every fused conv+BN launch and the lower peak memory against phase
     12's run (``resnet_variants``);
 19. checkpointing and the preemption contract (``ckpt``): lm_long at the
     train phase's cuts straight for 6 steps, then with periodic async
     saves preempted at step 3 by ``TPUFRAME_FAULTS=host:step=3:kind=
     sigterm`` (``SystemExit(14)``), then resumed to step 6: losses and
     state bit-equal to the straight run, every resumed flash launch on
     the tensor cores; an async snapshot held bit for bit to a blocking
     copy while the next step updates the state in place; a corrupt save
     quarantined and walked back; imagenet_resnet50's statistics and
     traces bit-equal after a resume, steps 3-4 within two straight runs'
     difference; bytes on disk, save, snapshot, worker and restore ms,
     the CRC-32C rate and step time with a save in flight, beside the
     card's name and power limit;
 20. the Horovod slice (``hvd``), in worlds of processes that
     ``LocalCluster`` starts with the launcher's environment (this process
     holds no process group): (a) a world of one over NCCL, every hvd verb
     and op on CUDA tensors against its plain expectation, then
     imagenet_resnet50 at RESNET_CUTS with ``grad_reduce="adasum"``, its
     losses equal to phase 12's and every fused conv+BN launch on the
     tensor cores (path ``hvd_resnet``); (b) cifar10_resnet18 as two
     processes on the one card over gloo (HVD_CIFAR_CUTS): final states
     bit-identical across ranks, step 1 against the plain data-parallel
     step, the loss falling, step p50 and idle share (gloo through the
     host); (c) ``adasum_combine`` at ResNet-50's leaf shapes against
     float64; (d) probes written down: raw gloo verbs on CUDA tensors, and
     two NCCL ranks on one card.

Phases 13-15 run with ``TPUFRAME_ATTN_IMPL=pallas`` and restore it after.
The harness turns TF32 off (f32 convolutions and matmuls run in f32), and
so does every f32 check here.

``--phases`` runs a subset after the build, for debugging.  A full run
prints a ``{"kernels": [...]}`` line, then ends with
``{"ok": true, "device": {...}}`` as its last line.  Weights and token ids
are random, drawn from fixed seeds.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
import json
import math
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))

from tpuframe_torch import _build  # noqa: E402
from tpuframe_torch import ckpt  # noqa: E402
from tpuframe_torch import native  # noqa: E402
from tpuframe_torch import train as train_lib  # noqa: E402
from tpuframe_torch.ckpt import checkpoint as ckpt_mod  # noqa: E402
from tpuframe_torch.launch.launcher import LocalCluster  # noqa: E402
from tpuframe_torch.data import datasets  # noqa: E402
from tpuframe_torch.models import get_model  # noqa: E402
from tpuframe_torch.models.bert import BertConfig  # noqa: E402
from tpuframe_torch.models.transformer_lm import LMConfig  # noqa: E402
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.obs import exporter as obs_exporter  # noqa: E402
from tpuframe_torch.obs import goodput as obs_goodput  # noqa: E402
from tpuframe_torch.obs import slo as slo_lib  # noqa: E402
from tpuframe_torch.obs import tracing  # noqa: E402
from tpuframe_torch.models import resnet as resnet_lib  # noqa: E402
from tpuframe_torch.ops import attention as attn  # noqa: E402
from tpuframe_torch.ops import flash_attention as fa  # noqa: E402
from tpuframe_torch.ops import fused_conv_bn as fcb  # noqa: E402
from tpuframe_torch.ops import precision_probe as pp  # noqa: E402
from tpuframe_torch.parallel import collectives, hvd  # noqa: E402
from tpuframe_torch.parallel import step as step_lib  # noqa: E402
from tpuframe_torch.serve import kv_cache as kv  # noqa: E402
from tpuframe_torch.resilience import faults  # noqa: E402
from tpuframe_torch.serve import loadgen  # noqa: E402
from tpuframe_torch.serve import router as router_lib  # noqa: E402
from tpuframe_torch.serve import replica as replica_lib  # noqa: E402
from tpuframe_torch.serve import rollout as rollout_lib  # noqa: E402
from tpuframe_torch.serve.engine import (BertClassifier, LMEngine,  # noqa: E402
                                        parity_diffs, swap_parity_check)
from tpuframe_torch.utils.config import get_config  # noqa: E402
from tpuframe_torch.utils.optim import build_optimizer  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {torch.bfloat16: 989e12,   # tensor cores
              torch.float32: 67e12}     # CUDA cores, outside tensor cores
PEAK_TF32_S = 495e12                    # tensor cores, TF32

# Kernel vs plain tolerances (max |diff|).  f32: the two differ only in
# summation order.  bf16: the kernel rounds P to bf16 against the running
# max of each tile, the plain version against the row's final max, so
# each P carries its own 2^-9 relative rounding; over |v| <= ~4 that is
# worth a few bf16 steps of the output.
TOL = {torch.float32: {"out": 2e-5, "lse": 2e-5},
       torch.bfloat16: {"out": 1e-2, "lse": 1e-4}}

# Prefill+decode against the full forward at full width in bf16: the two
# paths round the bf16 residual stream at different places (decode uses
# the plain einsum attention, and the matmuls see other row counts), so
# the f32 logits (std ~1 with these weights) differ by a few bf16 steps
# of the hidden state carried through 12 layers.
PARITY_ATOL_BF16 = 0.25

# Backward kernels vs plain versions: max |diff| over max |plain|.  f32:
# summation order only.  bf16: the kernel and the plain version round P
# and dS to bf16 from scores summed in other orders, so an operand near a
# rounding boundary can fall the other way, and each gradient is rounded
# to bf16 at the end (2^-8 relative).
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# The delta pass vs its plain version: max |diff| over max |plain|.  Both
# sum p * dp and p in f32 within each 64-key tile and in f64 across tiles,
# from the same inputs, in other orders within a tile: 1e-4 in either
# dtype.
DELTA_TOL = 1e-4

# The training slice: lm_long at its full width (hidden 768, 12 layers,
# 12 heads of 64, intermediate 3072, vocab 32000, bf16, adamw 3e-4, wd
# 0.1, clip 1.0, warmup+cosine, remat, fused xent, flash attention) and
# global batch 8, cut for one card: sequence 32768 -> 4096 (the config
# shards its sequence over a seq mesh axis with ring attention; on one
# card every token's activations sit on the card, 7.9 GiB at peak at 4096
# and about 8x that at 32768, which this run does not try), mesh data=2 x
# seq -> 1 x 1 (seq_mode ring on a seq degree of 1 is full causal
# attention), and a few steps with one eval batch.
TRAIN_STEPS = 4
TRAIN_EVAL_BATCHES = 1
TRAIN_OVERRIDES = {"mesh": {"data": 1, "seq": 1},
                   "dataset_kwargs": {"seq_len": 4096},
                   "total_steps": TRAIN_STEPS, "eval_every": TRAIN_STEPS,
                   "eval_batches": TRAIN_EVAL_BATCHES, "log_every": 1}
TRAIN_ARGS = ["--config", "lm_long"] + [
    a for k, v in TRAIN_OVERRIDES.items() for a in ("--set", f"{k}={v!r}")]
# The attention shape at the kernels there: batch, sequence, heads, D.
TRAIN_ATTN_SHAPE = (8, 4096, 12, 64)

# Gradient parity at full width in f32 (batch, sequence): the kernels and
# the einsum attention differ in summation order and in the einsum's
# -1e9 mask fill, worth ~1e-6 relative per layer.
GRAD_PARITY_SHAPE = (2, 256)
GRAD_PARITY_RTOL = 1e-4

# The same at full width in bf16, where the backward runs on the tensor
# cores.  Both routes carry bf16's own rounding, at different places, so
# each is held to the f32 einsum route's gradients from the same weights
# and batch: the kernels' relative error on each tensor may be at most
# BF16_NOISE_FACTOR times the bf16 einsum route's own error on it (its
# noise floor, measured in the same run).  The loss likewise, or within
# 1e-3 of the f32 loss.
BF16_PARITY_SHAPE = (2, 1024)
BF16_NOISE_FACTOR = 3.0

# Precision probe kernel vs its plain version (max |diff| over the probe's
# 256 x 256 product, entries up to ~75): both sum the same f32 products
# (a product of two TF32 values is exact in f32; "highest" rounds each
# product once either way) in other orders.  The tensor cores do not
# round each accumulation to nearest but truncate, so their error grows
# with the mma steps (32 in "medium", 96 in "high"), up to an ulp of the
# running sum (~8e-6 at |sum| ~ 64) each: below 1e-3.
PROBE_TOL = 1e-3
# Each mode's max |err| against float64 must fall in the band its
# precision gives: f32 keeps ~24 bits (a few 1e-5 over 256 terms), 3xTF32
# about as many less the tensor cores' truncation (above), one TF32 pass
# 11 bits (~1e-2).  The lower bound of "medium" shows that the tensor
# cores really ran in TF32.
PROBE_F64_BAND = {"highest": (0.0, 2e-4), "high": (0.0, 1e-3),
                  "medium": (1e-3, 0.1)}

SERVE_REQUESTS = 12
NEW_TOKENS = 16

# The ResNet slice: imagenet_resnet50 (ResNet-50 v1.5 at full width, 224 x
# 224, 1000 classes, bf16 compute with f32 params and BN statistics,
# nesterov SGD 0.9, wd 1e-4 under the decay mask, label smoothing 0.1,
# warmup + cosine, augment "flip") with bn="fused", cut for one card.
# Each cut and its reason:
RESNET_CUTS = {
    # the config's own per-chip model: its mesh is data-parallel, one card
    "model_kwargs": {"bn": "fused"},
    "mesh": {"data": 1},
    # 2048 over 8 chips in the recipe: one chip's share; the LR follows
    # the config's own rule (base_lr x global_batch / 256)
    "global_batch": 256,
    # no ImageNet on the machine: synthetic images, enough for 8 batches;
    # the eval split is an eighth (256) and must hold one batch
    "dataset_kwargs": {"synthetic_size": 2048},
    # a few steps and one eval batch, for the time limit
    "total_steps": 4, "eval_every": 4, "eval_batches": 1, "log_every": 1,
}
RESNET_ARGS = ["--config", "imagenet_resnet50"] + [
    a for k, v in RESNET_CUTS.items() for a in ("--set", f"{k}={v!r}")]
RESNET_BATCH = 256

# Fused conv+BN kernel vs plain version: max |diff| over max |plain|.
# Both compute g bit-equal (the kernel rounds each f32 operation on its
# own, as PyTorch does) and its products are exact in f32 for bf16
# operands; they differ in summation order only.  da is then rounded to
# its dtype (bf16: a 2^-8 step of the largest entries); dW is an f32 sum
# over up to 802,816 rows taken in another order.
CONV_BN_TOL = {torch.float32: {"da": 1e-4, "dw": 1e-4},
               torch.bfloat16: {"da": 1e-2, "dw": 1e-3}}
# The fused op against autograd through the plain composition (a strided
# downsample): max |diff| over max |plain|, the JAX package's own
# tolerances for the same comparison (tests/test_fused_conv_bn.py).  In
# bf16 autograd differentiates the bf16-rounded affine while the fused
# backward uses the exact closed form.
STRIDED_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}

# ResNet-50 gradient parity at full width in f32, batch 8 at 224: the
# fused op and cuDNN's conv + BN differ in summation order, in f32 with
# TF32 off, compounded through 53 BN layers.  Measured on the H100, the
# plain route alone moves its gradients by up to ~2.5% when the batch is
# reversed, so each tensor may differ by 3x that noise floor, or 1e-3.
RESNET_PARITY_BATCH = 8
RESNET_PARITY_RTOL = 1e-3
RESNET_NOISE_FACTOR = 3.0
# The same tolerances and noise floor hold the three ResNet-50 options of
# phase 18 to the bn="flax" 7x7 model from the same weights, f32, batch 8:
#   - bn="folded" normalises as x * a + b with the affine folded in f32
#     where flax takes (x - mean) * s + beta: equal in exact arithmetic,
#     one rounding apart in f32 (folded_bn.py: ~1e-5 per layer), carried
#     through 53 BN layers: loss, every gradient and running statistic;
#   - the space-to-depth stem with s2d_stem_kernel's weight sums the 7x7
#     stem's products (and a zero tap) in another order: the logits,
#     against the noise floor of the 7x7 model's logits on the batch
#     reversed;
#   - remat=True recomputes each block with the same arithmetic, and
#     cuDNN's backward may sum in other orders: every gradient; the
#     running statistics, updated once, within RESNET_PARITY_RTOL (a
#     second update would move them by ~10%).

# mnist_single (the reference's workload 1: the MNIST ConvNet, one
# device, no collective; batch 64, f32, dropout 0.25/0.5, nesterov SGD
# 0.02 constant; synthetic MNIST, 2048 train and 256 eval images) at its
# own recipe.  The only cut is the steps: 400 -> 100, with one eval pass
# (the 4 eval batches) at the end.
MNIST_CUTS = {"total_steps": 100, "eval_every": 100, "log_every": 50}
MNIST_ARGS = ["--config", "mnist_single"] + [
    a for k, v in MNIST_CUTS.items() for a in ("--set", f"{k}={v!r}")]
MNIST_BATCH = 64
# The ConvNet on the card against the same weights on the CPU, eval mode,
# f32 with TF32 off: summation order only, ~1e-6 of logits ~0.5.
MNIST_CPU_ATOL = 1e-4
# Learnable synthetic data: 100 steps must reach this eval accuracy (20
# reach 1.0 on the CPU).
MNIST_MIN_ACCURACY = 0.9

# cifar10_resnet18 (workload 2: ResNet-18 with the CIFAR stem at full
# width, 11.17 M params; batch 256, f32, nesterov SGD 0.1 x 256/256 with
# wd 5e-4 under the decay mask, 200 warmup steps then cosine; uint8
# synthetic CIFAR-10 with pad_crop_flip on the card) at its own recipe.
# Cuts: the mesh (data-parallel over all chips in the recipe; one card
# here) and the steps, 2000 -> 20 (inside the warmup) with one eval batch.
CIFAR_CUTS = {"mesh": {"data": 1}, "total_steps": 20, "eval_every": 20,
              "eval_batches": 1, "log_every": 5}
CIFAR_ARGS = ["--config", "cifar10_resnet18"] + [
    a for k, v in CIFAR_CUTS.items() for a in ("--set", f"{k}={v!r}")]
CIFAR_BATCH = 256
# A 3x3 conv at ResNet-18's first stage, f32 against f64: TF32 (10
# mantissa bits) errs ~1e-3 relative, f32 ~1e-6.  The harness's f32 must
# stay below this.
F32_CONV_MAX_REL = 1e-4

# The ResNet-50 variant run: imagenet_resnet50 with every option of the
# JAX model that reaches the hand-written kernel (bn "fused", the
# space-to-depth stem, remat) and lars, cut as RESNET_CUTS (one card's
# batch of 256, bf16, synthetic images), for 3 steps and one eval batch.
VARIANT_STEPS = 3
VARIANT_CUTS = {**RESNET_CUTS,
                "model_kwargs": {"bn": "fused", "stem": "space_to_depth",
                                 "remat": True},
                "optimizer": "lars", "total_steps": VARIANT_STEPS,
                "eval_every": VARIANT_STEPS}
VARIANT_ARGS = ["--config", "imagenet_resnet50"] + [
    a for k, v in VARIANT_CUTS.items() for a in ("--set", f"{k}={v!r}")]

# The BERT slice: glue_bert (BERT-base at full width: hidden 768, 12
# layers, 12 heads of 64, FFN 3072, vocab 30522, max_position 512; adamw
# 2e-5 with the decay mask, clip 1.0, linear schedule after 200 warmup
# steps; global batch 32, seq 128, bf16 compute over f32 params, dropout
# 0.1; synthetic SST-2) at its own recipe.  The only cuts are the steps:
# a few steps and two eval batches for the time limit, on one card.
BERT_LAYERS = 12
BERT_BATCH, BERT_SEQ = 32, 128
BERT_CUTS = {"mesh": {"data": 1}, "total_steps": 8, "eval_every": 8,
             "eval_batches": 2, "log_every": 1}
BERT_ARGS = ["--config", "glue_bert"] + [
    a for k, v in BERT_CUTS.items() for a in ("--set", f"{k}={v!r}")]
# STS-B (regression, Pearson at eval) and CoLA (MCC at eval), end to end.
BERT_TASK_CUTS = {"mesh": {"data": 1}, "total_steps": 2, "eval_every": 2,
                  "eval_batches": 1, "log_every": 1}
# Gradient parity at full width with dropout 0 (a config override both
# packages take), where every step runs the flash kernels key masked and
# not causal: batch 8 of glue_mnli's synthetic pairs (ragged lengths
# 64-128, segment ids that vary) at seq 128.  bf16 is held as the LM's is
# (BF16_NOISE_FACTOR times the bf16 einsum route's own error to f32).
# f32: GRAD_PARITY_RTOL on every tensor, against an f64 run of the einsum
# rather than the f32 one.  BERT's upper layers have query and key
# gradients ~1e-3 of the value gradients at init (dp - delta is small
# against dp), and f32 rounding in the einsum's own softmax backward moves
# them by up to 6.8e-5 (measured on the H100): too close to 1e-4 for the
# f32 einsum to serve as the reference.
BERT_PARITY_BATCH = 8
# Served probabilities, kernels against the einsum path with the same
# bf16 weights: the two round P to bf16 at different places (the kernel
# against each tile's running max, the einsum after normalising), a 2^-9
# relative step of each attention output, carried through 12 layers to
# logits of magnitude ~1 and probabilities in (0, 1): within 1e-2.
BERT_SERVE_ATOL = 1e-2
BERT_SERVE_REQUESTS = 16
BERT_BUCKETS = (64, 128)

# Checkpointing and the preemption contract (phase 19, ``ckpt``).  lm_long
# with the train phase's cuts (TRAIN_OVERRIDES: batch 8, S=4096, mesh
# 1x1, bf16 compute, f32 state: 134.1 M params, ~1.6 GB a checkpoint with
# the two Adam moments), 6 steps and its eval batch at the end; periodic
# async saves every 2 steps, 2 kept.  The resumed run must equal a
# straight run bit for bit: the flash and conv+BN kernels use no atomics
# (flash_bwd.cu, fused_conv_bn.cu), and a restore puts back every bit of
# the state (parameters, both moments, the update count, step and seed).
CKPT_STEPS = 6
CKPT_PREEMPT_STEP = 3
CKPT_LM_CUTS = {**TRAIN_OVERRIDES, "total_steps": CKPT_STEPS,
                "eval_every": 1000, "log_every": 1, "ckpt_every": 2,
                "ckpt_keep": 2, "ckpt_async": True}
# imagenet_resnet50 (bn fused) with RESNET_CUTS: 4 steps straight, twice,
# then 2 steps, a save, a resume and steps 3-4.  BN running statistics and
# SGD traces must be bit-equal after the restore; the losses of steps 3-4
# must agree within the difference between the two straight runs (cuDNN's
# convolutions may choose algorithms that sum in no fixed order).
CKPT_RESNET_CUTS = {**RESNET_CUTS, "eval_every": 1000, "ckpt_every": 2,
                    "ckpt_keep": 2}
# The CRC-32C rate is read over this many bytes.
CRC_BYTES = 256 << 20

# The Horovod slice (phase 20, ``hvd``): worlds of ranks started by
# LocalCluster with the launcher's environment, each rank a process that
# runs this script with ``--hvd-worker``; this process holds no group.
# A world's ranks must end within this (a hung probe is killed and
# reported).
HVD_TIMEOUT_S = 300
HVD_PROBE_TIMEOUT_S = 90
# (b) the reference's workload 2, cifar10_resnet18 at its own widths,
# batch (256 global, 128 a rank) and recipe, as two processes on the one
# card over gloo (NCCL refuses two ranks on one card).  Cut: steps, 2000
# -> 20, and one eval batch, as phase 17.
HVD_CIFAR_CUTS = {"mesh": {"data": 2}, "total_steps": 20, "eval_every": 20,
                  "eval_batches": 1, "log_every": 5}
HVD_CIFAR_ARGS = ["--config", "cifar10_resnet18"] + [
    a for k, v in HVD_CIFAR_CUTS.items() for a in ("--set", f"{k}={v!r}")]
# Step 1 of the two-rank run against the plain data-parallel step in one
# process (each rank's half-batch through forward and backward in turn,
# gradients and BN statistics averaged), every parameter, buffer and SGD
# trace: max |diff| over max |plain| per tensor.  f32 with TF32 off; the
# two differ only in the order of cuDNN's sums in two processes (~1e-6
# in one step), held to GRAD_PARITY_RTOL's 1e-4.
HVD_DP_RTOL = 1e-4
# (c) adasum_combine on the card against float64, max |diff| over max
# |f64| per leaf: in f32 its dots are f32 tree sums over up to 2.4 M
# entries (~1e-7 relative) and the combine rounds a few times: 1e-5; a
# bf16 leaf is rounded to bf16 once at the end: one bf16 step, 2^-8 of
# the entry (so at most 2^-8 of the largest), on top of f32's 1e-5.
HVD_COMBINE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -8 + 1e-5}

# The serving fleet (phase ``fleet``): phase serve's engine in each of
# FLEET_REPLICAS replica processes behind the port's router.  Seeded
# Poisson arrivals at FLEET_RATE a second, fast enough to keep both
# replicas' slots busy; NEW_TOKENS each.  Run (b) arms
# replica_crash:step=FLEET_CRASH_STEP:rank=1.  Workers exit after
# FLEET_MAX_IDLE_S without work, so no orphan holds the card.
FLEET_REPLICAS = 2
FLEET_REQUESTS = 24
FLEET_RATE = 16.0
FLEET_CRASH_STEP = 3
FLEET_READY_TIMEOUT_S = 240
FLEET_RUN_TIMEOUT_S = 120
FLEET_MAX_IDLE_S = 120
FLEET_ROUTER_PROC = FLEET_REPLICAS + 90   # the router's event-file id

# The live rollout (phase ``rollout``): phase fleet's replicas, run (a)
# clean and run (b) with ROLLOUT_SLOW_CANARY armed on every replica (the
# seam slows only a replica serving weights it was not launched with:
# 0.25 s a loop iteration, ~8x a decode step of 31.6 ms).  ROLLOUT_REQUESTS
# seeded Poisson requests at FLEET_RATE; once a quarter have retired, step
# 1 commits into a watched directory and the controller rolls the fleet to
# v1, the port's init for ROLLOUT_SEED (v0 is seed 0).  With two replicas
# the canary takes half of the placements, what either replica gets
# without one; the gate compares once each side has ROLLOUT_BAKE_MIN
# answers, past the canary's first wave (the slow canary answers 4 at a
# time, one wave of 16 tokens at ~0.28 s each, so three waves;
# ROLLOUT_REQUESTS keeps a backlog queued that long, and the router's
# queue holds them all: nothing is shed).  The A/A gate compares each v0
# replica's last ROLLOUT_BAKE_MIN answers before the roll: the gate's
# noise at the bake's sample size.  Hedging is off in these runs: a hedge races a slow
# canary's request against the old side, which wins, and the gate then
# never sees the canary's answers.  The drain may wait for a slow
# canary's wave.
ROLLOUT_REQUESTS = 128
ROLLOUT_SEED = 1
ROLLOUT_CANARY_FRAC = 0.5
ROLLOUT_BAKE_MIN = 8
ROLLOUT_BAKE_TIMEOUT_S = 20.0
ROLLOUT_DRAIN_TIMEOUT_S = 30.0
ROLLOUT_SLOW_CANARY = "slow_canary:times=1000:delay_s=0.25"
# The promotion gate's threshold, in % on the p90 of router TTFT, replica
# TTFT and TPOT (the library default is the JAX package's 25%), set from
# runs of this phase on one H100 (700 W) at ROLLOUT_BAKE_MIN answers a
# side.  The A/A gap between the two v0 replicas: 3.3-48.6% in every run
# (replica TTFT; at 4-6 answers it reached 452.6%, hence the bake of 8).
# A clean canary, its first wave not counted: +75.8% at most over ten
# runs (replica TTFT; when the gate still counted the burst the canary
# prefills out of the router's backlog at readmission, +192.2%).  The
# slow canary regressed TPOT by +513.9% to +900%.  200% is 4.1x the
# largest A/A gap, 2.6x the largest clean-canary gap, and 2.6x under the
# smallest slow-canary TPOT regression.
ROLLOUT_GATE_PCT = 200.0
ROLLOUT_BUDGET_S = 90.0


# device_time's record check: the sentinel kernel (torch.cuda._sleep's)
# and its spin, and the device symbols of the hand-written kernels, one
# event for each counted launch (the conv+BN wrapper launches one da
# kernel, and dW kernels beside it; the CUDA-core delta pass is the dq
# kernel).  A window of kernel launches alone is taken up to PROFILE_TRIES
# times for a whole record.  PROFILE_WINDOWS counts the records taken, the
# incomplete ones, and the windows left not measured.
PROFILE_TRIES = 3
SENTINEL_KERNEL = "spin_kernel"
SENTINEL_CYCLES = 1000
HAND_WRITTEN_EVENT = re.compile(
    r"flash_fwd(_tc)?_kernel|flash_bwd_(dq|dkv|delta)(_tc)?_kernel"
    r"|(?<![A-Za-z_])da(_tc)?_kernel|probe_kernel")
PROFILE_WINDOWS = {"records": 0, "incomplete": 0, "not_measured": 0}


def log(msg: str) -> None:
    print(msg, flush=True)


def reset_launches() -> None:
    for counts in (fa.LAUNCHES, fcb.LAUNCHES, pp.LAUNCHES, fa.FWD_ROUTES,
                   fa.BWD_ROUTES, fcb.ROUTES, attn.IMPLS):
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    """Every kernel's launches since the last :func:`reset_launches` (the
    routes are read from ``fa.FWD_ROUTES``, ``fa.BWD_ROUTES`` and
    ``fcb.ROUTES``)."""
    return {**fa.LAUNCHES, **fcb.LAUNCHES, **pp.LAUNCHES}


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events,
    after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def phase_card() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    log(_card_line())


def phase_build() -> None:
    secs = _build.build_all()
    log(f"[build] {len(_build.sources())} kernel source(s) in {secs:.1f} s")
    for src in _build.sources():
        text = _build.build_log(src.stem)
        regs = re.findall(r"Used (\d+) registers", text)
        spills = sum(map(int, re.findall(r"(\d+) bytes spill stores", text)))
        log(f"[build] {src.stem}: registers per instantiation {regs}, "
            f"spill stores {spills} B")
        # ptxas's lines for each entry function: registers, spills
        for name, body in re.findall(
                r"Compiling entry function '(\w+)'(.*?)(?=Compiling entry|"
                r"\Z)", text, re.S):
            used = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            log(f"[build]   {_kernel_label(name)}: "
                f"{used.group(1) if used else '?'} registers, "
                f"{spill.group(1) if spill else '?'} B spill stores")


def _kernel_label(mangled: str) -> str:
    """``flash_bwd_dq_tc_kernel<64>`` from a mangled kernel name: the
    first all-letter identifier ending in ``_kernel``, with its dtype,
    integer and bool template arguments."""
    m = re.search(r"[a-z][a-z_]*_kernel", mangled)
    if m is None:
        return mangled[:60]
    args = mangled[m.end():].split("EEv")[0]
    dtype = (["bf16"] if "__nv_bfloat16" in args
             else ["f32"] if args.startswith("If") else [])
    consts = [f"{int(v)}" if t == "i" else ("true" if v == "1" else "false")
              for t, v in re.findall(r"L([ib])(\d+)E", args)]
    return f"{m.group(0)}<{','.join(dtype + consts)}>"


def _flash_inputs(b, s, n, d, dtype, masked, gen, strided=False):
    """q, k, v ``[b, s, n, d]`` and, if ``masked``, a key mask whose row
    0 keeps a ragged prefix and whose other rows are fully masked.
    ``strided`` hands the kernel head-major storage seen through a
    transposed view, as a fused projection could."""
    dev = torch.device("cuda")
    shape = (b, n, s, d) if strided else (b, s, n, d)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    if strided:
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if masked:
        mask = torch.zeros((b, s), dtype=torch.int32, device=dev)
        mask[0, : (3 * s) // 5] = 1
    return q, k, v, mask


def _flash_check(name, q, k, v, mask, causal):
    """Kernel against plain version; raises past the tolerance, or if the
    kernel ran on another route than ``fa.fwd_route`` names, or if a fully
    masked batch row's output is not exactly zero."""
    route = fa.fwd_route(q.dtype, q.shape[-1])
    before = dict(fa.FWD_ROUTES)
    out, lse = fa.flash_mha_lse(q, k, v, mask=mask, causal=causal)
    torch.cuda.synchronize()
    ran = {r: fa.FWD_ROUTES[r] - before[r] for r in before}
    ref_out, ref_lse = _by_row(fa.flash_mha_reference, (q, k, v), mask,
                               causal)
    err = float((out.float() - ref_out.float()).abs().max())
    err_lse = float((lse - ref_lse).abs().max())
    tol = TOL[q.dtype]
    bad = []
    if ran != {r: int(r == route) for r in ran}:
        bad.append(f"launches by route {ran}, want one on {route}")
    if not (err <= tol["out"] and err_lse <= tol["lse"]):
        bad.append(f"max|out diff| {err:.3e} (tol {tol['out']}), max|lse "
                   f"diff| {err_lse:.3e} (tol {tol['lse']})")
    if mask is not None and not mask[1:].any():
        # rows 1.. of the batch are fully masked: zero output, lse -1e30
        if out[1:].any() or not (lse[1:] == fa.NEG_INF).all():
            bad.append("a fully masked batch row has a nonzero output")
    if bad:
        raise RuntimeError(f"flash_fwd {name}: " + "; ".join(bad))
    return out, lse, err, err_lse


def _flash_case(s, dtype, causal, masked, gen):
    b, n, d = (2, 12, 64) if masked else (1, 12, 64)
    q, k, v, mask = _flash_inputs(b, s, n, d, dtype, masked, gen)
    name = (f"S={s} {str(dtype)[6:]} {'causal' if causal else 'full'}"
            f"{' masked' if masked else ''}")
    out, lse, err, err_lse = _flash_check(name, q, k, v, mask, causal)
    tol = TOL[dtype]

    ms = cuda_ms(lambda: fa.flash_mha_lse(q, k, v, mask=mask,
                                          causal=causal), 100)
    plain_ms = cuda_ms(lambda: fa.flash_mha_reference(
        q, k, v, mask=mask, causal=causal), 10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn_mask = None if mask is None else mask.bool()[:, None, None, :]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=attn_mask, is_causal=causal), 100)
    # Device time alone (the times above include the host's launch cost
    # wherever that is the larger).
    dev_ms = device_ms(
        lambda: fa.flash_mha_lse(q, k, v, mask=mask, causal=causal), 10)
    lib_dev_ms = device_ms(
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask, is_causal=causal), 10)

    ops = 4 * d * _pairs(s, s, b, n, mask, causal)  # QK^T and PV
    nbytes = (3 * q.numel() * q.element_size() + out.numel()
              * out.element_size() + lse.numel() * 4
              + (0 if mask is None else mask.numel() * 4))
    t_ops, t_bytes = ops / PEAK_OPS_S[dtype], nbytes / PEAK_BYTES_S
    case = {"case": name, "max_abs_err": err, "max_abs_err_lse": err_lse,
            "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}
    log(f"[flash] {name}: err {err:.2e} (tol {tol['out']}), lse err "
        f"{err_lse:.2e}; kernel {ms:.4f} ms (device {_dev(dev_ms, '.4f')}), plain "
        f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms (device "
        f"{_dev(lib_dev_ms, '.4f')}), bound {case['bound_ms']:.5f} ms "
        f"({case['bound_by']})")
    return case


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s in (128, 256, 512, 200):
            cases[(s, dtype, True, False)] = _flash_case(s, dtype, True,
                                                         False, gen)
    cases[(512, torch.bfloat16, False, True)] = _flash_case(
        512, torch.bfloat16, False, True, gen)
    log(json.dumps({"flash_fwd_cases": list(cases.values())}))
    # Correctness only, each case asserting its route: every head_dim the
    # kernels take at a ragged length, with a key mask (fully masked batch
    # rows) and strided inputs; then the tensor-core route's head dims at
    # a longer ragged length (not a multiple of any tile), masked and not.
    worst, count = {}, {}
    sweep = [(d, dtype, causal, 77, True) for d in fa.HEAD_DIMS
             for dtype in fa.DTYPES for causal in (False, True)]
    sweep += [(d, torch.bfloat16, causal, 1037, masked)
              for d in fa.TC_HEAD_DIMS for causal in (False, True)
              for masked in (True, False)]
    for d, dtype, causal, s, masked in sweep:
        name = (f"D={d} {str(dtype)[6:]} causal={causal} S={s} "
                f"{'masked ' if masked else ''}strided")
        args = _flash_inputs(3 if s < 1000 else 2, s, 5 if s < 1000 else 3,
                             d, dtype, masked, gen, strided=True)
        err = _flash_check(name, *args, causal)[2]
        key = f"{str(dtype)[6:]} {fa.fwd_route(dtype, d)}"
        worst[key] = max(worst.get(key, 0.0), err)
        count[key] = count.get(key, 0) + 1
    log(f"[flash] sweep of {len(sweep)} cases (every head_dim x dtype x "
        f"causal at S=77, masked, strided; D in {fa.TC_HEAD_DIMS} bf16 x "
        f"causal x masked at S=1037, strided), cases by dtype and route "
        f"{count}: worst max abs err {worst}")
    cases["train"] = _flash_train_case(gen)
    return cases


def _flash_train_case(gen) -> dict:
    """The forward kernel at the training slice's shapes on both routes
    (bf16: the tensor cores, as the path runs it, and the CUDA-core kernel
    on the same inputs), each against its plain version one batch row at a
    time and timed beside its bound, the plain version and SDPA."""
    b, s, n, d = TRAIN_ATTN_SHAPE
    dtype = torch.bfloat16
    q, k, v, _ = _flash_inputs(b, s, n, d, dtype, False, gen)
    ref_out, ref_lse = _by_row(fa.flash_mha_reference, (q, k, v), None, True)
    plain_ms = cuda_ms(lambda: _by_row(fa.flash_mha_reference, (q, k, v),
                                       None, True), 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True)
    lib_ms = cuda_ms(sdpa, 10)
    lib_dev = device_ms(sdpa, 3)
    ops = 4 * d * _pairs(s, s, b, n, None, True)
    nbytes = 4 * q.numel() * 2 + b * n * s * 4
    t_ops, t_bytes = ops / PEAK_OPS_S[dtype], nbytes / PEAK_BYTES_S
    tol = TOL[dtype]
    res = {}
    for route in ("tensor_core", "cuda_core"):
        launch = lambda r=route: fa._launch(q, k, v, None, True,  # noqa: E731
                                            route=r)
        before = dict(fa.FWD_ROUTES)
        out, lse = launch()
        torch.cuda.synchronize()
        if fa.FWD_ROUTES[route] != before[route] + 1:
            raise RuntimeError(f"flash_fwd training shape: {route} did not "
                               f"run")
        err = float((out.float() - ref_out.float()).abs().max())
        err_lse = float((lse - ref_lse).abs().max())
        if not (err <= tol["out"] and err_lse <= tol["lse"]):
            raise RuntimeError(f"flash_fwd training shape, {route}: "
                               f"max|out diff| {err:.3e}, max|lse diff| "
                               f"{err_lse:.3e}")
        ms = cuda_ms(launch, 20 if route == "tensor_core" else 3)
        dev_ms = device_ms(launch, 3)
        smem, blocks = fa.fwd_kernel_info(dtype, d, route)
        res[route] = {"route": route, "max_abs_err": err,
                      "max_abs_err_lse": err_lse, "ms": ms,
                      "device_ms": dev_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "library_device_ms": lib_dev,
                      "bound_ms": 1e3 * max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "tflops": ops / ms / 1e9,
                      "smem_bytes": smem, "blocks_per_sm": blocks}
        log(f"[flash] B={b} S={s} N={n} D={d} bf16 causal (training shape),"
            f" route {route}: err {err:.2e}, lse err {err_lse:.2e}; kernel "
            f"{ms:.4f} ms (device {_dev(dev_ms, '.4f')}, {ops / ms / 1e9:.2f} "
            f"TFLOP/s, {smem} B smem, {blocks} blocks/SM), plain "
            f"{plain_ms:.1f} ms, sdpa {lib_ms:.4f} ms (device "
            f"{_dev(lib_dev, '.4f')})"
            f", bound {1e3 * max(t_ops, t_bytes):.4f} ms "
            f"({res[route]['bound_by']})")
    case = dict(res["tensor_core"])
    case["cuda_core"] = res["cuda_core"]
    return case


def _pairs(s_q, s_kv, b, n, mask, causal) -> int:
    """Query-key pairs the kernels keep, summed over batch and heads."""
    keep = torch.ones((s_q, s_kv), dtype=torch.bool, device="cuda")
    if causal:
        keep = keep.tril()
    if mask is None:
        return n * b * int(keep.sum())
    return n * int((keep[None] & (mask[:, None, :] != 0)).sum())


def _bwd_inputs(b, s, n, d, dtype, masked, causal, gen, *, strided=False,
                dlse=False):
    """Backward inputs as training hands them to the kernels: q, k, v,
    dO, the forward kernel's lse, delta = rowsum(dO * O) (less a random
    lse cotangent when ``dlse``) and the key mask."""
    q, k, v, mask = _flash_inputs(b, s, n, d, dtype, masked, gen,
                                  strided=strided)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    out, lse = fa.flash_fwd(q, k, v, mask=mask, causal=causal)
    delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
    if dlse:
        delta = delta - torch.randn(lse.shape, generator=gen, device="cuda")
    return q, k, v, do, lse, delta.contiguous(), mask


def _by_row(fn, args, mask, causal):
    """A plain version over one batch row at a time: its [B, N, S, S]
    f32 score tensors for the whole batch would not fit the card at the
    training slice's shapes.  Same inputs, same arithmetic per row."""
    parts = []
    for i in range(args[0].shape[0]):
        row = [a[i:i + 1] for a in args]
        got = fn(*row, mask=None if mask is None else mask[i:i + 1],
                 causal=causal)
        parts.append(got if isinstance(got, tuple) else (got,))
    return tuple(torch.cat(p) for p in zip(*parts))


def _bwd_check(name, args, causal):
    """The delta pass and both backward kernels against their plain
    versions; raises past the tolerance, or if the kernels ran on another
    route than ``fa.bwd_route`` names.  Returns ``({grad: max abs
    error}, route)``."""
    *tensors, mask = args
    route = fa.bwd_route(tensors[0].dtype, tensors[0].shape[-1])
    before = dict(fa.BWD_ROUTES)
    delta = fa._launch_bwd("delta", *tensors, mask, causal)
    dq = fa._launch_bwd("dq", *tensors, mask, causal)
    dk, dv = fa._launch_bwd("dkv", *tensors, mask, causal)
    torch.cuda.synchronize()
    ran = {r: fa.BWD_ROUTES[r] - before[r] for r in before}
    (ref_delta,) = _by_row(fa.flash_bwd_delta_reference, tensors[:5], mask,
                           causal)
    (ref_dq,) = _by_row(fa.flash_bwd_dq_reference, tensors, mask, causal)
    ref_dk, ref_dv = _by_row(fa.flash_bwd_dkv_reference, tensors, mask,
                             causal)
    tol = BWD_TOL[tensors[0].dtype]
    errs, bad = {}, []
    if ran != {r: 3 * (r == route) for r in ran}:
        bad.append(f"launches by route {ran}, want all three on {route}")
    errs["delta"] = float((delta - ref_delta).abs().max())
    scale = float(ref_delta.abs().max())
    if not (torch.isfinite(delta).all()
            and errs["delta"] <= DELTA_TOL * max(scale, 1e-30)):
        bad.append(f"delta: max|diff| {errs['delta']:.3e} vs tol "
                   f"{DELTA_TOL} x max|plain| {scale:.3e}")
    for g, got, ref in (("dq", dq, ref_dq), ("dk", dk, ref_dk),
                        ("dv", dv, ref_dv)):
        errs[g] = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if not (torch.isfinite(got.float()).all()
                and errs[g] <= tol * max(scale, 1e-30)):
            bad.append(f"{g}: max|diff| {errs[g]:.3e} vs tol {tol} x "
                       f"max|plain| {scale:.3e}")
    if mask is not None and not mask[1:].any():
        # rows 1.. of the batch are fully masked: exactly zero gradients
        if dq[1:].any() or dk[1:].any() or dv[1:].any() or delta[1:].any():
            bad.append("a fully masked batch row has nonzero gradients")
    if bad:
        raise RuntimeError(f"flash backward {name}: " + "; ".join(bad))
    return errs, route


def _sdpa_backward_ms(tensors, causal):
    """The yardstick: the backward of PyTorch's fused attention on the same
    tensors, timed alone (the graph is kept, so each call is only the
    backward), by CUDA events and by profiler device time.  The port never
    calls it."""
    q, k, v, do, _, _ = tensors
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    call = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,  # noqa: E731
                                       retain_graph=True)
    ms = cuda_ms(call, 10)
    return ms, device_ms(call, 3)


def _bwd_train_shape(dtype, gen) -> dict:
    """Both backward kernels at the training slice's shapes in ``dtype``:
    checked against the plain versions and timed beside their bound, the
    plain versions and SDPA's backward."""
    b, s, n, d = TRAIN_ATTN_SHAPE
    args = _bwd_inputs(b, s, n, d, dtype, False, True, gen)
    *tensors, mask = args
    errs, route = _bwd_check(f"training shape {str(dtype)[6:]}", args, True)
    pairs = _pairs(s, s, b, n, None, True)
    elt = tensors[0].element_size()
    qkvo = 4 * b * s * n * d * elt
    rows = 2 * b * n * s * 4            # lse, delta
    lib, lib_dev = _sdpa_backward_ms(tensors, True)
    res = {}
    # (which, FLOPs a kept pair, output bytes, plain version, its inputs);
    # the delta pass reads lse and writes delta, the rows term below.
    for which, flops_per_pair, out_bytes, fn, ins in (
            ("delta", 4 * d, 0, fa.flash_bwd_delta_reference, tensors[:5]),
            ("dq", 6 * d, b * s * n * d * elt, fa.flash_bwd_dq_reference,
             tensors),
            ("dkv", 8 * d, 2 * b * s * n * d * elt,
             fa.flash_bwd_dkv_reference, tensors)):
        launch = (lambda w=which: fa._launch_bwd(w, *tensors, mask, True))
        ms = cuda_ms(launch, 10)
        dev = device_ms(launch, 3)
        plain = cuda_ms(lambda f=fn, a=ins: _by_row(f, a, mask, True), 1)
        ops = flops_per_pair * pairs
        nbytes = qkvo + rows + out_bytes
        t_ops, t_bytes = ops / PEAK_OPS_S[dtype], nbytes / PEAK_BYTES_S
        smem, blocks = fa.bwd_kernel_info(which, dtype, d, route)
        res[which] = {"route": route, "ms": ms, "device_ms": dev,
                      "plain_ms": plain, "library_ms": lib,
                      "library_device_ms": lib_dev,
                      "bound_ms": 1e3 * max(t_ops, t_bytes),
                      "bound_by": "operations" if t_ops >= t_bytes
                      else "bytes", "ops": ops, "bytes": nbytes,
                      "tflops": ops / ms / 1e9, "smem_bytes": smem,
                      "blocks_per_sm": blocks}
    res["delta"]["max_abs_err"] = errs["delta"]
    res["delta"]["library_ms"] = res["delta"]["library_device_ms"] = None
    res["dq"]["max_abs_err"] = errs["dq"]
    res["dkv"]["max_abs_err"] = max(errs["dk"], errs["dv"])
    pair = res["dq"]["ms"] + res["dkv"]["ms"]
    whole = pair + res["delta"]["ms"]
    log(f"[flash-bwd] B={b} S={s} N={n} D={d} {str(dtype)[6:]} causal, "
        f"route {route}: err delta {errs['delta']:.2e} (tol {DELTA_TOL} x "
        f"max|plain|) dq {errs['dq']:.2e} dk {errs['dk']:.2e} dv "
        f"{errs['dv']:.2e} (tol {BWD_TOL[dtype]} x max|plain|); "
        + "; ".join(f"{w} {r['ms']:.3f} ms (device {_dev(r['device_ms'])}, "
                    f"{r['tflops']:.2f} TFLOP/s, {r['smem_bytes']} B smem, "
                    f"{r['blocks_per_sm']} blocks/SM), plain "
                    f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
                    f"({r['bound_by']}; {r['bound_ms'] / r['ms']:.3f} of it)"
                    for w, r in res.items())
        + f"; pair {pair:.3f} ms, with the delta pass {whole:.3f} ms; sdpa "
          f"backward {lib:.3f} ms (device {_dev(lib_dev)}), pair / sdpa "
          f"{pair / lib:.2f}, with the delta pass {whole / lib:.2f}")
    return res


def phase_backward() -> dict:
    """Both backward kernels against their plain versions at the training
    slice's shapes on both routes (timed) and over the correctness
    sweep."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    res = _bwd_train_shape(torch.bfloat16, gen)
    if res["dq"]["route"] != "tensor_core":
        raise RuntimeError("the training shape did not take the tensor-core "
                           "route")
    res["cuda_core_f32"] = _bwd_train_shape(torch.float32, gen)

    # Correctness sweep: f32; a masked, not causal case with fully masked
    # batch rows; every head_dim at a ragged length, masked, strided, with
    # an lse cotangent folded into delta; and the tensor-core route's head
    # dims at a longer ragged length (not a multiple of any tile).
    dtype = torch.bfloat16
    sweep = [("S=1024 f32 causal dlse",
              _bwd_inputs(2, 1024, 12, 64, torch.float32, False, True, gen,
                          dlse=True), True),
             ("S=512 bf16 masked full",
              _bwd_inputs(2, 512, 12, 64, dtype, True, False, gen), False)]
    for d_ in fa.HEAD_DIMS:
        for dt in fa.DTYPES:
            for causal in (False, True):
                sweep.append((f"D={d_} {str(dt)[6:]} causal={causal} S=77 "
                              f"masked strided dlse",
                              _bwd_inputs(3, 77, 5, d_, dt, True, causal,
                                          gen, strided=True, dlse=True),
                              causal))
    for d_ in fa.TC_HEAD_DIMS:
        for causal in (False, True):
            sweep.append((f"D={d_} bf16 causal={causal} S=1037 masked "
                          f"strided dlse",
                          _bwd_inputs(2, 1037, 3, d_, dtype, True, causal,
                                      gen, strided=True, dlse=True),
                          causal))
    worst, cases = {}, {}
    for name, args, causal in sweep:
        errs, route = _bwd_check(name, args, causal)
        key = f"{'f32' if args[0].dtype == torch.float32 else 'bf16'} {route}"
        worst[key] = max(worst.get(key, 0.0), *errs.values())
        cases[key] = cases.get(key, 0) + 1
    log(f"[flash-bwd] sweep of {len(sweep)} cases (f32 S=1024 with dlse; "
        f"bf16 masked full S=512 with fully masked rows; every head_dim x "
        f"dtype x causal at S=77, masked, strided, dlse; D in "
        f"{fa.TC_HEAD_DIMS} bf16 x causal at S=1037, masked, strided, "
        f"dlse), cases by dtype and route {cases}: worst max abs err "
        f"{worst}")
    return res


def phase_probe() -> dict:
    """The precision probe: its three modes through ``pp.probe`` (the
    probe's path: launches read around it), each mode's error against
    float64 held to its band; then each kernel mode against its plain
    version, timed beside its bound and, where one exists, the PyTorch
    call that computes the same product."""
    reset_launches()
    errs = {mode: pp.probe(mode, device="cuda") for mode in pp.MODES}
    torch.cuda.synchronize()
    launches = launch_counts()
    problems = []
    if launches["precision_probe"] != len(pp.MODES):
        problems.append(f"launches {launches}")
    for mode, err in errs.items():
        lo, hi = PROBE_F64_BAND[mode]
        if not lo <= err <= hi:
            problems.append(f"{mode}: max|err| vs f64 {err:.3e} outside "
                            f"[{lo}, {hi}]")
    x, y = pp.inputs(device="cuda")
    m, k = x.shape
    flops = 2 * m * k * y.shape[1]
    nbytes = 4 * (x.numel() + y.numel() + m * y.shape[1])
    modes = {}
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    for mode in pp.MODES:
        got = pp.matmul(x, y, mode)
        plain = pp.matmul_reference(x, y, mode)
        err = float((got - plain).abs().max())
        if not err <= PROBE_TOL:
            problems.append(f"{mode}: kernel vs plain {err:.3e} > "
                            f"{PROBE_TOL}")
        ms = cuda_ms(lambda md=mode: pp.matmul(x, y, md), 50)
        plain_ms = cuda_ms(lambda md=mode: pp.matmul_reference(x, y, md), 5)
        lib_ms = None   # no PyTorch call computes 3xTF32
        if mode != "high":
            torch.backends.cuda.matmul.allow_tf32 = mode == "medium"
            lib_ms = cuda_ms(lambda: torch.matmul(x, y), 50)
            torch.backends.cuda.matmul.allow_tf32 = prev_tf32
        ops = flops * (3 if mode == "high" else 1)
        t_ops = 1e3 * ops / (PEAK_OPS_S[torch.float32] if mode == "highest"
                             else PEAK_TF32_S)
        t_bytes = 1e3 * nbytes / PEAK_BYTES_S
        modes[mode] = {"err_vs_f64": errs[mode], "max_abs_err": err,
                       "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                       "bound_ms": max(t_ops, t_bytes), "ops_ms": t_ops,
                       "bytes_ms": t_bytes,
                       "bound_by": "operations" if t_ops >= t_bytes
                       else "bytes"}
        log(f"[probe] {mode}: max|err| vs float64 {errs[mode]:.3e}; kernel "
            f"vs plain {err:.2e} (tol {PROBE_TOL}); kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, torch.matmul "
            f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
            f"{modes[mode]['bound_ms']:.5f} ms ({modes[mode]['bound_by']})")
    if problems:
        raise RuntimeError("precision probe: " + "; ".join(problems))
    tot = {key: sum(r[key] for r in modes.values())
           for key in ("ms", "plain_ms", "bound_ms", "ops_ms", "bytes_ms")}
    tot.update(max_abs_err=max(r["max_abs_err"] for r in modes.values()),
               bound_by="operations" if tot["ops_ms"] >= tot["bytes_ms"]
               else "bytes", library_ms=None, modes=modes,
               launches=launches)
    log(f"[probe] {len(pp.MODES)} launches on the probe's run; errors vs "
        f"float64 {errs}")
    return tot


def phase_parity() -> None:
    cfg = LMConfig(dtype="bfloat16", attn_impl="pallas")
    buckets = kv.DEFAULT_PROMPT_BUCKETS
    cap = kv.capacity_for(max(buckets) + 4, kv.DEFAULT_DECODE_BLOCK)
    diffs = parity_diffs(cfg, buckets=buckets, capacity=cap,
                         decode_tokens=4, seed=0)
    worst = max(diffs.values())
    log(f"[parity] prefill+decode vs full forward, bf16 full width: "
        + ", ".join(f"{b}/{n}: {d:.3e}" for (b, n), d in diffs.items())
        + f"; worst {worst:.3e} (atol {PARITY_ATOL_BF16})")
    if not worst <= PARITY_ATOL_BF16:
        raise RuntimeError(f"prefill+decode parity {worst:.3e} > "
                           f"{PARITY_ATOL_BF16}")


def _pct(vals, q):
    vals = sorted(vals)
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


def _serve_engine(seed: int = 0) -> LMEngine:
    """The serving slice's engine: TransformerLM at lm_long's widths in
    bf16 with the flash forward, 4 slots, buckets 128/256/512, its
    weights drawn from ``seed``."""
    cfg = LMConfig(dtype="bfloat16", attn_impl="pallas")
    return LMEngine(cfg, slots=4, prompt_buckets=kv.DEFAULT_PROMPT_BUCKETS,
                    decode_block=kv.DEFAULT_DECODE_BLOCK, seed=seed)


def _warm_up(engine: LMEngine) -> None:
    """Every bucket once (library handles, allocator), outside a counted
    run; then a fresh decode cache."""
    loadgen.run_loadgen(engine, loadgen.synthetic_requests(
        3, buckets=engine.prompt_buckets, vocab_size=engine.cfg.vocab_size,
        max_new_tokens=2, seed=1))
    engine.reset()


def phase_serve() -> tuple:
    t0 = time.monotonic()
    engine = _serve_engine()
    cfg, buckets = engine.cfg, engine.prompt_buckets
    n_params = sum(p.numel() for p in engine.model.parameters())
    log(f"[serve] engine: {n_params / 1e6:.1f} M params, capacity "
        f"{engine.spec.capacity}, KV cache "
        f"{engine.spec.total_bytes() / 1e6:.1f} MB, built in "
        f"{time.monotonic() - t0:.1f} s")
    _warm_up(engine)

    reqs = loadgen.synthetic_requests(
        SERVE_REQUESTS, buckets=buckets, vocab_size=cfg.vocab_size,
        max_new_tokens=NEW_TOKENS, seed=0)
    reset_launches()
    stats = loadgen.run_loadgen(engine, reqs)
    torch.cuda.synchronize()
    launches = launch_counts()
    routes = dict(fa.FWD_ROUTES)

    prefills = len(reqs)   # each request is prefilled exactly once
    hit = sorted({kv.bucket_for(len(r.prompt), buckets) for r in reqs})
    ragged = sum(len(r.prompt) not in buckets for r in reqs)
    problems = []
    if stats["requests"] != len(reqs) or stats["unfinished"]:
        problems.append(f"{stats['requests']}/{len(reqs)} completed")
    if any(len(r.tokens) != NEW_TOKENS for r in reqs):
        problems.append("a request did not get all its tokens")
    if any(not 0 <= t < cfg.vocab_size for r in reqs for t in r.tokens):
        problems.append("a token lies outside the vocabulary")
    if hit != list(buckets) or not ragged:
        problems.append(f"buckets hit {hit}, {ragged} ragged prompts")
    if launches["flash_fwd"] != cfg.num_layers * prefills:
        problems.append(f"flash_fwd launched {launches['flash_fwd']} times"
                        f", want {cfg.num_layers} x {prefills} prefills")
    if routes != {"tensor_core": launches["flash_fwd"], "cuda_core": 0}:
        problems.append(f"forward launches by route {routes}: every bf16 "
                        f"prefill's attention on the tensor cores")
    if problems:
        raise RuntimeError("serving: " + "; ".join(problems))

    ttft = [r.ttft_ms() for r in reqs]
    tpot = [r.tpot_ms() for r in reqs]
    summary = {"tokens_per_s": stats["tokens_per_s"],
               "ttft_p50": _pct(ttft, .5), "ttft_p90": _pct(ttft, .9),
               "tpot_p50": _pct(tpot, .5), "tpot_p90": _pct(tpot, .9)}
    log(f"[serve] {stats['requests']} requests over buckets {hit} "
        f"({ragged} ragged), {stats['total_tokens']} tokens in "
        f"{stats['wall_s']} s: {stats['tokens_per_s']} tokens/s; "
        f"TTFT p50 {_pct(ttft, .5):.2f} ms p90 {_pct(ttft, .9):.2f} ms; "
        f"TPOT p50 {_pct(tpot, .5):.2f} ms p90 {_pct(tpot, .9):.2f} ms; "
        f"flash_fwd launches {launches['flash_fwd']} = "
        f"{cfg.num_layers} x {prefills} prefills, by route {routes}")

    # Where a request's time goes: host wall per call (synchronised by
    # the tokens it returns) against the device time of one such call.
    for b in buckets:
        ids = [(7 * i + 1) % cfg.vocab_size for i in range(b)]
        profile_window(f"prefill bucket {b}", lambda: engine.prefill(ids),
                       wall_ms(lambda: engine.prefill(ids), 5))
    profile_window(f"decode step ({engine.slots} slots)", engine.decode_step,
                   wall_ms(engine.decode_step, 20))
    return launches, routes, summary


def replica_worker(rank: int, out: str, ready: str) -> int:
    """One fleet replica (phase ``fleet``): phase serve's engine, warmed
    up, its launch counts reset, then served behind ``Replica`` until a
    SIGTERM drain (or FLEET_MAX_IDLE_S without work).  The parent sets
    ``TPUFRAME_METRICS_PORT=0``, ``TPUFRAME_PROCESS_ID`` and
    ``TPUFRAME_EVENTS_DIR`` (and, in run (b), ``TPUFRAME_FAULTS``).  The
    kernels were built by the parent: the engine loads them.  After the
    drain the counts go to ``out``; a crashed replica writes nothing."""
    faults.reset_from_env()
    engine = _serve_engine()
    _warm_up(engine)             # before the log opens: no warm-up events
    events.init()
    torch.cuda.synchronize()
    reset_launches()
    rep = replica_lib.Replica(engine, stall_timeout_s=5.0)
    signal.signal(signal.SIGTERM, rep.drain)
    if rep.exporter is None or rep.exporter.port is None:
        raise SystemExit("replica worker: no scrape endpoint")
    tmp = f"{ready}.tmp"
    Path(tmp).write_text(f"{replica_lib.READY_PREFIX} "
                         f"port={rep.exporter.port} "
                         f"pid={os.getpid()}\n")
    os.replace(tmp, ready)
    rc = rep.run(max_idle_s=FLEET_MAX_IDLE_S)
    torch.cuda.synchronize()
    Path(out).write_text(json.dumps({
        "rank": rank, "prefills": len(rep.scheduler.completed),
        "launches": launch_counts(), "routes": dict(fa.FWD_ROUTES),
        "steps": rep.scheduler.step_count}))
    events.close()
    obs_exporter.stop()
    return rc


def _spawn_fleet(root: str, name: str, fault_rank: int | None, *,
                 faults_spec: str | None = None) -> list:
    """FLEET_REPLICAS ``chip_smoke.py --replica-worker`` processes with the
    fleet's environment; ``fault_rank`` gets replica_crash, and every
    replica ``faults_spec``."""
    procs = []
    for rank in range(FLEET_REPLICAS):
        env = dict(os.environ)
        env.pop("TPUFRAME_FAULTS", None)
        env.update({"TPUFRAME_METRICS_PORT": "0",
                    "TPUFRAME_PROCESS_ID": str(rank),
                    "TPUFRAME_EVENTS_DIR": os.path.join(root, name),
                    "TPUFRAME_TRACE_SAMPLE": "1"})
        if rank == fault_rank:
            env["TPUFRAME_FAULTS"] = (f"replica_crash:step={FLEET_CRASH_STEP}"
                                      f":rank={rank}")
        if faults_spec:
            env["TPUFRAME_FAULTS"] = faults_spec
        base = os.path.join(root, f"{name}.{rank}")
        logf = open(f"{base}.log", "wb")
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--replica-worker", str(rank), f"{base}.json", f"{base}.ready"],
            env=env, stdout=logf, stderr=subprocess.STDOUT)
        logf.close()
        procs.append((proc, f"{base}.ready", f"{base}.log", f"{base}.json"))
    return procs


def _fleet_run(root: str, name: str, reqs: list, procs: list, *,
               hedge_ms: float | None = None,
               queue_limit: int | None = None, on_router=None) -> dict:
    """Serve ``reqs`` through the port's Router over the fleet ``procs``
    (:func:`_spawn_fleet`); the router's events go to the same directory
    under process id FLEET_ROUTER_PROC, as ``fleet_smoke`` does.
    ``on_router(router)``, if given, returns the router loop's ``on_tick``
    (the rollout controller's seam).  Every worker is drained with
    SIGTERM (or killed) before this returns."""
    saved = {k: os.environ.get(k) for k in ("TPUFRAME_PROCESS_ID",
                                             "TPUFRAME_TRACE_SAMPLE")}
    try:
        t0 = time.monotonic()
        ports = [router_lib._wait_ready(p, ready,
                                        timeout_s=FLEET_READY_TIMEOUT_S)
                 for p, ready, _, _ in procs]
        ready_s = time.monotonic() - t0
        urls = [f"http://127.0.0.1:{port}" for port in ports]
        os.environ["TPUFRAME_PROCESS_ID"] = str(FLEET_ROUTER_PROC)
        os.environ["TPUFRAME_TRACE_SAMPLE"] = "1"
        events.init(os.path.join(root, name))
        router = router_lib.Router(
            urls, queue_limit=queue_limit, hedge_ms=hedge_ms,
            scrape_interval_s=0.05,
            scrape_timeout_s=1.0, dispatch_timeout_s=60.0,
            max_inflight_per_replica=4)
        on_tick = on_router(router) if on_router is not None else None
        t0 = time.monotonic()
        out = router.run(reqs, timeout_s=FLEET_RUN_TIMEOUT_S,
                         on_tick=on_tick, log=log)
        out["serve_s"] = time.monotonic() - t0
        out["ready_s"] = ready_s
        out["tokens"] = {q.rid: q.result["tokens"] for q in router.completed}
        out["completed"] = list(router.completed)
        out["scrapes"] = {}
        for rank, (p, *_rest) in enumerate(procs):
            if p.poll() is None:
                out["scrapes"][rank] = router_lib.http_transport(
                    f"{urls[rank]}/metrics", None, 5.0)[1]
        events.close()
        for p, *_rest in procs:
            if p.poll() is None:
                p.terminate()            # the graceful drain (SIGTERM)
        out["exit_codes"] = [p.wait(timeout=60) for p, *_rest in procs]
        out["workers"] = {}
        for rank, (_p, _r, _l, res) in enumerate(procs):
            if os.path.exists(res):
                out["workers"][rank] = json.loads(Path(res).read_text())
        out["events"] = events.merge(os.path.join(root, name))
        return out
    except BaseException:
        for rank, (_p, _r, logp, _res) in enumerate(procs):
            if os.path.exists(logp):
                log(f"[fleet] replica {rank} log tail:\n"
                    + Path(logp).read_text(errors="replace")[-3000:])
        raise
    finally:
        events.close()
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
        for p, *_rest in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _worker_launch_checks(tag: str, workers: dict, num_layers: int) -> list:
    """Each replica's flash_fwd launches are ``num_layers`` x its prefills,
    all on the tensor cores, and no other kernel launched."""
    problems = []
    for rank, w in workers.items():
        n = w["launches"]["flash_fwd"]
        others = {k: v for k, v in w["launches"].items()
                  if k != "flash_fwd" and v}
        if (n != num_layers * w["prefills"] or others or w["routes"]
                != {"tensor_core": n, "cuda_core": 0}):
            problems.append(f"{tag} replica {rank}: launches "
                            f"{w['launches']} by route {w['routes']}, want "
                            f"{num_layers} x {w['prefills']} prefills, all "
                            f"tensor-core")
    return problems


def _fleet_checks(run: dict, reqs: list, want: dict, *, crash: bool,
                  num_layers: int) -> list:
    problems = []
    tag = "(b)" if crash else "(a)"
    if run["lost"] or run["timed_out"] or run["shed"]:
        problems.append(f"{tag} lost {run['lost']}, shed {run['shed']}, "
                        f"timed out {run['timed_out']}")
    if run["requests"] != len(reqs):
        problems.append(f"{tag} {run['requests']}/{len(reqs)} answered")
    wrong = sorted(rid for rid, toks in run["tokens"].items()
                   if toks != want[rid])
    if wrong:
        problems.append(f"{tag} tokens of rids {wrong} differ from the "
                        f"in-process engine's")
    served = {r.get("replica") for r in run["events"]
              if r.get("type") == "router_request"}
    codes = [0] * FLEET_REPLICAS
    if crash:
        codes[1] = faults._CRASH_RC
        if run["drains"] < 1 or run["redispatched"] < 1:
            problems.append(f"{tag} {run['drains']} drains, "
                            f"{run['redispatched']} redispatches")
    elif served != {f"r{i}" for i in range(FLEET_REPLICAS)}:
        problems.append(f"{tag} replicas that answered: {sorted(served)}")
    if run["exit_codes"] != codes:
        problems.append(f"{tag} exit codes {run['exit_codes']}, want "
                        f"{codes}")
    problems += _worker_launch_checks(tag, run["workers"], num_layers)
    if not crash:
        for rank in range(FLEET_REPLICAS):
            text = run["scrapes"].get(rank, "")
            gauges = router_lib.parse_gauges(text, (
                "tpuframe_serve_queue_depth", "tpuframe_serve_active_slots",
                "tpuframe_open_spans"))
            if (gauges != {"tpuframe_serve_queue_depth": 0.0,
                           "tpuframe_serve_active_slots": 0.0,
                           "tpuframe_open_spans": 0.0}
                    or 'tpuframe_serve_ttft_ms{quantile="p50"}' not in text):
                problems.append(f"{tag} replica {rank} /metrics: {gauges}")
        if len(run["workers"]) != FLEET_REPLICAS:
            problems.append(f"{tag} counts from {sorted(run['workers'])}")
    found = (tracing.verify_traces(run["events"])
             + tracing.span_anomalies(run["events"]))
    if crash:
        # the JAX chaos tier's contract: the only findings are the killed
        # replica's serve spans, leaked (its orphaned work), and there
        # are some; every admitted request has one complete root
        leaked = [f for f in found if f["kind"] == "leaked_span"
                  and str(f.get("host", "")).endswith("-p1")]
        if not leaked:
            problems.append(f"{tag} the killed replica leaked no span")
        found = [f for f in found if f not in leaked]
        traces = tracing.build_traces(run["events"])
        roots = [len(traces[r["trace"]].complete_roots())
                 for r in run["events"] if r.get("type") == "router_admit"]
        if roots != [1] * len(reqs):
            problems.append(f"{tag} complete roots a request: {roots}")
    if found:
        problems.append(f"{tag} traces: " + "; ".join(
            f"[{p['kind']}] {p['detail']}" for p in found[:5]))
    return problems


def _reference_tokens(reqs: list, seed: int) -> dict:
    """``{rid: tokens}`` of ``reqs`` through one in-process engine of phase
    serve's config on the weights of ``seed``, after its warm-up."""
    engine = _serve_engine(seed)
    _warm_up(engine)
    copies = [loadgen.Request(rid=r.rid, prompt=list(r.prompt),
                              max_new_tokens=r.max_new_tokens,
                              arrival_t=r.arrival_t) for r in reqs]
    loadgen.run_loadgen(engine, copies)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {r.rid: [int(t) for t in r.tokens] for r in copies}


def phase_fleet(serve: dict | None = None) -> dict:
    """The serving fleet (``serve/replica.py``, ``serve/router.py``,
    ``obs/tracing.py``, ``obs/exporter.py``, ``obs/slo.py``): phase serve's
    engine in FLEET_REPLICAS replica processes on the one card
    (``--replica-worker``) behind the port's Router, with every request
    traced.  FLEET_REQUESTS seeded Poisson requests over the three
    buckets, ragged lengths included:

      (a) clean: all answered, none lost or shed, both replicas serving;
          every request's tokens bit-equal to the same request through an
          in-process engine of the same config and seed; each replica's
          flash_fwd launches 12 x its prefills, all on the tensor cores;
          each replica's /metrics with its queue, slot and TTFT gauges
          and tpuframe_open_spans 0 after the run; verify_traces and
          span_anomalies clean on the merged events; SIGTERM drains both
          to rc 0;
      (b) the same with replica_crash:step=FLEET_CRASH_STEP:rank=1: none
          lost, a drain and a redispatch, exit codes 0 and the crash
          fault's, every answer's tokens still the in-process ones; on
          the traces, one complete root a request, and no finding but
          the killed replica's leaked serve spans (the JAX chaos tier's
          contract).

    Prints the fleet's tokens/s, TTFT (router, queue-inclusive) and TPOT
    p50/p90 beside phase serve's single engine (``serve``; None: phase
    serve runs first), and the SLO sentry's burn rates (informational)."""
    if serve is None:
        serve = phase_serve()[2]
    gc.collect()
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="tpuframe_fleet_")
    try:
        t_phase = time.monotonic()
        reqs = loadgen.synthetic_requests(
            FLEET_REQUESTS, buckets=kv.DEFAULT_PROMPT_BUCKETS,
            vocab_size=LMConfig().vocab_size, max_new_tokens=NEW_TOKENS,
            seed=0, rate=FLEET_RATE)
        procs = _spawn_fleet(root, "clean", None)
        try:
            # the in-process reference, while the fleet starts
            want = _reference_tokens(reqs, 0)
        except BaseException:
            for p, *_rest in procs:
                p.kill()
                p.wait()
            raise
        cfg = LMConfig(dtype="bfloat16", attn_impl="pallas")
        clean = _fleet_run(root, "clean", reqs, procs)
        crash = _fleet_run(root, "crash", reqs,
                           _spawn_fleet(root, "crash", 1))
        phase_s = time.monotonic() - t_phase
    finally:
        shutil.rmtree(root, ignore_errors=True)

    problems = (_fleet_checks(clean, reqs, want, crash=False,
                              num_layers=cfg.num_layers)
                + _fleet_checks(crash, reqs, want, crash=True,
                                num_layers=cfg.num_layers))
    hit = sorted({kv.bucket_for(len(r.prompt), kv.DEFAULT_PROMPT_BUCKETS)
                  for r in reqs})
    ragged = sum(len(r.prompt) not in kv.DEFAULT_PROMPT_BUCKETS
                 for r in reqs)
    if hit != list(kv.DEFAULT_PROMPT_BUCKETS) or not ragged:
        problems.append(f"buckets hit {hit}, {ragged} ragged prompts")
    if problems:
        raise RuntimeError("fleet: " + "; ".join(problems))

    fleet = obs_goodput.fleet_stats(clean["events"])
    served = obs_goodput.serve_stats(clean["events"])
    tokens = sum(len(t) for t in clean["tokens"].values())
    tok_s = tokens / clean["serve_s"]
    launches = {name: sum(w["launches"][name]
                          for w in clean["workers"].values())
                for name in launch_counts()}
    log(f"[fleet] (a) {clean['requests']}/{len(reqs)} requests over buckets "
        f"{hit} ({ragged} ragged), {tokens} tokens in "
        f"{clean['serve_s']:.3f} s: {tok_s:.2f} tokens/s through "
        f"{FLEET_REPLICAS} replicas (ready in {clean['ready_s']:.1f} s); "
        f"by replica {fleet['by_replica']}, hedged {clean['hedged']}, "
        f"duplicates {clean['duplicates']}; router TTFT p50 "
        f"{fleet['ttft_ms']['p50']:.2f} ms p90 {fleet['ttft_ms']['p90']:.2f}"
        f" ms; replica TTFT p50 {served['ttft_ms']['p50']:.2f} ms; TPOT p50 "
        f"{served['tpot_ms']['p50']:.2f} ms p90 "
        f"{served['tpot_ms']['p90']:.2f} ms; tokens bit-equal to the "
        f"in-process engine; flash_fwd launches "
        + ", ".join(f"r{k}: {w['launches']['flash_fwd']} = "
                    f"{cfg.num_layers} x {w['prefills']} prefills"
                    for k, w in sorted(clean["workers"].items()))
        + "; traces verified; exit codes " + str(clean["exit_codes"]))
    log(f"[fleet] phase serve's single engine, same run: "
        f"{serve['tokens_per_s']} tokens/s, TTFT p50 {serve['ttft_p50']:.2f}"
        f" ms p90 {serve['ttft_p90']:.2f} ms, TPOT p50 "
        f"{serve['tpot_p50']:.2f} ms p90 {serve['tpot_p90']:.2f} ms")
    log(f"[fleet] (b) replica_crash:step={FLEET_CRASH_STEP}:rank=1: "
        f"{crash['requests']}/{len(reqs)} answered, lost {crash['lost']}, "
        f"{crash['drains']} drain(s), {crash['redispatched']} "
        f"redispatched, exit codes {crash['exit_codes']}, tokens bit-equal")
    burn = slo_lib.evaluate(clean["events"])
    log("[fleet] SLO burn (informational): " + "; ".join(
        f"{row['slo']} rc-part {'breach' if row['breached'] else 'met'}, "
        f"worst burn "
        + ", ".join(f"{w['window_s']:g}s {w['burn']}" for w in row["windows"])
        for row in burn["slos"]) + f"; rc {burn['rc']}")
    log(f"[fleet] phase {phase_s:.1f} s")
    return {"launches": launches, "tokens_per_s": tok_s,
            "ttft_ms": fleet["ttft_ms"], "tpot_ms": served["tpot_ms"]}


def _rollout_run(root: str, name: str, reqs: list, procs: list) -> dict:
    """One live rollout over the fleet ``procs`` (:func:`_fleet_run`, no
    hedging): a manifest-only ``step_00000001`` sits in a watched
    directory from the start; once a quarter of ``reqs`` have retired,
    the A/A gate runs between the two v0 replicas' answers so far and the
    COMMIT lands, and the controller's ``committed_world`` poll starts the
    roll to ROLLOUT_SEED's weights (a rollback swaps seed 0's back)."""
    watch = os.path.join(root, f"{name}.ckpt")
    step_dir = os.path.join(watch, "step_00000001")
    os.makedirs(step_dir)
    Path(step_dir, "manifest.json").write_text(json.dumps(
        {"step": 1, "world": {"processes": 1, "devices": 1}}))
    state: dict = {}

    def on_router(router):
        ctl = rollout_lib.RolloutController(
            router, watch_dir=watch, watch_interval_s=0.05,
            current_version=0, canary_frac=ROLLOUT_CANARY_FRAC,
            gate_pct=ROLLOUT_GATE_PCT, bake_min_samples=ROLLOUT_BAKE_MIN,
            bake_timeout_s=ROLLOUT_BAKE_TIMEOUT_S,
            drain_timeout_s=ROLLOUT_DRAIN_TIMEOUT_S, swap_timeout_s=30.0,
            swap_seed=ROLLOUT_SEED, seed=0, log=log)
        state["ctl"] = ctl

        def on_tick():
            if ("aa" not in state
                    and router.counters["completed"] >= len(reqs) // 4):
                if ctl.state != "idle":
                    raise RuntimeError(f"{name}: the roll started before "
                                       f"its checkpoint committed")
                sides = [[q for q in router.completed if q.replica == rep
                          ][-ROLLOUT_BAKE_MIN:] for rep in ("r0", "r1")]
                rc, res = rollout_lib.gate_compare(
                    ctl._gate_events(sides[0]), ctl._gate_events(sides[1]),
                    pct=ROLLOUT_GATE_PCT)
                state["aa"] = {"rc": rc, "samples": [len(x) for x in sides],
                               "p90": _gate_deltas(res)}
                rollout_lib._commit_fake_checkpoint(watch, 1)
            return ctl.tick()
        return on_tick

    # a drained replica's requests wait in the queue while still in
    # flight, so the router may count one twice
    run = _fleet_run(root, name, reqs, procs, hedge_ms=0.0,
                     queue_limit=2 * len(reqs), on_router=on_router)
    ctl = state["ctl"]
    run.update(rollout=ctl.summary(), history=list(ctl.history),
               gate=_gate_deltas(ctl.gate_result), aa=state.get("aa"))
    return run


def _gate_deltas(res: dict | None) -> dict:
    """``{gate metric: (p90 a, p90 b, % change)}`` of a ``gate_compare``
    result."""
    return {m: (e["a"], e["b"], e["delta_pct"])
            for m, e in (res or {}).get("metrics", {}).items()
            if m in rollout_lib.GATE_METRICS and "delta_pct" in e}


def _aa_gap(p90: dict) -> float | None:
    """The largest gap of an A/A gate, in % of the smaller side: either
    replica may be the one a gate would call the canary."""
    gaps = [100.0 * (max(a, b) / min(a, b) - 1.0)
            for a, b, _ in p90.values() if min(a, b) > 0]
    return max(gaps) if gaps else None


def _rollout_checks(run: dict, reqs: list, want: dict, *, poisoned: bool,
                    num_layers: int) -> list:
    tag = "(b)" if poisoned else "(a)"
    ro = run["rollout"]
    problems = []
    final = 0 if poisoned else 1
    if ro["state"] != ("aborted" if poisoned else "done"):
        problems.append(f"{tag} rollout ended {ro['state']} "
                        f"({ro['abort_metric']}: {ro['abort_reason']})")
    if poisoned and ro["abort_metric"] not in rollout_lib.GATE_METRICS:
        problems.append(f"{tag} abort metric {ro['abort_metric']!r} is "
                        f"not a gate metric")
    if run["aa"] is None:
        problems.append(f"{tag} the roll never triggered")
    if run["lost"] or run["timed_out"] or run["shed"]:
        problems.append(f"{tag} lost {run['lost']}, shed {run['shed']}, "
                        f"timed out {run['timed_out']}")
    if run["requests"] != len(reqs):
        problems.append(f"{tag} {run['requests']}/{len(reqs)} answered")
    versions = {rank: router_lib.parse_gauges(
        run["scrapes"].get(rank, ""), ("tpuframe_weights_version",)).get(
            "tpuframe_weights_version") for rank in range(FLEET_REPLICAS)}
    if versions != {rank: float(final) for rank in range(FLEET_REPLICAS)}:
        problems.append(f"{tag} weights version gauges {versions}, want "
                        f"{final}")
    if run["exit_codes"] != [0] * FLEET_REPLICAS:
        problems.append(f"{tag} exit codes {run['exit_codes']}")
    # drain -> swapped -> readmitted on each replica that moved, and one
    # replica in transition at a time
    phases: dict = {}
    moving = None
    for _t, rep, phase in run["history"]:
        phases.setdefault(rep, []).append(phase)
        if phase == "drain":
            if moving is not None:
                problems.append(f"{tag} {rep} drained while {moving} was "
                                f"in transition")
            moving = rep
        elif phase in ("readmitted", "rolled_back"):
            moving = None
    moved = ["r0"] if poisoned else ["r0", "r1"]
    for rep in moved:
        core = [p for p in phases.get(rep, [])
                if p in ("drain", "swapped", "readmitted")]
        if core != ["drain", "swapped", "readmitted"]:
            problems.append(f"{tag} {rep} phases {phases.get(rep)}")
    if sorted(phases) != moved or (
            poisoned and phases["r0"][-1] != "rolled_back"):
        problems.append(f"{tag} phases {phases}")
    # the tokens of every answer: those of one version its replica held
    # while the request was in its hands: the one it served when the
    # winning attempt was launched, or one it swapped to before the
    # answer (a request can wait in a replica's inbox, which the drain's
    # idle probe does not see, and start after the swap)
    changes: dict = {}
    for t, rep, phase in run["history"]:
        if phase in ("swapped", "rolled_back"):
            changes.setdefault(rep, []).append(
                (t, 1 if phase == "swapped" else 0))
    served = {0: 0, 1: 0}
    wrong = []
    for q in run["completed"]:
        launch = q.submit_t + (q.ttft_ms
                               - float(q.result.get("ttft_ms") or 0)) / 1e3
        held = [0]
        for t, v in changes.get(q.replica, []):
            if t < launch:
                held = [v]
            elif t < q.done_t:
                held.append(v)
        match = [v for v in held if q.result["tokens"] == want[v][q.rid]]
        if match:
            served[match[0]] += 1
        else:
            wrong.append((q.rid, q.replica, held))
    if wrong:
        problems.append(f"{tag} (rid, replica, versions held) whose tokens "
                        f"differ from each such version's in-process "
                        f"engine: {wrong}")
    # a promotion needs ROLLOUT_BAKE_MIN answers a side; an abort may
    # come at the bake's deadline, on fewer canary answers
    need = 1 if poisoned else ROLLOUT_BAKE_MIN
    if served[1] < need:
        problems.append(f"{tag} {served[1]} answers on v1")
    if (ro["bake_samples"] is None
            or min(ro["bake_samples"].values()) < need):
        problems.append(f"{tag} bake samples {ro['bake_samples']}, want "
                        f"{need} a side")
    problems += _worker_launch_checks(tag, run["workers"], num_layers)
    if len(run["workers"]) != FLEET_REPLICAS:
        problems.append(f"{tag} counts from {sorted(run['workers'])}")
    found = (tracing.verify_traces(run["events"])
             + tracing.span_anomalies(run["events"]))
    if found:
        problems.append(f"{tag} traces: " + "; ".join(
            f"[{p['kind']}] {p['detail']}" for p in found[:5]))
    roots = [sp.closed for tv in tracing.build_traces(run["events"]).values()
             for sp in tv.roots if sp.name == "rollout"]
    status = "aborted" if poisoned else "done"
    if [(r or {}).get("status") for r in roots] != [status]:
        problems.append(f"{tag} rollout root spans closed {roots}, want "
                        f"one {status}")
    return problems


def _during_roll(run: dict) -> dict:
    """Tokens/s and router TTFT of the answers retired between the roll's
    first and last phase."""
    t0, t1 = run["history"][0][0], run["history"][-1][0]
    inside = [q for q in run["completed"] if t0 <= q.done_t <= t1]
    ttft = [q.ttft_ms for q in inside]
    tokens = sum(len(q.result["tokens"]) for q in inside)
    return {"s": t1 - t0, "requests": len(inside),
            "tokens_per_s": tokens / (t1 - t0) if t1 > t0 else None,
            "ttft_p50": _pct(ttft, .5) if ttft else None,
            "ttft_p90": _pct(ttft, .9) if ttft else None}


def _rollout_line(run: dict) -> str:
    """One run's numbers: its end, the A/A and canary p90s beside the
    gate, bake samples, the mixed-version window, swap ms, and tokens/s
    and router TTFT during the roll."""
    ro, aa = run["rollout"], run["aa"] or {}

    def p90s(d):
        return ", ".join(f"{m} {a:.2f} -> {b:.2f} ms ({pct:+.1f}%)"
                         for m, (a, b, pct) in d.items())

    text = (f"state {ro['state']}"
            + (f" on {ro['abort_metric']}" if ro["aborted"] else "")
            + f"; A/A gate r0 -> r1 on v0 ({aa.get('samples')} answers): "
            f"rc {aa.get('rc')}, {p90s(aa.get('p90', {}))}; A/A gap "
            f"{_aa_gap(aa.get('p90', {}))}%; canary gate old -> canary "
            f"({ro['bake_samples']}): {p90s(run['gate'])} (gate "
            f"{ROLLOUT_GATE_PCT:g}%); mixed-version window {ro['window_s']}"
            f" s; swap ms "
            + ", ".join(f"{rep} {ms:.1f}" for rep, ms in ro["swap_ms"]))
    if run["history"]:
        roll = _during_roll(run)
        text += (f"; during the roll ({roll['s']:.3f} s, "
                 f"{roll['requests']} answers): {roll['tokens_per_s']} "
                 f"tokens/s, router TTFT p50 {roll['ttft_p50']} ms p90 "
                 f"{roll['ttft_p90']} ms")
    return text + (f"; fleet ready in {run['ready_s']:.1f} s, served in "
                   f"{run['serve_s']:.3f} s; lost {run['lost']}, exit codes "
                   f"{run['exit_codes']}")


def _start_selfcheck(root: str) -> tuple:
    """``python -m tpuframe_torch.serve --selfcheck`` on the card, from
    this checkout, with no JAX, XLA or TPUFRAME variable; its output goes
    to a file under ``root``."""
    here = Path(__file__).resolve().parent
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "TPUFRAME_"))}
    env["PYTHONPATH"] = str(here)
    out = os.path.join(root, "selfcheck.log")
    with open(out, "wb") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpuframe_torch.serve", "--selfcheck"],
            cwd=here, env=env, stdout=f, stderr=subprocess.STDOUT)
    return proc, out, time.monotonic()


def _end_selfcheck(selfcheck: tuple) -> float:
    """Wait for :func:`_start_selfcheck`'s process; raises unless it
    exited 0 with 0 failures.  Returns its seconds."""
    proc, out, t0 = selfcheck
    try:
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = Path(out).read_text(errors="replace")
    if rc != 0 or "[serve] selfcheck: 0 failure(s)" not in text:
        raise RuntimeError(f"rollout (c): selfcheck rc {rc}:\n"
                           f"{text[-3000:]}")
    return time.monotonic() - t0


def phase_rollout(serve: dict | None = None) -> dict:
    """The live weight rollout (``serve/rollout.py``, the replicas'
    ``/swap_weights``, ``LMEngine.swap_params``): phase fleet's replicas
    on the one card behind the port's Router, ROLLOUT_REQUESTS traced
    Poisson requests, and the controller rolling them to v1 (the port's
    init for ROLLOUT_SEED) once step 1 commits:

      (s) ``swap_parity_check`` at full width over buckets 128/256/512:
          an engine hot-swapped onto seed 1's weights streams the tokens
          of one cold-started on them, its tensors swapped in place;
      (a) clean: the A/A gate between the two v0 replicas, then state
          done; both weights-version gauges 1; lost 0, shed 0; drain ->
          swapped -> readmitted on each replica, one in transition at a
          time; every answer's tokens bit-equal to an in-process engine's
          on the version its replica served at its launch (v1 after the
          readmission); each replica's flash_fwd launches 12 x its
          prefills, all on the tensor cores; the merged traces verified
          and the ``rollout`` root closed done; SIGTERM drains to rc 0;
      (b) the same with ROLLOUT_SLOW_CANARY: state aborted on a gate
          metric, the canary rolled back, both gauges 0, lost 0, the
          tokens checked as in (a);
      (c) ``python -m tpuframe_torch.serve --selfcheck`` on the card: rc
          0, 0 failures.

    Prints the A/A and canary gaps beside the gate, bake samples, the
    mixed-version window, swap ms, and tokens/s and TTFT during each roll.
    ``serve``: phase serve's summary (None: phase serve runs first)."""
    if serve is None:
        serve = phase_serve()[2]
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.monotonic()
    cfg = LMConfig(dtype="bfloat16", attn_impl="pallas")
    root = tempfile.mkdtemp(prefix="tpuframe_rollout_")
    procs = []
    try:
        # (c) runs beside (s), the fleet's start-up and the references,
        # and ends before any timed traffic
        selfcheck = _start_selfcheck(root)
        try:
            t0 = time.monotonic()
            problems = swap_parity_check(
                cfg, buckets=kv.DEFAULT_PROMPT_BUCKETS,
                decode_block=kv.DEFAULT_DECODE_BLOCK, seed=0)
            gc.collect()
            torch.cuda.empty_cache()
            if problems:
                raise RuntimeError("rollout (s): " + "; ".join(problems))
            log(f"[rollout] (s) swap parity at full width, buckets "
                f"{list(kv.DEFAULT_PROMPT_BUCKETS)}, full and ragged "
                f"prompts: hot swap == cold start, every tensor in place, "
                f"{time.monotonic() - t0:.1f} s")
            reqs = loadgen.synthetic_requests(
                ROLLOUT_REQUESTS, buckets=kv.DEFAULT_PROMPT_BUCKETS,
                vocab_size=cfg.vocab_size, max_new_tokens=NEW_TOKENS,
                seed=0, rate=FLEET_RATE)
            procs = _spawn_fleet(root, "clean", None)
            # the in-process references, while the fleet starts
            want = {0: _reference_tokens(reqs, 0),
                    1: _reference_tokens(reqs, ROLLOUT_SEED)}
        finally:
            selfcheck_s = _end_selfcheck(selfcheck)
        clean = _rollout_run(root, "clean", reqs, procs)
        procs = _spawn_fleet(root, "poisoned", None,
                             faults_spec=ROLLOUT_SLOW_CANARY)
        poisoned = _rollout_run(root, "poisoned", reqs, procs)
    finally:
        for p, *_rest in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(root, ignore_errors=True)
    card = _card_line()
    for tag, run in (("(a)", clean), ("(b)", poisoned)):
        log(f"[rollout] {tag} {card}: " + _rollout_line(run))
    same = [rid for rid in want[0] if want[0][rid] == want[1][rid]]
    problems = ([f"v0 and v1 give the same tokens for rids {same}"]
                if same else [])
    problems += (_rollout_checks(clean, reqs, want, poisoned=False,
                                 num_layers=cfg.num_layers)
                 + _rollout_checks(poisoned, reqs, want, poisoned=True,
                                   num_layers=cfg.num_layers))
    if problems:
        raise RuntimeError("rollout: " + "; ".join(problems))
    phase_s = time.monotonic() - t_phase
    log(f"[rollout] (c) python -m tpuframe_torch.serve --selfcheck: rc 0, "
        f"0 failures, {selfcheck_s:.1f} s")
    log(f"[rollout] phase {phase_s:.1f} s (budget {ROLLOUT_BUDGET_S:g} s)")
    workers = [w for run in (clean, poisoned)
               for w in run["workers"].values()]
    return {"launches": {name: sum(w["launches"][name] for w in workers)
                         for name in launch_counts()},
            "routes": {route: sum(w["routes"][route] for w in workers)
                       for route in ("tensor_core", "cuda_core")}}


def phase_grad_parity() -> None:
    """One training step's loss and gradients at full width in f32, with
    the flash kernels (``attn_impl="pallas"``) against the plain einsum
    attention (``"xla"``), from the same random weights and tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = GRAD_PARITY_SHAPE
    cfg = get_config("lm_long").with_overrides(
        compute_dtype="float32", dataset_kwargs={"seq_len": s})
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, 32000, (b, s + 1), generator=gen, device="cuda")
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    loss_fn = train_lib.make_loss_fn(cfg)
    out = {}
    for impl in ("pallas", "xla"):
        model = get_model(cfg.model, dtype="float32", device="cuda", seed=0,
                          **dict(cfg.model_kwargs, attn_impl=impl))
        loss, _ = loss_fn(model, batch, 0)
        loss.backward()
        out[impl] = (float(loss.detach()), {n: p.grad for n, p in
                                   model.named_parameters()})
        del model
    (lp, gp), (lx, gx) = out["pallas"], out["xla"]
    worst, where = 0.0, ""
    for name, g in gx.items():
        rel = float((gp[name] - g).norm() / g.norm().clamp_min(1e-30))
        if rel > worst:
            worst, where = rel, name
    log(f"[grad-parity] lm_long widths f32, B={b} S={s}: loss kernels "
        f"{lp:.6f} plain {lx:.6f}; worst per-tensor relative grad "
        f"difference {worst:.2e} ({where}; tol {GRAD_PARITY_RTOL})")
    if not (abs(lp - lx) <= GRAD_PARITY_RTOL * abs(lx)
            and worst <= GRAD_PARITY_RTOL):
        raise RuntimeError(f"gradient parity: loss {lp} vs {lx}, worst "
                           f"relative grad difference {worst:.3e} at {where}")


def phase_grad_parity_bf16() -> None:
    """One training step's loss and gradients at full width in bf16, the
    kernels (the backward on the tensor cores) against the einsum
    attention, both held to the f32 einsum route from the same weights
    and tokens: the kernels' error on each tensor within
    BF16_NOISE_FACTOR times the bf16 einsum route's own."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s = BF16_PARITY_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(4)
    ids = torch.randint(0, 32000, (b, s + 1), generator=gen, device="cuda")
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    out = {}
    before = dict(fa.BWD_ROUTES)
    for route, impl, dtype in (("kernels", "pallas", "bfloat16"),
                               ("plain", "xla", "bfloat16"),
                               ("f32", "xla", "float32")):
        cfg = get_config("lm_long").with_overrides(
            compute_dtype=dtype, dataset_kwargs={"seq_len": s})
        model = get_model(cfg.model, dtype=dtype, device="cuda", seed=0,
                          **dict(cfg.model_kwargs, attn_impl=impl))
        loss, _ = train_lib.make_loss_fn(cfg)(model, batch, 0)
        loss.backward()
        out[route] = (float(loss.detach()), {n: p.grad for n, p in
                                             model.named_parameters()})
        del model
    ran = {r: fa.BWD_ROUTES[r] - before[r] for r in before}

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    (lk, gk), (lx, gx), (l32, g32) = out["kernels"], out["plain"], out["f32"]
    worst, noise, direct, where, bad = 0.0, 0.0, 0.0, "", []
    for name, ref in g32.items():
        got, floor = rel(gk[name], ref), rel(gx[name], ref)
        noise = max(noise, floor)
        direct = max(direct, rel(gk[name], gx[name]))
        if got > worst:
            worst, where = got, name
        if got > BF16_NOISE_FACTOR * floor:
            bad.append(f"{name}: {got:.2e} (noise floor {floor:.2e})")
    log(f"[grad-parity-bf16] lm_long widths bf16, B={b} S={s}: loss kernels "
        f"{lk:.6f} einsum {lx:.6f} f32 {l32:.6f}; per-tensor relative grad "
        f"error vs f32: kernels worst {worst:.2e} ({where}), einsum bf16 "
        f"(noise floor) up to {noise:.2e}; kernels vs einsum bf16 up to "
        f"{direct:.2e}; backward launches by route {ran}")
    if abs(lk - l32) > max(BF16_NOISE_FACTOR * abs(lx - l32),
                           1e-3 * abs(l32)):
        bad.append(f"loss {lk} vs f32 {l32} (einsum bf16 {lx})")
    if ran != {"tensor_core": 3 * 12, "cuda_core": 0}:
        bad.append(f"backward launches by route {ran}, want 36 on the "
                   f"tensor cores (delta pass, dq and dkv a layer)")
    if bad:
        raise RuntimeError("bf16 gradient parity: " + "; ".join(bad[:8]))


def phase_train() -> dict:
    """The training slice: lm_long through ``tpuframe_torch.train.main``,
    with the cuts of TRAIN_ARGS, every kernel's launches read around it;
    then one more step of the same harness under the profiler."""
    b, s, n, d = TRAIN_ATTN_SHAPE
    layers = 12
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    metrics = train_lib.main(TRAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    routes = dict(fa.BWD_ROUTES)
    fwd_routes = dict(fa.FWD_ROUTES)
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = metrics["losses"], metrics["step_ms"]
    steps, evals = len(losses), TRAIN_EVAL_BATCHES
    want = {"flash_fwd": (2 * steps + evals) * layers,
            "flash_bwd_delta": steps * layers,
            "flash_bwd_dq": steps * layers, "flash_bwd_dkv": steps * layers,
            "fused_conv_bn_bwd": 0, "precision_probe": 0}
    problems = []
    if not all(math.isfinite(x) for x in losses) or steps != TRAIN_STEPS:
        problems.append(f"losses {losses}")
    if not math.isfinite(metrics.get("eval_loss", float("nan"))):
        problems.append("no finite eval loss")
    if launches != want:
        problems.append(f"launches {launches}, want {want} (forward twice "
                        f"per layer and step under remat, once per layer "
                        f"and eval batch; each backward kernel once per "
                        f"layer and step)")
    want_routes = {"tensor_core": 3 * steps * layers, "cuda_core": 0}
    if routes != want_routes:
        problems.append(f"backward launches by route {routes}, want "
                        f"{want_routes}: every delta, dq and dkv launch of "
                        f"the run on the tensor cores")
    want_fwd = {"tensor_core": want["flash_fwd"], "cuda_core": 0}
    if fwd_routes != want_fwd:
        problems.append(f"forward launches by route {fwd_routes}, want "
                        f"{want_fwd}: every forward launch of the run on "
                        f"the tensor cores")
    if problems:
        raise RuntimeError("training: " + "; ".join(problems))
    p50 = statistics.median(step_ms[1:])
    tokens = b * s
    cfg = get_config("lm_long")
    h, inter, vocab = 768, 3072, 32000
    matmul_params = layers * (4 * h * h + 2 * h * inter) + h * vocab
    pairs = b * s * (s + 1) // 2
    flops = 6 * matmul_params * tokens + 3 * 4 * d * pairs * n * layers
    mfu = flops / (p50 / 1e3) / PEAK_OPS_S[torch.bfloat16]
    log(f"[train] {cfg.name} cut to S={s}, mesh 1x1, {steps} steps + "
        f"{evals} eval batch in {wall:.1f} s: losses "
        f"{[round(x, 4) for x in losses]}, eval loss "
        f"{metrics['eval_loss']:.4f}; step ms {[round(x, 1) for x in step_ms]}"
        f" (p50 after the first {p50:.1f}); {tokens / p50 * 1e3:.0f} "
        f"tokens/s; model FLOPs {flops:.3e} a step, MFU {mfu:.4f} of "
        f"989 TFLOP/s; peak memory {peak / 2**30:.2f} GiB; launches "
        f"{launches}; forward launches by route {fwd_routes}; backward "
        f"launches by route {routes}")

    # One more step of the same path under the profiler: where it goes.
    cfg = get_config("lm_long").with_overrides(**TRAIN_OVERRIDES)
    harness = train_lib.build_harness(cfg)
    batch = next(iter(harness.train_loader))
    step = lambda: float(harness.train_step(harness.state, batch)["loss"])  # noqa: E731
    wall_step = wall_ms(step, 1)
    kernels = device_time(step)
    busy, idle, text = _busy(kernels, wall_step)
    split = None
    if kernels is not None:
        split = {which: sum(ms for k, ms, _ in kernels
                            if f"flash_bwd_{which}_tc_kernel" in k)
                 for which in ("delta", "dq", "dkv")}
        pair = sum(split.values())
        fwd = sum(ms for k, ms, _ in kernels if "flash_fwd" in k)
        text += (f"; flash forward {fwd:.1f} ms ({fwd / busy:.3f} of "
                 f"device time), backward {pair:.1f} ms ({pair / busy:.3f}"
                 f"): " + ", ".join(f"{w} {ms:.1f} ms"
                                    for w, ms in split.items()))
    log(f"[profile] training step: wall {wall_step:.1f} ms, {text}; top: "
        + _top(kernels, 8))
    return {"launches": launches, "step_ms_p50": p50, "mfu": mfu,
            "peak_bytes": peak, "routes": routes, "fwd_routes": fwd_routes,
            "device_ms": busy, "idle_share": idle,
            "backward_device_ms": split}


def resnet_conv_bn_shapes(batch: int = RESNET_BATCH, size: int = 224):
    """The fused op's calls in one ResNet-50 training step: ``{(n, h, w,
    k, c): calls}`` from the port's own Bottleneck layout (conv1, conv3
    and the downsample of each block; the downsample after its stride)."""
    calls = {}
    hw = size // 4                       # after the stem and the max pool
    cin = 64
    for i, n_blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(n_blocks):
            stride = 2 if i > 0 and j == 0 else 1
            out_hw = hw // stride
            for key in [(batch, hw, hw, cin, f),
                        (batch, out_hw, out_hw, f, 4 * f)] + (
                    [(batch, out_hw, out_hw, cin, 4 * f)] if j == 0 else []):
                calls[key] = calls.get(key, 0) + 1
            cin, hw = 4 * f, out_hw
    return calls


def _conv_bn_inputs(m, k, c, dtype, gen):
    """Kernel operands: activations ~N(0, 1), a conv-scaled W, and the
    folded coefficients of a BN with gamma in [0.5, 1.5]."""
    dev = torch.device("cuda")
    a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    w = (torch.randn((k, c), generator=gen, device=dev)
         * (2.0 / c) ** 0.5).to(dtype)
    x = torch.randn((m, c), generator=gen, device=dev).to(dtype)
    dy = torch.randn((m, c), generator=gen, device=dev).to(dtype)
    coef = torch.stack([
        torch.rand(c, generator=gen, device=dev) + 0.5,
        torch.randn(c, generator=gen, device=dev) * 0.1,
        torch.randn(c, generator=gen, device=dev) * 0.1])
    return a, w, x, dy, coef


def _conv_bn_check(name, args, route=None):
    """The kernel against its plain version; raises past the tolerance, or
    if it ran on another route than ``route`` (default: the one
    ``fcb.conv_bn_route`` names, through the public wrapper).  Returns
    ``{"da": err, "dw": err}`` (max abs)."""
    a, w = args[0], args[1]
    want = route or fcb.conv_bn_route(a.dtype, *w.shape)
    before = dict(fcb.ROUTES)
    da, dw = (fcb.fused_bwd(*args) if route is None
              else fcb._launch(*args, route=route))
    torch.cuda.synchronize()
    ran = {r: fcb.ROUTES[r] - before[r] for r in before}
    ref_da, ref_dw = fcb.fused_bwd_reference(*args)
    tol = CONV_BN_TOL[args[0].dtype]
    errs, bad = {}, []
    if ran != {r: int(r == want) for r in ran}:
        bad.append(f"launches by route {ran}, want one on {want}")
    for g, got, ref in (("da", da, ref_da), ("dw", dw, ref_dw)):
        errs[g] = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if not (torch.isfinite(got.float()).all()
                and errs[g] <= tol[g] * max(scale, 1e-30)):
            bad.append(f"{g}: max|diff| {errs[g]:.3e} vs tol {tol[g]} x "
                       f"max|plain| {scale:.3e}")
    if bad:
        raise RuntimeError(f"fused_conv_bn {name} ({want}): "
                           + "; ".join(bad))
    return errs


def _conv_bn_library_ms(n, h, w, args, iters):
    """The yardstick: the autograd backward of the unfused composition
    PyTorch offers, cuDNN's 1x1 ``F.conv2d`` + training-mode
    ``F.batch_norm``, on the same tensors (channels_last), timed alone
    (the graph is kept, so each call is only the backward).  The port
    never calls it."""
    a, w2, x, dy, coef = args
    k, c = w2.shape
    a4 = a.view(n, h, w, k).permute(0, 3, 1, 2).detach().requires_grad_()
    wt = w2.T.reshape(c, k, 1, 1).contiguous().detach().requires_grad_()
    gamma = coef[0].clone().requires_grad_()
    beta = coef[2].clone().requires_grad_()
    y = F.batch_norm(F.conv2d(a4, wt), None, None, gamma, beta,
                     training=True, eps=1e-5)
    dy4 = dy.view(n, h, w, c).permute(0, 3, 1, 2)
    lib = cuda_ms(lambda: torch.autograd.grad(
        y, (a4, wt, gamma, beta), dy4, retain_graph=True), iters)
    return lib, device_ms(lambda: torch.autograd.grad(
        y, (a4, wt, gamma, beta), dy4, retain_graph=True), 2)


def phase_conv_bn() -> dict:
    """The fused conv+BN backward kernel at every shape of a ResNet-50
    training step (bf16, batch 256) on both routes (the tensor cores, as
    the path runs it, and the CUDA-core kernels on the same inputs), each
    checked and timed beside the cuDNN yardstick and the bound; then a
    correctness sweep."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    dtype = torch.bfloat16
    routes = ("tensor_core", "cuda_core")
    keys = ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "ops_ms", "bytes_ms", "flops", "bytes")
    tots = {r: dict.fromkeys(keys, 0.0) for r in routes}
    cases = []
    worst = {r: {"da": 0.0, "dw": 0.0} for r in routes}
    split = {r: {} for r in routes}   # device ms a step, by kernel
    for (n, h, w, k, c), calls in resnet_conv_bn_shapes().items():
        m = n * h * w
        args = _conv_bn_inputs(m, k, c, dtype, gen)
        if fcb.conv_bn_route(dtype, k, c) != "tensor_core":
            raise RuntimeError(f"M={m} K={k} C={c} is not on the tensor-core"
                               f" route")
        plain = cuda_ms(lambda: fcb.fused_bwd_reference(*args), 3)
        lib, lib_dev = _conv_bn_library_ms(n, h, w, args, 10)
        flops = 4 * m * k * c
        nbytes = (2 * (m * k + 2 * m * c + k * c + m * k) + 4 * 3 * c
                  + 4 * k * c)
        t_ops = 1e3 * flops / PEAK_OPS_S[dtype]
        t_bytes = 1e3 * nbytes / PEAK_BYTES_S
        case = {"m": m, "k": k, "c": c, "calls": calls, "plain_ms": plain,
                "library_ms": lib, "library_device_ms": lib_dev,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        for route in routes:
            errs = _conv_bn_check(f"M={m} K={k} C={c}", args, route)
            launch = lambda r=route: fcb._launch(*args, route=r)  # noqa: E731
            ms = cuda_ms(launch, 10)
            kernels = device_time(launch, 3, PROFILE_TRIES)
            dev = (None if kernels is None
                   else sum(t for _, t, _ in kernels) / 3)
            for name, t, _ in kernels or []:
                found = re.search(r"\w+_kernel(<[^>]*>)?", name)
                short = found.group(0) if found else name[:40]
                split[route][short] = (split[route].get(short, 0.0)
                                       + calls * t / 3)
            case[route] = {"ms": ms, "device_ms": dev,
                           "max_abs_err_da": errs["da"],
                           "max_abs_err_dw": errs["dw"],
                           "tflops": flops / ms / 1e9,
                           "splits": fcb.dw_splits(m, k, c, route)[0]}
            for key, val in (("ms", ms), ("device_ms", dev),
                             ("plain_ms", plain), ("library_ms", lib),
                             ("library_device_ms", lib_dev),
                             ("bound_ms", case["bound_ms"]),
                             ("ops_ms", t_ops), ("bytes_ms", t_bytes),
                             ("flops", flops), ("bytes", nbytes)):
                # a total with a time not measured is not measured
                tots[route][key] = (None if val is None
                                    or tots[route][key] is None
                                    else tots[route][key] + calls * val)
            for g in ("da", "dw"):
                worst[route][g] = max(worst[route][g], errs[g])
        tc, cc = case["tensor_core"], case["cuda_core"]
        log(f"[conv-bn] M={m} K={k} C={c} x{calls}: tensor cores err da "
            f"{tc['max_abs_err_da']:.2e} dw {tc['max_abs_err_dw']:.2e}, "
            f"{tc['ms']:.3f} ms (device {_dev(tc['device_ms'])}, "
            f"{tc['tflops']:.2f} TFLOP/s, {tc['splits']} dW splits); CUDA "
            f"cores {cc['ms']:.3f} ms (device {_dev(cc['device_ms'])}); plain "
            f"{plain:.3f} ms, cuDNN conv+BN backward {lib:.3f} ms (device "
            f"{_dev(lib_dev)}), bound {case['bound_ms']:.4f} ms "
            f"({case['bound_by']})")
        cases.append(case)
        del args
    log(json.dumps({"fused_conv_bn_cases": cases}))
    info = {f"{which} K={k} C={c}": fcb.tc_kernel_info(which, k, c)
            for which in ("da", "dw") for k, c in ((64, 256), (2048, 512))}
    for route in routes:
        tot = tots[route]
        tot["bound_by"] = ("operations" if tot["ops_ms"] >= tot["bytes_ms"]
                           else "bytes")
        tot["max_abs_err"] = max(worst[route].values())
        tot["route"] = route
        if tot["device_ms"] is None:
            split[route] = "not measured"   # some window was incomplete
        log(f"[conv-bn] one ResNet-50 step's 36 calls ({len(cases)} shapes,"
            f" {tot['flops']:.3e} FLOPs, {tot['bytes'] / 1e9:.2f} GB), "
            f"route {route}: kernel {tot['ms']:.2f} ms (device "
            f"{_dev(tot['device_ms'], '.2f')}, "
            f"{tot['flops'] / tot['ms'] / 1e9:.2f} "
            f"TFLOP/s), plain {tot['plain_ms']:.2f} ms, cuDNN conv+BN "
            f"backward {tot['library_ms']:.2f} ms (device "
            f"{_dev(tot['library_device_ms'], '.2f')}), bound "
            f"{tot['bound_ms']:.3f} "
            f"ms (operations {tot['ops_ms']:.3f}, bytes "
            f"{tot['bytes_ms']:.3f}); worst err {worst[route]}; device ms "
            f"by kernel {split[route]}")
    log(f"[conv-bn] tensor-core kernels (dynamic smem bytes, blocks an SM): "
        f"{info}")

    # Correctness sweep: f32 at path widths; ragged M, K and C in both
    # dtypes (the CUDA-core route); ragged M and tile mixes on the tensor
    # cores; and the autograd op over a strided downsample.
    sweep = [(12544, 64, 256, torch.float32), (12544, 1024, 2048,
                                                torch.float32),
             (12544, 2048, 512, torch.float32)]
    for dt in fcb.DTYPES:
        sweep += [(1000, 12, 20, dt), (4099, 100, 300, dt), (33, 7, 130, dt),
                  (17, 65, 129, dt)]
    sweep += [(1000, 64, 64, dtype), (4099, 192, 320, dtype),
              (77, 512, 128, dtype), (130001, 256, 64, dtype)]
    sworst, scount = {}, {}
    for m, k, c, dt in sweep:
        errs = _conv_bn_check(f"sweep M={m} K={k} C={c} {dt}",
                              _conv_bn_inputs(m, k, c, dt, gen))
        key = f"{str(dt)[6:]} {fcb.conv_bn_route(dt, k, c)}"
        sworst[key] = max(sworst.get(key, 0.0), *errs.values())
        scount[key] = scount.get(key, 0) + 1
    for dt in fcb.DTYPES:
        sworst[f"strided {str(dt)[6:]}"] = _strided_downsample_check(dt, gen)
    log(f"[conv-bn] sweep of {len(sweep)} kernel cases (f32 at path widths;"
        f" ragged M, K, C in f32 and bf16; ragged M and mixed tiles on the "
        f"tensor cores), cases by route {scount}, and a stride-2 downsample "
        f"through autograd: worst max abs err {sworst}")
    out = dict(tots["tensor_core"])
    out["cuda_core"] = tots["cuda_core"]
    out["kernel_info"] = info
    return out


def _strided_downsample_check(dtype, gen) -> float:
    """``conv1x1_bn_train`` over ``a[:, ::2, ::2, :]`` (a ResNet
    downsample) against the plain composition through autograd: y and
    the gradients of a, w, gamma, beta."""
    dev = torch.device("cuda")
    a4 = torch.randn((8, 14, 14, 64), generator=gen, device=dev).to(dtype)
    w = torch.randn((64, 256), generator=gen, device=dev) * 0.2
    gamma = torch.rand(256, generator=gen, device=dev) + 0.5
    beta = torch.randn(256, generator=gen, device=dev)
    t = torch.randn((8, 7, 7, 256), generator=gen, device=dev)
    out = []
    for fn in (fcb.conv1x1_bn_train, fcb.conv1x1_bn_reference):
        leaves = [v.detach().clone().requires_grad_()
                  for v in (a4, w, gamma, beta)]
        y, _, _ = fn(leaves[0][:, ::2, ::2, :].contiguous(), *leaves[1:],
                     eps=1e-5)
        (y.float() * t).sum().backward()
        out.append([y.detach()] + [v.grad for v in leaves])
    tol = STRIDED_TOL[dtype]
    worst = 0.0
    for name, got, ref in zip(("y", "da", "dw", "dgamma", "dbeta"), *out):
        err = float((got.float() - ref.float()).abs().max())
        scale = float(ref.float().abs().max())
        if not err <= tol * max(scale, 1e-30):
            raise RuntimeError(f"strided downsample {dtype} {name}: max|diff|"
                               f" {err:.3e} vs tol {tol} x {scale:.3e}")
        worst = max(worst, err)
    return worst


def _random_bn_scales(model, seed):
    """BN scales in [0.5, 1.5] (the init zeroes the last of each block,
    which would leave conv3's gradients at exactly 0 on both routes)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, resnet_lib.BatchNorm):
                mod.weight.copy_(torch.rand(mod.weight.shape, generator=gen,
                                            device="cuda") + 0.5)


def phase_resnet_grad_parity() -> None:
    """One training step's loss, gradients and running statistics of
    ResNet-50 at full width in f32: ``bn="fused"`` (the kernel) against
    ``bn="flax"`` (cuDNN conv + the plain BatchNorm), same weights.

    The gradients of a random-init ResNet-50 at batch 8 are sensitive to
    f32 rounding: the plain route on the same batch in reverse order (the
    same function, its sums taken in another order) moves some tensors by
    a few percent.  So each tensor is held to the larger of
    RESNET_PARITY_RTOL and RESNET_NOISE_FACTOR times that measured noise
    floor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = RESNET_PARITY_BATCH
    cfg = get_config("imagenet_resnet50").with_overrides(
        compute_dtype="float32", augment="none")
    gen = torch.Generator(device="cuda").manual_seed(7)
    batch = {"image": torch.randn((b, 224, 224, 3), generator=gen,
                                  device="cuda") * 0.3 + 0.5,
             "label": torch.randint(0, 1000, (b,), generator=gen,
                                    device="cuda")}
    rev = {k: v.flip(0) for k, v in batch.items()}
    loss_fn = train_lib.make_loss_fn(cfg)
    out, state = {}, None
    reset_launches()
    for route, bn, data in (("plain", "flax", batch), ("kernel", "fused", batch),
                            ("plain reversed", "flax", rev)):
        model = get_model("resnet50", dtype="float32", device="cuda", seed=0,
                          num_classes=1000, bn=bn)
        if state is None:
            _random_bn_scales(model, 8)
            state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        loss, _ = loss_fn(model, data, 0)
        loss.backward()
        out[route] = (float(loss.detach()),
                      {n: p.grad for n, p in model.named_parameters()},
                      {n: v.clone() for n, v in model.named_buffers()})
        del model
    launches = fcb.LAUNCHES["fused_conv_bn_bwd"]

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    (lp, gp, sp), (lk, gk, sk), (_, gr, _) = (
        out["plain"], out["kernel"], out["plain reversed"])
    worst, noise, where, bad = 0.0, 0.0, "", []
    for name, g in gp.items():
        got, floor = rel(gk[name], g), rel(gr[name], g)
        noise = max(noise, floor)
        if got > worst:
            worst, where = got, name
        if got > max(RESNET_PARITY_RTOL, RESNET_NOISE_FACTOR * floor):
            bad.append(f"{name}: {got:.2e} (noise floor {floor:.2e})")
    stat = max(rel(sk[n], v) for n, v in sp.items())
    log(f"[resnet-grad-parity] ResNet-50 f32, B={b} 224x224: loss kernel "
        f"{lk:.6f} plain {lp:.6f}; worst per-tensor relative grad "
        f"difference {worst:.2e} ({where}), against a noise floor (plain "
        f"route, batch reversed) of up to {noise:.2e}; running stats "
        f"{stat:.2e}; fused_conv_bn_bwd launches {launches}")
    if abs(lk - lp) > RESNET_PARITY_RTOL * abs(lp):
        bad.append(f"loss {lk} vs {lp}")
    if stat > RESNET_PARITY_RTOL:
        bad.append(f"running stats {stat:.3e}")
    if launches != 36:
        bad.append(f"launches {launches} (want 36)")
    if bad:
        raise RuntimeError("ResNet gradient parity: " + "; ".join(bad[:8]))


def resnet_forward_flops(model, size: int = 224) -> int:
    """Forward FLOPs of one image: 2 x multiply-adds of every convolution
    and the Dense, counted from the outputs of one forward pass."""
    flops = []

    def conv_hook(mod, _inp, out):
        o, i, kh, kw = mod.weight.shape
        flops.append(2 * out[0].numel() * i * kh * kw)

    hooks = [m.register_forward_hook(conv_hook) for m in model.modules()
             if isinstance(m, resnet_lib.Conv)]
    try:
        with torch.no_grad():
            model(torch.zeros((1, size, size, 3), device="cuda"))
    finally:
        for h in hooks:
            h.remove()
    return sum(flops) + 2 * model.fc.weight.numel()


def phase_resnet_train() -> dict:
    """The ResNet slice: imagenet_resnet50 (bn="fused") through
    ``tpuframe_torch.train.main`` with the cuts of RESNET_CUTS, every
    kernel's launches read around it; then one more step of the same
    harness under the profiler."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    metrics = train_lib.main(RESNET_ARGS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    conv_routes = dict(fcb.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = metrics["losses"], metrics["step_ms"]
    steps = len(losses)
    want = {"flash_fwd": 0, "flash_bwd_delta": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "fused_conv_bn_bwd": 36 * steps,
            "precision_probe": 0}
    problems = []
    if not all(math.isfinite(x) for x in losses) or steps != 4:
        problems.append(f"losses {losses}")
    for key in ("eval_loss", "eval_accuracy", "eval_top5"):
        if not math.isfinite(metrics.get(key, float("nan"))):
            problems.append(f"no finite {key}")
    if launches != want:
        problems.append(f"launches {launches}, want {want} (the fused op "
                        f"once per Bottleneck 1x1 pair and step, none in "
                        f"eval)")
    want_routes = {"tensor_core": 36 * steps, "cuda_core": 0}
    if conv_routes != want_routes:
        problems.append(f"fused conv+BN launches by route {conv_routes}, "
                        f"want {want_routes}: every launch of the run on "
                        f"the tensor cores")
    if problems:
        raise RuntimeError("ResNet training: " + "; ".join(problems))
    p50 = statistics.median(step_ms[1:])
    cfg = get_config("imagenet_resnet50").with_overrides(**RESNET_CUTS)
    harness = train_lib.build_harness(cfg)
    fwd = resnet_forward_flops(harness.state.model)
    flops = 3 * fwd * RESNET_BATCH
    mfu = flops / (p50 / 1e3) / PEAK_OPS_S[torch.bfloat16]
    log(f"[resnet-train] imagenet_resnet50 bn=fused, batch {RESNET_BATCH}, "
        f"mesh 1, {steps} steps + 1 eval batch in {wall:.1f} s: losses "
        f"{[round(x, 4) for x in losses]}, eval loss "
        f"{metrics['eval_loss']:.4f} top5 {metrics['eval_top5']:.4f}; step "
        f"ms {[round(x, 1) for x in step_ms]} (p50 after the first "
        f"{p50:.1f}); {RESNET_BATCH / p50 * 1e3:.1f} images/s; model FLOPs "
        f"{flops:.3e} a step (3 x {fwd:.4e} a forward image), MFU "
        f"{mfu:.4f} of 989 TFLOP/s; peak memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}; fused conv+BN launches by route "
        f"{conv_routes}")

    batch = next(iter(harness.train_loader))
    step = lambda: float(harness.train_step(harness.state, batch)["loss"])  # noqa: E731
    wall_step = wall_ms(step, 1)
    kernels = device_time(step)
    busy, idle, text = _busy(kernels, wall_step)
    if kernels is not None:
        conv_bn = sum(ms for k, ms, _ in kernels
                      if re.search(r"\b(da|dw)(_tc)?_kernel|dw_reduce", k))
        text += f"; fused conv+BN kernels {conv_bn:.1f} ms"
    log(f"[profile] ResNet-50 training step: wall {wall_step:.1f} ms, "
        f"{text}; top: {_top(kernels, 10)}")
    return {"launches": launches, "step_ms_p50": p50, "mfu": mfu,
            "peak_bytes": peak, "routes": conv_routes, "device_ms": busy,
            "idle_share": idle, "losses": losses}


@contextlib.contextmanager
def _attn_impl(impl: str):
    """``TPUFRAME_ATTN_IMPL`` set to ``impl`` inside the block and
    restored (or removed) after it."""
    saved = os.environ.get("TPUFRAME_ATTN_IMPL")
    os.environ["TPUFRAME_ATTN_IMPL"] = impl
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("TPUFRAME_ATTN_IMPL", None)
        else:
            os.environ["TPUFRAME_ATTN_IMPL"] = saved


def _glue_batch(name: str, n: int, split: int = 0, device="cuda") -> dict:
    """The first ``n`` rows of a GLUE builder's synthetic split (0 train,
    1 eval) at BERT_SEQ, as device tensors."""
    ds = datasets.build(name, None, seq_len=BERT_SEQ)[split]
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in ds[np.arange(n)].items()}


def _bert_kernel_checks(gen) -> None:
    """The three flash kernels against their plain versions at BERT's
    shapes: key masks from glue_mnli's ragged pairs, not causal, bf16 (the
    tensor cores) and f32 (the CUDA cores), each case asserting its
    route."""
    b, n, d = BERT_PARITY_BATCH, 12, 64
    mask = _glue_batch("glue_mnli", b)["attention_mask"]
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((b, BERT_SEQ, n, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        name = f"BERT B={b} S={BERT_SEQ} {str(dtype)[6:]} key-masked full"
        fwd_err = _flash_check(name, q, k, v, mask, False)[2]
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        out, lse = fa.flash_fwd(q, k, v, mask=mask)
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1)
        bwd_errs, route = _bwd_check(
            name, (q, k, v, do, lse, delta.contiguous(), mask), False)
        errs[f"{str(dtype)[6:]} {route}"] = {"out": fwd_err, **bwd_errs}
    log(f"[bert-kernels] B={b} S={BERT_SEQ} N={n} D={d}, glue_mnli key "
        f"masks (lengths {mask.sum(1).tolist()}), not causal: max abs err "
        f"{errs} (tol fwd {TOL[torch.bfloat16]['out']} bf16 / "
        f"{TOL[torch.float32]['out']} f32; bwd {BWD_TOL} x max|plain|)")


def _bert_delta_case(b, glue, split, gen) -> dict:
    """The delta pass at BERT's shape (bf16, the key masks of a GLUE
    builder's split, not causal) against its plain version, timed beside
    its bound and the plain version."""
    n, d = 12, 64
    mask = _glue_batch(glue, b, split=split)["attention_mask"]
    q, k, v, do = (torch.randn((b, BERT_SEQ, n, d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    _, lse = fa.flash_fwd(q, k, v, mask=mask)
    args = (q, k, v, do, lse)
    call = lambda: fa._launch_bwd("delta", *args, None, mask,  # noqa: E731
                                  False)
    got = call()
    (want,) = _by_row(fa.flash_bwd_delta_reference, args, mask, False)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    name = f"BERT B={b} S={BERT_SEQ} bf16 {glue} key-masked full"
    if not (torch.isfinite(got).all() and err <= DELTA_TOL * scale):
        raise RuntimeError(f"delta pass {name}: max|diff| {err:.3e} vs tol "
                           f"{DELTA_TOL} x max|plain| {scale:.3e}")
    ms = cuda_ms(call, 100)
    dev = device_ms(call, 10)
    plain = cuda_ms(lambda: _by_row(fa.flash_bwd_delta_reference, args,
                                    mask, False), 3)
    ops = 4 * d * _pairs(BERT_SEQ, BERT_SEQ, b, n, mask, False)
    nbytes = 4 * q.numel() * 2 + 2 * lse.numel() * 4 + mask.numel() * 4
    t_ops, t_bytes = ops / PEAK_OPS_S[torch.bfloat16], nbytes / PEAK_BYTES_S
    case = {"case": name, "route": fa.bwd_route(q.dtype, d),
            "max_abs_err": err, "ms": ms, "device_ms": dev,
            "plain_ms": plain, "library_ms": None,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}
    share = ("" if dev is None
             else f"; {case['bound_ms'] / dev:.3f} of it by device time")
    log(f"[bert-delta] {name}, route {case['route']}: err {err:.2e} (tol "
        f"{DELTA_TOL} x max|plain| {scale:.2e}); kernel {ms:.4f} ms (device "
        f"{_dev(dev, '.4f')}), plain {plain:.4f} ms, bound "
        f"{case['bound_ms']:.5f} ms ({case['bound_by']}{share})")
    return case


def _bert_grads(dtype: str, impl: str, batch: dict):
    """One glue_bert_mnli training step's loss and gradients at full
    width, dropout 0, on ``impl``'s attention, from the seed-0 weights.
    ``float64`` (the einsum only) runs the model, its weights and its
    head in f64: the reference the f32 routes are held to."""
    cfg = get_config("glue_bert_mnli").with_overrides(
        compute_dtype=dtype, model_kwargs={"num_classes": 3, "dropout": 0.0})
    with _attn_impl(impl):
        model = get_model(cfg.model, dtype=dtype, device="cuda", seed=0,
                          **cfg.model_kwargs)
        if dtype == "float64":
            model.double()
            model.classifier.dtype = torch.float64
        loss, _ = train_lib.make_loss_fn(cfg)(model, batch, 0)
        loss.backward()
    grads = {n: p.grad.float() for n, p in model.named_parameters()}
    return float(loss.detach()), grads


def _grad_rel_err(got: dict, ref: dict) -> dict:
    """``{name: |got - ref| / |ref|}`` per tensor.  The key projections'
    biases have a gradient that is zero by symmetry (the bias adds q.b to
    every score of a row, which the softmax cancels), so theirs is
    measured against their layer's key-kernel gradient instead."""
    out = {}
    for name, r in ref.items():
        scale = r
        if name.endswith("attention.key.bias"):
            scale = ref[name.replace(".bias", ".weight")]
        out[name] = float((got[name] - r).norm()
                          / scale.norm().clamp_min(1e-30))
    return out


def phase_bert_parity() -> list:
    """BERT-base at full width with dropout 0: the kernels at BERT's
    shapes (the delta pass timed at B=8 and B=32, returned), then one GLUE
    step's loss and every parameter's gradient
    through the kernels against the einsum attention from the same
    weights: in f32 within GRAD_PARITY_RTOL of an f64 run of the einsum,
    in bf16 within BF16_NOISE_FACTOR times the bf16 einsum route's own
    error to the f32 einsum."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    _bert_kernel_checks(gen)
    delta_cases = [_bert_delta_case(BERT_PARITY_BATCH, "glue_mnli", 0, gen),
                   _bert_delta_case(BERT_BATCH, "glue_sst2", 1, gen)]
    batch = _glue_batch("glue_mnli", BERT_PARITY_BATCH)
    out, ran = {}, {}
    for route, impl, dtype in (("f64", "xla", "float64"),
                               ("kernels_f32", "pallas", "float32"),
                               ("f32", "xla", "float32"),
                               ("kernels", "pallas", "bfloat16"),
                               ("plain", "xla", "bfloat16")):
        reset_launches()
        out[route] = _bert_grads(dtype, impl, batch)
        torch.cuda.synchronize()
        ran[route] = {**launch_counts(), "fwd": dict(fa.FWD_ROUTES),
                      "bwd": dict(fa.BWD_ROUTES), "impls": dict(attn.IMPLS)}
    bad = []
    L = BERT_LAYERS
    for route, core in (("kernels_f32", "cuda_core"),
                        ("kernels", "tensor_core")):
        r = ran[route]
        want = {"flash_fwd": L, "flash_bwd_delta": L, "flash_bwd_dq": L,
                "flash_bwd_dkv": L}
        got = {k: r[k] for k in want}
        if (got != want or r["fwd"][core] != L or r["bwd"][core] != 3 * L
                or r["impls"] != {"pallas": L, "xla": 0, "xla_dropout": 0}):
            bad.append(f"{route}: launches {got}, forward routes "
                       f"{r['fwd']}, backward routes {r['bwd']}, attention "
                       f"paths {r['impls']}; want {L} of each kernel a step "
                       f"on the {core} route")
    for route in ("f64", "f32", "plain"):
        if ran[route]["impls"] != {"pallas": 0, "xla": L, "xla_dropout": 0}:
            bad.append(f"{route}: attention paths {ran[route]['impls']}")

    (l64, g64), (lk32, gk32), (l32, g32) = (out["f64"], out["kernels_f32"],
                                            out["f32"])
    relk32, relx32 = _grad_rel_err(gk32, g64), _grad_rel_err(g32, g64)
    where32 = max(relk32, key=relk32.get)
    direct32 = _grad_rel_err(gk32, g32)
    for name in relk32:
        if relk32[name] > GRAD_PARITY_RTOL:
            bad.append(f"f32 {name}: {relk32[name]:.2e} off f64 (f32 einsum "
                       f"{relx32[name]:.2e})")
    if abs(lk32 - l64) > GRAD_PARITY_RTOL * abs(l64):
        bad.append(f"f32 loss {lk32} vs f64 {l64}")
    (lk, gk), (lx, gx) = out["kernels"], out["plain"]
    relk, relx = _grad_rel_err(gk, g32), _grad_rel_err(gx, g32)
    where = max(relk, key=relk.get)
    for name in relk:
        if relk[name] > BF16_NOISE_FACTOR * relx[name]:
            bad.append(f"bf16 {name}: {relk[name]:.2e} (noise floor "
                       f"{relx[name]:.2e})")
    if abs(lk - l32) > max(BF16_NOISE_FACTOR * abs(lx - l32),
                           1e-3 * abs(l32)):
        bad.append(f"bf16 loss {lk} vs f32 {l32} (einsum bf16 {lx})")
    log(f"[bert-parity] BERT-base full width, dropout 0, glue_mnli B="
        f"{BERT_PARITY_BATCH} S={BERT_SEQ}: loss f64 {l64:.8f}, f32 kernels "
        f"{lk32:.8f} einsum {l32:.8f}; f32 per-tensor relative grad error "
        f"vs f64: kernels worst {relk32[where32]:.2e} ({where32}; tol "
        f"{GRAD_PARITY_RTOL}), einsum up to {max(relx32.values()):.2e}; "
        f"kernels vs einsum f32 up to {max(direct32.values()):.2e}; bf16 "
        f"loss kernels {lk:.6f} einsum {lx:.6f}, per-tensor relative grad "
        f"error vs f32: kernels worst {relk[where]:.2e} ({where}), einsum "
        f"bf16 up to {max(relx.values()):.2e}, largest ratio "
        f"{max(relk[n] / max(relx[n], 1e-30) for n in relk):.2f} (tol "
        f"{BF16_NOISE_FACTOR}); launches a step: f32 {ran['kernels_f32']}, "
        f"bf16 {ran['kernels']}")
    if bad:
        raise RuntimeError("BERT gradient parity: " + "; ".join(bad[:8]))
    return delta_cases


def _flash_bert_eval_case(gen) -> dict:
    """The forward kernel at glue_bert's eval shape (B=32, S=128, N=12,
    D=64, bf16, key masks of glue_sst2's eval split, not causal) against
    its plain version, timed beside its bound, the plain version and SDPA
    with the same boolean mask."""
    b, s, n, d = BERT_BATCH, BERT_SEQ, 12, 64
    mask = _glue_batch("glue_sst2", b, split=1)["attention_mask"]
    q, k, v = (torch.randn((b, s, n, d), generator=gen,
                           device="cuda").to(torch.bfloat16)
               for _ in range(3))
    name = f"BERT eval B={b} S={s} bf16 key-masked full"
    out, lse, err, err_lse = _flash_check(name, q, k, v, mask, False)
    call = lambda: fa.flash_mha_lse(q, k, v, mask=mask)  # noqa: E731
    ms = cuda_ms(call, 100)
    dev_ms = device_ms(call, 10)
    plain_ms = cuda_ms(lambda: fa.flash_mha_reference(q, k, v, mask=mask),
                       10)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bool_mask = mask.bool()[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=bool_mask)
    lib_ms = cuda_ms(sdpa, 100)
    lib_dev = device_ms(sdpa, 10)
    ops = 4 * d * _pairs(s, s, b, n, mask, False)
    nbytes = (4 * q.numel() * 2 + lse.numel() * 4 + mask.numel() * 4)
    t_ops, t_bytes = ops / PEAK_OPS_S[torch.bfloat16], nbytes / PEAK_BYTES_S
    case = {"case": name, "route": fa.fwd_route(q.dtype, d),
            "max_abs_err": err, "max_abs_err_lse": err_lse, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_device_ms": lib_dev,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}
    log(f"[flash] {name}, route {case['route']}: err {err:.2e}, lse err "
        f"{err_lse:.2e}; kernel {ms:.4f} ms (device {_dev(dev_ms, '.4f')}, "
        f"{ops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f} ms, sdpa "
        f"(same boolean mask) {lib_ms:.4f} ms (device "
        f"{_dev(lib_dev, '.4f')}), bound "
        f"{case['bound_ms']:.5f} ms ({case['bound_by']})")
    return case


def phase_bert_serve() -> dict:
    """BertClassifier at full width in bf16 over buckets 64 and 128:
    16 requests of lengths 8-128 from a seed, each held to a classifier
    on the einsum path with the same weights and timed with a sync; the
    forward kernel launched 12 times a request on the tensor cores.  Then
    the forward kernel at glue_bert's eval shape."""
    cfg = BertConfig(dtype="bfloat16")
    clf = BertClassifier(cfg, buckets=BERT_BUCKETS, seed=0)
    weights = {k: v.float() for k, v in clf.model.state_dict().items()}
    plain = BertClassifier(cfg, weights, buckets=BERT_BUCKETS)
    rng = np.random.default_rng(0)
    reqs = [rng.integers(1000, cfg.vocab_size, int(n)).tolist()
            for n in rng.integers(8, 129, BERT_SERVE_REQUESTS)]
    with _attn_impl("pallas"):
        for b in BERT_BUCKETS:            # warm-up, outside the counts
            clf.classify(reqs[0][:1] * b)
        torch.cuda.synchronize()
        reset_launches()
        got, req_ms = [], []
        for ids in reqs:
            t0 = time.perf_counter()
            got.append(clf.classify(ids))
            torch.cuda.synchronize()
            req_ms.append(1e3 * (time.perf_counter() - t0))
        launches = launch_counts()
        routes = dict(fa.FWD_ROUTES)
        impls = dict(attn.IMPLS)
    with _attn_impl("xla"):
        want = [plain.classify(ids) for ids in reqs]
    hit = sorted({kv.bucket_for(len(r), BERT_BUCKETS) for r in reqs})
    diff = max(float(np.abs(g[1] - w[1]).max()) for g, w in zip(got, want))
    agree = sum(g[0] == w[0] for g, w in zip(got, want))
    n_fwd = BERT_LAYERS * len(reqs)
    problems = []
    if hit != list(BERT_BUCKETS):
        problems.append(f"buckets hit {hit}")
    if not diff <= BERT_SERVE_ATOL or not all(
            np.isfinite(g[1]).all() and abs(g[1].sum() - 1) < 1e-5
            for g in got):
        problems.append(f"max |probs diff| {diff:.3e} (atol "
                        f"{BERT_SERVE_ATOL}) or probabilities that do not "
                        f"sum to 1")
    if launches["flash_fwd"] != n_fwd or routes != {
            "tensor_core": n_fwd, "cuda_core": 0}:
        problems.append(f"flash_fwd launches {launches['flash_fwd']} by "
                        f"route {routes}, want {n_fwd} on the tensor cores")
    if impls != {"pallas": n_fwd, "xla": 0, "xla_dropout": 0}:
        problems.append(f"attention paths {impls}, want every call on the "
                        f"kernel")
    if problems:
        raise RuntimeError("BERT serving: " + "; ".join(problems))
    log(f"[bert-serve] BertClassifier BERT-base bf16, {len(reqs)} requests "
        f"(lengths {[len(r) for r in reqs]}) over buckets {hit}: request "
        f"ms p50 {_pct(req_ms, .5):.3f} p90 {_pct(req_ms, .9):.3f} (min "
        f"{min(req_ms):.3f} max {max(req_ms):.3f}); probs vs the einsum "
        f"path max |diff| {diff:.2e} (atol {BERT_SERVE_ATOL}), labels agree "
        f"{agree}/{len(reqs)}; flash_fwd launches {launches['flash_fwd']} "
        f"by route {routes}; attention paths {impls}")
    with _attn_impl("pallas"):
        ids = reqs[0]
        profile_window("BERT request (bucket 64)",
                       lambda: clf.classify(ids[:60]),
                       wall_ms(lambda: clf.classify(ids[:60]), 10))
    eval_case = _flash_bert_eval_case(
        torch.Generator(device="cuda").manual_seed(7))
    return {"launches": launches, "routes": routes,
            "p50_ms": _pct(req_ms, .5), "p90_ms": _pct(req_ms, .9),
            "eval_case": eval_case}


def _bert_train_flops(harness, steps: int) -> float:
    """Model FLOPs of an average step of the first ``steps`` batches:
    6 x (encoder matmul params) x tokens, the pooler and classifier on one
    row per example, and 3 x 4 x D x (kept query-key pairs) x N x L for
    attention."""
    cfg = harness.state.model.cfg
    h, inter, n, d = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                      cfg.head_dim)
    enc = cfg.num_layers * (4 * h * h + 2 * h * inter)
    head = h * h + h * cfg.num_classes
    pairs = []
    for i, batch in enumerate(harness.train_loader.from_step(0)):
        if i >= steps:
            break
        pairs.append(BERT_SEQ * int(batch["attention_mask"].sum()))
    return (6 * enc * BERT_BATCH * BERT_SEQ + 6 * head * BERT_BATCH
            + 3 * 4 * d * statistics.mean(pairs) * n * cfg.num_layers)


def phase_bert_train() -> dict:
    """glue_bert through ``tpuframe_torch.train.main`` at its own recipe
    (BERT_CUTS), kernels and attention paths read around it: the training
    forwards drop attention probabilities on the einsum (12 a step, no
    kernel), each eval batch runs the forward kernel 12 times on the
    tensor cores.  Then one more step under the profiler, and
    glue_bert_stsb and glue_bert_cola end to end."""
    steps, evals = BERT_CUTS["total_steps"], BERT_CUTS["eval_batches"]
    L = BERT_LAYERS
    with _attn_impl("pallas"):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.monotonic()
        metrics = train_lib.main(BERT_ARGS)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = launch_counts()
        routes = dict(fa.FWD_ROUTES)
        impls = dict(attn.IMPLS)
        peak = torch.cuda.max_memory_allocated()
    losses, step_ms = metrics["losses"], metrics["step_ms"]
    want = {"flash_fwd": evals * L, "flash_bwd_delta": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "fused_conv_bn_bwd": 0,
            "precision_probe": 0}
    problems = []
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        problems.append(f"losses {losses}")
    for key in ("eval_loss", "eval_accuracy"):
        if not math.isfinite(metrics.get(key, float("nan"))):
            problems.append(f"no finite {key}")
    if launches != want or routes != {"tensor_core": evals * L,
                                      "cuda_core": 0}:
        problems.append(f"launches {launches} by route {routes}, want "
                        f"{want} (the forward kernel once per layer and "
                        f"eval batch, on the tensor cores; no kernel in "
                        f"training, whose dropout runs on the einsum)")
    want_impls = {"pallas": evals * L, "xla": 0, "xla_dropout": steps * L}
    if impls != want_impls:
        problems.append(f"attention paths {impls}, want {want_impls}")
    if problems:
        raise RuntimeError("BERT training: " + "; ".join(problems))
    p50 = statistics.median(step_ms[1:])
    cfg = get_config("glue_bert").with_overrides(**BERT_CUTS)
    with _attn_impl("pallas"):
        harness = train_lib.build_harness(cfg)
    flops = _bert_train_flops(harness, steps)
    mfu = flops / (p50 / 1e3) / PEAK_OPS_S[torch.bfloat16]
    n_params = sum(p.numel() for p in harness.state.model.parameters())
    log(f"[bert-train] glue_bert ({n_params / 1e6:.2f} M params), batch "
        f"{BERT_BATCH} x {BERT_SEQ}, mesh 1, {steps} steps + {evals} eval "
        f"batches in {wall:.1f} s: losses {[round(x, 4) for x in losses]}, "
        f"eval loss {metrics['eval_loss']:.4f} accuracy "
        f"{metrics['eval_accuracy']:.4f}; step ms "
        f"{[round(x, 2) for x in step_ms]} (p50 after the first "
        f"{p50:.2f}); {BERT_BATCH / p50 * 1e3:.1f} examples/s; model FLOPs "
        f"{flops:.3e} a step, MFU {mfu:.4f} of 989 TFLOP/s; peak memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}; forward launches by "
        f"route {routes}; attention paths {impls}")

    with _attn_impl("pallas"):
        batch = next(iter(harness.train_loader))
        step = lambda: float(  # noqa: E731
            harness.train_step(harness.state, batch)["loss"])
        wall_step = wall_ms(step, 3)
        kernels = device_time(step)
    busy, idle, text = _busy(kernels, wall_step)
    log(f"[profile] glue_bert training step: wall {wall_step:.2f} ms, "
        f"{text}; top: {_top(kernels, 8)}")
    del harness

    tasks = {}
    for name in ("glue_bert_stsb", "glue_bert_cola"):
        args = ["--config", name] + [
            a for k, v in BERT_TASK_CUTS.items()
            for a in ("--set", f"{k}={v!r}")]
        with _attn_impl("pallas"):
            m = train_lib.main(args)
        shown = {k: v for k, v in m.items() if k.startswith("eval_")}
        if not (all(math.isfinite(x) for x in m["losses"])
                and len(m["losses"]) == BERT_TASK_CUTS["total_steps"]
                and shown and all(math.isfinite(v) for v in shown.values())):
            raise RuntimeError(f"{name}: losses {m['losses']}, eval {shown}")
        if name == "glue_bert_stsb" and "eval_pearson" not in shown:
            raise RuntimeError(f"{name}: no eval_pearson in {shown}")
        tasks[name] = shown
        log(f"[bert-train] {name}, {len(m['losses'])} steps + 1 eval batch: "
            f"losses {[round(x, 4) for x in m['losses']]}, eval {shown}")
    return {"launches": launches, "routes": routes, "step_ms_p50": p50,
            "mfu": mfu, "peak_bytes": peak, "device_ms": busy,
            "idle_share": idle, "tasks": tasks}


def _no_kernel_launches(launches: dict, what: str) -> None:
    if any(launches.values()):
        raise RuntimeError(f"{what}: launches {launches}, want none (no "
                           f"hand-written kernel on this path)")


def _profile_steps(harness, calls: int):
    """``calls`` more training steps of ``harness`` on one batch: wall ms
    a step, the kernels (largest first; None when the profiler's record
    is incomplete) and :func:`_busy`'s ``(device ms a step, idle share,
    log text)``."""
    batch = next(iter(harness.train_loader))
    step = lambda: float(harness.train_step(harness.state, batch)["loss"])  # noqa: E731
    wall_step = wall_ms(step, calls)

    def window():
        for _ in range(calls):
            step()

    kernels = device_time(window)
    return wall_step, kernels, _busy(kernels, wall_step, calls)


def phase_mnist_train() -> dict:
    """mnist_single through ``tpuframe_torch.train.main`` (MNIST_CUTS):
    the eval accuracy must rise on the learnable synthetic data, and no
    hand-written kernel runs.  First the ConvNet on the card against the
    same weights on the CPU; after, 20 more steps under the profiler."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = torch.rand((MNIST_BATCH, 28, 28, 1),
                   generator=torch.Generator().manual_seed(3))
    card = get_model("convnet", dtype="float32", device="cuda", seed=0)
    cpu = get_model("convnet", dtype="float32", device="cpu", seed=0)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    with torch.no_grad():
        err = float((card(x.cuda()).cpu() - cpu(x)).abs().max())
    n_params = sum(p.numel() for p in cpu.parameters())
    log(f"[mnist-train] ConvNet logits, card vs CPU (f32, eval): max |diff| "
        f"{err:.3e} (tolerance {MNIST_CPU_ATOL:g})")
    if not err <= MNIST_CPU_ATOL:
        raise RuntimeError(f"ConvNet card vs CPU: {err} > {MNIST_CPU_ATOL}")
    del card, cpu

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    metrics = train_lib.main(MNIST_ARGS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = metrics["losses"], metrics["step_ms"]
    steps = MNIST_CUTS["total_steps"]
    _no_kernel_launches(launches, "mnist_single")
    acc = metrics.get("eval_accuracy", float("nan"))
    if (len(losses) != steps or not all(math.isfinite(v) for v in losses)
            or not acc >= MNIST_MIN_ACCURACY
            or not np.mean(losses[-10:]) < np.mean(losses[:10])):
        raise RuntimeError(f"mnist_single: losses {losses[:3]}..."
                           f"{losses[-3:]}, eval accuracy {acc} (want >= "
                           f"{MNIST_MIN_ACCURACY})")
    p50 = statistics.median(step_ms[1:])
    log(f"[mnist-train] mnist_single (ConvNet, {n_params / 1e6:.2f} M "
        f"params), batch "
        f"{MNIST_BATCH}, f32, {steps} steps + 1 eval pass in {wall:.1f} s: "
        f"loss {np.mean(losses[:10]):.4f} (first 10) -> "
        f"{np.mean(losses[-10:]):.4f} (last 10), final {losses[-1]:.4f}; "
        f"eval loss {metrics['eval_loss']:.4f} accuracy {acc:.4f}; step ms "
        f"p50 {p50:.3f} (after the first; first {step_ms[0]:.1f}); "
        f"{MNIST_BATCH / p50 * 1e3:.1f} images/s; peak memory "
        f"{peak / 2**30:.3f} GiB")
    cfg = get_config("mnist_single").with_overrides(**MNIST_CUTS)
    wall_step, kernels, (busy, idle, text) = _profile_steps(
        train_lib.build_harness(cfg), 20)
    log(f"[profile] mnist_single training step (20 steps): wall "
        f"{wall_step:.3f} ms a step, {text}; top: {_top(kernels, 6, 20)}")
    return {"launches": launches, "step_ms_p50": p50, "peak_bytes": peak,
            "device_ms": busy, "idle_share": idle, "eval_accuracy": acc}


def _f32_conv_precision(tf32: bool) -> float:
    """Max relative error against f64 of a 3x3 conv at ResNet-18's first
    stage (batch 256, 64 -> 64 channels, 32x32), with cuDNN's TF32 flag
    set to ``tf32`` for the call and restored after."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((CIFAR_BATCH, 64, 32, 32), generator=gen, device="cuda")
    w = torch.randn((64, 64, 3, 3), generator=gen, device="cuda") / 24
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        y = F.conv2d(x, w, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    ref = F.conv2d(x.double(), w.double(), padding=1)
    return float((y.double() - ref).abs().max() / ref.abs().max())


def phase_cifar_train() -> dict:
    """cifar10_resnet18 through ``tpuframe_torch.train.main`` (CIFAR_CUTS):
    finite losses and eval, no hand-written kernel; step time, images/s,
    MFU against the f32 peak, peak memory, the precision the f32
    convolutions ran in, then one more step under the profiler."""
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    metrics = train_lib.main(CIFAR_ARGS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = metrics["losses"], metrics["step_ms"]
    steps = CIFAR_CUTS["total_steps"]
    _no_kernel_launches(launches, "cifar10_resnet18")
    if (len(losses) != steps or not all(math.isfinite(v) for v in losses)
            or not all(math.isfinite(metrics.get(k, float("nan")))
                       for k in ("eval_loss", "eval_accuracy"))):
        raise RuntimeError(f"cifar10_resnet18: losses {losses}, metrics "
                           f"{metrics}")
    tf32_flag = torch.backends.cudnn.allow_tf32
    off, on = _f32_conv_precision(tf32_flag), _f32_conv_precision(True)
    if tf32_flag or not off <= F32_CONV_MAX_REL:
        raise RuntimeError(f"f32 convolutions: cudnn.allow_tf32 "
                           f"{tf32_flag} after the harness, max relative "
                           f"error to f64 {off:.2e} (want f32: <= "
                           f"{F32_CONV_MAX_REL:g})")
    p50 = statistics.median(step_ms[1:])
    cfg = get_config("cifar10_resnet18").with_overrides(**CIFAR_CUTS)
    harness = train_lib.build_harness(cfg)
    fwd = resnet_forward_flops(harness.state.model, 32)
    flops = 3 * fwd * CIFAR_BATCH
    mfu = flops / (p50 / 1e3) / PEAK_OPS_S[torch.float32]
    n_params = sum(p.numel() for p in harness.state.model.parameters())
    log(f"[cifar-train] cifar10_resnet18 (ResNet-18, CIFAR stem, "
        f"{n_params / 1e6:.2f} M params), batch {CIFAR_BATCH}, f32, u8 "
        f"synthetic + pad_crop_flip "
        f"on the card, {steps} steps + 1 eval batch in {wall:.1f} s: losses "
        f"{[round(v, 4) for v in losses[:3]]}..."
        f"{[round(v, 4) for v in losses[-3:]]}, "
        f"eval loss {metrics['eval_loss']:.4f} accuracy "
        f"{metrics['eval_accuracy']:.4f}; step ms p50 {p50:.2f} (after the "
        f"first; first {step_ms[0]:.1f}); {CIFAR_BATCH / p50 * 1e3:.1f} "
        f"images/s; model FLOPs {flops:.3e} a step (3 x {fwd:.4e} a forward "
        f"image), MFU {mfu:.4f} of the 67 TFLOP/s f32 peak; peak memory "
        f"{peak / 2**30:.2f} GiB; f32 convolutions in f32 (cudnn.allow_tf32 "
        f"{tf32_flag}): max relative error to f64 {off:.2e}, against "
        f"{on:.2e} with TF32 on")
    wall_step, kernels, (busy, idle, text) = _profile_steps(harness, 1)
    log(f"[profile] cifar10_resnet18 training step: wall {wall_step:.2f} ms,"
        f" {text}; top: {_top(kernels, 8)}")
    return {"launches": launches, "step_ms_p50": p50, "mfu": mfu,
            "peak_bytes": peak, "device_ms": busy,
            "idle_share": idle, "conv_rel_err": off,
            "conv_rel_err_tf32": on}


def _resnet50_f32_step(state, batch, **kwargs):
    """One ResNet-50 f32 training forward and backward from ``state``:
    ``(loss, logits, grads, buffers)``."""
    cfg = get_config("imagenet_resnet50").with_overrides(
        compute_dtype="float32", augment="none")
    model = get_model("resnet50", dtype="float32", device="cuda", seed=0,
                      num_classes=1000, **kwargs)
    model.load_state_dict(state)
    out = []
    hook = model.register_forward_hook(lambda m, i, o: out.append(o.detach()))
    loss, _ = train_lib.make_loss_fn(cfg)(model, batch, 0)
    loss.backward()
    hook.remove()
    return (float(loss.detach()), out[0],
            {n: p.grad for n, p in model.named_parameters()},
            {n: v.clone() for n, v in model.named_buffers()})


def _variant_parity() -> list:
    """bn="folded", the s2d stem and remat=True against the bn="flax" 7x7
    ResNet-50 from the same weights, f32, batch RESNET_PARITY_BATCH, each
    held as RESNET_PARITY_RTOL's comment says."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b = RESNET_PARITY_BATCH
    gen = torch.Generator(device="cuda").manual_seed(17)
    batch = {"image": torch.randn((b, 224, 224, 3), generator=gen,
                                  device="cuda") * 0.3 + 0.5,
             "label": torch.randint(0, 1000, (b,), generator=gen,
                                    device="cuda")}
    rev = {k: v.flip(0) for k, v in batch.items()}
    model = get_model("resnet50", dtype="float32", device="cuda", seed=1,
                      num_classes=1000)
    _random_bn_scales(model, 9)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    del model
    s2d_state = dict(state, **{"conv1.weight": resnet_lib.s2d_stem_kernel(
        state["conv1.weight"])})

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    lp, logits, gp, sp = _resnet50_f32_step(state, batch)
    _, logits_r, gr, _ = _resnet50_f32_step(state, rev)
    floor_logits = rel(logits_r.flip(0), logits)
    results, bad = [], []
    for name, st, kwargs in (("folded", state, {"bn": "folded"}),
                             ("s2d", s2d_state, {"stem": "space_to_depth"}),
                             ("remat", state, {"remat": True})):
        lk, logits_k, gk, sk = _resnet50_f32_step(st, batch, **kwargs)
        row = {"option": name, "loss": lk, "loss_ref": lp}
        if name == "s2d":
            got = rel(logits_k, logits)
            tol = max(RESNET_PARITY_RTOL, RESNET_NOISE_FACTOR * floor_logits)
            row.update(logits_rel=got, noise_floor=floor_logits, tol=tol)
            if got > tol:
                bad.append(f"s2d logits {got:.2e} > {tol:.2e}")
            log(f"[resnet-variants] s2d stem vs 7x7 stem (s2d_stem_kernel "
                f"weights), f32 B={b}: logits relative difference "
                f"{got:.2e}, tolerance {tol:.2e} (noise floor "
                f"{floor_logits:.2e})")
            results.append(row)
            continue
        worst, where, noise = 0.0, "", 0.0
        for n, g in gp.items():
            got, floor = rel(gk[n], g), rel(gr[n], g)
            noise = max(noise, floor)
            if got > worst:
                worst, where = got, n
            if got > max(RESNET_PARITY_RTOL, RESNET_NOISE_FACTOR * floor):
                bad.append(f"{name} {n}: {got:.2e} (noise floor {floor:.2e})")
        stat = max(rel(sk[n], v) for n, v in sp.items())
        if abs(lk - lp) > RESNET_PARITY_RTOL * abs(lp):
            bad.append(f"{name} loss {lk} vs {lp}")
        if stat > RESNET_PARITY_RTOL:
            bad.append(f"{name} running stats {stat:.3e}")
        row.update(worst_grad_rel=worst, worst_grad=where, noise_floor=noise,
                   stats_rel=stat, tol=RESNET_PARITY_RTOL,
                   noise_factor=RESNET_NOISE_FACTOR)
        results.append(row)
        log(f"[resnet-variants] {name} vs flax, f32 B={b}: loss {lk:.6f} vs "
            f"{lp:.6f}; worst per-tensor relative grad difference "
            f"{worst:.2e} ({where}), tolerance max({RESNET_PARITY_RTOL:g}, "
            f"{RESNET_NOISE_FACTOR:g} x its noise floor; floors up to "
            f"{noise:.2e}); running stats {stat:.2e} (tolerance "
            f"{RESNET_PARITY_RTOL:g})")
    if bad:
        raise RuntimeError("ResNet-50 option parity: " + "; ".join(bad[:8]))
    return results


def phase_resnet_variants(baseline: dict | None = None) -> dict:
    """The ResNet-50 options against bn="flax" (:func:`_variant_parity`),
    then imagenet_resnet50 with bn "fused", the s2d stem, remat and lars
    (VARIANT_CUTS) through ``tpuframe_torch.train.main``: every fused
    conv+BN launch on the tensor cores, once per pair and step under
    remat, and a lower peak memory than phase 12's run without remat
    (``baseline``; run here when not given)."""
    parity = _variant_parity()
    if baseline is None:
        baseline = phase_resnet_train()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.monotonic()
    metrics = train_lib.main(VARIANT_ARGS)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    conv_routes = dict(fcb.ROUTES)
    peak = torch.cuda.max_memory_allocated()
    losses, step_ms = metrics["losses"], metrics["step_ms"]
    steps = len(losses)
    want = {"flash_fwd": 0, "flash_bwd_delta": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "fused_conv_bn_bwd": 36 * steps,
            "precision_probe": 0}
    problems = []
    if not all(math.isfinite(v) for v in losses) or steps != VARIANT_STEPS:
        problems.append(f"losses {losses}")
    for key in ("eval_loss", "eval_accuracy", "eval_top5"):
        if not math.isfinite(metrics.get(key, float("nan"))):
            problems.append(f"no finite {key}")
    if launches != want:
        problems.append(f"launches {launches}, want {want} (the fused op's "
                        f"backward once per 1x1 pair and step under remat)")
    if conv_routes != {"tensor_core": 36 * steps, "cuda_core": 0}:
        problems.append(f"fused conv+BN launches by route {conv_routes}: "
                        f"want all {36 * steps} on the tensor cores")
    if not peak < baseline["peak_bytes"]:
        problems.append(f"peak memory {peak / 2**30:.2f} GiB with remat, "
                        f"not below {baseline['peak_bytes'] / 2**30:.2f} "
                        f"GiB without")
    if problems:
        raise RuntimeError("ResNet-50 variant training: "
                           + "; ".join(problems))
    p50 = statistics.median(step_ms[1:])
    log(f"[resnet-variants] imagenet_resnet50 bn=fused + space_to_depth + "
        f"remat + lars, batch {RESNET_BATCH} bf16, {steps} steps + 1 eval "
        f"batch in {wall:.1f} s: losses {[round(v, 4) for v in losses]}, "
        f"eval loss {metrics['eval_loss']:.4f}; step ms "
        f"{[round(v, 1) for v in step_ms]} (p50 after the first {p50:.1f}; "
        f"phase 12 without remat {baseline['step_ms_p50']:.1f}); peak memory "
        f"{peak / 2**30:.2f} GiB (phase 12 without remat "
        f"{baseline['peak_bytes'] / 2**30:.2f}); launches {launches}; fused "
        f"conv+BN launches by route {conv_routes}")
    return {"launches": launches, "routes": conv_routes, "step_ms_p50": p50,
            "peak_bytes": peak, "baseline_step_ms_p50": baseline["step_ms_p50"],
            "baseline_peak_bytes": baseline["peak_bytes"], "parity": parity}


def _host_copy(tree) -> dict:
    """A blocking host copy of every tensor of ``tree`` (and its numbers)."""
    return {n: t.detach().cpu().clone() if isinstance(t, torch.Tensor)
            else t for n, t in ckpt_mod._flatten(tree)}


def _diff_leaves(got: dict, want: dict) -> list:
    """Leaf names whose values are not bit-equal (or missing)."""
    bad = [n for n in want if n not in got]
    for n, w in want.items():
        g = got.get(n)
        if g is None:
            continue
        if isinstance(w, torch.Tensor):
            g = torch.as_tensor(g)
            if g.dtype != w.dtype or not torch.equal(g.cpu(), w.cpu()):
                bad.append(n)
        elif int(g) != int(w):
            bad.append(n)
    return bad


def _dir_bytes(path: str) -> int:
    return sum(f.stat().st_size for f in Path(path).iterdir())


def _harness_steps(h, n: int) -> list:
    """``n`` training steps of a harness, as ``train_lib.train`` takes
    them: the loader from the state's step, host ms to the loss read."""
    it = h.train_loader.from_step(h.state.step)
    out = []
    for _ in range(n):
        batch = next(it)
        t0 = time.perf_counter()
        loss = float(h.train_step(h.state, batch)["loss"])
        out.append((loss, 1e3 * (time.perf_counter() - t0)))
    return out


def _ckpt_lm(root: str, before_sigterm) -> dict:
    """lm_long: a straight run, the same run preempted at step 3 by the
    host:sigterm seam, its resume, then the snapshot and corruption
    checks on a harness of its own (see phase_ckpt)."""
    cfg = get_config("lm_long").with_overrides(**CKPT_LM_CUTS)
    layers = 12
    # 1. straight: 6 steps; its final state is saved (sync) at step 6
    dir_a = os.path.join(root, "straight")
    straight = train_lib.train(cfg.with_overrides(
        ckpt_dir=dir_a, ckpt_every=1000, ckpt_async=False))
    disk = _dir_bytes(os.path.join(dir_a, f"step_{CKPT_STEPS:08d}"))
    want6 = dict(ckpt_mod._flatten(ckpt.restore(dir_a, CKPT_STEPS)))
    n_params = sum(t.numel() for n, t in want6.items()
                   if n.startswith("model/"))
    shutil.rmtree(dir_a)

    # 2. preempted at step 3: async saves at 2, the preemption save at 3
    dir_b = os.path.join(root, "preempted")
    run = cfg.with_overrides(ckpt_dir=dir_b)
    os.environ["TPUFRAME_FAULTS"] = (f"host:step={CKPT_PREEMPT_STEP}:"
                                     f"kind=sigterm")
    try:
        train_lib.train(run)
    except SystemExit as e:
        if e.code != 14:
            raise
    else:
        raise RuntimeError("ckpt: the host:sigterm fault did not preempt")
    finally:
        del os.environ["TPUFRAME_FAULTS"]
    problems = []
    if signal.getsignal(signal.SIGTERM) is not before_sigterm:
        problems.append("the preemption guard is still installed")
    committed = sorted(p.name for p in Path(dir_b).iterdir()
                       if (p / "COMMIT").exists())
    if committed != ["step_00000002", "step_00000003"]:
        problems.append(f"committed {committed}, want steps 2 and 3")
    if ckpt.latest_step(dir_b) != CKPT_PREEMPT_STEP:
        problems.append(f"latest_step {ckpt.latest_step(dir_b)}")
    world = ckpt.committed_world(dir_b)
    if world != {"step": 3, "processes": 1, "devices": 1}:
        problems.append(f"committed_world {world}")

    # 3. resume to step 6, the flash kernels' launches read around it
    reset_launches()
    resumed = train_lib.train(run)
    launches = launch_counts()
    fwd_routes, bwd_routes = dict(fa.FWD_ROUTES), dict(fa.BWD_ROUTES)
    steps = CKPT_STEPS - CKPT_PREEMPT_STEP
    if resumed["losses"] != straight["losses"][CKPT_PREEMPT_STEP:]:
        problems.append(f"resumed losses {resumed['losses']} != straight "
                        f"{straight['losses'][CKPT_PREEMPT_STEP:]}")
    bad = _diff_leaves(dict(ckpt_mod._flatten(ckpt.restore(
        dir_b, CKPT_STEPS))), want6)
    if bad:
        problems.append(f"state at step 6, resumed vs straight: {len(bad)} "
                        f"leaves differ, first {bad[:4]}")
    del want6
    shutil.rmtree(dir_b)
    # 4. every resumed launch on the tensor cores
    want = {"flash_fwd": (2 * steps + 1) * layers,
            "flash_bwd_delta": steps * layers,
            "flash_bwd_dq": steps * layers, "flash_bwd_dkv": steps * layers,
            "fused_conv_bn_bwd": 0, "precision_probe": 0}
    if launches != want:
        problems.append(f"resumed launches {launches}, want {want}")
    if (fwd_routes != {"tensor_core": want["flash_fwd"], "cuda_core": 0}
            or bwd_routes != {"tensor_core": 3 * steps * layers,
                              "cuda_core": 0}):
        problems.append(f"resumed routes: forward {fwd_routes}, backward "
                        f"{bwd_routes}, want every launch on the tensor "
                        f"cores")

    # 5. the snapshot: an async save at step 1, then at once an optimizer
    # update in place (step 1's gradients again: the earliest the next
    # step writes the state, while the ~30 ms of copies are in flight) and
    # step 2; step 1 restored must equal a blocking copy taken at step 1.
    # Then step time with a save in flight against without.
    dir_s = os.path.join(root, "snapshot")
    h = train_lib.build_harness(cfg.with_overrides(ckpt_dir=dir_s,
                                                   ckpt_every=1000))
    _harness_steps(h, 1)
    ref = _host_copy(h.state.to_tree())
    h.manager.save(1, h.state.to_tree())
    h.state.opt.step()
    in_flight = [ms for _, ms in _harness_steps(h, 1)]
    h.manager.wait_pending()
    t0 = time.perf_counter()
    snap = ckpt.restore(dir_s, 1, target=h.state.to_tree())
    restore_ms = 1e3 * (time.perf_counter() - t0)
    bad = _diff_leaves(dict(ckpt_mod._flatten(snap)), ref)
    if bad:
        problems.append(f"async snapshot at step 1 vs a blocking copy: "
                        f"{len(bad)} leaves differ, first {bad[:4]}")
    del snap, ref
    plain = []
    for _ in range(2):
        plain += [ms for _, ms in _harness_steps(h, 1)]
        h.manager.save(h.state.step, h.state.to_tree())
        in_flight += [ms for _, ms in _harness_steps(h, 1)]
        h.manager.wait_pending()
    # device memory a save and a restore take beyond the state
    ref = _host_copy(h.state.to_tree())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    h.manager.save(h.state.step, h.state.to_tree())
    h.manager.wait_pending()
    save_peak = torch.cuda.max_memory_allocated() - base

    # 6. a save through the ckpt_shard:kind=corrupt seam: restore_latest
    # quarantines it and walks back to the last good step
    good = h.state.step
    os.environ["TPUFRAME_FAULTS"] = "ckpt_shard:kind=corrupt"
    try:
        ckpt_mod.faults.reset_from_env()
        ckpt.save(dir_s, good + 1, h.state.to_tree())
    finally:
        del os.environ["TPUFRAME_FAULTS"]
        ckpt_mod.faults.reset_from_env()
    got = h.manager.restore_latest(target=h.state.to_tree())
    quarantined = Path(dir_s, f"step_{good + 1:08d}.corrupt").is_dir()
    if got is None or got[0] != good or not quarantined:
        problems.append(f"corrupt step {good + 1}: restore_latest gave "
                        f"step {got and got[0]}, quarantined {quarantined}")
    else:
        bad = _diff_leaves(dict(ckpt_mod._flatten(got[1])), ref)
        if bad:
            problems.append(f"walked back to step {good}: {len(bad)} leaves"
                            f" differ from a blocking copy, first {bad[:4]}")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        h.state.load_tree(got[1])
        torch.cuda.synchronize()
        load_ms = 1e3 * (time.perf_counter() - t0)
        restore_peak = torch.cuda.max_memory_allocated() - base
    del h, got, ref
    shutil.rmtree(dir_s)
    if problems:
        raise RuntimeError("ckpt (lm_long): " + "; ".join(problems))
    return {"launches": launches, "disk_bytes": disk, "params": n_params,
            "losses": resumed["losses"], "restore_ms": restore_ms,
            "load_ms": load_ms, "save_peak": save_peak,
            "restore_peak": restore_peak,
            "step_ms_in_flight": statistics.median(in_flight),
            "step_ms_plain": statistics.median(plain),
            "in_flight": in_flight, "plain": plain}


def _ckpt_resnet(root: str, straight: list | None) -> dict:
    """imagenet_resnet50 (bn fused): 2 steps, a blocking copy and a save,
    steps 3-4 (a straight run), then a resume in a new harness (every
    tensor bit-equal to the copy) and its steps 3-4, held to the straight
    runs' losses within their difference.  ``straight``: another straight
    run's losses (phase 12's, same cuts), else one is run here."""
    cfg = get_config("imagenet_resnet50").with_overrides(**CKPT_RESNET_CUTS)
    if straight is None:
        straight = train_lib.train(cfg)["losses"]
    run = cfg.with_overrides(ckpt_dir=os.path.join(root, "resnet"))
    h = train_lib.build_harness(run)
    again = [loss for loss, _ in _harness_steps(h, 2)]
    ref = _host_copy(h.state.to_tree())
    h.manager.save(2, h.state.to_tree())
    again += [loss for loss, _ in _harness_steps(h, 2)]
    del h
    noise = max(abs(x - y) for x, y in zip(straight, again))
    reset_launches()
    h = train_lib.build_harness(run)
    bad = _diff_leaves(dict(ckpt_mod._flatten(h.state.to_tree())), ref)
    resumed = [loss for loss, _ in _harness_steps(h, 2)]
    launches = launch_counts()
    stats = sum(1 for n in ref if n.endswith(("running_mean", "running_var")))
    traces = sum(1 for n in ref if n.startswith("opt/trace/"))
    diff = max(abs(x - y) for x, y in zip(resumed, straight[2:]))
    problems = []
    if h.state.step != 4 or bad:
        problems.append(f"restored state: step {h.state.step}, "
                        f"{len(bad)} leaves not bit-equal, first {bad[:4]}")
    if not diff <= noise:
        problems.append(f"steps 3-4 resumed {resumed} vs straight "
                        f"{straight[2:]}: {diff:.3e} beyond the two straight"
                        f" runs' difference {noise:.3e}")
    if launches["fused_conv_bn_bwd"] != 72:
        problems.append(f"resumed launches {launches}, want 36 fused "
                        f"conv+BN a step")
    del h
    shutil.rmtree(os.path.join(root, "resnet"))
    if problems:
        raise RuntimeError("ckpt (imagenet_resnet50): " + "; ".join(problems))
    return {"launches": launches, "noise": noise, "diff": diff,
            "stats": stats, "traces": traces, "straight": straight,
            "again": again, "resumed": resumed}


def phase_ckpt(resnet_losses: list | None = None) -> dict:
    """Checkpointing and the preemption contract (``tpuframe_torch.ckpt``,
    ``resilience``) on the card, lm_long (CKPT_LM_CUTS) and
    imagenet_resnet50 (CKPT_RESNET_CUTS), into a temporary directory
    removed at the end:

      1. lm_long straight for 6 steps (its final state saved, sync);
      2. the same with periodic async saves, preempted at step 3 by
         ``TPUFRAME_FAULTS=host:step=3:kind=sigterm``: SystemExit(14),
         steps 2 and 3 committed, the guard uninstalled;
      3. the resume to step 6: its losses and its state at step 6 equal
         the straight run's bit for bit; the flash kernels' launches and
         routes read around it;
      4. (in 3) every resumed step's flash launches on the tensor cores;
      5. an async save at step 1, then at once an in-place optimizer
         update and step 2: step 1 restored is bit-equal to a blocking
         copy taken at step 1; step time with a save in flight against
         without; device memory a save and a restore take;
      6. a save through the ``ckpt_shard:kind=corrupt`` seam is
         quarantined and ``restore_latest`` walks back to the last good
         step, bit-equal to a blocking copy;
      7. imagenet_resnet50: statistics and traces bit-equal after a
         resume, steps 3-4 within two straight runs' difference (one of
         them phase 12's, ``resnet_losses``, when given).

    The numbers come from the run's ``ckpt_save``/``ckpt_restore`` events
    (``tpuframe_torch.obs.events``) and the phase's own clocks."""
    before_sigterm = signal.getsignal(signal.SIGTERM)
    crc_buf = np.frombuffer(np.random.default_rng(0).bytes(CRC_BYTES),
                            np.uint8)
    native.crc32c(crc_buf[:64])
    if not native.loaded():
        raise RuntimeError("ckpt: the native CRC-32C library did not load")
    crc_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        native.crc32c(crc_buf)
        crc_s.append(time.perf_counter() - t0)
    crc_gbps = CRC_BYTES / min(crc_s) / 1e9
    root = tempfile.mkdtemp(prefix="tpuframe_ckpt_")
    events.init(os.path.join(root, "events"))
    try:
        t0 = time.monotonic()
        lm = _ckpt_lm(root, before_sigterm)
        lm_wall = time.monotonic() - t0
        t0 = time.monotonic()
        resnet = _ckpt_resnet(root, resnet_losses)
        resnet_wall = time.monotonic() - t0
        records = events.merge(os.path.join(root, "events"))
    finally:
        events.close()
        shutil.rmtree(root, ignore_errors=True)
    saves = [r for r in records if r["type"] == "ckpt_save"]
    restores = [r for r in records if r["type"] == "ckpt_restore"]
    faults_seen = [r for r in records if r["type"] == "fault_injected"]
    sync_ms = saves[0]["ms"]
    async_saves = [r for r in saves if r["async_write"]]
    block = [r["block_ms"] for r in async_saves]
    write = [r["write_ms"] for r in async_saves]
    if (saves[0]["async_write"] or not async_saves or not restores
            or [r["seam"] for r in faults_seen] != ["host", "ckpt_shard"]
            or not any(r["type"] == "preempt" for r in records)):
        raise RuntimeError(f"ckpt: events {[r['type'] for r in records]}")
    card = _card_line()
    gb = lm["disk_bytes"] / 1e9
    log(f"[ckpt] {card}: lm_long ({lm['params'] / 1e6:.1f} M params, f32 "
        f"state + 2 Adam moments) {lm['disk_bytes']} bytes on disk a "
        f"checkpoint; sync save "
        f"{sync_ms:.1f} ms ({gb / sync_ms * 1e3:.2f} GB/s); async snapshot "
        f"(blocking) ms {block} (median {statistics.median(block):.1f}), "
        f"worker ms {write} (median {statistics.median(write):.1f}); "
        f"restore {restores[0]['ms']:.1f} ms in the resumed run, "
        f"{lm['restore_ms']:.1f} ms to host + {lm['load_ms']:.1f} ms onto "
        f"the card in the snapshot check; CRC32C {crc_gbps:.2f} GB/s "
        f"(native, {CRC_BYTES >> 20} MiB); step p50 "
        f"{lm['step_ms_in_flight']:.1f} ms with an async save in flight "
        f"{[round(x, 1) for x in lm['in_flight']]} vs "
        f"{lm['step_ms_plain']:.1f} ms without "
        f"{[round(x, 1) for x in lm['plain']]}; peak device memory "
        f"+{lm['save_peak'] / 2**20:.1f} MiB during a save, "
        f"+{lm['restore_peak'] / 2**20:.1f} MiB during a restore; resumed "
        f"steps 4-6 losses {lm['losses']} bit-equal to the straight run, "
        f"state at step 6 bit-equal; async snapshot bit-equal; corrupt "
        f"step quarantined; {len(saves)} saves, {len(restores)} restores, "
        f"{lm_wall:.1f} s; launches {lm['launches']}")
    log(f"[ckpt] {card}: imagenet_resnet50 bn=fused batch {RESNET_BATCH}: "
        f"{resnet['stats']} running statistics and {resnet['traces']} SGD "
        f"traces bit-equal after the restore; steps 3-4 resumed "
        f"{resnet['resumed']} vs straight {resnet['straight'][2:]}: "
        f"max |diff| {resnet['diff']:.3e} within two straight runs' "
        f"{resnet['noise']:.3e} ({resnet['straight']} vs "
        f"{resnet['again']}); {resnet_wall:.1f} s; launches "
        f"{resnet['launches']}")
    return {"lm": lm, "resnet": resnet, "crc_gbps": crc_gbps,
            "sync_ms": sync_ms, "block_ms": block, "write_ms": write,
            "restore_ms": restores[0]["ms"]}


def _cpu_tree(tree):
    """A blocking host copy of a nested tree of tensors and numbers."""
    if isinstance(tree, dict):
        return {k: _cpu_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def _state_digest(tree) -> str:
    """SHA-256 over every leaf's name and bytes."""
    digest = hashlib.sha256()
    for name, leaf in ckpt_mod._flatten(tree):
        digest.update(name.encode())
        if isinstance(leaf, torch.Tensor):
            digest.update(leaf.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes())
        else:
            digest.update(repr(leaf).encode())
    return digest.hexdigest()


def _hvd_launch(name: str, n: int, out: str, env: dict | None = None,
                timeout: float = HVD_TIMEOUT_S):
    """``n`` ranks of ``chip_smoke.py --hvd-worker name out`` through
    LocalCluster, with the launcher's environment and ``env``."""
    return LocalCluster(n, timeout=timeout, extra_env=env or {}).launch(
        [sys.executable, str(Path(__file__).resolve()), "--hvd-worker",
         name, out])


def _hvd_world1_verbs() -> dict:
    """Every hvd verb and op on CUDA tensors in a world of one, each
    against its plain expectation (the input), as a name -> bool map."""
    import torch.distributed as dist
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(64, 33, device="cuda", generator=gen)
    checks = {}

    def check(name, got, want):
        checks[name] = (got is not want and got.device.type == "cuda"
                        and torch.equal(got, want))

    for op in (hvd.Average, hvd.Sum, hvd.Min, hvd.Max, hvd.Product,
               hvd.Adasum):
        check(op.name, hvd.allreduce(x, op=op), x)
    check("average=False", hvd.allreduce(x, average=False), x)
    check("ProcessSet Average", hvd.allreduce(
        x, process_set=hvd.ProcessSet([0])), x)
    check("ProcessSet Sum", hvd.allreduce(
        x, op=hvd.Sum, process_set=hvd.ProcessSet([0])), x)
    check("allgather", hvd.allgather(x), x)
    check("alltoall", hvd.alltoall(x, splits=[64]), x)
    a, b = hvd.grouped_allreduce([x, 2 * x])
    check("grouped_allreduce", torch.cat([a, b]), torch.cat([x, 2 * x]))
    t = x.clone()
    check("allreduce_async_ + synchronize",
          hvd.synchronize(hvd.allreduce_async_(t, op=hvd.Sum)), x)
    sd = {"w": x.clone()}
    hvd.broadcast_parameters(sd)
    check("broadcast_parameters", sd["w"], x)
    checks["broadcast_object"] = hvd.broadcast_object({"a": [1]}) == {"a": [1]}
    checks["allgather_object"] = hvd.allgather_object("zz") == ["zz"]
    hvd.barrier()
    checks["barrier"] = True
    checks["join"] = hvd.join() == -1
    checks["nccl_built"] = hvd.nccl_built()
    checks["cuda_built"] = hvd.cuda_built()
    checks["backend nccl"] = dist.get_backend() == "nccl"
    checks["size, rank, local_rank, local_size"] = [
        hvd.size(), hvd.rank(), hvd.local_rank(), hvd.local_size()] == [
        1, 0, 0, 1]
    return checks


def hvd_worker_nccl(out: str) -> None:
    """(a) The one rank of a world of one over NCCL: init and first
    collective seconds, every verb, the NCCL kernels they ran, then
    imagenet_resnet50 (RESNET_CUTS) with grad_reduce="adasum" through
    ``tpuframe_torch.train.main``, its launches read around it."""
    t0 = time.perf_counter()
    hvd.init()
    group_s = time.perf_counter() - t0
    x = torch.ones(1024, device="cuda")
    hvd.allreduce(x, op=hvd.Sum)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    checks = _hvd_world1_verbs()
    kernels = device_time(_hvd_world1_verbs)
    nccl = (None if kernels is None
            else [(k, c) for k, _, c in kernels if "nccl" in k.lower()])
    reset_launches()
    metrics = train_lib.main(RESNET_ARGS + ["--set", "grad_reduce='adasum'"])
    torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump({"group_s": group_s, "first_collective_s": first_s,
                   "checks": checks, "nccl_kernels": nccl,
                   "losses": metrics["losses"],
                   "step_ms": metrics["step_ms"],
                   "launches": launch_counts(),
                   "routes": dict(fcb.ROUTES)}, f)
    # the group goes before the interpreter: one run's rank aborted at
    # its exit ("terminate called without an active exception") with
    # the NCCL group still up
    torch.cuda.synchronize()
    hvd.shutdown()


def hvd_worker_probe(out: str) -> None:
    """A rank of a gloo world of two on the one card: each raw
    ``torch.distributed`` verb on CUDA tensors, its outcome written to
    ``out.<rank>`` as soon as it is known (a verb that hangs leaves the
    ones before it); point-to-point last."""
    import torch.distributed as dist
    hvd.init()
    r, n = dist.get_rank(), dist.get_world_size()
    total = float(n * (n + 1) // 2)
    x = torch.full((8,), float(r + 1), device="cuda")
    found = {}

    def run(name, fn, ok):
        try:
            res = fn()
            torch.cuda.synchronize()
            found[name] = "ok" if ok(res) else "ran, wrong result"
        except Exception as e:  # noqa: BLE001 - the backend's answer
            found[name] = f"{type(e).__name__}: " + (
                str(e).strip().splitlines() or [""])[0][:160]
        with open(f"{out}.{r}", "w") as f:
            json.dump(found, f)

    def inplace(call, t):
        call(t)
        return t

    run("all_reduce", lambda: inplace(dist.all_reduce, x.clone()),
        lambda t: bool((t == total).all()))
    run("broadcast", lambda: inplace(lambda t: dist.broadcast(t, 1),
                                     x.clone()),
        lambda t: bool((t == n).all()))
    parts = [torch.empty_like(x) for _ in range(n)]
    run("all_gather", lambda: dist.all_gather(parts, x),
        lambda _: all(bool((p == i + 1).all()) for i, p in enumerate(parts)))
    big = torch.empty(n * 8, device="cuda")
    run("all_gather_into_tensor",
        lambda: dist.all_gather_into_tensor(big, x),
        lambda _: bool((big.view(n, 8)[:, 0] == torch.arange(
            1, n + 1, device="cuda")).all()))
    one = torch.empty(8 // n, device="cuda")
    run("reduce_scatter_tensor",
        lambda: dist.reduce_scatter_tensor(one, x),
        lambda _: bool((one == total).all()))
    a2a = torch.empty_like(x)
    run("all_to_all_single", lambda: dist.all_to_all_single(a2a, x),
        lambda _: bool((a2a.view(n, -1)[:, 0] == torch.arange(
            1, n + 1, device="cuda")).all()))
    run("reduce", lambda: inplace(lambda t: dist.reduce(t, 0), x.clone()),
        lambda t: r != 0 or bool((t == total).all()))
    got = [torch.empty_like(x) for _ in range(n)] if r == 0 else None
    run("gather", lambda: dist.gather(x, got, dst=0),
        lambda _: r != 0 or all(bool((g == i + 1).all())
                                for i, g in enumerate(got)))
    sc = torch.empty_like(x)
    run("scatter", lambda: dist.scatter(
        sc, [x * 0 + i for i in range(n)] if r == 0 else None, src=0),
        lambda _: bool((sc == r).all()))
    recv = torch.empty_like(x)
    run("send/recv (batch_isend_irecv)", lambda: [w.wait() for w in (
        dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - r),
                                dist.P2POp(dist.irecv, recv, 1 - r)]))],
        lambda _: bool((recv == 2 - r).all()))


def hvd_worker_nccl_pair(out: str) -> None:
    """A rank of an NCCL world of two on the one card: NCCL's own error
    is expected at the first collective."""
    hvd.init()
    hvd.allreduce(torch.ones(4, device="cuda"))
    torch.cuda.synchronize()
    with open(f"{out}.{hvd.rank()}", "w") as f:
        f.write("ran")


def _gloo_verbs_on_cuda() -> dict:
    """Each hvd verb on CUDA tensors in this gloo world: a verb whose
    collective gloo takes on CUDA (``GLOO_CUDA_VERBS``) must give the
    expected values; every other one must raise, naming the verb and
    gloo.  ``{verb: "ok" | "refused" | what went wrong}``."""
    r, n = hvd.rank(), hvd.size()
    x = torch.full((4, 8), float(r + 1), device="cuda")
    total = float(n * (n + 1) // 2)
    # rank j's block of a gather, or the block rank j sent: j + 1
    by_rank = torch.arange(1.0, n + 1, device="cuda").repeat_interleave(
        x.shape[0] // n)
    cases = {  # verb: (raw collective, call, expected)
        "allreduce Average": ("all_reduce", lambda: hvd.allreduce(x),
                              total / n),
        "allreduce Sum": ("all_reduce",
                          lambda: hvd.allreduce(x, op=hvd.Sum), total),
        "allreduce Max": ("all_reduce",
                          lambda: hvd.allreduce(x, op=hvd.Max), float(n)),
        "allreduce Min": ("all_reduce",
                          lambda: hvd.allreduce(x, op=hvd.Min), 1.0),
        "broadcast_parameters": ("broadcast", lambda: _bcast(x), 1.0),
        "allgather": ("all_gather", lambda: hvd.allgather(x),
                      torch.arange(1.0, n + 1, device="cuda")
                      .repeat_interleave(x.shape[0])[:, None]),
        "alltoall": ("all_to_all", lambda: hvd.alltoall(x),
                     by_rank[:, None]),
        "allreduce Product": ("all_gather",
                              lambda: hvd.allreduce(x, op=hvd.Product),
                              float(math.factorial(n))),
        "allreduce Adasum": ("send/recv",
                             lambda: hvd.allreduce(x, op=hvd.Adasum), None),
    }
    found = {}
    for verb, (raw, call, want) in cases.items():
        allowed = raw in collectives.GLOO_CUDA_VERBS
        try:
            got = call()
            ok = allowed and bool((got == want).all())
            found[verb] = "ok" if ok else f"ran ({raw}): {got.flatten()[:4]}"
        except RuntimeError as e:
            found[verb] = ("refused" if not allowed and raw in str(e)
                           and "gloo" in str(e) else f"raised: {e}")
    return found


def _bcast(x):
    sd = {"t": x.clone()}
    hvd.broadcast_parameters(sd, root_rank=0)
    return sd["t"]


def hvd_worker_cifar(out: str) -> None:
    """(b) A rank of the gloo world of two: the hvd verbs on CUDA tensors
    under gloo, then cifar10_resnet18 (HVD_CIFAR_ARGS) through
    ``tpuframe_torch.train.main`` with its step 1 captured (the rank's
    batch, the state before and after), the final state's digest gathered
    from every rank, and one more step profiled."""
    hvd.init()
    rank = hvd.rank()
    verbs = _gloo_verbs_on_cuda()
    captured = {}
    build = train_lib.build_harness

    def capturing_build(cfg, device="cuda"):
        h = build(cfg, device)
        step = h.train_step

        def train_step(state, batch):
            if "step1" in captured:
                return step(state, batch)
            captured["batch"] = _cpu_tree(batch)
            captured["init"] = _cpu_tree(state.to_tree())
            metrics = step(state, batch)
            captured["step1"] = _cpu_tree(state.to_tree())
            return metrics

        h.train_step = train_step
        captured["harness"] = h
        return h

    train_lib.build_harness = capturing_build
    try:
        metrics = train_lib.main(HVD_CIFAR_ARGS)
    finally:
        train_lib.build_harness = build
    h = captured.pop("harness")
    digests = hvd.allgather_object(_state_digest(h.state.to_tree()))
    torch.save(captured, f"{out}.{rank}.pt")
    # step 1's batches again under the final parameters, with step 1's
    # augmentation: the loss falls on the same data
    batch = {k: v.to(h.device) for k, v in captured["batch"].items()}
    with torch.no_grad():
        again, _ = train_lib.make_loss_fn(h.cfg)(
            h.state.model, batch,
            step_lib.dropout_seed(h.state.seed, 0, rank))
    again = statistics.mean(hvd.allgather_object(float(again)))
    wall_step, kernels, (busy, _idle, _text) = _profile_steps(h, 1)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"verbs": verbs, "losses": metrics["losses"],
                       "step1_again": again,
                       "step_ms": metrics["step_ms"],
                       "eval_loss": metrics["eval_loss"],
                       "eval_accuracy": metrics["eval_accuracy"],
                       "digests": digests, "wall_step": wall_step,
                       "device_ms": busy,
                       "top": [(k[:60], ms, c)
                               for k, ms, c in (kernels or [])[:8]]},
                      f)


def _hvd_plain_dp_step(batches: list, init: dict) -> dict:
    """The plain version of step 1 of (b): one process, the same init;
    each rank's half-batch through forward and backward in turn (BN
    statistics restored in between), gradients and statistics averaged,
    the optimizer's step.  Returns the state's flat host copy."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("cifar10_resnet18").with_overrides(**HVD_CIFAR_CUTS)
    model = get_model(cfg.model, dtype=cfg.compute_dtype, device="cuda",
                      seed=cfg.seed, **cfg.model_kwargs)
    state = step_lib.TrainState(model, build_optimizer(cfg, model))
    state.load_tree(init)
    loss_fn = train_lib.make_loss_fn(cfg)
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    start = [b.clone() for b in bufs]
    grads, stats = [], []
    for r, batch in enumerate(batches):
        for b, b0 in zip(bufs, start):
            b.copy_(b0)
        model.zero_grad(set_to_none=True)
        batch = {k: v.to("cuda") for k, v in batch.items()}
        loss, _ = loss_fn(model, batch,
                          step_lib.dropout_seed(state.seed, 0, r))
        loss.backward()
        grads.append([p.grad.clone() for p in model.parameters()])
        stats.append([b.clone() for b in bufs])
    n = len(batches)
    with torch.no_grad():
        for p, *gs in zip(model.parameters(), *grads):
            p.grad = sum(gs) / n
        for b, *ss in zip(bufs, *stats):
            b.copy_(sum(ss) / n)
    state.opt.step()
    state.step += 1
    return _host_copy(state.to_tree())


def _adasum_combine_check() -> dict:
    """(c) ``adasum_combine`` on the card at the shapes of ResNet-50's
    161 gradient leaves, f32 and bf16, against float64; the exact cases;
    its time over all leaves (CUDA events) beside its bound."""
    shapes = [tuple(p.shape) for p in get_model(
        "resnet50", device="cuda").parameters()]
    gen = torch.Generator(device="cuda").manual_seed(7)
    out = {"leaves": len(shapes),
           "elements": sum(math.prod(s) for s in shapes)}
    for dtype in (torch.float32, torch.bfloat16):
        worst, exact = 0.0, True
        pairs = []
        for shape in shapes:
            a = torch.randn(shape, device="cuda", generator=gen).to(dtype)
            b = (0.5 * a.float() + torch.randn(
                shape, device="cuda", generator=gen)).to(dtype)
            pairs.append((a, b))
            got = collectives.adasum_combine(a, b).double().cpu().numpy()
            a64, b64 = a.double().cpu().numpy(), b.double().cpu().numpy()
            dot, na, nb = (a64 * b64).sum(), (a64 * a64).sum(), \
                (b64 * b64).sum()
            ref = (1 - dot / (2 * na)) * a64 + (1 - dot / (2 * nb)) * b64
            worst = max(worst, float(np.abs(got - ref).max()
                                     / np.abs(ref).max()))
            mask = torch.rand(shape, device="cuda", generator=gen) < 0.5
            oa, ob = a * mask, b * ~mask
            exact &= torch.equal(collectives.adasum_combine(a, a), a)
            exact &= torch.equal(collectives.adasum_combine(oa, ob), oa + ob)
            exact &= torch.equal(collectives.adasum_combine(
                torch.zeros_like(a), b), b)
        if not worst <= HVD_COMBINE_TOL[dtype] or not exact:
            raise RuntimeError(
                f"adasum_combine {dtype}: max error {worst:.3e} against "
                f"float64 (tolerance {HVD_COMBINE_TOL[dtype]:g}); exact "
                f"cases (identical, orthogonal, zero) held: {exact}")
        ms = cuda_ms(lambda: [collectives.adasum_combine(a, b)
                              for a, b in pairs], 10)
        nbytes = 3 * out["elements"] * pairs[0][0].element_size()
        out[str(dtype)] = {"max_rel_err": worst, "ms": ms,
                           "bound_ms": nbytes / PEAK_BYTES_S * 1e3}
    return out


def phase_hvd(resnet_losses: list | None = None,
              resnet_noise: float = 0.0) -> dict:
    """The Horovod slice (``tpuframe_torch.parallel.hvd``, ``bootstrap``,
    ``launch.launcher``), run in processes that LocalCluster starts with
    the launcher's environment:

      (a) a world of one over NCCL: every hvd verb and op on CUDA
          tensors against its plain expectation, the seconds to the
          group and to the first collective, then imagenet_resnet50 at
          RESNET_CUTS with grad_reduce="adasum": its losses equal phase
          12's (``resnet_losses``; within ``resnet_noise``, the measured
          difference of two straight runs, when that is not 0), every
          fused conv+BN launch on the tensor cores;
      (b) cifar10_resnet18 as two processes on the one card over gloo
          (HVD_CIFAR_CUTS): the hvd verbs on CUDA tensors under gloo (the
          collectives gloo does not take on CUDA refused); the ranks'
          final states bit-identical; step 1 against the plain
          data-parallel step (HVD_DP_RTOL); the loss falls; step p50 and
          rank 0's idle share, which are gloo's copies through the host,
          not NCCL's cost;
      (c) ``adasum_combine`` at ResNet-50's leaf shapes against float64;
      (d) probes: each raw torch.distributed verb on CUDA tensors under
          gloo, and an NCCL world of two on the one card (NCCL's own
          error expected); written down, not held.

    ``resnet_losses`` None: phase 12 runs first for its losses."""
    if resnet_losses is None:
        resnet_losses = phase_resnet_train()["losses"]
    gc.collect()
    torch.cuda.empty_cache()
    card = _card_line()
    root = tempfile.mkdtemp(prefix="tpuframe_hvd_")
    try:
        t0 = time.monotonic()
        _hvd_launch("nccl", 1, os.path.join(root, "nccl.json"))
        a = json.loads(Path(root, "nccl.json").read_text())
        a_wall = time.monotonic() - t0
        t0 = time.monotonic()
        _hvd_launch("cifar", 2, os.path.join(root, "cifar.json"),
                    {"TPUFRAME_DIST_BACKEND": "gloo"})
        b = json.loads(Path(root, "cifar.json").read_text())
        ranks = [torch.load(os.path.join(root, f"cifar.json.{r}.pt"))
                 for r in range(2)]
        b_wall = time.monotonic() - t0
        plain = _hvd_plain_dp_step([rk["batch"] for rk in ranks],
                                   ranks[0]["init"])
        combine = _adasum_combine_check()
        probes = _hvd_probes(root)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    problems = []
    bad = [k for k, ok in a["checks"].items() if not ok]
    if bad:
        problems.append(f"(a) NCCL world of one: {bad} failed")
    diff = max(abs(x - y) for x, y in zip(a["losses"], resnet_losses))
    if len(a["losses"]) != len(resnet_losses) or not diff <= resnet_noise:
        problems.append(f"(a) adasum losses {a['losses']} vs phase 12's "
                        f"{resnet_losses}: {diff:.3e}, beyond two straight "
                        f"runs' {resnet_noise:.3e}")
    steps = len(a["losses"])
    want = {"fused_conv_bn_bwd": 36 * steps, "flash_fwd": 0,
            "flash_bwd_delta": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
            "precision_probe": 0}
    if a["launches"] != want or a["routes"] != {
            "tensor_core": 36 * steps, "cuda_core": 0}:
        problems.append(f"(a) launches {a['launches']} by route "
                        f"{a['routes']}, want {want}, all tensor-core")
    bad = {k: v for k, v in b["verbs"].items() if v not in ("ok", "refused")}
    if bad:
        problems.append(f"(b) hvd verbs on CUDA under gloo: {bad}")
    if len(set(b["digests"])) != 1:
        problems.append(f"(b) the ranks' final states differ: "
                        f"{b['digests']}")
    step1 = ranks[0]["step1"]
    got = {n: t for n, t in ckpt_mod._flatten(step1)}
    dp_err, worst = 0.0, None
    for name, ref in plain.items():
        if not isinstance(ref, torch.Tensor):
            if got[name] != ref:
                problems.append(f"(b) step 1 {name}: {got[name]} vs {ref}")
            continue
        scale = ref.double().abs().max().item()
        err = (got[name].double() - ref.double()).abs().max().item() / (
            scale if scale > 0 else 1.0)
        if err > dp_err:
            dp_err, worst = err, name
    if not dp_err <= HVD_DP_RTOL:
        problems.append(f"(b) step 1 against the plain data-parallel step: "
                        f"{worst} off by {dp_err:.3e} of its largest entry "
                        f"(tolerance {HVD_DP_RTOL:g})")
    losses = b["losses"]
    if (len(losses) != HVD_CIFAR_CUTS["total_steps"]
            or not b["step1_again"] < losses[0]
            or not all(math.isfinite(x) for x in losses)):
        problems.append(f"(b) losses {losses}, step 1's batches again at "
                        f"the end {b['step1_again']}: want every step's "
                        f"finite, and the loss on step 1's batches fallen")
    if problems:
        raise RuntimeError("hvd: " + "; ".join(problems))
    p50 = statistics.median(b["step_ms"][1:])
    idle = (None if b["device_ms"] is None
            else 1 - b["device_ms"] / b["wall_step"])
    log(f"[hvd] {card}: (a) world of one over NCCL: group in "
        f"{a['group_s']:.2f} s, first collective at "
        f"{a['first_collective_s']:.2f} s; {len(a['checks'])} verb checks "
        f"held; NCCL kernels in the verbs "
        f"{_dev(a['nccl_kernels'], '')}; "
        f"imagenet_resnet50 bn=fused grad_reduce=adasum losses "
        f"{a['losses']} equal phase 12's (max |diff| {diff:.3e}); step ms "
        f"{[round(x, 1) for x in a['step_ms']]}; launches {a['launches']}; "
        f"{a_wall:.1f} s")
    log(f"[hvd] {card}: (b) cifar10_resnet18, two processes on one card "
        f"over gloo, batch 256 (128 a rank), {len(losses)} steps in "
        f"{b_wall:.1f} s: losses {[round(x, 4) for x in losses[:3]]}..."
        f"{[round(x, 4) for x in losses[-3:]]} (step 1's batches again at "
        f"the end: {b['step1_again']:.4f}), eval loss "
        f"{b['eval_loss']:.4f} accuracy {b['eval_accuracy']:.4f}; final "
        f"states bit-identical ({b['digests'][0][:16]}); step 1 against "
        f"the plain data-parallel step: max error {dp_err:.3e} ({worst}); "
        f"step ms p50 {p50:.2f} and rank 0's idle share "
        f"{_dev(idle)}, both "
        f"gloo through the host (not NCCL's cost); profiled step: wall "
        f"{b['wall_step']:.2f} ms, rank 0's device "
        f"{_dev(b['device_ms'], '.2f')} "
        f"ms; top: " + "; ".join(f"{k} {ms:.2f} ms x{c}"
                                 for k, ms, c in b["top"]))
    log(f"[hvd] hvd verbs on CUDA under gloo: {b['verbs']}")
    log(f"[hvd] {card}: (c) adasum_combine at ResNet-50's "
        f"{combine['leaves']} leaf shapes ({combine['elements']} entries) "
        f"against float64: " + "; ".join(
            f"{k}: max error {v['max_rel_err']:.3e}, {v['ms']:.3f} ms over "
            f"all leaves (bound {v['bound_ms']:.4f} ms, bytes)"
            for k, v in combine.items() if isinstance(v, dict))
        + "; identical, orthogonal and zero inputs exact")
    log(f"[hvd] probes: raw torch.distributed verbs on CUDA tensors under "
        f"gloo: {probes['gloo_cuda']}; NCCL world of two on one card: "
        f"{probes['nccl_pair']}")
    return {"launches": a["launches"], "nccl": a, "cifar_p50": p50,
            "cifar_idle": idle, "dp_err": dp_err, "combine": combine,
            "probes": probes}


def _hvd_probes(root: str) -> dict:
    """(d) The two probes, at once: what a failed or hung probe shows is
    its finding."""
    from concurrent.futures import ThreadPoolExecutor

    def probe(name, env):
        out = os.path.join(root, f"{name}.json")
        try:
            _hvd_launch(name, 2, out, env, timeout=HVD_PROBE_TIMEOUT_S)
            status = "both ranks exited 0"
        except RuntimeError as e:
            lines = [ln for ln in str(e).splitlines()
                     if re.search(r"\(exit |NCCL|Duplicate|Error|timed out|"
                                  r"signal", ln)]
            status = "failed: " + " | ".join(lines[:6])[:900]
        return out, status

    with ThreadPoolExecutor(2) as pool:
        gloo = pool.submit(probe, "probe", {"TPUFRAME_DIST_BACKEND": "gloo"})
        pair = pool.submit(probe, "nccl_pair", {})
        (g_out, g_status), (_, p_status) = gloo.result(), pair.result()
    found = {}
    for r in range(2):
        if os.path.exists(f"{g_out}.{r}"):
            for verb, what in json.loads(
                    Path(f"{g_out}.{r}").read_text()).items():
                found.setdefault(verb, []).append(what)
    found = {verb: whats[0] if len(set(whats)) == 1 else
             {f"rank {r}": w for r, w in enumerate(whats)}
             for verb, whats in found.items()}
    found["(world)"] = g_status
    return {"gloo_cuda": found, "nccl_pair": p_status}


HVD_WORKERS = {"nccl": hvd_worker_nccl, "probe": hvd_worker_probe,
               "nccl_pair": hvd_worker_nccl_pair, "cifar": hvd_worker_cifar}


def wall_ms(fn, calls: int) -> float:
    fn()
    t = time.monotonic()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.monotonic() - t) / calls


def device_time(fn, calls: int = 1, tries: int = 1):
    """Kernels that ``calls`` calls of ``fn`` run on the card, by
    torch.profiler: a list of ``(name, device ms, count)``, largest
    first.  Only device-side events count (the CPU ops that launched
    them carry the same time again).

    None when the profiler's record of the window is not whole: it must
    hold both sentinel kernels (``torch.cuda._sleep``, launched first and
    last inside the window) and one event for each launch of a
    hand-written kernel that the wrappers counted in it.  On the H100
    machines this runs on, some records lose kernels, most often the
    last (PERF.md §6).  A window whose ``fn`` only launches kernels (no
    state it changes) may be taken again, ``tries`` times in all."""
    for _ in range(tries - 1):
        kernels = _device_time(fn, calls, quiet=True)
        if kernels is not None:
            return kernels
    return _device_time(fn, calls)


def _device_time(fn, calls: int, quiet: bool = False):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = sum(launch_counts().values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SENTINEL_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
    launched = sum(launch_counts().values()) - before
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    sentinels = sum(c for k, _, c in events if SENTINEL_KERNEL in k)
    recorded = sum(c for k, _, c in events if HAND_WRITTEN_EVENT.search(k))
    PROFILE_WINDOWS["records"] += 1
    if sentinels != 2 or recorded != launched:
        PROFILE_WINDOWS["incomplete"] += 1
        if not quiet:
            PROFILE_WINDOWS["not_measured"] += 1
            log(f"[profile] incomplete record, device time not measured: "
                f"sentinel kernels {sentinels} of 2, hand-written kernels "
                f"{recorded} of {launched} launches")
        return None
    return sorted((e for e in events if SENTINEL_KERNEL not in e[0]),
                  key=lambda k: -k[1])


def device_ms(fn, calls: int) -> float | None:
    """Device ms a call of ``fn``, a function that only launches kernels
    (:func:`device_time` with PROFILE_TRIES; None when no record was
    whole)."""
    kernels = device_time(fn, calls, PROFILE_TRIES)
    return None if kernels is None else sum(
        ms for _, ms, _ in kernels) / calls


def _dev(ms: float | None, spec: str = ".3f") -> str:
    """A device time for a log line."""
    return "not measured" if ms is None else format(ms, spec)


def _busy(kernels, wall: float, per: int = 1) -> tuple:
    """``(device ms, idle share, log text)`` of a profiled window of
    ``per`` steps over ``wall`` ms a step; (None, None, "...not
    measured") when :func:`device_time` returned None."""
    if kernels is None:
        return None, None, ("device not measured (incomplete profiler "
                            "record), idle share not measured")
    busy = sum(ms for _, ms, _ in kernels) / per
    return busy, 1 - busy / wall, (
        f"{sum(c for *_, c in kernels) // per} kernels"
        + (" a step" if per > 1 else "") + f", device {busy:.3f} ms"
        + (" a step" if per > 1 else "") + f", idle share "
        f"{1 - busy / wall:.3f}")


def _top(kernels, n: int, per: int = 1) -> str:
    return "; ".join(f"{k[:60]} {ms / per:.3f} ms x{c // per}"
                     for k, ms, c in (kernels or [])[:n])


def profile_window(name: str, fn, wall: float) -> None:
    kernels = device_time(fn)
    log(f"[profile] {name}: wall {wall:.3f} ms, {_busy(kernels, wall)[2]}; "
        f"top: {_top(kernels, 4)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated subset of "
                         f"{','.join(PHASES)} (debugging: a partial run "
                         "prints neither the kernels line nor the ok line)")
    ap.add_argument("--hvd-worker", nargs=2, metavar=("NAME", "OUT"),
                    help="run one rank of a phase-hvd world (LocalCluster "
                         "starts these)")
    ap.add_argument("--replica-worker", nargs=3,
                    metavar=("RANK", "OUT", "READY"),
                    help="run one replica of phase fleet (the phase starts "
                         "these)")
    args = ap.parse_args(argv)
    if args.hvd_worker is not None:
        name, out = args.hvd_worker
        HVD_WORKERS[name](out)
        return 0
    if args.replica_worker is not None:
        rank, out, ready = args.replica_worker
        return replica_worker(int(rank), out, ready)
    phase_card()
    t0 = time.monotonic()
    phase_build()
    if args.phases is not None:
        for name in args.phases.split(","):
            PHASES[name]()
        log(f"[done] partial run in {time.monotonic() - t0:.1f} s")
        return 0
    cases = phase_kernels()
    bwd = phase_backward()
    probe = phase_probe()
    phase_parity()
    serve_launches, serve_routes, serve_summary = phase_serve()
    fleet = phase_fleet(serve_summary)
    rollout = phase_rollout(serve_summary)
    phase_grad_parity()
    phase_grad_parity_bf16()
    train = phase_train()
    conv_bn = phase_conv_bn()
    phase_resnet_grad_parity()
    resnet = phase_resnet_train()
    bert_delta = phase_bert_parity()
    bert_serve = phase_bert_serve()
    bert_train = phase_bert_train()
    mnist = phase_mnist_train()
    cifar = phase_cifar_train()
    variants = phase_resnet_variants(resnet)
    ckpt_run = phase_ckpt(resnet["losses"])
    hvd_run = phase_hvd(resnet["losses"], ckpt_run["resnet"]["noise"])

    by_path = {name: {"serve": serve_launches[name],
                      "fleet": fleet["launches"][name],
                      "rollout": rollout["launches"][name],
                      "lm_train": train["launches"][name],
                      "resnet_train": resnet["launches"][name],
                      "probe": probe["launches"][name],
                      "bert_serve": bert_serve["launches"][name],
                      "bert_train": bert_train["launches"][name],
                      "mnist_train": mnist["launches"][name],
                      "cifar_train": cifar["launches"][name],
                      "resnet_variants": variants["launches"][name],
                      "ckpt_lm_resume": ckpt_run["lm"]["launches"][name],
                      "ckpt_resnet_resume":
                          ckpt_run["resnet"]["launches"][name],
                      "hvd_resnet": hvd_run["launches"][name]}
               for name in launch_counts()}
    attn = "B=8 S=4096 N=12 D=64 bf16 causal"
    ops = "tpuframe/ops/"
    rows = [("flash_fwd", "flash_fwd.cu", ops + "flash_attention.py:136",
             cases["train"], attn),
            ("flash_bwd_delta", "flash_bwd.cu", ops + "flash_attention.py:378",
             bwd["delta"], attn),
            ("flash_bwd_dq", "flash_bwd.cu", ops + "flash_attention.py:295",
             bwd["dq"], attn),
            ("flash_bwd_dkv", "flash_bwd.cu", ops + "flash_attention.py:327",
             bwd["dkv"], attn),
            ("fused_conv_bn_bwd", "fused_conv_bn.cu",
             ops + "fused_conv_bn.py:150", conv_bn,
             "ResNet-50 batch 256 bf16: the 36 calls of one training step "
             "over 15 shapes, times summed"),
            ("precision_probe", "precision_probe.cu",
             "perf/exp_precision_probe.py:25", probe,
             "256 x 256 x 256 f32 in the three modes, times summed")]
    kernels = [{
        "name": name, "route": "cuda",
        "source": f"tpuframe_torch/csrc/{src}",
        "replaces": line,
        "launches": sum(by_path[name].values()),
        "launches_by_path": by_path[name],
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "shape": shape,
    } for name, src, line, r, shape in rows]
    sub = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
           "library_ms", "max_abs_err")
    for row in kernels:
        if row["name"] == "flash_fwd":
            row["cores"] = ("tensor cores (wgmma bf16) at this shape and on "
                            "every path's launch; f32, and bf16 at D "
                            "16/32/256, on the CUDA cores")
            row["device_ms"] = cases["train"]["device_ms"]
            row["routes_by_path"] = {"serve": serve_routes,
                                     "rollout": rollout["routes"],
                                     "lm_train": train["fwd_routes"],
                                     "bert_serve": bert_serve["routes"],
                                     "bert_train": bert_train["routes"]}
            row["cuda_core_bf16"] = {key: cases["train"]["cuda_core"][key]
                                     for key in sub}
            row["bert_eval"] = {key: bert_serve["eval_case"][key]
                                for key in ("case", "route", *sub)}
        elif row["name"] == "fused_conv_bn_bwd":
            row["cores"] = ("tensor cores (wgmma bf16) at all 15 shapes and "
                            "on every path's launch; f32 and K or C not a "
                            "multiple of 64 on the CUDA cores")
            row["device_ms"] = conv_bn["device_ms"]
            row["routes_by_path"] = {"resnet_train": resnet["routes"],
                                     "resnet_variants": variants["routes"]}
            row["cuda_core_bf16"] = {key: conv_bn["cuda_core"][key]
                                     for key in sub}
        elif row["name"].startswith("flash_bwd_"):
            which = row["name"][len("flash_bwd_"):]
            f32 = bwd["cuda_core_f32"][which]
            if which == "delta":
                row["note"] = ("delta = sum_j p*dp / sum_j p (f32 sums over "
                               "a key tile, f64 across tiles), where the "
                               "TPU backward takes rowsum(dO*O) from XLA; "
                               "no Pallas kernel of its own. Tensor cores: "
                               "flash_bwd_delta_tc_kernel; CUDA cores: the "
                               "dq kernel's delta mode")
                row["bert_shapes"] = [{key: c[key] for key in (
                    "case", "route", *sub)} for c in bert_delta]
            row["cores"] = (f"tensor cores (wgmma bf16) at this shape; "
                            f"f32, and bf16 at D 16/32/256, on the CUDA "
                            f"cores")
            row["lm_train_routes"] = train["routes"]
            row["cuda_core_f32"] = {key: f32[key] for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "max_abs_err")}
        elif row["name"] == "precision_probe":
            row["modes"] = probe["modes"]
    log(f"[profile] {PROFILE_WINDOWS['records']} profiler records, "
        f"{PROFILE_WINDOWS['incomplete']} incomplete; "
        f"{PROFILE_WINDOWS['not_measured']} windows' device times not "
        f"measured")
    log(f"[done] {time.monotonic() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


PHASES = {"kernels": phase_kernels, "backward": phase_backward,
          "probe": phase_probe, "parity": phase_parity, "serve": phase_serve,
          "fleet": phase_fleet, "rollout": phase_rollout,
          "grad_parity": phase_grad_parity,
          "grad_parity_bf16": phase_grad_parity_bf16, "train": phase_train,
          "conv_bn": phase_conv_bn,
          "resnet_grad_parity": phase_resnet_grad_parity,
          "resnet_train": phase_resnet_train,
          "bert_parity": phase_bert_parity, "bert_serve": phase_bert_serve,
          "bert_train": phase_bert_train, "mnist_train": phase_mnist_train,
          "cifar_train": phase_cifar_train,
          "resnet_variants": phase_resnet_variants, "ckpt": phase_ckpt,
          "hvd": phase_hvd}


if __name__ == "__main__":
    sys.exit(main())
