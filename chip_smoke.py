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
     step; MFU from the trainer's own FLOP count (``obs/flops.py``, as
     for ResNet, CIFAR and BERT below);
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
 19b. the supervised training run (``supervise``): lm_long at phase
     19's cuts under ``python -m tpuframe_torch.launch local --nprocs 1
     --relaunch 2``, each attempt a ``--train-worker`` process, with
     ``TPUFRAME_FAULTS=host:step=3:kind=hang:once=1,host:step=5:kind=
     sigterm`` and the run's telemetry on (events, TensorBoard, the
     timeline, a trace of step 6, devmem every second, the trainer's and
     the supervisor's exporters): attempts exit 13 (stall abort), 14
     (preempted) and 0; one event file with three attempts, each with
     run_start (h100, FLOPs) and a run_end whose buckets sum to wall;
     the stall, its flight dump and the preempt recorded; step losses 1-6
     bit-equal to phase 19's straight run; the resumed attempts' flash
     launches all on the tensor cores; ``python -m tpuframe_torch.obs
     summarize`` and ``anomalies`` read it; every artifact checked;
 20. the Horovod slice (``hvd``), in worlds of processes that
     ``LocalCluster`` starts with the launcher's environment (this process
     holds no process group): (a) a world of one over NCCL, every hvd verb
     and op on CUDA tensors against its plain expectation, then
     imagenet_resnet50 at RESNET_CUTS with ``grad_reduce="adasum"``, its
     losses equal to phase 12's and every fused conv+BN launch on the
     tensor cores (path ``hvd_resnet``), and ``hvd.DistributedOptimizer``
     through the fusion buckets bit-equal to the per-tensor path; (b)
     cifar10_resnet18 as two processes on the one card over gloo
     (HVD_CIFAR_CUTS), with TPUFRAME_FUSION_THRESHOLD unset, at 64 MiB,
     at 4 MiB and unset again, under TPUFRAME_CHECK_SPMD=1: final states
     bit-identical across ranks and across thresholds, step 1 against the
     plain data-parallel step, the all_reduce calls of every step equal
     to the bucket census, buckets started inside the backward, the loss
     falling, step p50 and idle share by threshold (gloo through the
     host); (c) ``adasum_combine`` at ResNet-50's leaf shapes against
     float64; (d) probes written down: raw gloo verbs on CUDA tensors, and
     two NCCL ranks on one card; (e) imagenet_resnet50 bn="fused" as two
     processes, unset and at 4 MiB, every fused conv+BN launch on the
     tensor cores (path ``hvd_resnet50_x2``); (f) a divergent threshold
     under TPUFRAME_CHECK_SPMD=1 failing both ranks before step 1;
 21. the ZeRO-1 weight update and the int8-block wire (``zero1``):
     imagenet_resnet50 bn="fused" as (e)'s two gloo processes, (i) zero1
     fp unset, (ii) zero1 fp at 4 MiB, (iii) zero1 int8-block, (iv)
     replicated int8-block, through ``train.main`` with
     TPUFRAME_WEIGHT_UPDATE and TPUFRAME_WIRE_FORMAT: ranks bit-identical,
     step 1 against the plain data-parallel step, (i) and (ii) bit-equal
     to (e)'s unset run, a rank's optimizer state padded_bytes / n, wire
     bytes and collective calls a step equal to the byte laws and the
     census, the int8 gradients within 2 x blockmax / 254 of the fp mean
     and the loss gap bounded, every fused conv+BN launch on the tensor
     cores (path ``zero1``); step p50, peak memory, idle share;
 22. mixture of experts, expert and tensor parallelism (``moe``):
     lm_long at its widths with 8 experts, top-2, on every second block
     (4 layers, S=4096, global batch 2) through ``train.main``, (a) as one
     process, then (b) on data=1 x expert=2 and (c) on data=1 x model=2 in
     one world of two gloo processes: step 1 of (b) and (c) against (a) and a
     one-process f32 step by phase seq's noise rule (loss, aux, gradient
     norm, every parameter's gradient put together from the ranks'
     blocks), replicated leaves bit-identical across ranks, every flash
     launch on the tensor cores ((c)'s on 6 heads), the collectives of
     every step equal to their law (path ``moe``); step p50 and p10-p90,
     peak memory and state bytes a rank, bytes a step, idle share;
 22b. fsdp's sharded state (``fsdp``): glue_bert (a) one process, (b)
     fsdp=2, (c) fsdp=2 x model=2; lm_long (d0) one process, (d) fsdp=2;
     imagenet_resnet50 bn="fused" (e0) one process, (e) fsdp=2 from
     ``TPUFRAME_SPEC="dp=1,fsdp=2"`` (BatchNorm statistics over the
     batch group); the worlds at once: step 1 against one-process f32
     and bf16 steps ((e)'s running statistics too), replicated leaves
     bit-identical, each rank's blocks, the collectives of every step
     equal to their law, every kernel launch a rank exact and on the
     tensor cores, (e)'s log naming its spec; the flash and fused
     conv+BN kernels at a rank's shapes against their plain versions;
 23. pipeline parallelism (``pp``): lm_long at its widths and depth as
     transformer-lm-pp, S=4096, global batch 8 in 4 microbatches, (a) as
     one process beside a one-process f32 step, (b) on pipe=2 as two gloo
     processes, both worlds at once (beside phase fsdp's worlds in a
     whole run): step 1 of (b) against the f32 step by phase seq's noise
     rule with (a) the bf16 yardstick, replicated leaves bit-identical
     across the stages, each rank's parameters and moments its stage's
     layers, the pipe traffic of every step equal to its law, every flash
     launch on the tensor cores (path ``pp``), and the kernels at a
     microbatch's attention against their plain versions and timed;
     step p50, peak memory, state bytes a rank, idle share.

For the time limit a whole run takes phase 23's kernel checks after phase
19, then runs phases 20-21 in a process of their own (``--hvd-chain``)
beside phases 22, fsdp, 23 and seq, in that order, and phase 23's worlds
beside phase fsdp's; the step times of those phases are read with other
worlds on the card and the host.  Its processes share the large
synthetic datasets through files (DATA_SHARE_ENV) instead of each
building them.

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
import socket
import statistics
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import Future, ThreadPoolExecutor
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
from tpuframe_torch.data.pipeline import ShardedLoader  # noqa: E402
from tpuframe_torch.models import get_model  # noqa: E402
from tpuframe_torch.models.bert import BertConfig  # noqa: E402
from tpuframe_torch.models.transformer_lm import LMConfig  # noqa: E402
from tpuframe_torch.obs import events  # noqa: E402
from tpuframe_torch.obs import exporter as obs_exporter  # noqa: E402
from tpuframe_torch.obs import flops as obs_flops  # noqa: E402
from tpuframe_torch.obs import goodput as obs_goodput  # noqa: E402
from tpuframe_torch.obs import slo as slo_lib  # noqa: E402
from tpuframe_torch.obs import tracing  # noqa: E402
from tpuframe_torch.models import resnet as resnet_lib  # noqa: E402
from tpuframe_torch.ops import attention as attn  # noqa: E402
from tpuframe_torch.ops import flash_attention as fa  # noqa: E402
from tpuframe_torch.ops import fused_conv_bn as fcb  # noqa: E402
from tpuframe_torch.ops import precision_probe as pp  # noqa: E402
from tpuframe_torch.ops import seq_parallel as sp  # noqa: E402
from tpuframe_torch.parallel import bootstrap, collectives, hvd  # noqa: E402
from tpuframe_torch.parallel import fusion  # noqa: E402
from tpuframe_torch.parallel import mesh as mesh_lib  # noqa: E402
from tpuframe_torch.parallel import quantwire  # noqa: E402
from tpuframe_torch.parallel import step as step_lib  # noqa: E402
from tpuframe_torch.parallel import zero1  # noqa: E402
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


# A whole or partial run shares the large synthetic datasets between its
# processes through files in this directory (:func:`_shared_build`).
DATA_SHARE_ENV = "TPUFRAME_SMOKE_DATA_DIR"
DATA_SHARE_BYTES = 64 << 20
_DATA_SHARE = None      # the directory, in the process that made it


def _reuse_synthetic_datasets() -> None:
    """Build each synthetic dataset once a process, and a large one once a
    run (:func:`_shared_build`).  With no data directory
    ``datasets.build`` is a pure function of its arguments (seeded
    templates, the JAX package's bits), and ``train.main`` builds the
    whole split again at every call: ImageNet's 2048 f32 images at 224 x
    224 (1.2 GB) took 26 s of host CPU a build, and the ResNet-50 phases
    call the trainer a dozen times, in a dozen processes.  The datasets
    are only read (a rank's shard is a new view), so every call gets the
    same data as before."""
    build, cache = datasets.build, {}

    def cached(name, data_dir=None, **kwargs):
        if data_dir is not None:
            return build(name, data_dir, **kwargs)
        key = (name, json.dumps(kwargs, sort_keys=True))
        if key not in cache:
            if len(cache) >= 2:             # the latest two configs
                cache.pop(next(iter(cache)))
            cache[key] = _shared_build(build, name, kwargs)
        return cache[key]

    datasets.build = cached


def _shared_build(build, name: str, kwargs: dict):
    """``build(name, None, **kwargs)``, read from the run's share
    (DATA_SHARE_ENV) when a process has written it there; a result of
    DATA_SHARE_BYTES or more that this process built is written there
    (each column a ``.npy``, the directory renamed into place whole)."""
    root = os.environ.get(DATA_SHARE_ENV)
    if not root or not os.path.isdir(root):
        return build(name, None, **kwargs)
    key = hashlib.sha256(json.dumps([name, kwargs], sort_keys=True)
                         .encode()).hexdigest()[:16]
    where = Path(root, key)
    if where.is_dir():
        splits = json.loads((where / "splits.json").read_text())
        return tuple(datasets.ArrayDataset(
            {c: np.load(where / f"{i}.{c}.npy") for c in cols})
            for i, cols in enumerate(splits))
    out = build(name, None, **kwargs)
    if not (isinstance(out, tuple) and all(
            isinstance(d, datasets.ArrayDataset) for d in out)):
        return out
    if sum(v.nbytes for d in out for v in d.columns.values()) \
            >= DATA_SHARE_BYTES:
        tmp = Path(tempfile.mkdtemp(dir=root))
        for i, d in enumerate(out):
            for c, v in d.columns.items():
                np.save(tmp / f"{i}.{c}.npy", v)
        (tmp / "splits.json").write_text(
            json.dumps([list(d.columns) for d in out]))
        try:
            os.rename(tmp, where)
        except OSError:                  # another process was first
            shutil.rmtree(tmp, ignore_errors=True)
    return out


_reuse_synthetic_datasets()

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

# The supervised training run (phase ``supervise``): lm_long at
# CKPT_LM_CUTS (S=4096, batch 8, 6 steps, async saves every 2, log every
# step) under ``python -m tpuframe_torch.launch local --nprocs 1
# --relaunch 2``, each attempt a ``chip_smoke.py --train-worker`` process.
# The faults: attempt 0 commits step 2 and hangs after step 3 (rc 13 from
# the stall watchdog); the hang is ``once``, so attempt 1 resumes at 2 and
# is preempted after step 5 (rc 14); attempt 2 resumes at 5 and finishes.
SUPERVISE_FAULTS = "host:step=3:kind=hang:once=1,host:step=5:kind=sigterm"
# The stall timeout: at least 5x the longest gap between two beats of an
# attempt, which the phase measures on its timeline and checks.  A step
# is ~0.4 s at these cuts; the longest gap is a process's first async
# snapshot, which pins its host buffers (~1.6 GB): 0.6-1.6 s on one H100
# (700 W) in this phase's runs, and more on a host that pins more slowly.
# 20 s is 5x a gap of 4 s; the hang costs attempt 0 the whole timeout.
SUPERVISE_STALL_TIMEOUT_S = 20.0
SUPERVISE_STALL_POLL_S = 0.5
SUPERVISE_BACKOFF_S = 0.5
SUPERVISE_TRACE_STEPS = "5:1"      # step 6, inside attempt 2
SUPERVISE_TIMEOUT_S = 300          # the supervisor is killed past this
SUPERVISE_BUDGET_S = 100.0

# The Horovod slice (phase 20, ``hvd``): worlds of ranks started by
# LocalCluster with the launcher's environment, each rank a process that
# runs this script with ``--hvd-worker``; this process holds no group.
# A world's ranks must end within this (a hung probe is killed and
# reported).
HVD_TIMEOUT_S = 300
# Phases hvd and zero1, run beside the others in a process of their own,
# are stopped past this (~200 s in a whole run).
HVD_CHAIN_TIMEOUT_S = 900
HVD_PROBE_TIMEOUT_S = 90
# (b) the reference's workload 2, cifar10_resnet18 at its own widths,
# batch (256 global, 128 a rank) and recipe, as two processes on the one
# card over gloo (NCCL refuses two ranks on one card).  Cut: steps, 2000
# -> 10 (20 before phase zero1 needed the time), and one eval batch, as
# phase 17.
HVD_CIFAR_CUTS = {"mesh": {"data": 2}, "total_steps": 10, "eval_every": 10,
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
# (b) the fusion buckets (TPUFRAME_FUSION_THRESHOLD): unset (one
# collective a tensor, 104 a step), Horovod's default 64 MiB (one gradient
# bucket: 62 leaves, 44.7 MB) and 4 MiB (12 gradient buckets, so the
# staged pass has buckets to start during the backward), then unset again
# (all three ran twice before the second fused round's time went to
# phase zero1), in one world of two processes, every run with
# TPUFRAME_CHECK_SPMD=1.  A fused run's final state must equal the first
# unfused run's bit for bit, or lie within the two unfused runs' measured
# difference (max |diff| over every leaf).  These runs take cuDNN's
# deterministic algorithms (torch.backends.cudnn.deterministic), so that
# difference is that of the reduction alone.  One more unset run on
# cuDNN's default algorithms, the configuration the trainer runs (its step
# p50 is the two-process metric of earlier records), is held to the
# ranks' bit-identity and the census, not to the other runs' state.
HVD_FUSION_SETTINGS = (None, 64 << 20, 4 << 20, None)
# (e) imagenet_resnet50 bn="fused" as two processes (RESNET_CUTS on a
# data=2 mesh: batch 256, 128 a rank, 4 steps): unset and 4 MiB (161
# leaves in 32 gradient buckets).  An unset run used to go again for the
# unfused runs' difference; on cuDNN's deterministic algorithms it read 0
# in every call, and the repeat's time went to phase zero1: the fused run
# (and phase zero1's fp runs) is held to the unset run bit for bit.
HVD_RESNET_ARGS = RESNET_ARGS + ["--set", "mesh={'data': 2}"]
HVD_RANK_BATCH = RESNET_BATCH // 2     # each rank's share of (e)'s batch
HVD_RESNET_SETTINGS = (None, 4 << 20)
# (f) the program check: TPUFRAME_CHECK_SPMD=1 with rank r's threshold
# HVD_SPMD_THRESHOLDS[r]; both ranks must exit non-zero before step 1.
HVD_SPMD_THRESHOLDS = (4 << 20, 64 << 20)
# (a) hvd.DistributedOptimizer over NCCL with the knob at this threshold.
HVD_OPT_THRESHOLD = 4 << 20

# The ZeRO-1 weight update and the int8-block wire (phase ``zero1``):
# imagenet_resnet50 bn="fused" at full width as phase hvd (e)'s two gloo
# processes on the one card (HVD_RESNET_ARGS: RESNET_CUTS on a data=2
# mesh, batch 256, 128 a rank, 4 steps + 1 eval batch), on cuDNN's
# deterministic algorithms as (e), once for each setting: (label, the
# trainer's environment, TPUFRAME_FUSION_THRESHOLD).
ZERO1_SETTINGS = (
    ("(i) zero1 fp, unset", {"TPUFRAME_WEIGHT_UPDATE": "zero1"}, None),
    ("(ii) zero1 fp, 4 MiB", {"TPUFRAME_WEIGHT_UPDATE": "zero1"}, 4 << 20),
    ("(iii) zero1 int8-block", {"TPUFRAME_WEIGHT_UPDATE": "zero1",
                                "TPUFRAME_WIRE_FORMAT": "int8-block"}, None),
    ("(iv) replicated int8-block",
     {"TPUFRAME_WIRE_FORMAT": "int8-block"}, None),
)
# (i) and (ii) against (e)'s unset replicated run: the gradient norm of
# step 1 is the chunks' sums of squares plus one scalar all-reduce, where
# the replicated step sums the whole tensors' squares: f32 sums in
# another order, ~1e-7 relative over 25.6 M terms.
ZERO1_NORM_RTOL = 1e-6
# (iii) and (iv): |loss(int8) - loss(fp)| at every step, against (i) and
# (e)'s unset run.  Step 1's loss is computed before any update, so it is
# equal; a later step's parameters differ by the updates' quantization,
# at most lr x 2 x blockmax / 254 an element a step (lr <= 2e-4 in these
# warmup steps), far below the bf16 forward's own rounding, which then
# decides the gap.  The bound is the JAX package's documented acceptance
# bound for the int8 wire (tests/test_quantwire.py, 2e-3 a step).
ZERO1_INT8_LOSS_GAP = 2e-3
# (iii): the quantized update-delta gather, at the first step whose
# learning rate is above 0 (step 2: imagenet_resnet50's warmup starts at
# lr 0, so step 1's delta is zero), per element against the exact delta:
# at most half a quantization step, blockmax / 254, times the f32
# roundings of the scale, the division and the product (together under
# 3.1e-5 relative; the slack below is 2^-12).
ZERO1_DELTA_SLACK = 1.0 + 2.0 ** -12

# Sequence parallelism (phase ``seq``): lm_long as its own recipe trains
# it, on its own mesh and sequence: hidden 768, 12 layers, 12 heads of
# 64, vocab 32000, bf16, remat, the fused xent head, flash attention, S
# 32768, data=2 x seq=2 (four ranks, gloo: NCCL refuses two ranks on one
# card).  Cut for the time limit: the steps (2, with one eval batch at
# the end; 3 before phase zero1 needed the time) and the global batch,
# 8 -> 4, so each rank holds [2, 16384] tokens, and the depth, 12 -> 4
# -> 2 layers (phases moe and fsdp needed the time; every check a layer
# stays).  At
# batch 8 a step took 20.5 s (ring) and 18.5 s (Ulysses), bound by the
# seq group's bytes through gloo's host copies, and the phase 334.5 s.
SEQ_RANKS = 4
SEQ_MESH = {"data": 2, "seq": 2}
SEQ_STEPS = 2
SEQ_EVAL_BATCHES = 1
SEQ_GLOBAL_BATCH = 4
SEQ_LAYERS = 2
SEQ_CUTS = {"mesh": SEQ_MESH, "total_steps": SEQ_STEPS,
            "eval_every": SEQ_STEPS, "eval_batches": SEQ_EVAL_BATCHES,
            "log_every": 1, "global_batch": SEQ_GLOBAL_BATCH}
SEQ_MODES = ("ring", "ulysses")
SEQ_TIMEOUT_S = 900
# (c)'s shapes: a rank's attention at lm_long's uncut batch, batch 8 /
# data 2: the ring's stages, sequence 32768 / seq 2, and Ulysses's
# whole-sequence call on 12 heads / seq 2.
SEQ_RING_SHAPE = (4, 16384, 12, 64)
SEQ_ULYSSES_SHAPE = (4, 32768, 6, 64)
# Step 1 of the four-rank run against one process on the same global
# batch and weights (seq 1), held as phase grad_parity_bf16 holds bf16:
# each parameter's reduced gradient (rank 0's, before the optimizer)
# and the loss and the gradient norm, the seq run's relative distance
# from the one-process f32 step at most BF16_NOISE_FACTOR times the
# one-process bf16 step's own (its rounding noise); the loss and the
# norm may instead lie within SEQ_PARITY_RTOL of the f32 value.  The ring
# rounds each stage's output to bf16 before the merge and Ulysses runs
# the kernels on other head groups, so the seq runs carry bf16 noise of
# their own.
SEQ_PARITY_RTOL = 1e-3
# (c) compares [B, S, N, D] tensors tile by tile: for each batch row,
# head and tile of SEQ_TILE_ROWS sequence rows, ||diff|| / ||plain||, and
# the worst tile counts.  A max |diff| over the whole tensor is set by
# the few early rows of a long causal sequence, whose outputs are O(1),
# while the late rows' outputs are ~sqrt(1/t) (~0.01 at t = 16k); the
# tile metric holds every part of the sequence to its own size.
SEQ_TILE_ROWS = 128
# (c) The flash-stage ring against the plain-stage ring at
# SEQ_RING_SHAPE (bf16 in, causal), worst tile: the plain stages compute
# in f32 and round once at the end; the flash stages round P to bf16
# inside the kernel (2^-9 relative on each p, TOL's reason) and each
# stage's output to bf16 before the f32 merge, then the merged output
# once more: ~3e-3 of a tile's norm.  The gradients carry the backward
# kernels' rounding of P and dS to bf16, the stage cotangents w_i * dO
# rounded to bf16 before the kernels take them, and the final bf16
# gradient: a few 2^-9.  Measured on the H100: out 3.4e-3, dq 4.0e-3,
# dk 6.4e-3, dv 6.6e-3; the limits are three times that, far below the
# 1 of a wrong stage, mask or merge.
SEQ_RING_TOL = {"out": 1e-2, "grad": 2e-2}
# (c) ``flash_mha_lse`` through its kernels against its plain versions,
# one batch row and head at a time, at each stage the seq run gives the
# kernels (SEQ_KERNEL_CASES), worst tile: kernel and plain version each
# round P (forward) or P and dS (backward) to bf16 against other maxima
# and round their results to bf16, ~2e-3 of a tile's norm; the lse rows
# are f32 in both (TOL's 1e-4, absolute).  The lse cotangent enters the
# backward only as ``delta - dlse``, in f32.  Measured on the H100 in all
# three cases: out 2.7e-3, dq/dk/dv 6.5e-4 to 8.9e-4, lse 1.9e-6; the
# limits are 3.5 times that.
SEQ_KERNEL_TOL = {"out": 1e-2, "lse": TOL[torch.bfloat16]["lse"],
                  "grad": 3e-3}
# (name, shape, causal, a random N(0, 1) lse cotangent): the ring's
# diagonal stage and its off-diagonal stage (the lse rows merge, so both
# take a non-zero dlse), and Ulysses's call (its lse is unused).
SEQ_KERNEL_CASES = (("ring diagonal stage", SEQ_RING_SHAPE, True, True),
                    ("ring off-diagonal stage", SEQ_RING_SHAPE, False, True),
                    ("ulysses", SEQ_ULYSSES_SHAPE, True, False))

# Mixture of experts, expert and tensor parallelism (phase ``moe``): the
# lm_long recipe at its widths and depth (hidden 768, 12 heads,
# intermediate 3072, vocab 32000, bf16, remat, fused xent, flash) with
# Mixtral 8x7B's expert count and k (8 experts, top-2; Jiang et al.,
# arXiv 2401.04088) on every second block, capacity factor 1.25 and aux
# weight 0.01 (the defaults), cut to S=4096 and a global batch of 2 (T =
# 8192 tokens: the router's f32 [T, E, C] tensors are 672 MB each at C =
# capacity_for(8192, 8, 2, 1.25) = 2564; lm_long's own batch would make
# them 687 GB) and the depth to 4 layers (2 of them MoE layers; 8 until
# phase fsdp needed the time).  (a) one process; (b) data=1 x expert=2
# and (c) data=1 x
# model=2 in turn in one world of two gloo processes on the card
# (``--moe-worker``).
MOE_STEPS = 2
MOE_EVAL_BATCHES = 1
MOE_GLOBAL_BATCH = 2
MOE_DATA = {"seq_len": 4096}
MOE_MODEL = {"moe_experts": 8, "moe_k": 2, "num_layers": 4}
MOE_MESHES = {"b": {"data": 1, "expert": 2}, "c": {"data": 1, "model": 2}}
MOE_TIMEOUT_S = 600

# Phase fsdp: fsdp's sharded state (parallel/fsdp.py: each rank
# holds its blocks of the parameters and of the Adam moments, gathers a
# block before its use and reduce-scatters its gradient) and BERT's
# tensor parallelism.  glue_bert at BERT-base width and recipe, but for
# dropout 0 (the port seeds dropout by batch index, so a sharded run and
# one process would draw other masks; the head-sliced masks are held on
# the CPU, tests/test_torch_bert_tp.py), with TPUFRAME_ATTN_IMPL=pallas:
# (a) as one process, (b) on fsdp=2, (c) on fsdp=2 x model=2 (6 heads a
# rank); lm_long at its widths and depth (12 layers) on fsdp=2 with
# seq=1, S=4096 and global batch 2, as phase moe's (a) is cut (d), beside
# (d0), the same config as one process.  Three steps and one eval batch
# each; gloo on CUDA tensors: (b) then (d) in one world of two and (c)
# in a world of four, the two worlds at once (the time limit); rank 0's
# idle share from one profiled step of (a), (c), (d0) and (d).  Step 1
# of (b), (c) and (d) is held under
# BF16_NOISE_FACTOR's rule against one-process steps on the same global
# batch (each batch rank's first loader batch, stacked in batch order).
# (e0) and (e): imagenet_resnet50 with bn="fused" (the fused conv+BN
# kernel's path), bf16, at full width (ResNet-50, 1000 classes, 224 x
# 224): (e0) as one process, (e) on fsdp=2 as two gloo processes whose
# mesh comes from TPUFRAME_SPEC="dp=1,fsdp=2" (no mesh override), a third
# world beside the other two; each BatchNorm's statistics are the global
# batch's (parallel/fsdp.py).  Step 1 of (e) is held as (b)'s is, and so
# are its BatchNorm running statistics after step 1.  The cuts of
# FSDP_RESNET_CUTS and their reasons are beside them.
FSDP_STEPS = 3
FSDP_EVAL_BATCHES = 1
FSDP_BERT_KW = {"dropout": 0.0}
FSDP_LM_DATA = {"seq_len": 4096}
FSDP_LM_BATCH = 2
FSDP_RESNET_SPEC = "dp=1,fsdp=2"
FSDP_RESNET_CUTS = {
    # the config's model with the fused conv+BN op
    "model_kwargs": {"bn": "fused"},
    # 2048 in the recipe (8 chips): 64, 32 images a rank, for the time
    # limit; the LR follows the config's rule (base_lr x batch / 256)
    "global_batch": 64,
    # no ImageNet on the machine: phase resnet_train's synthetic images
    "dataset_kwargs": {"synthetic_size": 2048},
    # the port seeds augmentation by batch index, as it seeds dropout, so
    # a sharded run's flips would not be one process's on the same batch
    "augment": "none",
}
FSDP_ONE = {"bert": {"data": 1}, "lm": {"data": 1, "seq": 1},
            "resnet": {"data": 1}}
# world: (ranks, its runs (which, family, mesh; None: TPUFRAME_SPEC's),
# extra environment)
FSDP_WORLDS = {"bd": (2, (("b", "bert", {"data": 1, "fsdp": 2}),
                          ("d", "lm", {"data": 1, "fsdp": 2, "seq": 1})),
                      {}),
               "c": (4, (("c", "bert", {"data": 1, "fsdp": 2, "model": 2}),),
                     {}),
               "e": (2, (("e", "resnet", None),),
                     {"TPUFRAME_SPEC": FSDP_RESNET_SPEC})}
FSDP_TAGS = {"a": "(a) glue_bert one process",
             "b": "(b) glue_bert fsdp=2",
             "c": "(c) glue_bert fsdp=2 x model=2",
             "d0": "(d0) lm_long one process",
             "d": "(d) lm_long fsdp=2",
             "e0": "(e0) imagenet_resnet50 bn=fused one process",
             "e": f"(e) imagenet_resnet50 bn=fused TPUFRAME_SPEC="
                  f"{FSDP_RESNET_SPEC}"}
FSDP_TIMEOUT_S = 600

# Phase pp: pipeline parallelism (parallel/pp.py, parallel/pp_lm.py: GPipe
# over the pipe axis, each stage holding its layers of the layer-stacked
# blocks and their moments).  lm_long at its widths and depth (12 layers,
# 134.1 M parameters) as transformer-lm-pp (ScanBlockLM; seq_mode none,
# no shard_seq), bf16, remat, fused xent, flash on the tensor cores,
# S=4096, global batch 8 in PP_MICRO microbatches of 2 rows, 2 steps and
# one eval batch: (a) one process (no pipe), beside a one-process f32
# step 1 on the same batch; (b) pipe=2, two gloo processes on the card.
# (a) and (b) run as worlds of their own at once, beside phase fsdp's
# worlds in a whole run (the time limit), so their times are contended.
# Step 1 of (b) is held under BF16_NOISE_FACTOR's rule against the f32
# step, with (a) the bf16 yardstick.
PP_STEPS = 2
PP_EVAL_BATCHES = 1
PP_DATA = {"seq_len": 4096}
PP_BATCH = 8
PP_MICRO = 4
PP_WORLDS = {"a": {"data": 1}, "b": {"data": 1, "pipe": 2}}
PP_TAGS = {"a": "(a) lm_long transformer-lm-pp one process",
           "b": "(b) lm_long transformer-lm-pp pipe=2"}
PP_TIMEOUT_S = 600


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


def _delta_bytes(do) -> int:
    """What bounds the delta pass: the bytes of the function it stands
    for, ``rowsum(dO * O)``: dO and O read once, one f32 a row written.
    Its multiply-adds, one an element, take far less time; the kernel's
    recompute of p and dp is its design's work, not the function's."""
    b, s, n, _ = do.shape
    return 2 * do.numel() * do.element_size() + b * s * n * 4


def _delta_library_ms(q, k, v, do, mask, causal, iters: int = 10):
    """The delta pass's yardstick: one PyTorch call of the function it
    stands for, ``rowsum(dO * O)`` (``torch.linalg.vecdot``, f32, [B, S,
    N]), on f32 copies of the same dO and of the forward's O (made before
    the timing), by CUDA events and by profiler device time.  The port
    never calls it."""
    out, _ = fa.flash_fwd(q, k, v, mask=mask, causal=causal)
    dof, of = do.float(), out.float()
    call = lambda: torch.linalg.vecdot(dof, of)  # noqa: E731
    return cuda_ms(call, iters), device_ms(call, 3)


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
    # dq and dkv read q, k, v, dO, lse and delta.  The delta pass is bound
    # by its bytes alone (:func:`_delta_bytes`); its FLOPs, the recompute's
    # matmuls, give its rate.
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
        if which == "delta":
            t_ops, nbytes = 0.0, _delta_bytes(tensors[3])
        else:
            t_ops, nbytes = ops / PEAK_OPS_S[dtype], qkvo + rows + out_bytes
        t_bytes = nbytes / PEAK_BYTES_S
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
    (res["delta"]["library_ms"],
     res["delta"]["library_device_ms"]) = _delta_library_ms(
        *tensors[:4], mask, True)
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
        + f"; delta's rowsum(dO*O) by torch.linalg.vecdot "
          f"{res['delta']['library_ms']:.4f} ms (device "
          f"{_dev(res['delta']['library_device_ms'], '.4f')})"
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
    # the trainer's run_start count (obs/flops.py): 6 x matmul params x
    # tokens + 3 x 4 x D x causal pairs x N x L
    flops = obs_flops.lm_step_flops(LMConfig(**cfg.model_kwargs), b, s)
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

    # Phase hvd (e)'s calls: ResNet-50 as two processes, HVD_RANK_BATCH
    # images a rank, so every M is half the batch-256 one and dW may take
    # other splits (fcb.dw_splits depends on M).  Each through the public
    # wrapper, on the tensor cores, against the plain version.
    rworst, rsplits = {"da": 0.0, "dw": 0.0}, {}
    rshapes = resnet_conv_bn_shapes(batch=HVD_RANK_BATCH)
    for n, h, w, k, c in rshapes:
        m = n * h * w
        if fcb.conv_bn_route(dtype, k, c) != "tensor_core":
            raise RuntimeError(f"rank batch M={m} K={k} C={c} is not on the "
                               f"tensor-core route")
        errs = _conv_bn_check(f"rank batch M={m} K={k} C={c}",
                              _conv_bn_inputs(m, k, c, dtype, gen))
        for g in rworst:
            rworst[g] = max(rworst[g], errs[g])
        rsplits[f"M={m} K={k} C={c}"] = fcb.dw_splits(
            m, k, c, "tensor_core")[0]
    log(f"[conv-bn] phase hvd (e)'s {len(rshapes)} shapes ({HVD_RANK_BATCH} "
        f"images a rank), bf16 on the tensor cores against the plain "
        f"version: worst max abs err {rworst}; dW splits {rsplits}")

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
    out["rank_batch_max_abs_err"] = rworst
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
    fwd = obs_flops.image_forward_flops(harness.state.model, (224, 224, 3))
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
    lib, lib_dev = _delta_library_ms(q, k, v, do, mask, False, 100)
    ops = 4 * d * _pairs(BERT_SEQ, BERT_SEQ, b, n, mask, False)
    nbytes = _delta_bytes(do)
    case = {"case": name, "route": fa.bwd_route(q.dtype, d),
            "max_abs_err": err, "ms": ms, "device_ms": dev,
            "plain_ms": plain, "library_ms": lib,
            "library_device_ms": lib_dev,
            "bound_ms": 1e3 * nbytes / PEAK_BYTES_S, "bound_by": "bytes",
            "ops": ops, "bytes": nbytes}
    share = ("" if dev is None
             else f"; {case['bound_ms'] / dev:.3f} of it by device time")
    log(f"[bert-delta] {name}, route {case['route']}: err {err:.2e} (tol "
        f"{DELTA_TOL} x max|plain| {scale:.2e}); kernel {ms:.4f} ms (device "
        f"{_dev(dev, '.4f')}), plain {plain:.4f} ms, rowsum(dO*O) by "
        f"torch.linalg.vecdot {lib:.4f} ms (device {_dev(lib_dev, '.4f')}), "
        f"bound {case['bound_ms']:.5f} ms ({case['bound_by']}{share})")
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
    """Model FLOPs of an average step of the first ``steps`` batches, as
    the trainer counts one (``obs/flops.py``): 6 x (encoder matmul params)
    x tokens, the pooler and classifier on one row per example, and 3 x 4
    x D x (kept query-key pairs) x N x L for attention."""
    pairs = []
    for i, batch in enumerate(harness.train_loader.from_step(0)):
        if i >= steps:
            break
        pairs.append(obs_flops.bert_pairs(batch["attention_mask"]))
    return obs_flops.bert_step_flops(harness.state.model.cfg, BERT_BATCH,
                                     BERT_SEQ, statistics.mean(pairs))


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


def _profile_steps(harness, calls: int, tries: int = 1):
    """``calls`` more training steps of ``harness`` on one batch: wall ms
    a step, the kernels (largest first; None when the profiler's record
    is incomplete) and :func:`_busy`'s ``(device ms a step, idle share,
    log text)``.  ``tries``: windows to take until one's record is whole
    (each window steps the state on); in a world of ranks every rank's
    record must be whole, so that all ranks take the next window (and its
    collectives) together."""
    import torch.distributed as dist
    batch = next(iter(harness.train_loader))
    step = lambda: float(harness.train_step(harness.state, batch)["loss"])  # noqa: E731
    wall_step = wall_ms(step, calls)

    def window():
        for _ in range(calls):
            step()

    agree = (None if not dist.is_initialized() or dist.get_world_size() == 1
             else lambda whole: all(hvd.allgather_object(whole)))
    kernels = device_time(window, tries=tries, agree=agree)
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
    fwd = obs_flops.image_forward_flops(harness.state.model, (32, 32, 3))
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
            "losses": resumed["losses"], "straight": straight["losses"],
            "restore_ms": restore_ms,
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


def train_worker(out: str, train_args: list) -> int:
    """One attempt of phase supervise (``--train-worker OUT -- <train
    args>``, started by ``python -m tpuframe_torch.launch``):
    ``train_lib.main`` with the attempt's kernel launches counted and, in
    a ``finally``, written with the routes and the exit code to
    ``OUT.<attempt>.json``.  The stall abort ends the process with
    ``os._exit(13)`` before any ``finally``, so that attempt writes none.
    The attempt's exporter writes ``OUT.prom``; the supervisor's writes
    the environment's textfile.  The kernels were built by the parent:
    the trainer loads them."""
    os.environ["TPUFRAME_METRICS_TEXTFILE"] = f"{out}.prom"
    reset_launches()
    rc = 1
    try:
        train_lib.main(train_args)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
        raise
    finally:
        Path(f"{out}.{events.attempt_id()}.json").write_text(json.dumps({
            "rc": rc, "launches": launch_counts(),
            "fwd_routes": dict(fa.FWD_ROUTES),
            "bwd_routes": dict(fa.BWD_ROUTES)}))
        bootstrap.shutdown()
    return 0


def _free_port() -> int:
    """A free loopback port whose successor (the supervisor's) is free
    too."""
    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port + 1))
            except OSError:
                continue
        return port
    raise RuntimeError("supervise: no free pair of ports")


def _attempt_checks(by_att: dict, n_params: int) -> tuple:
    """Per-attempt books: buckets summing to wall, run_start's hardware
    and FLOPs, the peak device memory against the state's bytes."""
    problems, books = [], {}
    state_bytes = 3 * 4 * n_params      # f32 parameters + 2 Adam moments
    for att, recs in sorted(by_att.items()):
        start = next((r for r in recs if r["type"] == "run_start"), None)
        end = next((r for r in recs if r["type"] == "run_end"), None)
        if start is None or end is None:
            problems.append(f"attempt {att}: run_start {start is not None}, "
                            f"run_end {end is not None}")
            continue
        if (start.get("generation") != "h100"
                or not (start.get("flops_per_step") or 0) > 0
                or start.get("flops_source") != "model"):
            problems.append(f"attempt {att}: run_start generation "
                            f"{start.get('generation')!r}, flops "
                            f"{start.get('flops_per_step')} "
                            f"({start.get('flops_source')})")
        g = end["goodput"]
        gap = abs(sum(g["buckets"].values()) - end["wall_s"])
        if gap > 1e-3:
            problems.append(f"attempt {att}: buckets sum "
                            f"{sum(g['buckets'].values()):.4f} s, wall "
                            f"{end['wall_s']:.4f} s")
        peak = end.get("peak_hbm_bytes") or 0
        if peak < state_bytes:
            problems.append(f"attempt {att}: run_end peak {peak} bytes < "
                            f"the state's {state_bytes}")
        books[att] = {"buckets": g["buckets"], "wall_s": end["wall_s"],
                      "final_step": end["final_step"], "peak": peak,
                      "mfu": end.get("mfu_productive"), "t0": recs[0]["t"],
                      "t1": recs[-1]["t"]}
    return problems, books


def _resumed_launches(workers: dict, layers: int) -> list:
    """Attempts 1 and 2: every flash launch on the tensor cores, at the
    counts ``_ckpt_lm`` holds a resume to (steps 3-5 with no eval, then
    step 6 and one eval batch)."""
    problems = []
    for att, steps, evals in ((1, 3, 0), (2, 1, TRAIN_EVAL_BATCHES)):
        w = workers.get(att)
        if w is None:
            problems.append(f"attempt {att} wrote no launch counts")
            continue
        fwd = (2 * steps + evals) * layers
        want = {"flash_fwd": fwd, "flash_bwd_delta": steps * layers,
                "flash_bwd_dq": steps * layers,
                "flash_bwd_dkv": steps * layers, "fused_conv_bn_bwd": 0,
                "precision_probe": 0}
        if w["launches"] != want:
            problems.append(f"attempt {att} launches {w['launches']}, want "
                            f"{want}")
        if (w["fwd_routes"] != {"tensor_core": fwd, "cuda_core": 0}
                or w["bwd_routes"] != {"tensor_core": 3 * steps * layers,
                                       "cuda_core": 0}):
            problems.append(f"attempt {att} routes: forward "
                            f"{w['fwd_routes']}, backward {w['bwd_routes']},"
                            f" want every launch on the tensor cores")
    return problems


def _longest_beat_gap(timeline: list, by_att: dict) -> tuple:
    """``(seconds, where)``: the longest gap between two beats of one
    attempt, and the attempt and the two beats (timeline phase, step) that
    bound it.  The trainer beats at the end of each ``train_step``,
    ``eval`` and ``checkpoint`` phase of its timeline; an attempt's beats
    are those inside its span of event records (the hang, after which no
    beat comes, is no gap)."""
    ends = sorted([(e["ts"] + e["dur"], e["name"],
                    e.get("args", {}).get("step")) for e in timeline
                   if e["ph"] == "X"
                   and e["name"] in ("train_step", "eval", "checkpoint")],
                  key=lambda beat: beat[0])
    longest, where = 0.0, "no gap"
    for att, recs in sorted(by_att.items()):
        lo, hi = (1e6 * min(r["t"] for r in recs) - 1e4,
                  1e6 * max(r["t"] for r in recs) + 1e4)
        beats = [b for b in ends if lo <= b[0] <= hi]
        for a, b in zip(beats, beats[1:]):
            if (b[0] - a[0]) / 1e6 > longest:
                longest = (b[0] - a[0]) / 1e6
                where = (f"attempt {att}, {a[1]} of step {a[2]} to {b[1]} "
                         f"of step {b[2]}")
    return longest, where


def _artifact_checks(root: str, records: list, timeline: list) -> list:
    """TensorBoard, the timeline, the trace window and the two
    exporters' textfiles."""
    from tpuframe_torch.obs import tensorboard as obs_tb

    problems = []
    tb_dir = os.path.join(root, "tb")
    tb_steps = set()
    for name in sorted(os.listdir(tb_dir)):
        tb_steps |= {step for step, tag, _ in obs_tb.read_scalars(
            os.path.join(tb_dir, name)) if tag == "train/loss"}
    if tb_steps != set(range(1, CKPT_STEPS + 1)):
        problems.append(f"TensorBoard train/loss at steps {sorted(tb_steps)}")
    names = {(e["name"], e["ph"]) for e in timeline}
    want = {("data_wait", "X"), ("train_step", "X"), ("checkpoint", "X"),
            ("stall_abort", "i"), ("preempted", "i")}
    if not want <= names:
        problems.append(f"timeline lacks {sorted(want - names)}")
    starts = [r for r in records if r["type"] == "trace_start"]
    ends = [r for r in records if r["type"] == "trace_end"]
    trace_dir = os.path.join(root, "events", "trace")
    traces = os.listdir(trace_dir) if os.path.isdir(trace_dir) else []
    if (len(starts) != 1 or len(ends) != 1 or not traces
            or {starts[0]["path"], ends[0]["path"]} != {trace_dir}
            or not starts[0]["t"] <= ends[0]["t"]):
        problems.append(f"trace window: {len(starts)} trace_start, "
                        f"{len(ends)} trace_end, files {traces}")
    child = Path(root, "worker.prom").read_text()
    for family in ("tpuframe_goodput_bucket_seconds", "tpuframe_step "):
        if family not in child:
            problems.append(f"the trainer's textfile lacks {family.strip()}")
    if "tpuframe_supervisor_attempts" not in Path(root,
                                                  "sup.prom").read_text():
        problems.append("the supervisor's textfile lacks "
                        "tpuframe_supervisor_attempts")
    return problems


def phase_supervise(straight: list | None = None,
                    train_mfu: float | None = None) -> dict:
    """The training run under its supervisor, full width: lm_long at
    CKPT_LM_CUTS through ``python -m tpuframe_torch.launch local --nprocs
    1 --relaunch 2``, each attempt a ``--train-worker`` process, with
    SUPERVISE_FAULTS armed and every knob of the run's telemetry on
    (events, TensorBoard, the timeline, a trace window, devmem every
    second, the trainer's and the supervisor's exporters).  Attempt 0
    stalls (rc 13), attempt 1 is preempted (rc 14), attempt 2 finishes.
    Held to: the books of every attempt, the losses of steps 1-6 bit-equal
    to a straight run (phase ckpt's, ``straight``, else one run here), the
    resumed attempts' kernel launches, the analyzer's reading, and every
    artifact.  Files live in a temporary directory, removed at the end."""
    layers = 12
    cfg = get_config("lm_long").with_overrides(**CKPT_LM_CUTS)
    if straight is None:
        straight = train_lib.train(cfg)["losses"]
    t0 = time.monotonic()
    root = tempfile.mkdtemp(prefix="tpuframe_supervise_")
    out = os.path.join(root, "worker")
    ev = os.path.join(root, "events")
    env = dict(os.environ)
    for var in ("TPUFRAME_ATTEMPT", "TPUFRAME_COORDINATOR",
                "TPUFRAME_NUM_PROCESSES", "TPUFRAME_PROCESS_ID"):
        env.pop(var, None)
    here = str(Path(__file__).resolve().parent)
    env.update({
        "PYTHONPATH": here + os.pathsep + env.get("PYTHONPATH", ""),
        "TPUFRAME_FAULTS": SUPERVISE_FAULTS,
        "TPUFRAME_STALL_TIMEOUT_S": str(SUPERVISE_STALL_TIMEOUT_S),
        "TPUFRAME_STALL_POLL_S": str(SUPERVISE_STALL_POLL_S),
        "TPUFRAME_RELAUNCH_BACKOFF_S": str(SUPERVISE_BACKOFF_S),
        "TPUFRAME_TB_DIR": os.path.join(root, "tb"),
        "TPUFRAME_TIMELINE": os.path.join(root, "timeline.json"),
        "TPUFRAME_TRACE_STEPS": SUPERVISE_TRACE_STEPS,
        "TPUFRAME_DEVMEM_INTERVAL_S": "1",
        "TPUFRAME_METRICS_TEXTFILE": os.path.join(root, "sup.prom"),
        "TPUFRAME_METRICS_PORT": str(_free_port()),
        # One bytecode cache for the supervisor, its three attempts and
        # the analyzer: where site-packages holds none and cannot take
        # one, every process compiles torch's modules anew (~4 s of its
        # ~6 s import, and again for torch._dynamo, which the first
        # checkpoint(remat) call of a step imports).
        "PYTHONPYCACHEPREFIX": os.path.join(root, "pycache")})
    train_args = ["--config", "lm_long"] + [
        a for k, v in CKPT_LM_CUTS.items() for a in ("--set", f"{k}={v!r}")
    ] + ["--ckpt-dir", os.path.join(root, "ck"), "--events-dir", ev]
    cmd = [sys.executable, "-m", "tpuframe_torch.launch", "local",
           "--nprocs", "1", "--relaunch", "2", "--", sys.executable,
           str(Path(__file__).resolve()), "--train-worker", out, "--",
           *train_args]
    try:
        try:
            sup = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                                 text=True, timeout=SUPERVISE_TIMEOUT_S)
        except subprocess.TimeoutExpired as e:
            raise RuntimeError(f"supervise: the supervisor ran past "
                               f"{SUPERVISE_TIMEOUT_S} s: "
                               f"{(e.stdout or b'')[-3000:]!r}") from None
        supervised_s = time.monotonic() - t0
        stdout = sup.stdout
        tail = (stdout[-4000:] + sup.stderr[-2000:])
        if sup.returncode != 0:
            raise RuntimeError(f"supervise: the supervisor exited "
                               f"{sup.returncode}:\n{tail}")
        problems = []
        rcs = [int(m) for m in re.findall(r"--- rank 0 \(exit (-?\d+)\) ---",
                                          stdout)]
        done = "[rank 0] [tpuframe] done" in stdout
        if rcs != [13, 14] or not done:
            problems.append(f"attempts' exit codes {rcs}, then "
                            f"{'0' if done else 'none'}; want 13, 14, 0")
        workers = {}
        for att in range(3):
            path = Path(f"{out}.{att}.json")
            if path.exists():
                workers[att] = json.loads(path.read_text())
        if sorted(workers) != [1, 2] or [workers[a]["rc"] for a in (1, 2)] \
                != [14, 0]:
            problems.append(f"launch files of attempts {sorted(workers)}, "
                            f"rcs {[w['rc'] for w in workers.values()]}")
        files = events.event_files(ev)
        records = events.merge(ev)
        bad = events.validate_files(files)
        by_att: dict = {}
        for r in records:
            by_att.setdefault(r["attempt"], []).append(r)
        if len(files) != 1 or sorted(by_att) != [0, 1, 2] or bad:
            problems.append(f"event files {files}, attempts "
                            f"{sorted(by_att)}, {len(bad)} invalid: "
                            f"{bad[:3]}")
        start = next(r for r in records if r["type"] == "run_start")
        more, books = _attempt_checks(by_att, int(start["n_params"]))
        problems += more
        a0 = by_att.get(0, [])
        stalls = [r for r in a0 if r["type"] == "stall"]
        if not stalls or not books.get(0, {}).get("buckets", {}).get(
                "stall", 0) > 0:
            problems.append(f"attempt 0: {len(stalls)} stall events, "
                            f"buckets {books.get(0, {}).get('buckets')}")
        flight0 = Path(ev, "flight_0.json")
        reason = (json.loads(flight0.read_text())["reason"]
                  if flight0.exists() else None)
        if reason != "stall_abort":
            problems.append(f"flight_0.json reason {reason!r}")
        if not any(r["type"] == "preempt" for r in by_att.get(1, [])):
            problems.append("attempt 1 has no preempt event")
        losses = {}
        for r in records:
            if r["type"] == "step" and "loss" in r:
                losses[r["step"]] = r["loss"]
        got = [losses.get(i) for i in range(1, CKPT_STEPS + 1)]
        if got != straight:
            problems.append(f"step losses {got} != straight {straight}")
        problems += _resumed_launches(workers, layers)
        # the analyzer's two commands, side by side
        clis = [subprocess.Popen([sys.executable, "-m", "tpuframe_torch.obs",
                                  verb, ev], cwd=here, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
                for verb in ("summarize", "anomalies")]
        outs = [p.communicate(timeout=120) for p in clis]
        summ, anom = (subprocess.CompletedProcess(p.args, p.returncode, *o)
                      for p, o in zip(clis, outs))
        summary = obs_goodput.from_events(records)
        if (summ.returncode != 0 or "3 attempt(s)" not in summ.stdout
                or "mfu_productive:" not in summ.stdout
                or not summary["restart_lost_s"] > 0):
            problems.append(f"summarize rc {summ.returncode}, restart-lost "
                            f"{summary['restart_lost_s']}:\n"
                            f"{summ.stdout[-1500:]}{summ.stderr[-500:]}")
        if "ANOMALY [stall]" not in anom.stdout:
            problems.append(f"anomalies name no stall:\n{anom.stdout[-800:]}")
        devmem = [d["bytes_in_use"] for r in records
                  if r["type"] == "devmem" for d in r["devices"]]
        if not devmem or min(devmem) <= 0:
            problems.append(f"devmem samples {devmem[:5]}")
        timeline = json.load(open(os.path.join(root, "timeline.json")))[
            "traceEvents"]
        problems += _artifact_checks(root, records, timeline)
        longest, gap_at = _longest_beat_gap(timeline, by_att)
        if SUPERVISE_STALL_TIMEOUT_S < 5 * longest:
            problems.append(f"stall timeout {SUPERVISE_STALL_TIMEOUT_S} s "
                            f"under 5x the longest gap between beats "
                            f"{longest:.3f} s ({gap_at})")
        if problems:
            raise RuntimeError("supervise: " + "; ".join(problems)
                               + f"\n--- supervisor ---\n{tail}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    phase_s = time.monotonic() - t0
    hang = next(r for r in a0 if r["type"] == "fault_injected")
    hang_s = books[0]["t1"] - hang["t"]
    relaunch = [books[b]["t0"] - books[a]["t1"] for a, b in ((0, 1), (1, 2))]
    card = _card_line()
    for att, b in books.items():
        log(f"[supervise] attempt {att} (rc {[13, 14, 0][att]}): final step "
            f"{b['final_step']}, wall {b['wall_s']:.3f} s, buckets "
            f"{b['buckets']}, peak device memory {b['peak'] / 2**30:.2f} GiB")
    log(f"[supervise] {card}: lm_long S=4096 batch 8 under python -m "
        f"tpuframe_torch.launch local --nprocs 1 --relaunch 2: exits 13, 14,"
        f" 0; restart-lost {summary['restart_lost_s']:.3f} s "
        f"({summary['retrained_steps']} step retrained); hang to rc 13 "
        f"{hang_s:.3f} s against a {SUPERVISE_STALL_TIMEOUT_S:g} s timeout "
        f"(poll {SUPERVISE_STALL_POLL_S:g} s; stall idle "
        f"{stalls[0]['idle_s']:.3f} s; longest gap between beats "
        f"{longest:.3f} s ({gap_at}), x5 {5 * longest:.3f} s); relaunch "
        f"gaps "
        f"{[round(x, 3) for x in relaunch]} s; mfu_productive "
        f"{summary.get('mfu_productive')} (run_end) beside phase train's "
        f"{train_mfu}; step losses 1-6 bit-equal to the straight run; "
        f"launches attempt 1 {workers[1]['launches']}, attempt 2 "
        f"{workers[2]['launches']}")
    log(f"[supervise] phase {phase_s:.1f} s (budget {SUPERVISE_BUDGET_S:g} "
        f"s), the supervised run {supervised_s:.1f} s; summarize:\n"
        f"{summ.stdout.rstrip()}")
    return {"launches": {name: workers[1]["launches"][name]
                         + workers[2]["launches"][name]
                         for name in launch_counts()},
            "phase_s": phase_s, "restart_lost_s": summary["restart_lost_s"],
            "hang_s": hang_s, "relaunch_s": relaunch,
            "mfu": summary.get("mfu_productive"), "books": books}


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


def _hvd_fused_optimizer() -> dict:
    """(a) ``hvd.DistributedOptimizer`` (Average) over NCCL on ResNet-50's
    161 parameters with random gradients, the knob unset and at
    HVD_OPT_THRESHOLD: the all_reduce calls of each ``step()`` (one a
    tensor; one a bucket of the census of the gradients in the
    optimizer's order) and whether the parameters after it are bit-equal
    to the per-tensor path's."""
    cfg = get_config("imagenet_resnet50").with_overrides(
        model_kwargs={"bn": "fused"})
    base = get_model(cfg.model, dtype=cfg.compute_dtype, device="cuda",
                     seed=cfg.seed, **cfg.model_kwargs)
    init = {k: v.clone() for k, v in base.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(5)
    grads = [torch.randn(p.shape, device="cuda", generator=gen)
             for p in base.parameters()]
    out, finals = {}, {}
    for threshold in (None, HVD_OPT_THRESHOLD):
        if threshold is None:
            os.environ.pop(fusion.ENV_VAR, None)
        else:
            os.environ[fusion.ENV_VAR] = str(threshold)
        base.load_state_dict(init)
        opt = hvd.DistributedOptimizer(build_optimizer(cfg, base))
        for p, g in zip(base.parameters(), grads):
            p.grad = g.clone()
        calls, restore = _counting_all_reduce()
        try:
            opt.step()
            torch.cuda.synchronize()
        finally:
            restore()
            os.environ.pop(fusion.ENV_VAR, None)
        finals[threshold] = [p.detach().clone() for p in base.parameters()]
        out[str(threshold)] = calls[0]
    out["want_fused"] = fusion.bucket_census(
        grads, HVD_OPT_THRESHOLD)["n_buckets"]
    out["leaves"] = len(grads)
    out["bit_equal"] = all(torch.equal(a, b) for a, b in zip(
        finals[None], finals[HVD_OPT_THRESHOLD]))
    return out


def hvd_worker_nccl(out: str) -> None:
    """(a) The one rank of a world of one over NCCL: init and first
    collective seconds, every verb, the NCCL kernels they ran,
    ``hvd.DistributedOptimizer`` through the fusion buckets
    (:func:`_hvd_fused_optimizer`), then imagenet_resnet50 (RESNET_CUTS)
    with grad_reduce="adasum" through ``tpuframe_torch.train.main``, its
    launches read around it."""
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
    fused_opt = _hvd_fused_optimizer()
    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    metrics = train_lib.main(RESNET_ARGS + ["--set", "grad_reduce='adasum'"])
    torch.cuda.synchronize()
    with open(out, "w") as f:
        json.dump({"group_s": group_s, "first_collective_s": first_s,
                   "checks": checks, "nccl_kernels": nccl,
                   "fused_opt": fused_opt,
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


def _counting_all_reduce():
    """``torch.distributed.all_reduce`` wrapped to count its calls
    (``calls[0]``); returns ``(calls, restore)``."""
    import torch.distributed as dist
    real, calls = dist.all_reduce, [0]

    def counting(*a, **k):
        calls[0] += 1
        return real(*a, **k)

    dist.all_reduce = counting
    return calls, lambda: setattr(dist, "all_reduce", real)


def _max_diff(got: dict, want: dict) -> float:
    """Max |got - want| over the tensor leaves of two host copies."""
    return max((float((got[n].double() - w.double()).abs().max())
                for n, w in want.items() if isinstance(w, torch.Tensor)
                and w.numel()), default=0.0)


def _hvd_train_runs(args: list, settings, capture: str | None,
                    profile: bool, deterministic: bool = True,
                    finals: str | None = None) -> list:
    """``tpuframe_torch.train.main(args)`` once for each
    TPUFRAME_FUSION_THRESHOLD of ``settings`` (None: unset) in this
    world.  Per run: losses and step ms, the all_reduce calls and the
    buckets started before ``backward()`` returned of every step, the
    census the step is held to (the reducer's gradient buckets plus the
    statistics-and-metrics buckets; unfused, one a tensor), launches and
    conv+BN routes, every rank's final-state digest, the final state's
    max |diff| from the first run's, and, with ``profile``, one more
    step profiled.  ``capture`` (a path stem): run 0's batch and init on
    every rank, and rank 0's state after step 1 of every run, saved
    there.  ``deterministic`` (cuDNN's deterministic algorithms): the
    runs then differ only by the reduction, so a fused run's state can be
    held to the unfused one's bit for bit (the unfused runs' difference
    reads 0); False runs cuDNN's defaults, as the trainer does.
    ``finals`` (a path stem): rank 0's final state of each unfused run
    ``k`` saved to ``finals.<k>.pt`` (phase zero1's baseline)."""
    rank = hvd.rank()
    torch.backends.cudnn.deterministic = deterministic
    calls, restore = _counting_all_reduce()
    build = train_lib.build_harness
    runs, ref, step1s = [], None, []
    try:
        for k, threshold in enumerate(settings):
            if threshold is None:
                os.environ.pop(fusion.ENV_VAR, None)
            else:
                os.environ[fusion.ENV_VAR] = str(threshold)
            got = {"steps": []}

            def capturing_build(cfg, device="cuda"):
                h = build(cfg, device)
                step = h.train_step

                def train_step(state, batch):
                    first = not got["steps"]
                    if first:
                        got["batch"] = _state_digest(batch)
                        if capture and k == 0:
                            got["batch_t"] = _cpu_tree(batch)
                            got["init"] = _cpu_tree(state.to_tree())
                    calls[0] = 0
                    metrics = step(state, batch)
                    red = step.reducer
                    got["steps"].append({
                        "calls": calls[0],
                        "early": None if red is None else red.early})
                    if first:
                        got["metrics"] = list(metrics.values())
                        got["step1"] = {key: float(v)
                                        for key, v in metrics.items()}
                        if capture and rank == 0:
                            step1s.append(_cpu_tree(state.to_tree()))
                    return metrics

                h.train_step = train_step
                got["harness"] = h
                got["reducer"] = lambda: step.reducer
                return h

            train_lib.build_harness = capturing_build
            reset_launches()
            try:
                metrics = train_lib.main(args)
            finally:
                train_lib.build_harness = build
            torch.cuda.synchronize()
            launches, routes = launch_counts(), dict(fcb.ROUTES)
            h = got.pop("harness")
            model = h.state.model
            stats = [b for b in model.buffers() if b.is_floating_point()]
            # the step's metrics: loss, accuracy and grad_norm (not reduced)
            reduced = stats + got["metrics"][:-1]
            red = got["reducer"]()
            if threshold is None:
                want = (sum(1 for p in model.parameters() if p.requires_grad)
                        + len(reduced))
            else:
                want = (red.census()["n_buckets"] + fusion.bucket_census(
                    reduced, threshold)["n_buckets"])
            final = _host_copy(h.state.to_tree())
            if finals and threshold is None and rank == 0:
                torch.save(final, f"{finals}.{k}.pt")
            digests = hvd.allgather_object(_state_digest(h.state.to_tree()))
            diff = 0.0 if ref is None else _max_diff(final, ref)
            ref = final if ref is None else ref
            run = {"threshold": threshold, "losses": metrics["losses"],
                   "step_ms": metrics["step_ms"],
                   "eval_loss": metrics.get("eval_loss"),
                   "eval_accuracy": metrics.get("eval_accuracy"),
                   "steps": list(got["steps"]), "want_calls": want,
                   "step1": got["step1"],
                   "grad_buckets": None if red is None
                   else red.census()["n_buckets"],
                   "batch": got["batch"], "launches": launches,
                   "routes": routes, "digests": digests, "diff": diff,
                   "all_launches": hvd.allgather_object(launches),
                   "all_routes": hvd.allgather_object(routes)}
            if k == 0 and capture:
                run["harness"] = h
                run["captured"] = {"batch": got["batch_t"],
                                   "init": got["init"]}
            if profile:
                restore()
                wall_step, kernels, (busy, idle, _) = _profile_steps(h, 1)
                calls, restore = _counting_all_reduce()
                run.update(wall_step=wall_step, device_ms=busy, idle=idle,
                           top=[(n[:60], ms, c)
                                for n, ms, c in (kernels or [])[:8]])
            runs.append(run)
            del h, model, stats, reduced
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        restore()
        os.environ.pop(fusion.ENV_VAR, None)
    if capture:
        torch.save({**runs[0].pop("captured"), "step1": step1s},
                   f"{capture}.{rank}.pt")
    return runs


def hvd_worker_cifar(out: str) -> None:
    """(b) A rank of the gloo world of two: the hvd verbs on CUDA tensors
    under gloo, then cifar10_resnet18 (HVD_CIFAR_ARGS) through
    ``tpuframe_torch.train.main`` once for each threshold of
    HVD_FUSION_SETTINGS with TPUFRAME_CHECK_SPMD=1 (:func:`_hvd_train_runs`,
    step 1 captured, a step profiled after each run), then once unset on
    cuDNN's default algorithms; after the first run, step 1's batch under
    its final parameters."""
    hvd.init()
    rank = hvd.rank()
    verbs = _gloo_verbs_on_cuda()
    os.environ["TPUFRAME_CHECK_SPMD"] = "1"
    try:
        runs = _hvd_train_runs(HVD_CIFAR_ARGS, HVD_FUSION_SETTINGS, out, True)
        default = _hvd_train_runs(HVD_CIFAR_ARGS, (None,), None, True,
                                  deterministic=False)[0]
    finally:
        os.environ.pop("TPUFRAME_CHECK_SPMD", None)
    h = runs[0].pop("harness")
    # step 1's batches again under the first run's final parameters (its
    # profiled step moved them once more), with step 1's augmentation:
    # the loss falls on the same data
    batch = {k: v.to(h.device) for k, v in torch.load(
        f"{out}.{rank}.pt")["batch"].items()}
    with torch.no_grad():
        again, _ = train_lib.make_loss_fn(h.cfg)(
            h.state.model, batch,
            step_lib.dropout_seed(h.state.seed, 0, rank))
    again = statistics.mean(hvd.allgather_object(float(again)))
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"verbs": verbs, "step1_again": again, "runs": runs,
                       "default_algos": default}, f)


def hvd_worker_resnet2(out: str) -> None:
    """(e) A rank of the gloo world of two: imagenet_resnet50 bn="fused"
    (HVD_RESNET_ARGS) once for each threshold of HVD_RESNET_SETTINGS; rank
    0's final state of each unfused run ``k`` to ``out.final.<k>.pt``."""
    hvd.init()
    runs = _hvd_train_runs(HVD_RESNET_ARGS, HVD_RESNET_SETTINGS, None,
                           False, finals=f"{out}.final")
    if hvd.rank() == 0:
        with open(out, "w") as f:
            json.dump({"runs": runs}, f)


def hvd_worker_spmd(out: str) -> None:
    """(f) A rank of the gloo world of two with TPUFRAME_CHECK_SPMD=1 and
    this rank's threshold, HVD_SPMD_THRESHOLDS[rank]: cifar10_resnet18
    through ``tpuframe_torch.train.main``, which must raise the
    divergence before any step (a step writes ``out.<rank>.stepped``)."""
    rank = int(os.environ["TPUFRAME_PROCESS_ID"])
    os.environ[fusion.ENV_VAR] = str(HVD_SPMD_THRESHOLDS[rank])
    os.environ["TPUFRAME_CHECK_SPMD"] = "1"
    build = train_lib.build_harness

    def capturing_build(cfg, device="cuda"):
        h = build(cfg, device)
        step = h.train_step

        def train_step(state, batch):
            Path(f"{out}.{rank}.stepped").write_text("stepped")
            return step(state, batch)

        h.train_step = train_step
        return h

    train_lib.build_harness = capturing_build
    train_lib.main(HVD_CIFAR_ARGS)


def _hvd_plain_dp_step(batches: list, init: dict, cfg=None) -> dict:
    """The plain version of step 1 of (b) (or of ``cfg``'s run): one
    process, the same init; each rank's batch through forward and
    backward in turn (BN statistics restored in between), gradients and
    statistics averaged, the optimizer's step.  Returns the state's flat
    host copy."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if cfg is None:
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


def _fused_run_problems(tag: str, runs: list) -> tuple:
    """Hold the runs of :func:`_hvd_train_runs`: every run's ranks
    bit-identical and the same batches; every step's all_reduce calls
    equal to its census; a fused run's final state bit-equal to the first
    unfused run's, or within the unfused runs' difference; at a
    threshold of several gradient buckets, a bucket started before the
    backward ended in every step.  Returns ``(problems, noise)``."""
    problems = []
    unfused = [r for r in runs if r["threshold"] is None]
    noise = max(r["diff"] for r in unfused)
    for k, run in enumerate(runs):
        name = f"{tag} run {k} (threshold {run['threshold']})"
        if len(set(run["digests"])) != 1:
            problems.append(f"{name}: the ranks' final states differ: "
                            f"{run['digests']}")
        if run["batch"] != runs[0]["batch"]:
            problems.append(f"{name}: step 1's batch is not run 0's")
        calls = [st["calls"] for st in run["steps"]]
        if set(calls) != {run["want_calls"]}:
            problems.append(f"{name}: all_reduce calls a step {calls}, want "
                            f"{run['want_calls']} (the census)")
        if run["threshold"] is not None:
            if not (run["diff"] == 0.0 or run["diff"] <= noise):
                problems.append(
                    f"{name}: final state off the unfused run's by "
                    f"{run['diff']:.3e}, beyond the unfused runs' "
                    f"difference {noise:.3e}")
            if run["grad_buckets"] > 1 and not all(
                    st["early"] >= 1 for st in run["steps"]):
                problems.append(
                    f"{name}: buckets started before backward() returned, "
                    f"a step: {[st['early'] for st in run['steps']]}; want "
                    f"at least 1 of {run['grad_buckets']}")
    return problems, noise


def _setting_line(runs: list, threshold) -> str:
    """A threshold's collectives a step, early buckets, step p50 and
    spread (p10-p90 over both runs' steps after the first), idle share."""
    mine = [r for r in runs if r["threshold"] == threshold]
    ms = sorted(x for r in mine for x in r["step_ms"][1:])
    q = statistics.quantiles(ms, n=10)
    early = sorted({st["early"] for r in mine for st in r["steps"]
                    if st["early"] is not None})
    idle = [_dev(r.get("idle")) for r in mine]
    label = ("unset" if threshold is None
             else f"{threshold / 2**20:g} MiB")
    return (f"{label}: {mine[0]['want_calls']} all_reduce a step"
            + (f" (gradient buckets {mine[0]['grad_buckets']}, started "
               f"before backward() returned {early})"
               if threshold is not None else "")
            + f", step ms p50 {statistics.median(ms):.2f} (p10-p90 "
            f"{q[0]:.2f}-{q[-1]:.2f}; each run's p50 "
            f"{[round(statistics.median(r['step_ms'][1:]), 2) for r in mine]})"
            + (f", rank 0's idle share {idle}" if "idle" in mine[0] else ""))


def phase_hvd(resnet_losses: list | None = None,
              resnet_noise: float = 0.0, keep: str | None = None) -> dict:
    """The Horovod slice (``tpuframe_torch.parallel.hvd``, ``bootstrap``,
    ``launch.launcher``, ``fusion``), run in processes that LocalCluster
    starts with the launcher's environment:

      (a) a world of one over NCCL: every hvd verb and op on CUDA
          tensors against its plain expectation, the seconds to the
          group and to the first collective; ``hvd.DistributedOptimizer``
          with TPUFRAME_FUSION_THRESHOLD at HVD_OPT_THRESHOLD reducing
          ResNet-50's gradients in fusion buckets, bit-equal to the
          per-tensor path; then imagenet_resnet50 at RESNET_CUTS with
          grad_reduce="adasum": its losses equal phase 12's
          (``resnet_losses``; within ``resnet_noise``, the measured
          difference of two straight runs, when that is not 0), every
          fused conv+BN launch on the tensor cores;
      (b) cifar10_resnet18 as two processes on the one card over gloo
          (HVD_CIFAR_CUTS), with TPUFRAME_CHECK_SPMD=1, once for each
          threshold of HVD_FUSION_SETTINGS: the hvd verbs on CUDA tensors
          under gloo (the collectives gloo does not take on CUDA
          refused); every run's ranks bit-identical; every run's step 1
          against the plain data-parallel step (HVD_DP_RTOL); a fused
          run's final state bit-equal to the first unfused run's, or
          within the two unfused runs' difference; every step's
          all_reduce count equal to its census; at 4 MiB a bucket started
          before the backward ended; the loss falls; each threshold's
          step p50, spread and rank 0's idle share (gloo through the
          host, not NCCL's cost); then one unset run on cuDNN's default
          algorithms (the runs above take its deterministic ones), held
          to its ranks' bit-identity and census, for the step p50 of the
          configuration the trainer runs;
      (c) ``adasum_combine`` at ResNet-50's leaf shapes against float64;
      (d) probes: each raw torch.distributed verb on CUDA tensors under
          gloo, and an NCCL world of two on the one card (NCCL's own
          error expected); written down, not held;
      (e) imagenet_resnet50 bn="fused" as two processes over gloo
          (HVD_RESNET_ARGS) for each threshold of HVD_RESNET_SETTINGS,
          held as (b)'s runs are, and per rank and run
          ``fused_conv_bn_bwd`` launched 36 times a step, all on the
          tensor cores (path ``hvd_resnet50_x2``);
      (f) the program check: TPUFRAME_CHECK_SPMD=1 with the ranks'
          thresholds HVD_SPMD_THRESHOLDS: both ranks exit non-zero with
          the divergence message before step 1, within HVD_TIMEOUT_S.

    (a), (b), (d) and (f) run at once, then (e): every step time here is
    read with other worlds on the card and the host.

    ``resnet_losses`` None: phase 12 runs first for its losses.  ``keep``
    (a directory): (e)'s first unfused run's final state is moved there,
    ``resnet2_final.pt``, for phase zero1 (the returned ``resnet2``)."""
    if resnet_losses is None:
        resnet_losses = phase_resnet_train()["losses"]
    gc.collect()
    torch.cuda.empty_cache()
    card = _card_line()
    root = tempfile.mkdtemp(prefix="tpuframe_hvd_")
    gloo = {"TPUFRAME_DIST_BACKEND": "gloo"}
    try:
        def world(name, n, env=None):
            t = time.monotonic()
            _hvd_launch(name, n, os.path.join(root, f"{name}.json"), env)
            return time.monotonic() - t

        def spmd_world():
            t = time.monotonic()
            try:
                _hvd_launch("spmd", 2, spmd_out, gloo)
                found = "both ranks exited 0"
            except RuntimeError as err:
                found = str(err)
            return found, time.monotonic() - t

        # (a), (b), (d) and (f) at once, then (e), for the time limit:
        # their step times are read with the other worlds on the card and
        # the host (two ResNet-50 worlds at once would not leave phase
        # seq's world room on the card)
        spmd_out = os.path.join(root, "spmd")
        with ThreadPoolExecutor(3) as pool:
            a_run = pool.submit(world, "nccl", 1)
            b_run = pool.submit(world, "cifar", 2, gloo)
            f_run = pool.submit(spmd_world)
            probes = _hvd_probes(root)
            a_wall, b_wall = a_run.result(), b_run.result()
            spmd, f_wall = f_run.result()
        a = json.loads(Path(root, "nccl.json").read_text())
        b = json.loads(Path(root, "cifar.json").read_text())
        ranks = [torch.load(os.path.join(root, f"cifar.json.{r}.pt"))
                 for r in range(2)]
        plain = _hvd_plain_dp_step([rk["batch"] for rk in ranks],
                                   ranks[0]["init"])
        step1s = ranks[0]["step1"]
        del ranks
        combine = _adasum_combine_check()
        e_wall = world("resnet2", 2, gloo)
        e = json.loads(Path(root, "resnet2.json").read_text())
        e_final = None
        if keep is not None:
            e_final = os.path.join(keep, "resnet2_final.pt")
            shutil.move(os.path.join(root, "resnet2.json.final.0.pt"),
                        e_final)
        stepped = [r for r in range(2)
                   if os.path.exists(f"{spmd_out}.{r}.stepped")]
    finally:
        shutil.rmtree(root, ignore_errors=True)

    problems = []
    bad = [k for k, ok in a["checks"].items() if not ok]
    if bad:
        problems.append(f"(a) NCCL world of one: {bad} failed")
    fo = a["fused_opt"]
    if (fo["None"] != fo["leaves"] or fo[str(HVD_OPT_THRESHOLD)]
            != fo["want_fused"] or not fo["bit_equal"]):
        problems.append(f"(a) hvd.DistributedOptimizer with the fusion knob "
                        f"over NCCL: {fo}; want one all_reduce a tensor "
                        f"unset, one a bucket at {HVD_OPT_THRESHOLD}, "
                        f"bit-equal parameters")
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
    runs = b["runs"]
    found, b_noise = _fused_run_problems("(b)", runs)
    problems += found
    dp_errs = []
    for k, step1 in enumerate(step1s):
        got = {n: t for n, t in ckpt_mod._flatten(step1)}
        dp_err, worst = 0.0, None
        for name, ref in plain.items():
            if not isinstance(ref, torch.Tensor):
                if got[name] != ref:
                    problems.append(f"(b) run {k} step 1 {name}: "
                                    f"{got[name]} vs {ref}")
                continue
            scale = ref.double().abs().max().item()
            err = (got[name].double() - ref.double()).abs().max().item() / (
                scale if scale > 0 else 1.0)
            if err > dp_err:
                dp_err, worst = err, name
        dp_errs.append((dp_err, worst))
        if not dp_err <= HVD_DP_RTOL:
            problems.append(
                f"(b) run {k} (threshold {runs[k]['threshold']}) step 1 "
                f"against the plain data-parallel step: {worst} off by "
                f"{dp_err:.3e} of its largest entry (tolerance "
                f"{HVD_DP_RTOL:g})")
    if len(step1s) != len(runs):
        problems.append(f"(b) {len(step1s)} step-1 captures for "
                        f"{len(runs)} runs")
    losses = runs[0]["losses"]
    if (len(losses) != HVD_CIFAR_CUTS["total_steps"]
            or not b["step1_again"] < losses[0]
            or not all(math.isfinite(x) for r in runs
                       for x in r["losses"])):
        problems.append(f"(b) losses {losses}, step 1's batches again at "
                        f"the end {b['step1_again']}: want every step's "
                        f"finite, and the loss on step 1's batches fallen")
    default = b["default_algos"]
    found, _ = _fused_run_problems("(b) on cuDNN's default algorithms",
                                   [default])
    problems += found
    if (default["batch"] != runs[0]["batch"]
            or len(default["losses"]) != len(losses)
            or not all(math.isfinite(x) for x in default["losses"])):
        problems.append(f"(b) on cuDNN's default algorithms: losses "
                        f"{default['losses']}; want {len(losses)} finite, "
                        f"from run 0's batches")
    found, e_noise = _fused_run_problems("(e)", e["runs"])
    problems += found
    e_steps = len(e["runs"][0]["losses"])
    for k, run in enumerate(e["runs"]):
        for r, (ln, rt) in enumerate(zip(run["all_launches"],
                                         run["all_routes"])):
            if (ln["fused_conv_bn_bwd"] != 36 * e_steps
                    or rt != {"tensor_core": 36 * e_steps, "cuda_core": 0}):
                problems.append(f"(e) run {k} rank {r}: launches {ln} by "
                                f"route {rt}, want {36 * e_steps} "
                                f"fused_conv_bn_bwd, all tensor-core")
    exits = re.findall(r"--- rank (\d) \(exit (-?\d+)\) ---", spmd)
    told = [part for part in re.split(r"(?=--- rank \d \(exit)", spmd)
            if part.startswith("--- rank")
            and "SPMD divergence in 'train_step:program'" in part]
    if (sorted(int(r) for r, c in exits if int(c) != 0) != [0, 1]
            or len(told) != 2 or stepped or "timed out" in spmd
            or not f_wall < HVD_TIMEOUT_S):
        problems.append(f"(f) divergent thresholds {HVD_SPMD_THRESHOLDS} "
                        f"under TPUFRAME_CHECK_SPMD=1: exits {exits}, ranks "
                        f"that stepped {stepped}, {f_wall:.1f} s; want both "
                        f"ranks non-zero with the divergence message before "
                        f"step 1: {spmd[-1500:]}")
    run0 = runs[0]
    p50 = statistics.median(run0["step_ms"][1:])
    idle = run0["idle"]
    log(f"[hvd] {card}: (a) world of one over NCCL: group in "
        f"{a['group_s']:.2f} s, first collective at "
        f"{a['first_collective_s']:.2f} s; {len(a['checks'])} verb checks "
        f"held; NCCL kernels in the verbs "
        f"{_dev(a['nccl_kernels'], '')}; hvd.DistributedOptimizer over "
        f"ResNet-50's {fo['leaves']} gradients: {fo['None']} all_reduce "
        f"unset, {fo[str(HVD_OPT_THRESHOLD)]} at "
        f"{HVD_OPT_THRESHOLD >> 20} MiB (the census's buckets), parameters "
        f"bit-equal; imagenet_resnet50 bn=fused grad_reduce=adasum losses "
        f"{a['losses']} equal phase 12's (max |diff| {diff:.3e}); step ms "
        f"{[round(x, 1) for x in a['step_ms']]}; launches {a['launches']}; "
        f"{a_wall:.1f} s")
    log(f"[hvd] {card}: (b) cifar10_resnet18, two processes on one card "
        f"over gloo, batch 256 (128 a rank), {len(runs)} runs of "
        f"{len(losses)} steps with TPUFRAME_CHECK_SPMD=1 in {b_wall:.1f} s: "
        f"run 0's losses {[round(x, 4) for x in losses[:3]]}..."
        f"{[round(x, 4) for x in losses[-3:]]} (step 1's batches again at "
        f"the end: {b['step1_again']:.4f}), eval loss "
        f"{run0['eval_loss']:.4f} accuracy {run0['eval_accuracy']:.4f}; "
        f"every run's final states bit-identical across ranks "
        f"({run0['digests'][0][:16]}); step 1 against the plain "
        f"data-parallel step: max error "
        f"{[format(x, '.3e') for x, _ in dp_errs]} ({dp_errs[0][1]}); final "
        f"state "
        f"against run 0's, max |diff| by run "
        f"{[format(r['diff'], '.3e') for r in runs]} (unfused runs' "
        f"difference "
        f"{b_noise:.3e}); step ms p50 {p50:.2f} and rank 0's idle share "
        f"{_dev(idle)} in run 0, both gloo through the host (not NCCL's "
        f"cost); its profiled step: wall {run0['wall_step']:.2f} ms, rank "
        f"0's device {_dev(run0['device_ms'], '.2f')} ms; top: "
        + "; ".join(f"{k} {ms:.2f} ms x{c}" for k, ms, c in run0["top"]))
    for threshold in dict.fromkeys(HVD_FUSION_SETTINGS):
        log(f"[hvd] {card}: (b) " + _setting_line(runs, threshold))
    log(f"[hvd] {card}: (b) on cuDNN's default algorithms (the trainer's "
        f"configuration; every run above is on deterministic ones), "
        + _setting_line([default], None) + f"; losses off run 0's by at "
        f"most {max(abs(x - y) for x, y in zip(default['losses'], losses)):.3e}")
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
    er = e["runs"]
    log(f"[hvd] {card}: (e) imagenet_resnet50 bn=fused, two processes on "
        f"one card over gloo, batch 256 (128 a rank), {len(er)} runs of "
        f"{e_steps} steps in {e_wall:.1f} s: losses by run "
        f"{[[round(x, 4) for x in r['losses']] for r in er]}; ranks "
        f"bit-identical; final state against run 0's, max |diff| by run "
        f"{[format(r['diff'], '.3e') for r in er]} (unfused runs' "
        f"difference "
        f"{e_noise:.3e}); fused_conv_bn_bwd {36 * e_steps} a rank and run, "
        f"all tensor-core")
    for threshold in dict.fromkeys(HVD_RESNET_SETTINGS):
        log(f"[hvd] {card}: (e) " + _setting_line(er, threshold))
    log(f"[hvd] (f) TPUFRAME_CHECK_SPMD=1, rank thresholds "
        f"{HVD_SPMD_THRESHOLDS}: both ranks exited non-zero (exits "
        f"{exits}) with \"SPMD divergence in 'train_step:program'\" "
        f"before step 1, {f_wall:.1f} s")
    if problems:
        raise RuntimeError("hvd: " + "; ".join(problems))
    launches_2 = {name: sum(ln[name] for r in er
                            for ln in r["all_launches"])
                  for name in launch_counts()}
    return {"launches": a["launches"], "launches_2proc": launches_2,
            "nccl": a, "cifar_p50": p50, "cifar_idle": idle,
            "cifar_default_p50": statistics.median(
                default["step_ms"][1:]),
            "dp_err": dp_errs[0][0], "combine": combine, "probes": probes,
            "resnet2": {"final": e_final, "noise": e_noise,
                        "step1": e["runs"][0]["step1"],
                        "losses": e["runs"][0]["losses"]}}


_VERBS = {"all_reduce": "all_reduce", "all_gather": "all_gather",
          "all_gather_into_tensor": "all_gather",
          "all_to_all_single": "all_to_all",
          "reduce_scatter_tensor": "reduce_scatter",
          "reduce_scatter_single": "reduce_scatter"}
_WIRE_KINDS = ("reduce_scatter", "all_gather", "all_to_all", "all_reduce")


def _counting_verbs():
    """The ``torch.distributed`` collectives a rank calls, counted by
    kind (``calls``): all_reduce, all_gather, all_to_all_single and the
    reduce-scatter; returns ``(calls, restore)``."""
    import torch.distributed as dist
    calls = dict.fromkeys(_WIRE_KINDS, 0)
    real = {a: getattr(dist, a) for a in _VERBS if hasattr(dist, a)}

    def wrap(fn, kind):
        def counting(*a, **k):
            calls[kind] += 1
            return fn(*a, **k)
        return counting

    for attr, fn in real.items():
        setattr(dist, attr, wrap(fn, _VERBS[attr]))
    return calls, lambda: [setattr(dist, a, f) for a, f in real.items()]


def _int8_wire_bytes(padded: int, n: int) -> int:
    """Bytes of one leg of the int8-block wire for a flat operand of
    ``padded`` elements over ``n`` ranks: each rank's chunk as s8 blocks
    of 256 with an f32 scale a block (quantwire.py's formula, written out
    here)."""
    return n * -(-(padded // n) // 256) * (256 + 4)


def _zero1_laws(model, small: list, n: int, update: str, wire: str,
                threshold) -> tuple:
    """``(calls, bytes)`` of one step by kind, from the byte laws and the
    bucket census: the gradient wire (fp zero1: a reduce-scatter and an
    all-gather of the padded bytes, no gradient all-reduce; int8: the s8
    payload and the scales of every leaf of at least 1024 padded
    elements, fp below), plus the all-reduces of ``small`` (the
    statistics and metrics: one each, or the census's buckets) and of the
    zero1 step's gradient norm.  Bytes count the gradient wire only."""
    calls = dict.fromkeys(_WIRE_KINDS, 0)
    nbytes = dict.fromkeys(_WIRE_KINDS, 0)
    calls["all_reduce"] += (len(small) if threshold is None else
                            fusion.bucket_census(small, threshold)
                            ["n_buckets"])
    fp = []
    for p in model.parameters():
        size, item = p.numel(), p.element_size()
        padded = zero1.padded_len(size, n)
        if update == "zero1" and not (wire == "int8-block"
                                      and padded >= 1024):
            fp.append(torch.empty(padded, dtype=p.dtype, device="meta"))
        elif update == "zero1" or size >= 1024:
            for kind in ("all_to_all", "all_gather"):
                calls[kind] += 2            # the payload and the scales
                nbytes[kind] += _int8_wire_bytes(padded, n)
        else:
            calls["all_reduce"] += 1
            nbytes["all_reduce"] += size * item
    if update == "zero1":
        calls["all_reduce"] += 1            # the gradient norm's scalar
        buckets = (len(fp) if threshold is None else
                   fusion.bucket_census(fp, threshold)["n_buckets"])
        for kind in ("reduce_scatter", "all_gather"):
            calls[kind] += buckets
            nbytes[kind] += sum(f.numel() * f.element_size() for f in fp)
    return calls, nbytes


def _int8_errors(local: list, reduced: list, full: bool) -> dict:
    """Step 1's gradients over the int8-block wire against the fp mean of
    the same local gradients, per element, against ``2 * blockmax /
    254``, blockmax the largest |local gradient| of any rank in the
    element's block (quantwire.py's error law): ``{"ratio": the worst
    error over its bound, "abs": the worst error}``.  ``reduced``: the
    full means (``full``) or this rank's chunks of the padded layout."""
    import torch.distributed as dist
    n, idx = dist.get_world_size(), dist.get_rank()
    ratio = worst = 0.0
    for g, r in zip(local, reduced):
        size = g.numel()
        padded = zero1.padded_len(size, n)
        c = padded // n
        nb = -(-c // 256)
        flat = F.pad(g.float().reshape(-1), (0, padded - size))
        mean = flat.clone()
        dist.all_reduce(mean)
        mean /= n
        blocks = F.pad(flat.view(n, c).abs(), (0, nb * 256 - c)).view(
            n, nb, 256).amax(dim=-1)
        dist.all_reduce(blocks, op=dist.ReduceOp.MAX)
        bound = (2 * blocks / 254).repeat_interleave(256, dim=1)[:, :c]
        if full:
            err = (r.float().reshape(-1) - mean[:size]).abs()
            bound = bound.reshape(-1)[:size]
        else:
            err = (r.float() - mean.view(n, c)[idx]).abs()
            bound = bound[idx]
        worst = max(worst, float(err.max()))
        over = err / torch.where(bound > 0, bound, 1.0)
        # an all-zero block must come back exactly
        ratio = max(ratio, float(torch.where(bound > 0, over,
                                             err * 1e30).max()))
    return {"ratio": ratio, "abs": worst}


def _delta_errors(calls: list, before: list, after: list, n: int) -> dict:
    """(iii) The quantized update-delta gather of one step (``calls``: each
    quantized leaf's ``(this rank's exact delta chunk, the gathered
    vector)``, in parameter order) against the exact deltas of every rank,
    per element, against ``blockmax / 254`` (``blockmax`` the largest
    |exact delta| in the element's block of its rank's chunk): ``{"ratio":
    the worst error over its bound, "abs": the worst error, "leaves": the
    leaves gathered, "want": the quantized leaves, "applied": every such
    parameter after the step is the one before plus its gathered delta,
    bit for bit}``."""
    import torch.distributed as dist
    quantized = [i for i, p in enumerate(before)
                 if zero1.padded_len(p.numel(), n)
                 >= quantwire.MIN_QUANT_ELEMS]
    ratio = worst = 0.0
    applied = len(calls) == len(quantized)
    for i, (x, full) in zip(quantized, calls):
        c = x.numel()
        exact = x.new_empty(n * c)
        dist.all_gather_into_tensor(exact, x)
        exact = exact.view(n, c).double()
        nb = -(-c // 256)
        blocks = F.pad(exact.abs(), (0, nb * 256 - c)).view(
            n, nb, 256).amax(dim=-1)
        bound = (blocks / 254).repeat_interleave(256, dim=1)[:, :c]
        err = (full.double().view(n, c) - exact).abs()
        worst = max(worst, float(err.max()))
        # an all-zero block must come back exactly
        ratio = max(ratio, float(torch.where(
            bound > 0, err / torch.where(bound > 0, bound, 1.0),
            err * 1e30).max()))
        p0, p1 = before[i], after[i]
        applied = applied and torch.equal(
            p1, p0 + full[:p0.numel()].view(p0.shape).to(p0.dtype))
    return {"ratio": ratio, "abs": worst, "leaves": len(calls),
            "want": len(quantized), "applied": bool(applied)}


def _zero1_run(k: int, label: str, threshold, base: dict, out: str) -> dict:
    """One setting of :func:`hvd_worker_zero1`: ``train.main`` of
    HVD_RESNET_ARGS, its steps counted (collective calls by kind, wire
    bytes by kind), step 1's int8 gradients against the fp mean, the
    quantized delta gather at the first step with lr > 0 against the exact
    deltas, the final state against (e)'s (``base``), and the run's
    books."""
    rank, n = hvd.rank(), hvd.size()
    calls, restore = _counting_verbs()
    build = train_lib.build_harness
    got: dict = {"steps": []}
    real = {"all_reduce_mean": quantwire.all_reduce_mean,
            "scatter_grads": zero1.scatter_grads,
            "all_gather": quantwire.all_gather}

    def capturing(fn, full):
        # step 1's local gradients and their reduction over the wire
        def wrapped(grads, *a, **kw):
            res = fn(grads, *a, **kw)
            if "int8" not in got:
                out_ = res if full else res[0]
                got["int8"] = ([g.detach().clone() for g in grads],
                               [r.detach().clone() for r in out_], full)
            return res
        return wrapped

    def capturing_gather(x, grp):
        # the zero1 step's quantized delta gather, at the delta step
        full = real["all_gather"](x, grp)
        if got.get("in_delta_step"):
            got["delta"].append((x.detach().clone(), full.detach().clone()))
        return full

    def capturing_build(cfg, device="cuda"):
        h = build(cfg, device)
        step = h.train_step

        def train_step(state, batch):
            first = not got["steps"]
            if first:
                got["batch"] = _state_digest(batch)
                if k == 0:
                    got["batch_t"] = _cpu_tree(batch)
                    got["init"] = {
                        "model": _cpu_tree(dict(state.model.state_dict())),
                        "opt": build_optimizer(cfg, state.model)
                        .state_dict(), "step": 0, "seed": state.seed}
            opt = state.opt
            delta_step = (quantwire.all_gather is capturing_gather
                          and "delta" not in got
                          and opt.schedule(opt.count) > 0)
            if delta_step:
                got["delta"], got["in_delta_step"] = [], True
                before = [p.detach().clone() for p in opt.params]
            for kind in calls:
                calls[kind] = 0
            collectives.reset_wire()
            metrics = step(state, batch)
            if delta_step:
                got["in_delta_step"] = False
                got["delta_params"] = (
                    before, [p.detach().clone() for p in opt.params])
                got["delta_at"] = len(got["steps"]) + 1
            got["steps"].append({"calls": dict(calls),
                                 "bytes": dict(collectives.WIRE_BYTES)})
            if first:
                got["step1"] = {key: float(v) for key, v in metrics.items()}
                if rank == 0:
                    tree = state.to_tree()
                    got["after1"] = {
                        "model": _cpu_tree(tree["model"]),
                        "opt": {key: val if key == "count" else
                                {name: getattr(t, "tensor", t).detach()
                                 .cpu().clone() for name, t in val.items()}
                                for key, val in tree["opt"].items()}}
            return metrics

        h.train_step = train_step
        got["harness"] = h
        return h

    train_lib.build_harness = capturing_build
    if os.environ.get(quantwire.ENV_VAR) == "int8-block":
        quantwire.all_reduce_mean = capturing(real["all_reduce_mean"], True)
        zero1.scatter_grads = capturing(real["scatter_grads"], False)
        if os.environ.get(zero1.ENV_VAR) == "zero1":
            quantwire.all_gather = capturing_gather
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        metrics = train_lib.main(HVD_RESNET_ARGS)
        torch.cuda.synchronize()
    finally:
        train_lib.build_harness = build
        quantwire.all_reduce_mean = real["all_reduce_mean"]
        zero1.scatter_grads = real["scatter_grads"]
        quantwire.all_gather = real["all_gather"]
        restore()
    peak = torch.cuda.max_memory_allocated()
    launches, routes = launch_counts(), dict(fcb.ROUTES)
    h = got.pop("harness")
    steps = list(got["steps"])              # not the profiled step's
    model, opt = h.state.model, h.state.opt
    update, wire = h.weight_update[0], h.wire_format[0]
    stats = [b for b in model.buffers() if b.is_floating_point()]
    # the step's statistics and metrics (accuracy, loss) its mean reduces
    small = stats + [torch.empty((), device="meta")] * 2
    want_calls, want_bytes = _zero1_laws(model, small, n, update, wire,
                                         threshold)
    int8 = _int8_errors(*got.pop("int8")) if "int8" in got else None
    delta = (dict(_delta_errors(got.pop("delta"), *got.pop("delta_params"),
                                n), step=got["delta_at"])
             if "delta" in got else None)
    # the final state against (e)'s unset replicated run
    model_diff = max(float((t.detach().cpu().double()
                            - base[f"model/{name}"].double()).abs().max())
                     for name, t in model.state_dict().items()
                     if t.is_floating_point())
    moment_diff = 0.0
    for key, ts in opt.moments.items():
        for name, p, t in zip(opt.names, opt.params, ts):
            ref = base[f"opt/{key}/{name}"]
            if opt.shards is not None:
                c = t.numel()
                ref = zero1.flat_pad(ref, n)[rank * c:(rank + 1) * c]
            moment_diff = max(moment_diff, float(
                (t.detach().cpu().double() - ref.double()).abs().max()))
    opt_bytes = sum(t.numel() * t.element_size()
                    for ts in opt.moments.values() for t in ts)
    want_opt = (zero1.padded_bytes(model, n) // n if opt.shards is not None
                else sum(p.numel() * p.element_size()
                         for p in model.parameters())) * len(opt.moments)
    digests = hvd.allgather_object(_state_digest(
        {"model": dict(model.state_dict())}))
    # step 1's batches again under the final parameters, with step 1's
    # augmentation: the loss falls on the same data
    batch = (got["batch_t"] if k == 0
             else torch.load(f"{out}.{rank}.pt")["batch"])
    batch = {key: v.to(h.device) for key, v in batch.items()}
    with torch.no_grad():
        again, _ = train_lib.make_loss_fn(h.cfg)(
            model, batch, step_lib.dropout_seed(h.state.seed, 0, rank))
    again = statistics.mean(hvd.allgather_object(float(again)))
    if k == 0:
        torch.save({"batch": got.pop("batch_t"), "init": got.pop("init")},
                   f"{out}.{rank}.pt")
    if rank == 0:
        torch.save(got.pop("after1"), f"{out}.after1.{k}.pt")
    wall_step, kernels, (busy, idle, _) = _profile_steps(
        h, 1, tries=PROFILE_TRIES)
    run = {"label": label, "threshold": threshold, "update": update,
           "wire": wire, "sources": [h.weight_update[1], h.wire_format[1]],
           "losses": metrics["losses"], "step_ms": metrics["step_ms"],
           "eval_loss": metrics.get("eval_loss"), "steps": steps,
           "want_calls": want_calls, "want_bytes": want_bytes,
           "batch": got["batch"], "step1": got["step1"],
           "step1_again": again, "digests": digests,
           "model_diff": hvd.allgather_object(model_diff),
           "moment_diff": hvd.allgather_object(moment_diff),
           "opt_bytes": hvd.allgather_object(opt_bytes),
           "want_opt_bytes": want_opt,
           "padded_bytes": zero1.padded_bytes(model, n),
           "int8": hvd.allgather_object(int8),
           "delta": hvd.allgather_object(delta),
           "launches": hvd.allgather_object(launches),
           "routes": hvd.allgather_object(routes),
           "peak": hvd.allgather_object(peak), "wall_step": wall_step,
           "device_ms": busy, "idle": idle,
           "top": [(name[:60], ms, c) for name, ms, c in
                   (kernels or [])[:6]]}
    del h, model, opt, stats
    gc.collect()
    torch.cuda.empty_cache()
    return run


def hvd_worker_zero1(out: str) -> None:
    """(zero1) A rank of the gloo world of two: imagenet_resnet50
    bn="fused" (HVD_RESNET_ARGS) through ``tpuframe_torch.train.main`` once
    for each setting of ZERO1_SETTINGS (:func:`_zero1_run`), against the
    final state of (e)'s unset replicated run in the host copy
    ``TPUFRAME_SMOKE_BASELINE`` names.  Rank 0 writes the runs to
    ``out``; each rank its step-1 batch and the init to ``out.<rank>.pt``;
    rank 0 its state after step 1 of run ``k`` to ``out.after1.<k>.pt``."""
    hvd.init()
    torch.backends.cudnn.deterministic = True
    base = torch.load(os.environ["TPUFRAME_SMOKE_BASELINE"])
    runs = []
    for k, (label, env, threshold) in enumerate(ZERO1_SETTINGS):
        knobs = {**env, **({} if threshold is None
                           else {fusion.ENV_VAR: str(threshold)})}
        os.environ.update(knobs)
        try:
            runs.append(_zero1_run(k, label, threshold, base, out))
        finally:
            for var in knobs:
                os.environ.pop(var, None)
    if hvd.rank() == 0:
        with open(out, "w") as f:
            json.dump({"runs": runs}, f)


def _zero1_baseline(root: str) -> dict:
    """(e)'s runs alone (``--hvd-worker resnet2``), for phase zero1 run
    without phase hvd: the baseline :func:`phase_hvd` hands it."""
    out = os.path.join(root, "resnet2.json")
    _hvd_launch("resnet2", 2, out, {"TPUFRAME_DIST_BACKEND": "gloo"})
    e = json.loads(Path(out).read_text())
    found, noise = _fused_run_problems("(e)", e["runs"])
    if found:
        raise RuntimeError("zero1 baseline: " + "; ".join(found))
    return {"final": f"{out}.final.0.pt", "noise": noise,
            "step1": e["runs"][0]["step1"], "losses": e["runs"][0]["losses"]}


def _rel_err(got: torch.Tensor, ref: torch.Tensor,
             scale: float | None = None) -> float:
    """max |got - ref| over ``scale`` (ref's largest |entry| by default;
    1 when that is 0)."""
    if scale is None:
        scale = ref.double().abs().max().item()
    return (got.double() - ref.double()).abs().max().item() / (
        scale if scale > 0 else 1.0)


def _zero1_step1_problems(name: str, after1: dict, plain: dict, fp: bool,
                          n: int) -> tuple:
    """Rank 0's state after step 1 against the plain data-parallel step:
    every model tensor, and with the fp wire every moment chunk, within
    HVD_DP_RTOL of its largest plain entry.  Returns ``(problems, (worst
    error, tensor))``."""
    problems, worst = [], (0.0, "")
    for key, t in after1["model"].items():
        if not t.is_floating_point():
            if not torch.equal(t, plain[f"model/{key}"]):
                problems.append(f"{name} step 1 model/{key}: {t} vs "
                                f"{plain[f'model/{key}']}")
            continue
        err = _rel_err(t, plain[f"model/{key}"])
        if err > worst[0]:
            worst = (err, f"model/{key}")
    for key, val in after1["opt"].items():
        if key == "count":
            if val != plain["opt/count"]:
                problems.append(f"{name} step 1 opt count {val} vs "
                                f"{plain['opt/count']}")
            continue
        if not fp:
            continue
        for pname, t in val.items():
            ref = plain[f"opt/{key}/{pname}"]
            if t.shape != ref.shape:
                # rank 0's chunk of the flat layout, against the plain
                # moment's largest entry
                err = _rel_err(t, zero1.flat_pad(ref, n)[:t.numel()],
                               ref.double().abs().max().item())
            else:
                err = _rel_err(t, ref)
            if err > worst[0]:
                worst = (err, f"opt/{key}/{pname}")
    if not worst[0] <= HVD_DP_RTOL:
        problems.append(f"{name} step 1 against the plain data-parallel "
                        f"step: {worst[1]} off by {worst[0]:.3e} of its "
                        f"largest entry (tolerance {HVD_DP_RTOL:g})")
    return problems, worst


def phase_zero1(baseline: dict | None = None) -> dict:
    """The ZeRO-1 weight update and the int8-block wire
    (``parallel/zero1.py``, ``parallel/quantwire.py``): imagenet_resnet50
    bn="fused" as two gloo processes on the one card (HVD_RESNET_ARGS),
    once for each setting of ZERO1_SETTINGS, through
    ``tpuframe_torch.train.main`` with ``TPUFRAME_WEIGHT_UPDATE`` and
    ``TPUFRAME_WIRE_FORMAT``.  Held: every run's ranks' final parameters
    bit-identical; step 1 against the plain data-parallel step
    (HVD_DP_RTOL; the moments too on the fp wire); (i) and (ii): the final
    state bit-equal to phase hvd (e)'s unset replicated run
    (``baseline``), or within (e)'s two unset runs' difference, and step
    1's gradient norm within ZERO1_NORM_RTOL of (e)'s; each zero1 rank's
    optimizer-state bytes ``padded_bytes / n`` of the moments; every
    step's wire bytes by kind equal to the byte laws and its collective
    calls by kind to the bucket census (:func:`_zero1_laws`); (iii) and
    (iv): step 1's gradients within ``2 * blockmax / 254`` an element of
    the fp mean, the loss gap to the fp run under ZERO1_INT8_LOSS_GAP;
    (iii): the quantized delta gather at the first step with lr > 0 within
    ``blockmax / 254`` (x ZERO1_DELTA_SLACK) an element of the exact
    deltas, every quantized parameter moved by its gathered delta;
    every run's loss falls on step 1's batches; ``fused_conv_bn_bwd``
    launched 36 times a step a rank, all on the tensor cores.  Written
    down: step p50 and p10-p90, peak memory a rank, rank 0's idle share
    from one profiled step.  ``baseline`` None: (e)'s runs go first."""
    gc.collect()
    torch.cuda.empty_cache()
    card = _card_line()
    root = tempfile.mkdtemp(prefix="tpuframe_zero1_")
    try:
        if baseline is None:
            baseline = _zero1_baseline(root)
        t0 = time.monotonic()
        out = os.path.join(root, "zero1.json")
        _hvd_launch("zero1", 2, out, {"TPUFRAME_DIST_BACKEND": "gloo",
                                      "TPUFRAME_SMOKE_BASELINE":
                                          baseline["final"]})
        wall = time.monotonic() - t0
        z = json.loads(Path(out).read_text())
        ranks = [torch.load(f"{out}.{r}.pt") for r in range(2)]
        after1 = [torch.load(f"{out}.after1.{k}.pt")
                  for k in range(len(ZERO1_SETTINGS))]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = get_config("imagenet_resnet50").with_overrides(
        **{**RESNET_CUTS, "mesh": {"data": 2}})
    plain = _hvd_plain_dp_step([rk["batch"] for rk in ranks],
                               ranks[0]["init"], cfg)
    del ranks
    runs = z["runs"]
    n = 2
    problems, dp_errs = [], []
    fp_losses = {"zero1": None, "replicated": baseline["losses"]}
    for k, run in enumerate(runs):
        name = run["label"]
        steps = len(run["losses"])
        if len(set(run["digests"])) != 1:
            problems.append(f"{name}: the ranks' final parameters differ: "
                            f"{run['digests']}")
        if run["batch"] != runs[0]["batch"]:
            problems.append(f"{name}: step 1's batch is not run 0's")
        env = ZERO1_SETTINGS[k][1]
        want = [env.get(zero1.ENV_VAR, "replicated"),
                env.get(quantwire.ENV_VAR, "fp")]
        if [run["update"], run["wire"]] != want:
            problems.append(f"{name}: the trainer ran {run['update']} "
                            f"{run['wire']} ({run['sources']}), want "
                            f"{want}")
        found, worst = _zero1_step1_problems(name, after1[k], plain,
                                             run["wire"] == "fp", n)
        problems += found
        dp_errs.append(worst)
        fp_run = run["update"] == "zero1" and run["wire"] == "fp"
        if fp_run:
            fp_losses["zero1"] = fp_losses["zero1"] or run["losses"]
            diffs = run["model_diff"] + run["moment_diff"]
            if not all(d == 0.0 or d <= baseline["noise"] for d in diffs):
                problems.append(
                    f"{name}: final state off (e)'s unset replicated run's "
                    f"by {max(diffs):.3e} (model {run['model_diff']}, "
                    f"moments {run['moment_diff']}), beyond (e)'s unset "
                    f"runs' difference {baseline['noise']:.3e}")
            ref = baseline["step1"]["grad_norm"]
            rel = abs(run["step1"]["grad_norm"] - ref) / ref
            if not rel <= ZERO1_NORM_RTOL:
                problems.append(f"{name}: step 1 grad_norm "
                                f"{run['step1']['grad_norm']!r} vs (e)'s "
                                f"{ref!r}: {rel:.3e} relative (tolerance "
                                f"{ZERO1_NORM_RTOL:g})")
        if run["update"] == "zero1" and set(run["opt_bytes"]) != {
                run["want_opt_bytes"]}:
            problems.append(f"{name}: optimizer-state bytes a rank "
                            f"{run['opt_bytes']}, want padded_bytes / n = "
                            f"{run['want_opt_bytes']}")
        for i, st in enumerate(run["steps"]):
            if st["bytes"] != run["want_bytes"]:
                problems.append(f"{name} step {i + 1}: wire bytes "
                                f"{st['bytes']}, want {run['want_bytes']}")
            if st["calls"] != run["want_calls"]:
                problems.append(f"{name} step {i + 1}: collective calls "
                                f"{st['calls']}, want {run['want_calls']}")
        if run["wire"] == "int8-block":
            if not all(e is not None and e["ratio"] <= 1.0
                       for e in run["int8"]):
                problems.append(f"{name}: step 1's gradients off the fp "
                                f"mean beyond 2 x blockmax / 254: "
                                f"{run['int8']}")
            if run["update"] == "zero1" and not all(
                    d is not None and d["ratio"] <= ZERO1_DELTA_SLACK
                    and d["applied"] and d["leaves"] == d["want"] > 0
                    for d in run["delta"]):
                problems.append(f"{name}: the quantized delta gather at the "
                                f"first step with lr > 0 off the exact "
                                f"deltas beyond blockmax / 254 (x "
                                f"{ZERO1_DELTA_SLACK!r}), or not applied "
                                f"as gathered: {run['delta']}")
            ref = fp_losses[run["update"]]
            gap = max(abs(a - b) for a, b in zip(run["losses"], ref))
            run["loss_gap"] = gap
            if len(run["losses"]) != len(ref) or not (
                    gap <= ZERO1_INT8_LOSS_GAP):
                problems.append(f"{name}: losses {run['losses']} vs the fp "
                                f"run's {ref}: gap {gap:.3e} (bound "
                                f"{ZERO1_INT8_LOSS_GAP:g})")
        if not (all(math.isfinite(x) for x in run["losses"])
                and run["step1_again"] < run["losses"][0]):
            problems.append(f"{name}: losses {run['losses']}, step 1's "
                            f"batches again at the end "
                            f"{run['step1_again']}: want finite, and the "
                            f"loss on step 1's batches fallen")
        for r, (ln, rt) in enumerate(zip(run["launches"], run["routes"])):
            if (ln["fused_conv_bn_bwd"] != 36 * steps
                    or rt != {"tensor_core": 36 * steps, "cuda_core": 0}):
                problems.append(f"{name} rank {r}: launches {ln} by route "
                                f"{rt}, want {36 * steps} fused_conv_bn_bwd,"
                                f" all tensor-core")
    for k, run in enumerate(runs):
        ms = sorted(run["step_ms"][1:])
        q = statistics.quantiles(ms, n=10)
        extra = (f"; int8 error (worst over its bound, worst abs) by rank "
                 f"{[(round(e['ratio'], 4), e['abs']) for e in run['int8']]}"
                 f", loss gap to fp {run['loss_gap']:.3e}"
                 if run["wire"] == "int8-block" else "")
        if run["wire"] == "int8-block" and run["update"] == "zero1":
            by_rank = [(round(d["ratio"], 4), d["abs"], d["leaves"])
                       for d in run["delta"]]
            extra += (f"; delta gather at step {run['delta'][0]['step']} "
                      f"(worst over blockmax / 254, worst abs, leaves) by "
                      f"rank {by_rank}, applied as gathered")
        log(f"[zero1] {card}: {run['label']}: losses "
            f"{[round(x, 5) for x in run['losses']]} (step 1's batches "
            f"again {run['step1_again']:.5f}); step 1 grad_norm "
            f"{run['step1']['grad_norm']!r} ((e) "
            f"{baseline['step1']['grad_norm']!r}); step ms p50 "
            f"{statistics.median(ms):.2f} (p10-p90 {q[0]:.2f}-{q[-1]:.2f}); "
            f"peak memory a rank "
            f"{[round(b / 2**30, 2) for b in run['peak']]} GiB; optimizer "
            f"state a rank {run['opt_bytes']} B (padded_bytes "
            f"{run['padded_bytes']}); wire bytes a step "
            f"{run['steps'][0]['bytes']}; calls a step "
            f"{run['steps'][0]['calls']}; final state off (e)'s by model "
            f"{max(run['model_diff']):.3e}, moments "
            f"{max(run['moment_diff']):.3e}; step 1 vs the plain step "
            f"{dp_errs[k][0]:.3e} ({dp_errs[k][1] or 'every tensor'})"
            f"{extra}; rank 0's "
            f"profiled step: wall {run['wall_step']:.2f} ms, device "
            f"{_dev(run['device_ms'], '.2f')} ms, idle share "
            f"{_dev(run['idle'])}; top: "
            + "; ".join(f"{kn} {ms_:.2f} ms x{c}"
                        for kn, ms_, c in run["top"]))
    log(f"[zero1] {len(runs)} runs of imagenet_resnet50 bn=fused, two "
        f"processes on one card over gloo, in {wall:.1f} s")
    if problems:
        raise RuntimeError("zero1: " + "; ".join(problems))
    launches = {name: sum(ln[name] for run in runs
                          for ln in run["launches"])
                for name in launch_counts()}
    return {"launches": launches, "runs": runs}


def _hvd_probes(root: str) -> dict:
    """(d) The two probes, at once: what a failed or hung probe shows is
    its finding."""
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


def _seq_args(mode: str, cuts: dict = SEQ_CUTS) -> list:
    """``train.main`` arguments of lm_long with ``cuts`` and its model's
    ``seq_mode`` set to ``mode``."""
    model = dict(get_config("lm_long").model_kwargs, seq_mode=mode,
                 num_layers=SEQ_LAYERS)
    sets = {**cuts, "model_kwargs": model}
    return ["--config", "lm_long"] + [
        a for k, v in sets.items() for a in ("--set", f"{k}={v!r}")]


def _seq_global_batch(cfg) -> dict:
    """Step 1's global batch of the four-rank run: each data rank's rows
    as its loader draws them, stacked in data order (every seq rank of a
    data rank takes its block of the same rows)."""
    ds, _ = datasets.build(cfg.dataset, None, **cfg.dataset_kwargs)
    parts = [next(iter(ShardedLoader(ds, cfg.global_batch, device="cuda",
                                     seed=cfg.seed,
                                     world=SEQ_MESH["data"], rank=r)))
             for r in range(SEQ_MESH["data"])]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _grads(model) -> dict:
    """Each parameter's gradient, f32 on the host."""
    return {n: p.grad.detach().float().cpu()
            for n, p in model.named_parameters() if p.grad is not None}


def _rel(a, b) -> float:
    """||a - b|| / ||b||."""
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def _seq_reference() -> dict:
    """Step 1 of lm_long as one process (seq 1) on the four-rank run's
    global batch and weights, in bf16 (the run's own dtype) and in f32
    (the noise floor's yardstick): loss, gradient norm and each
    parameter's gradient (on the host) of each."""
    cfg = get_config("lm_long").with_overrides(
        mesh={"data": 1, "seq": 1}, global_batch=SEQ_GLOBAL_BATCH,
        model_kwargs={"num_layers": SEQ_LAYERS})
    batch = _seq_global_batch(cfg)
    out = {}
    for dtype in ("bfloat16", "float32"):
        t0 = time.monotonic()
        h = train_lib.build_harness(cfg.with_overrides(compute_dtype=dtype),
                                    device="cuda")
        m = h.train_step(h.state, batch)
        out[dtype] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "grads": _grads(h.state.model),
                      "s": time.monotonic() - t0}
        del h, m
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _tile_rel(got, want) -> float:
    """The worst tile of SEQ_TILE_ROWS sequence rows of one batch row and
    head of ``[B, S, N, D]`` tensors: ``||got - want|| / ||want||``."""
    b, s, n, d = want.shape
    shape = (b, s // SEQ_TILE_ROWS, SEQ_TILE_ROWS, n, d)
    want = want.float().reshape(shape)
    num = (got.float().reshape(shape) - want).square().sum(dim=(2, 4))
    den = want.square().sum(dim=(2, 4))
    return float((num / den.clamp_min(1e-30)).sqrt().max())


def _seq_kernel_check(name: str, shape: tuple, causal: bool,
                      with_dlse: bool) -> dict:
    """(c) ``flash_mha_lse`` at ``shape`` (bf16) through its kernels, with
    a cotangent on the output and, ``with_dlse``, a random N(0, 1) one on
    the lse rows, against its plain versions: the plain forward and the
    plain delta pass, dq and dkv from the plain lse with ``delta -
    dlse``, one batch row and head at a time.  Worst tile
    (:func:`_tile_rel`) of out, dq, dk and dv; max |diff| of lse."""
    b, s, n, d = shape
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, _ = _flash_inputs(b, s, n, d, torch.bfloat16, False, gen)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    dlse = (torch.randn((b, n, s), generator=gen, device="cuda")
            if with_dlse else None)
    before = dict(fa.BWD_ROUTES)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out, lse = fa.flash_mha_lse(*leaves, causal=causal)
    if with_dlse:
        grads = torch.autograd.grad((out, lse), leaves, (do, dlse))
    else:
        grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    ran = {r: fa.BWD_ROUTES[r] - before[r] for r in before}
    ref = {key: [] for key in ("out", "lse", "dq", "dk", "dv")}
    for i in range(b):
        for h in range(n):
            qi, ki, vi, doi = (t[i:i + 1, :, h:h + 1] for t in (q, k, v, do))
            o_r, l_r = fa.flash_mha_reference(qi, ki, vi, causal=causal)
            delta = fa.flash_bwd_delta_reference(qi, ki, vi, doi, l_r,
                                                 causal=causal)
            if with_dlse:
                delta = delta - dlse[i:i + 1, h:h + 1]
            dq = fa.flash_bwd_dq_reference(qi, ki, vi, doi, l_r, delta,
                                           causal=causal)
            dk, dv = fa.flash_bwd_dkv_reference(qi, ki, vi, doi, l_r, delta,
                                                causal=causal)
            for key, t in (("out", o_r), ("lse", l_r), ("dq", dq),
                           ("dk", dk), ("dv", dv)):
                ref[key].append(t)
    full = {}
    for key, parts in ref.items():
        axis = 1 if key == "lse" else 2
        rows = [torch.cat(parts[i * n:(i + 1) * n], dim=axis)
                for i in range(b)]
        full[key] = torch.cat(rows)
    errs = {"out": _tile_rel(out.detach(), full["out"]),
            "lse": float((lse.detach() - full["lse"]).abs().max())}
    for key, got in zip(("dq", "dk", "dv"), grads):
        errs[key] = _tile_rel(got, full[key])
    bad = []
    if ran != {"tensor_core": 3, "cuda_core": 0}:
        bad.append(f"backward launches by route {ran}, want 3 on the tensor "
                   f"cores")
    tols = {"out": SEQ_KERNEL_TOL["out"], "lse": SEQ_KERNEL_TOL["lse"],
            **{g: SEQ_KERNEL_TOL["grad"] for g in ("dq", "dk", "dv")}}
    for key, tol in tols.items():
        if not errs[key] <= tol:
            bad.append(f"{key} {errs[key]:.3e} > {tol}")
    log(f"[seq] (c) flash_mha_lse, {name}, at {list(shape)} bf16 "
        f"{'causal' if causal else 'non-causal'}"
        f"{' with a random lse cotangent' if with_dlse else ''}, kernels "
        f"vs plain versions: worst tile out {errs['out']:.3e} dq "
        f"{errs['dq']:.3e} dk {errs['dk']:.3e} dv {errs['dv']:.3e}, "
        f"max|diff| lse {errs['lse']:.3e} (tolerances {SEQ_KERNEL_TOL}); "
        f"backward routes {ran}")
    del q, k, v, do, dlse, leaves, out, lse, grads, ref, full
    gc.collect()
    torch.cuda.empty_cache()
    if bad:
        raise RuntimeError(f"seq (c) flash_mha_lse, {name}: "
                           + "; ".join(bad))
    return errs


def _seq_run(mode: str, rank: int, profile: bool) -> tuple:
    """One lm_long run of this world through ``train.main`` with
    ``seq_mode=mode``: every step's launches and bytes through the seq
    group, step 1's loss and gradient norm, the final state's digest,
    peak memory; then, with ``profile``, one more step, profiled on rank
    0.  Returns that and, on rank 0, step 1's reduced gradients (before
    the optimizer update; None on the other ranks)."""
    build = train_lib.build_harness
    got = {"steps": [], "grads": None}

    def capturing_build(cfg, device="cuda"):
        h = build(cfg, device)
        step = h.train_step

        def train_step(state, batch):
            launches0 = launch_counts()
            bytes0 = sum(collectives.SEQ_BYTES.values())
            metrics = step(state, batch)
            launches = launch_counts()
            got["steps"].append({
                "launches": {k: launches[k] - launches0[k]
                             for k in launches},
                "seq_bytes": sum(collectives.SEQ_BYTES.values()) - bytes0})
            if len(got["steps"]) == 1:
                got["step1"] = {"loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"])}
                if rank == 0:
                    # the optimizer leaves the reduced gradients in place
                    got["grads"] = _grads(state.model)
            return metrics

        h.train_step = train_step
        got["harness"] = h
        return h

    train_lib.build_harness = capturing_build
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        metrics = train_lib.main(_seq_args(mode))
    finally:
        train_lib.build_harness = build
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    routes = {"fwd": dict(fa.FWD_ROUTES), "bwd": dict(fa.BWD_ROUTES)}
    peak = torch.cuda.max_memory_allocated()
    h = got.pop("harness")
    digest = _state_digest(h.state.to_tree())
    layout = h.layout
    prof = {"wall_ms": None, "device_ms": None, "idle": None, "top": []}
    if profile:
        # one more step, profiled on rank 0; the others step beside it
        batch = next(iter(h.train_loader))
        def step():
            return float(h.train_step(h.state, batch)["loss"])

        if rank == 0:
            torch.cuda.synchronize()
            t1 = time.monotonic()
            kernels = device_time(step)
            wall_step = 1e3 * (time.monotonic() - t1)
            busy, idle, _ = _busy(kernels, wall_step)
            prof = {"wall_ms": wall_step, "device_ms": busy, "idle": idle,
                    "top": [(k[:60], ms, c)
                            for k, ms, c in (kernels or [])[:8]]}
        else:
            step()
        torch.cuda.synchronize()
    del h
    gc.collect()
    torch.cuda.empty_cache()
    return {"mode": mode, "rank": rank, "seq_index": layout.seq_index,
            "data_index": layout.data_index, "wall_s": wall,
            "losses": metrics["losses"], "step_ms": metrics["step_ms"],
            "eval_loss": metrics.get("eval_loss"), "step1": got["step1"],
            "steps": got["steps"], "launches": launches, "routes": routes,
            "peak_bytes": peak, "digest": digest,
            "profile": prof}, got["grads"]


def _seq_ring_check(rank: int, ring) -> dict | None:
    """(c) One layer's ring at SEQ_RING_SHAPE on the seq ring ``ring`` of
    data rank 0 (ranks 0 and 1; the others wait): the flash-stage ring
    against the plain-stage ring (``impl="xla"``, f32 stages) on the same
    bf16 inputs, causal, forward and dq/dk/dv, worst tile
    (:func:`_tile_rel`).  Each rank draws the whole sequence from one
    seed and keeps its block."""
    res = None
    if rank in ring.ranks and ring.ranks[0] == 0:
        b, c, n, d = SEQ_RING_SHAPE
        gen = torch.Generator(device="cuda").manual_seed(13)
        q, k, v, _ = _flash_inputs(b, c * ring.size, n, d, torch.bfloat16,
                                   False, gen)
        g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        lo = ring.index * c
        q, k, v, g = (t[:, lo:lo + c].contiguous() for t in (q, k, v, g))
        got = {}
        for impl in ("pallas", "xla"):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = sp.ring_attention(*leaves, seq=ring, causal=True,
                                    impl=impl)
            grads = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            got[impl] = (out.detach(), grads, time.monotonic() - t0)
        (o_f, g_f, t_f), (o_x, g_x, t_x) = got["pallas"], got["xla"]
        res = {"out": _tile_rel(o_f, o_x), "s_flash": t_f, "s_plain": t_x}
        for key, a, w in zip(("dq", "dk", "dv"), g_f, g_x):
            res[key] = _tile_rel(a, w)
        res["finite"] = bool(torch.isfinite(o_f.float()).all()
                             and all(torch.isfinite(t.float()).all()
                                     for t in g_f))
        del got, q, k, v, g, o_f, g_f, o_x, g_x
        gc.collect()
        torch.cuda.empty_cache()
    bootstrap.host_barrier("seq-ring-check")
    return res


def seq_worker(out: str) -> None:
    """A rank of phase seq's gloo world of four: lm_long on data=2 x seq=2
    once for each mode of SEQ_MODES (:func:`_seq_run`), then (c)'s ring
    check on a layout of its own; rank 0 writes every rank's results to
    ``out`` and step 1's gradients of each mode beside it
    (``grads_<mode>.pt``)."""
    bootstrap.initialize(device="cuda")
    rank = collectives.world()[1]
    runs = []
    for mode in SEQ_MODES:
        run, grads = _seq_run(mode, rank, profile=mode == "ring")
        runs.append(run)
        if grads is not None:
            torch.save(grads, Path(out).with_name(f"grads_{mode}.pt"))
        del grads
    ring = _seq_ring_check(rank, mesh_lib.build(SEQ_MESH, rank).seq)
    everyone = bootstrap.allgather_object({"runs": runs, "ring": ring})
    if rank == 0:
        Path(out).write_text(json.dumps(everyone))
    bootstrap.shutdown()


def _seq_want(mode: str, seq_index: int, steps: int) -> tuple:
    """Launches a rank must show: (a step's, the eval's) per kernel.  The
    ring runs ``seq_index + 1`` stages at or below the diagonal a layer
    (none above), the forward twice a step under remat; Ulysses one
    whole-sequence stage a layer."""
    stages = seq_index + 1 if mode == "ring" else 1
    step = {"flash_fwd": 2 * stages * SEQ_LAYERS,
            "flash_bwd_delta": stages * SEQ_LAYERS,
            "flash_bwd_dq": stages * SEQ_LAYERS,
            "flash_bwd_dkv": stages * SEQ_LAYERS,
            "fused_conv_bn_bwd": 0, "precision_probe": 0}
    evals = {k: 0 for k in step}
    evals["flash_fwd"] = stages * SEQ_LAYERS * SEQ_EVAL_BATCHES
    return step, evals


def _seq_parity(run: dict, grads: dict, ref: dict) -> tuple:
    """Step 1 against the one-process steps (SEQ_PARITY_RTOL's rule):
    the loss, the gradient norm and each parameter's gradient.  Returns
    (problems, the worst gradient's ratio to its noise floor and its
    name)."""
    bad = []
    for key in ("loss", "grad_norm"):
        got, b16, f32 = (run["step1"][key], ref["bfloat16"][key],
                         ref["float32"][key])
        if abs(got - f32) > max(BF16_NOISE_FACTOR * abs(b16 - f32),
                                SEQ_PARITY_RTOL * abs(f32)):
            bad.append(f"step 1 {key} {got} vs one process f32 {f32} (bf16 "
                       f"{b16}): beyond {BF16_NOISE_FACTOR} x the bf16 "
                       f"step's distance and {SEQ_PARITY_RTOL} relative")
    want, noise = ref["float32"]["grads"], ref["bfloat16"]["grads"]
    if set(grads) != set(want):
        bad.append(f"step 1 gradients of {sorted(set(grads) ^ set(want))} "
                   f"on one side only")
    worst, where = 0.0, ""
    for name in sorted(set(grads) & set(want)):
        got, floor = _rel(grads[name], want[name]), _rel(noise[name],
                                                         want[name])
        ratio = got / max(floor, 1e-30)
        if ratio > worst:
            worst, where = ratio, name
        if not got <= BF16_NOISE_FACTOR * floor:
            bad.append(f"step 1 gradient {name}: {got:.2e} from the one-"
                       f"process f32 step (noise floor {floor:.2e})")
    return bad, (worst, where)


def phase_seq() -> dict:
    """Sequence parallelism (``parallel/mesh.py``, the seq verbs of
    ``parallel/collectives.py``, ``ops/seq_parallel.py``): lm_long on its
    own data=2 x seq=2 mesh at S=32768 in a gloo world of four processes
    (``--seq-worker``), (a) with ring attention on the flash kernels and
    (b) with Ulysses: step 1's loss, gradient norm and per-parameter
    gradients against one process on the same global batch and weights
    (SEQ_PARITY_RTOL's rule), every rank's final parameters bit-identical,
    every step's launches on every rank (the ring's ``seq_index + 1``
    stages a layer, none above the diagonal; the forward twice under
    remat) all on the tensor cores; then (c) the flash-stage ring against
    the plain-stage ring, and ``flash_mha_lse``'s kernels against their
    plain versions at each stage the run gives them (SEQ_KERNEL_CASES: the
    ring's two with an lse cotangent, Ulysses's), at a rank's shapes, each
    by its worst tile.  Prints each rank's step p50, tokens/s,
    peak memory, bytes through the seq group a step and rank 0's idle
    share from one profiled step."""
    gc.collect()
    torch.cuda.empty_cache()
    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    ref = _seq_reference()
    ref_s = time.monotonic() - t0
    log(f"[seq] one process, seq 1, step 1 on the four-rank run's global "
        f"batch (lm_long, S=32768, batch {SEQ_GLOBAL_BATCH}): bf16 loss "
        f"{ref['bfloat16']['loss']:.6f} grad norm "
        f"{ref['bfloat16']['grad_norm']:.6f} ({ref['bfloat16']['s']:.1f} s "
        f"with the build); f32 loss {ref['float32']['loss']:.6f} grad norm "
        f"{ref['float32']['grad_norm']:.6f} ({ref['float32']['s']:.1f} s)")
    kernels = {name: _seq_kernel_check(name, shape, causal, with_dlse)
               for name, shape, causal, with_dlse in SEQ_KERNEL_CASES}
    root = tempfile.mkdtemp(prefix="tpuframe_seq_")
    try:
        t0 = time.monotonic()
        out = os.path.join(root, "seq.json")
        LocalCluster(SEQ_RANKS, timeout=SEQ_TIMEOUT_S,
                     extra_env={"TPUFRAME_DIST_BACKEND": "gloo"}).launch(
            [sys.executable, str(Path(__file__).resolve()), "--seq-worker",
             out])
        ranks = json.loads(Path(out).read_text())
        grads = {mode: torch.load(os.path.join(root, f"grads_{mode}.pt"))
                 for mode in SEQ_MODES}
        world_s = time.monotonic() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    problems = []
    total = {k: 0 for k in launch_counts()}
    tokens = SEQ_GLOBAL_BATCH * get_config("lm_long").dataset_kwargs[
        "seq_len"]                      # the global batch's, a step
    for m, mode in enumerate(SEQ_MODES):
        runs = [r["runs"][m] for r in ranks]
        tag = "(a) ring" if mode == "ring" else "(b) ulysses"
        if len({r["digest"] for r in runs}) != 1:
            problems.append(f"{tag}: final parameters differ across ranks")
        bad, (ratio, where) = _seq_parity(runs[0], grads[mode], ref)
        problems += [f"{tag}: {p}" for p in bad]
        if len({(r["step1"]["loss"], r["step1"]["grad_norm"])
                for r in runs}) != 1:
            problems.append(f"{tag}: ranks report different step-1 "
                            f"metrics {[r['step1'] for r in runs]}")
        for r in runs:
            losses = r["losses"]
            if (len(losses) != SEQ_STEPS
                    or not all(math.isfinite(x) for x in losses)
                    or not math.isfinite(r["eval_loss"] or float("nan"))):
                problems.append(f"{tag} rank {r['rank']}: losses {losses}, "
                                f"eval {r['eval_loss']}")
            want_step, want_eval = _seq_want(mode, r["seq_index"],
                                             SEQ_STEPS)
            for i, st in enumerate(r["steps"][:SEQ_STEPS]):
                if st["launches"] != want_step:
                    problems.append(f"{tag} rank {r['rank']} step {i + 1}: "
                                    f"launches {st['launches']}, want "
                                    f"{want_step}")
            want = {k: SEQ_STEPS * want_step[k] + want_eval[k]
                    for k in want_step}
            if r["launches"] != want:
                problems.append(f"{tag} rank {r['rank']}: run launches "
                                f"{r['launches']}, want {want}")
            n_fwd, n_bwd = want["flash_fwd"], 3 * want["flash_bwd_dq"]
            if (r["routes"]["fwd"] != {"tensor_core": n_fwd, "cuda_core": 0}
                    or r["routes"]["bwd"] != {"tensor_core": n_bwd,
                                              "cuda_core": 0}):
                problems.append(f"{tag} rank {r['rank']}: routes "
                                f"{r['routes']}, want every launch on the "
                                f"tensor cores")
            for k in total:
                total[k] += r["launches"][k]
            p50 = statistics.median(r["step_ms"][1:])
            prof = r["profile"]
            idle = ("" if r["rank"] or prof["wall_ms"] is None else
                    f", one profiled step {prof['wall_ms']:.1f} ms wall, "
                    f"device {_dev(prof['device_ms'], '.1f')} ms, idle share "
                    f"{_dev(prof['idle'])}; top: "
                    + "; ".join(f"{k} {ms:.1f} ms x{cnt}"
                                for k, ms, cnt in prof["top"][:5]))
            log(f"[seq] {tag} rank {r['rank']} (data {r['data_index']}, seq "
                f"{r['seq_index']}): losses "
                f"{[round(x, 4) for x in r['losses']]}, eval "
                f"{r['eval_loss']:.4f}; step ms "
                f"{[round(x, 1) for x in r['step_ms']]} (p50 after the "
                f"first {p50:.1f}, {tokens / p50 * 1e3:.0f} tokens/s of the "
                f"global batch); peak memory {r['peak_bytes'] / 2**30:.2f} "
                f"GiB; through the seq group "
                f"{r['steps'][SEQ_STEPS - 1]['seq_bytes'] / 1e9:.3f} GB a "
                f"step; run "
                f"{r['wall_s']:.1f} s{idle}; {card}")
        log(f"[seq] {tag} step 1: loss {runs[0]['step1']['loss']:.6f} grad "
            f"norm {runs[0]['step1']['grad_norm']:.6f} against one process "
            f"bf16 {ref['bfloat16']['loss']:.6f} / "
            f"{ref['bfloat16']['grad_norm']:.6f}, f32 "
            f"{ref['float32']['loss']:.6f} / "
            f"{ref['float32']['grad_norm']:.6f}; per-parameter gradients "
            f"(rank 0's, reduced) against the one-process f32 step: worst "
            f"{ratio:.2f} x the one-process bf16 step's own distance "
            f"({where}; limit {BF16_NOISE_FACTOR})")
    ring = [r["ring"] for r in ranks if r["ring"] is not None]
    if len(ring) != SEQ_MESH["seq"]:
        problems.append(f"(c) ring check ran on {len(ring)} ranks")
    worst = {key: max(r[key] for r in ring) for key in
             ("out", "dq", "dk", "dv")} if ring else {}
    if ring and not (all(r["finite"] for r in ring)
                     and worst["out"] <= SEQ_RING_TOL["out"]
                     and max(worst[g] for g in ("dq", "dk", "dv"))
                     <= SEQ_RING_TOL["grad"]):
        problems.append(f"(c) flash-stage ring vs plain-stage ring {worst}, "
                        f"tolerances {SEQ_RING_TOL}")
    if ring:
        log(f"[seq] (c) one layer's ring at {list(SEQ_RING_SHAPE)} a rank, "
            f"bf16 causal, flash stages vs plain stages, worst tile: out "
            f"{worst['out']:.3e} dq "
            f"{worst['dq']:.3e} dk {worst['dk']:.3e} dv {worst['dv']:.3e} "
            f"(tolerances {SEQ_RING_TOL}); forward + backward "
            f"{max(r['s_flash'] for r in ring):.2f} s flash, "
            f"{max(r['s_plain'] for r in ring):.2f} s plain")
    log(f"[seq] world of {SEQ_RANKS} (two lm_long runs, one profiled step "
        f"after the ring's, the ring check): {world_s:.1f} s; the "
        f"one-process steps "
        f"{ref_s:.1f} s; {card}")
    if problems:
        raise RuntimeError("seq: " + "; ".join(problems[:12]))
    return {"launches": total, "kernels": kernels, "ring": worst}


def _moe_args(mesh: dict) -> list:
    """``train.main`` arguments of lm_long with phase moe's model and
    cuts on ``mesh``."""
    cfg = get_config("lm_long")
    sets = {"mesh": mesh, "model_kwargs": dict(cfg.model_kwargs, **MOE_MODEL),
            "dataset_kwargs": MOE_DATA,
            "global_batch": MOE_GLOBAL_BATCH, "total_steps": MOE_STEPS,
            "eval_every": MOE_STEPS, "eval_batches": MOE_EVAL_BATCHES,
            "log_every": 1}
    return ["--config", "lm_long"] + [
        a for k, v in sets.items() for a in ("--set", f"{k}={v!r}")]


def _moe_cfg() -> LMConfig:
    """Phase moe's model."""
    return LMConfig(**dict(get_config("lm_long").model_kwargs, **MOE_MODEL))


def _moe_law(mesh: dict) -> dict:
    """The sharded-state collectives of one training step of phase moe's
    model on ``mesh`` (data 1), as ``{verb: (calls, bytes this rank
    sends)}`` from ``collectives.SHARD_CALLS``/``SHARD_BYTES``.  Every
    partial result is summed in f32 ([T, H], 4 bytes an element), every
    ``copy_to``'s cotangent once in the backward; the remat recompute
    (``torch.utils.checkpoint``) stops once it has rebuilt the last tensor
    the block's backward saved, so an MLP's or MoE layer's output sum,
    which only feeds the residual add, runs once a step, and the
    attention's, under the MLP's LayerNorm, twice.  The embedding's
    columns and the head's rows are gathered once (outside the blocks),
    and the global gradient norm sums three numbers.  (b) expert=2: an
    MoE layer's output sum and its tokens' and combine weights' ([T, E])
    cotangents.  (c) model=2: each block's attention output sum (x2) and
    its input's cotangent; a dense MLP's output sum and input cotangent;
    an MoE layer's as (b)'s."""
    t = MOE_GLOBAL_BATCH * MOE_DATA["seq_len"]
    cfg = _moe_cfg()
    h, e, v = cfg.hidden_size, cfg.moe_experts, cfg.vocab_size
    layers = cfg.num_layers
    moe = sum(1 for i in range(layers) if (i + 1) % cfg.moe_every == 0)
    dense = layers - moe
    full, weight = t * h * 4, t * e * 4
    calls, nbytes = 3 * moe + 1, moe * (2 * full + weight) + 12
    gather = (0, 0)
    if mesh.get("model", 1) > 1:
        m = mesh["model"]
        calls += 3 * layers + 2 * dense
        nbytes += (3 * layers + 2 * dense) * full
        gather = (2, t * (h // m) * 4 + (v // m) * h * 4)
    return {"all_reduce": (calls, nbytes), "all_gather": gather}


def _grad_blocks(model) -> dict:
    """Each parameter's gradient (f32, on the host) with the block of the
    whole tensor it is (None: whole)."""
    specs = getattr(model, "shard_specs", {})
    out = {}
    for n, p in model.named_parameters():
        if p.grad is None:
            continue
        idx = None
        if n in specs:
            from tpuframe_torch.parallel import tp

            idx = tp.shard_leaf(p.grad, specs[n], model.layout).index
        out[n] = (idx, p.grad.detach().float().cpu())
    return out


def _whole(blocks_by_rank: list) -> dict:
    """The ranks' gradient blocks put back together."""
    from tpuframe_torch.parallel import tp

    out = {}
    for name, (idx, t) in blocks_by_rank[0].items():
        if idx is None:
            out[name] = t
            continue
        parts = {tuple(map(tuple, r[name][0])): r[name][1]
                 for r in blocks_by_rank}
        shape = tuple(max(hi for _, hi in dims) for dims in zip(*parts))
        out[name] = tp.paste(shape, parts.items())
    return out


def _moe_run(tag: str, mesh: dict, rank: int, profile: bool,
             tries: int = 1) -> tuple:
    """One lm_long MoE run of this process (or world) through
    ``train.main`` on ``mesh`` (:func:`_sharded_run`)."""
    return _sharded_run(tag, _moe_args(mesh), rank, profile, tries,
                        steps=MOE_STEPS,
                        keys=("loss", "moe_aux", "grad_norm"))


def _sharded_run(tag: str, args: list, rank: int, profile: bool,
                 tries: int = 1, *, steps: int, keys: tuple,
                 stats_out: dict | None = None) -> tuple:
    """One run of this process (or world) through ``train.main`` with
    ``args``: every step's launches, sharded-state and pipe collectives
    and flash head counts, step 1's metrics ``keys``, the final
    replicated leaves' digests, each parameter's and its moments' shapes,
    peak memory and state bytes; then, with ``profile``, one step timed
    outside the profiler and one more profiled on rank 0 (up to ``tries``
    times while the profiler's record is not whole: one process only,
    since the other ranks of a world step once beside it).  Returns that and step 1's
    reduced gradients as blocks (:func:`_grad_blocks`); ``stats_out``
    gets the running statistics after step 1 (f32, on the host)."""
    build = train_lib.build_harness
    got = {"steps": [], "heads": set()}
    real_fwd, real_bwd = fa._launch, fa._launch_bwd

    def fwd(q, *a, **kw):
        got["heads"].add(int(q.shape[2]))
        return real_fwd(q, *a, **kw)

    def bwd(which, q, *a, **kw):
        got["heads"].add(int(q.shape[2]))
        return real_bwd(which, q, *a, **kw)

    def capturing_build(cfg, device="cuda"):
        h = build(cfg, device)
        step = h.train_step

        def train_step(state, batch):
            launches0 = launch_counts()
            counters = (collectives.SHARD_CALLS, collectives.SHARD_BYTES,
                        collectives.PIPE_CALLS, collectives.PIPE_BYTES)
            before = [dict(c) for c in counters]
            metrics = step(state, batch)
            launches = launch_counts()
            calls, nbytes, pipe_calls, pipe_bytes = (
                {k: c[k] - c0[k] for k in c0}
                for c, c0 in zip(counters, before))
            got["steps"].append({
                "launches": {k: launches[k] - launches0[k]
                             for k in launches},
                "calls": calls, "bytes": nbytes, "pipe_calls": pipe_calls,
                "pipe_bytes": pipe_bytes})
            if len(got["steps"]) == 1:
                got["step1"] = {k: float(metrics[k]) for k in keys}
                got["grads"] = _grad_blocks(state.model)
                if stats_out is not None:
                    stats_out.update(_running_stats(state.model))
            return metrics

        h.train_step = train_step
        got["harness"] = h
        return h

    train_lib.build_harness = capturing_build
    fa._launch, fa._launch_bwd = fwd, bwd
    reset_launches()
    collectives.reset_shard()
    collectives.reset_pipe()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    try:
        metrics = train_lib.main(args)
    finally:
        train_lib.build_harness = build
        fa._launch, fa._launch_bwd = real_fwd, real_bwd
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = launch_counts()
    routes = {"fwd": dict(fa.FWD_ROUTES), "bwd": dict(fa.BWD_ROUTES),
              "conv_bn": dict(fcb.ROUTES)}
    peak = torch.cuda.max_memory_allocated()
    h = got.pop("harness")
    model = h.state.model
    specs = getattr(model, "shard_specs", {})
    replicated = {n: hashlib.sha256(p.detach().cpu().contiguous().view(
        torch.uint8).numpy().tobytes()).hexdigest()
        for n, p in model.named_parameters() if n not in specs}
    state_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters()) + sum(
        t.numel() * t.element_size() for key, ts in h.state.opt.moments
        .items() for t in ts)
    moments = h.state.opt.state_dict()
    shapes = {n: [list(p.shape)] + [list(moments[k][n].shape)
                                    for k in ("mu", "nu", "trace")
                                    if k in moments]
              for n, p in model.named_parameters()}
    prof = {"wall_ms": None, "device_ms": None, "idle": None, "top": []}
    if profile:
        batch = next(iter(h.train_loader))

        def step():
            return float(h.train_step(h.state, batch)["loss"])

        # the wall of one step outside the profiler (whose start-up
        # would count as idle), then one more step profiled on rank 0
        torch.cuda.synchronize()
        t1 = time.monotonic()
        step()
        wall_step = 1e3 * (time.monotonic() - t1)
        if rank == 0:
            kernels = device_time(step, tries=tries)
            busy, idle, _ = _busy(kernels, wall_step)
            prof = {"wall_ms": wall_step, "device_ms": busy, "idle": idle,
                    "top": [(k[:60], ms, c)
                            for k, ms, c in (kernels or [])[:8]]}
        else:
            step()
        torch.cuda.synchronize()
    grads = got.pop("grads")
    lay = h.layout
    del h, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"tag": tag, "rank": rank, "coords": lay.coords(),
            "wall_s": wall, "losses": metrics["losses"],
            "step_ms": metrics["step_ms"],
            "eval_loss": metrics.get("eval_loss"), "step1": got["step1"],
            "steps": got["steps"][:steps], "heads": sorted(got["heads"]),
            "launches": launches, "routes": routes, "peak_bytes": peak,
            "state_bytes": state_bytes, "replicated": replicated,
            "shapes": shapes, "sizes": lay.sizes, "profile": prof}, grads


def _moe_reference() -> dict:
    """Step 1 of phase moe's model as one process in f32, on the same
    global batch and weights: the noise floor's yardstick (loss, aux,
    gradient norm, each parameter's gradient on the host)."""
    cfg = get_config("lm_long").with_overrides(
        mesh={"data": 1}, global_batch=MOE_GLOBAL_BATCH,
        dataset_kwargs=MOE_DATA, compute_dtype="float32",
        model_kwargs=dict(get_config("lm_long").model_kwargs, **MOE_MODEL))
    t0 = time.monotonic()
    h = train_lib.build_harness(cfg, device="cuda")
    batch = next(iter(h.train_loader))
    m = h.train_step(h.state, batch)
    out = {"loss": float(m["loss"]), "moe_aux": float(m["moe_aux"]),
           "grad_norm": float(m["grad_norm"]),
           "grads": {n: g for n, (_, g) in
                     _grad_blocks(h.state.model).items()},
           "s": time.monotonic() - t0}
    del h, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_worker(out: str) -> None:
    """A rank of phase moe's gloo world of two: each run of MOE_MESHES in
    turn through :func:`_moe_run`; each rank saves step 1's gradient
    blocks beside ``out`` (``grads_<which>.<rank>.pt``), rank 0 writes
    every rank's results to ``out`` (``{which: [rank 0's, rank 1's]}``)."""
    bootstrap.initialize(device="cuda")
    rank = collectives.world()[1]
    runs = {}
    for which, mesh in MOE_MESHES.items():
        run, grads = _moe_run(which, mesh, rank, profile=True)
        torch.save(grads, Path(out).with_name(f"grads_{which}.{rank}.pt"))
        runs[which] = bootstrap.allgather_object(run)
        del grads
    if rank == 0:
        Path(out).write_text(json.dumps(runs))
    bootstrap.shutdown()


def _moe_parity(step1: dict, grads: dict, ref: dict) -> tuple:
    """Step 1 against the one-process steps (SEQ_PARITY_RTOL's rule,
    phase seq's): loss, aux, gradient norm and each parameter's gradient
    within BF16_NOISE_FACTOR x run (a)'s own distance from the f32 step.
    Returns (problems, the worst gradient's ratio to its floor and its
    name)."""
    bad = []
    for key in ("loss", "moe_aux", "grad_norm"):
        got, b16, f32 = step1[key], ref["bf16"][key], ref["f32"][key]
        if abs(got - f32) > max(BF16_NOISE_FACTOR * abs(b16 - f32),
                                SEQ_PARITY_RTOL * abs(f32)):
            bad.append(f"step 1 {key} {got} vs one process f32 {f32} (bf16 "
                       f"{b16})")
    want, noise = ref["f32"]["grads"], ref["bf16"]["grads"]
    if set(grads) != set(want):
        bad.append(f"step 1 gradients of {sorted(set(grads) ^ set(want))} "
                   f"on one side only")
    worst, where = 0.0, ""
    for name in sorted(set(grads) & set(want)):
        got, floor = _rel(grads[name], want[name]), _rel(noise[name],
                                                         want[name])
        ratio = got / max(floor, 1e-30)
        if ratio > worst:
            worst, where = ratio, name
        if not got <= BF16_NOISE_FACTOR * floor:
            bad.append(f"step 1 gradient {name}: {got:.2e} from the one-"
                       f"process f32 step (noise floor {floor:.2e})")
    return bad, (worst, where)


def _moe_checks(tag: str, r: dict, want_heads: int, law: dict | None) -> list:
    """:func:`_run_checks` of a phase moe run (remat: the forward twice a
    layer and step)."""
    return _run_checks(tag, r, want_heads, law, steps=MOE_STEPS,
                       layers=_moe_cfg().num_layers, fwd_per_step=2,
                       eval_batches=MOE_EVAL_BATCHES)


def _run_checks(tag: str, r: dict, want_heads: int, law: dict | None, *,
                steps: int, layers: int, fwd_per_step: int,
                eval_batches: int) -> list:
    """A run's launches a step and in all (phase train's count: the
    forward ``fwd_per_step`` times a layer and step, twice under remat,
    once a layer and eval batch; each backward kernel once a layer and
    step), every one on the tensor cores, on ``want_heads`` heads; its
    collectives a step equal to ``law``; finite losses and eval loss."""
    bad = []
    want_step = {"flash_fwd": fwd_per_step * layers,
                 "flash_bwd_delta": layers,
                 "flash_bwd_dq": layers, "flash_bwd_dkv": layers,
                 "fused_conv_bn_bwd": 0, "precision_probe": 0}
    want = dict(want_step,
                flash_fwd=(fwd_per_step * steps + eval_batches) * layers,
                flash_bwd_delta=steps * layers, flash_bwd_dq=steps * layers,
                flash_bwd_dkv=steps * layers)
    for i, st in enumerate(r["steps"]):
        if st["launches"] != want_step:
            bad.append(f"step {i + 1} launches {st['launches']}, want "
                       f"{want_step}")
        if law is not None:
            got = {k: (st["calls"][k], st["bytes"][k]) for k in law}
            if got != law:
                bad.append(f"step {i + 1} collectives {got}, want the law "
                           f"{law}")
    if r["launches"] != want:
        bad.append(f"run launches {r['launches']}, want {want}")
    n_bwd = 3 * steps * layers
    if (r["routes"]["fwd"] != {"tensor_core": want["flash_fwd"],
                               "cuda_core": 0}
            or r["routes"]["bwd"] != {"tensor_core": n_bwd, "cuda_core": 0}):
        bad.append(f"routes {r['routes']}, want every launch on the tensor "
                   f"cores")
    if r["heads"] != [want_heads]:
        bad.append(f"flash launches on {r['heads']} heads, want "
                   f"{want_heads}")
    if (len(r["losses"]) != steps
            or not all(math.isfinite(x) for x in r["losses"])
            or not math.isfinite(r["eval_loss"] or float("nan"))):
        bad.append(f"losses {r['losses']}, eval {r['eval_loss']}")
    return [f"{tag} rank {r['rank']}: {b}" for b in bad]


def _moe_line(tag: str, r: dict, card: str, prefix: str = "[moe]") -> str:
    ms = r["step_ms"][1:] or r["step_ms"]
    q = statistics.quantiles(ms, n=10) if len(ms) > 1 else [ms[0]] * 9
    st = r["steps"][-1]
    prof = r["profile"]
    idle = ("" if prof["wall_ms"] is None else
            f"; one profiled step {prof['wall_ms']:.1f} ms wall, device "
            f"{_dev(prof['device_ms'], '.1f')} ms, idle share "
            f"{_dev(prof['idle'])}; top: "
            + "; ".join(f"{k} {ms_:.1f} ms x{c}"
                        for k, ms_, c in prof["top"][:4]))
    return (f"{prefix} {tag} rank {r['rank']} {r['coords']}: losses "
            f"{[round(x, 4) for x in r['losses']]}, eval "
            f"{r['eval_loss']:.4f}; step ms "
            f"{[round(x, 1) for x in r['step_ms']]} (p50 after the first "
            f"{statistics.median(ms):.1f}, p10-p90 {q[0]:.1f}-{q[-1]:.1f});"
            f" peak memory {r['peak_bytes'] / 2**30:.2f} GiB, state "
            f"{r['state_bytes'] / 1e9:.3f} GB; sharded-state collectives a "
            f"step {st['calls']} calls, {st['bytes']} bytes; run "
            f"{r['wall_s']:.1f} s{idle}; {card}")


def phase_moe() -> dict:
    """Mixture of experts, expert and tensor parallelism
    (``models/transformer_lm.py``'s ``MoEMLP``, ``parallel/tp.py``, the
    sharded-state layout of ``parallel/mesh.py``): phase moe's lm_long
    MoE model through ``train.main`` (a) as one process, then (b) on
    data=1 x expert=2 and (c) on data=1 x model=2 in turn in one world of
    two gloo processes (``--moe-worker``).  Step 1 of (b) and (c) against (a) and a
    one-process f32 step (SEQ_PARITY_RTOL's rule): loss, aux, gradient
    norm and every parameter's gradient (the ranks' blocks put together);
    replicated leaves bit-identical across the ranks (step-1 gradients and
    final values); every flash launch on the tensor cores, the count a
    rank the path's, (c)'s on 6 heads; the sharded-state collectives of
    every step equal to :func:`_moe_law`.  Prints each run's step p50 and
    p10-p90, peak memory and state bytes a rank, bytes a step and rank
    0's idle share from one profiled step."""
    gc.collect()
    torch.cuda.empty_cache()
    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    ref_f32 = _moe_reference()
    a, grads_a = _moe_run("(a) one process", {"data": 1}, 0, profile=True,
                          tries=PROFILE_TRIES)
    ref = {"f32": ref_f32, "bf16": {**a["step1"], "grads": {
        n: g for n, (_, g) in grads_a.items()}}}
    one_s = time.monotonic() - t0
    heads = _moe_cfg().num_heads
    problems = _moe_checks("(a)", a, heads, None)
    runs = {"a": [a]}
    root = tempfile.mkdtemp(prefix="tpuframe_moe_")
    try:
        out = os.path.join(root, "moe.json")
        LocalCluster(2, timeout=MOE_TIMEOUT_S,
                     extra_env={"TPUFRAME_DIST_BACKEND": "gloo"}).launch(
            [sys.executable, str(Path(__file__).resolve()), "--moe-worker",
             out])
        runs.update(json.loads(Path(out).read_text()))
        for which, mesh in MOE_MESHES.items():
            blocks = [torch.load(os.path.join(root, f"grads_{which}.{r}.pt"))
                      for r in range(2)]
            tag = ("(b) expert=2" if which == "b" else "(c) model=2")
            for name, (idx, g) in blocks[0].items():
                if idx is None and not torch.equal(g, blocks[1][name][1]):
                    problems.append(f"{tag}: step-1 gradient of replicated "
                                    f"{name} differs across ranks")
            grads = _whole(blocks)
            law = _moe_law(mesh)
            for r in runs[which]:
                problems += _moe_checks(tag, r,
                                        heads // mesh.get("model", 1), law)
            r0, r1 = runs[which]
            if r0["replicated"] != r1["replicated"]:
                diff = [n for n in r0["replicated"]
                        if r0["replicated"][n] != r1["replicated"].get(n)]
                problems.append(f"{tag}: final replicated leaves differ "
                                f"across ranks: {diff[:6]}")
            if r0["step1"] != r1["step1"]:
                problems.append(f"{tag}: ranks report different step-1 "
                                f"metrics {r0['step1']}, {r1['step1']}")
            bad, (ratio, where) = _moe_parity(r0["step1"], grads, ref)
            problems += [f"{tag}: {p}" for p in bad]
            runs[which + "_parity"] = (ratio, where)
            del blocks, grads
    finally:
        shutil.rmtree(root, ignore_errors=True)
    world_s = time.monotonic() - t0 - one_s
    log(f"[moe] lm_long + {MOE_MODEL} (every second block), "
        f"S={MOE_DATA['seq_len']}, "
        f"global batch {MOE_GLOBAL_BATCH}, {MOE_STEPS} steps + "
        f"{MOE_EVAL_BATCHES} eval batch; one-process f32 step 1: loss "
        f"{ref_f32['loss']:.6f} aux {ref_f32['moe_aux']:.6f} grad norm "
        f"{ref_f32['grad_norm']:.6f} ({ref_f32['s']:.1f} s with the build)")
    log(_moe_line("(a) one process", a, card))
    total = dict(a["launches"])
    for which in MOE_MESHES:
        tag = "(b) expert=2" if which == "b" else "(c) model=2"
        for r in runs[which]:
            log(_moe_line(tag, r, card))
            for k in total:
                total[k] += r["launches"][k]
        ratio, where = runs[which + "_parity"]
        s1 = runs[which][0]["step1"]
        log(f"[moe] {tag} step 1: loss {s1['loss']:.6f} aux "
            f"{s1['moe_aux']:.6f} grad norm {s1['grad_norm']:.6f} against "
            f"(a) {a['step1']['loss']:.6f} / {a['step1']['moe_aux']:.6f} / "
            f"{a['step1']['grad_norm']:.6f} and f32 "
            f"{ref_f32['loss']:.6f} / {ref_f32['moe_aux']:.6f} / "
            f"{ref_f32['grad_norm']:.6f}; per-parameter gradients against "
            f"the f32 step: worst {ratio:.2f} x (a)'s own distance "
            f"({where}; limit {BF16_NOISE_FACTOR}); law "
            f"{_moe_law(MOE_MESHES[which])}")
    log(f"[moe] (a) and the f32 step {one_s:.1f} s, the world of (b) and "
        f"(c) {world_s:.1f} s; {card}")
    if problems:
        raise RuntimeError("moe: " + "; ".join(problems[:12]))
    return {"launches": total}


_FSDP_CONFIGS = {"bert": "glue_bert", "lm": "lm_long",
                 "resnet": "imagenet_resnet50"}


def _fsdp_sets(family: str, mesh: dict | None) -> dict:
    """Phase fsdp's overrides of ``family``'s config on ``mesh`` (None:
    no mesh override, the run's TPUFRAME_SPEC declares it)."""
    sets = {"total_steps": FSDP_STEPS, "eval_every": FSDP_STEPS,
            "eval_batches": FSDP_EVAL_BATCHES, "log_every": 1}
    if mesh is not None:
        sets["mesh"] = mesh
    if family == "bert":
        return {**sets, "model_kwargs": FSDP_BERT_KW}
    if family == "resnet":
        return {**sets, **FSDP_RESNET_CUTS}
    return {**sets, "dataset_kwargs": FSDP_LM_DATA,
            "global_batch": FSDP_LM_BATCH}


def _fsdp_mesh(mesh: dict | None) -> dict:
    """The mesh of a run: ``mesh``, or (None) the one FSDP_RESNET_SPEC
    declares on its two ranks."""
    if mesh is not None:
        return mesh
    from tpuframe_torch.parallel import pspec

    sizes = pspec.parse_spec(FSDP_RESNET_SPEC).sizes(2)
    return {a: n for a, n in sizes.items() if n > 1 or a == "data"}


def _fsdp_cfg(family: str, mesh: dict | None):
    return get_config(_FSDP_CONFIGS[family]).with_overrides(
        **_fsdp_sets(family, _fsdp_mesh(mesh)))


def _fsdp_model_cfg(family: str):
    """Phase fsdp's model config of ``family`` (``BertConfig`` or
    ``LMConfig``)."""
    kw = dict(_fsdp_cfg(family, FSDP_ONE[family]).model_kwargs)
    return (BertConfig if family == "bert" else LMConfig)(**kw)


def _fsdp_args(family: str, mesh: dict | None) -> list:
    """``train.main`` arguments of phase fsdp's ``family`` run on
    ``mesh`` (None: TPUFRAME_SPEC's)."""
    return ["--config", _FSDP_CONFIGS[family]] + [
        a for k, v in _fsdp_sets(family, mesh).items()
        for a in ("--set", f"{k}={v!r}")]


def _fsdp_reference(family: str) -> dict:
    """Step 1 of ``family``'s config as one process on the sharded runs'
    global batch (each of the two batch ranks' first loader batch, in
    batch order) and weights, in bf16 (the run's own dtype) and in f32
    (the noise floor's yardstick): loss, gradient norm, each parameter's
    gradient and the running statistics after the step, on the host."""
    cfg = _fsdp_cfg(family, FSDP_ONE[family])
    ds, _ = datasets.build(cfg.dataset, None, **cfg.dataset_kwargs)
    parts = [next(iter(ShardedLoader(ds, cfg.global_batch, device="cuda",
                                     seed=cfg.seed, world=2, rank=r)))
             for r in range(2)]
    batch = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    out = {}
    for dtype in ("bfloat16", "float32"):
        t0 = time.monotonic()
        h = train_lib.build_harness(cfg.with_overrides(compute_dtype=dtype),
                                    device="cuda")
        m = h.train_step(h.state, batch)
        out[dtype] = {"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "grads": _grads(h.state.model),
                      "stats": _running_stats(h.state.model),
                      "s": time.monotonic() - t0}
        del h, m
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _running_stats(model) -> dict:
    """The model's float buffers (the BatchNorm running statistics), f32
    on the host."""
    return {n: b.detach().float().cpu() for n, b in model.named_buffers()
            if b.is_floating_point()}


def _fsdp_law(family: str, mesh: dict) -> tuple:
    """The placement and the sharded-state collectives of one training
    step of ``family`` on ``mesh``, from the whole model's
    ``fsdp.state_shardings``: ``({parameter: (whole
    shape, spec)}, {verb: (calls, bytes this rank sends)})``.  (The
    whole model is built on the card only for its shapes: the host's
    initialisation of BERT-base took seconds.)

    Every parameter split over fsdp is gathered before each use, its
    block's f32 bytes sent (twice a step inside lm_long's blocks, whose
    remat recompute rebuilds every weight the block's backward saved;
    once for the embedding, the head and every BERT parameter), and
    reduce-scattered once a step, its whole f32 bytes over fsdp sent.
    BERT on model=2: each layer's attention and FFN input cotangents and
    their row-parallel output sums, four f32 all-reduces of the rank's
    ``[B/2, S, H]``, and the word embedding's columns gathered once.  The
    gradient norm sums seven numbers over the model group (when it has
    one) and over the fsdp group.  ResNet-50: each BatchNorm's two f32
    sums a channel over the batch group once in the forward and once in
    the backward (``bn_stats``; no remat)."""
    from tpuframe_torch.parallel import fsdp, tp

    cfg = _fsdp_cfg(family, mesh)
    model = get_model(cfg.model, device="cuda", seed=cfg.seed,
                      **cfg.model_kwargs)
    world = int(np.prod(list(mesh.values())))
    sizes = cfg.mesh.sizes(world)
    tp_axes = sizes["model"] > 1 or sizes["expert"] > 1
    specs = fsdp.state_shardings(
        model, sizes, tp.rules_for_model(cfg.model) if tp_axes else None)
    place = {n: (tuple(p.shape), specs[n])
             for n, p in model.named_parameters()}
    law = {"fsdp_all_gather": [0, 0], "fsdp_reduce_scatter": [0, 0],
           "all_reduce": [1, 28], "all_gather": [0, 0]}
    remat = cfg.model_kwargs.get("remat", False)
    for n, (shape, spec) in place.items():
        if "fsdp" not in spec:
            continue
        local = int(np.prod(shape))
        for a in spec:
            if a is not None:
                local //= sizes[a]
        uses = 2 if remat and n.startswith("blocks.") else 1
        law["fsdp_all_gather"][0] += uses
        law["fsdp_all_gather"][1] += uses * local * 4
        law["fsdp_reduce_scatter"][0] += 1
        law["fsdp_reduce_scatter"][1] += local * sizes["fsdp"] * 4
    m = sizes["model"]
    if m > 1:
        b = cfg.global_batch // (sizes["data"] * sizes["fsdp"])
        rows = b * cfg.dataset_kwargs["seq_len"]
        h, layers = model.cfg.hidden_size, model.cfg.num_layers
        law["all_reduce"] = [4 * layers + 2, 4 * layers * rows * h * 4 + 56]
        law["all_gather"] = [1, rows * (h // m) * 4]
    if family == "resnet":
        law["bn_stats"] = [0, 0]
        for mod in model.modules():
            if hasattr(mod, "stats_group"):
                law["bn_stats"][0] += 2
                law["bn_stats"][1] += 2 * 2 * mod.weight.numel() * 4
    del model
    return place, {k: tuple(v) for k, v in law.items()}


def _fsdp_blocks(r: dict, place: dict) -> list:
    """A rank's parameters and Adam moments against the block law: each
    of the shape of its block of ``place``'s spec (so no whole parameter
    the placement splits stays resident)."""
    from tpuframe_torch.parallel import tp

    bad = []
    if set(r["shapes"]) != set(place):
        bad.append(f"parameters {sorted(set(r['shapes']) ^ set(place))} "
                   f"on one side only")
    for n, (shape, spec) in place.items():
        idx = tp.index(shape, spec, r["sizes"], r["coords"])
        want = [hi - lo for lo, hi in idx]
        got = r["shapes"].get(n) or []
        if len(got) < 2 or any(sh != want for sh in got):
            bad.append(f"{n}: parameter and moments {got}, want the block "
                       f"{want} of {list(shape)} ({spec}) each")
    return bad


def fsdp_worker(out: str) -> None:
    """A rank of one of phase fsdp's gloo worlds: each run the file
    ``<out>.runs.json`` names (``[which, family, mesh]``) in turn through
    :func:`_sharded_run`; each rank saves step 1's gradient blocks beside
    ``out`` (``grads_<which>.<rank>.pt``), rank 0 writes every rank's
    results to ``out`` (``{which: [rank 0's, ...]}``)."""
    bootstrap.initialize(device="cuda")
    rank = collectives.world()[1]
    runs = {}
    for which, family, mesh in json.loads(
            Path(out + ".runs.json").read_text()):
        args, stats = _fsdp_args(family, mesh), {}
        logs = Path(out).with_name(f"events_{which}.{rank}")
        if mesh is None:
            # the spec's run: its log must name the spec
            args += ["--events-dir", str(logs)]
        # (b) shares its world with (d): one profiled step is (d)'s
        run, grads = _sharded_run(FSDP_TAGS[which], args, rank,
                                  profile=which != "b", steps=FSDP_STEPS,
                                  keys=("loss", "grad_norm"),
                                  stats_out=stats)
        if mesh is None:
            run["pspec"] = [
                [rec.get("spec"), rec.get("source")]
                for f in sorted(logs.glob("*.jsonl"))
                for rec in map(json.loads, f.read_text().splitlines())
                if rec.get("type") == "pspec"]
        torch.save(grads, Path(out).with_name(f"grads_{which}.{rank}.pt"))
        torch.save(stats, Path(out).with_name(f"stats_{which}.{rank}.pt"))
        runs[which] = bootstrap.allgather_object(run)
        del grads, stats
    if rank == 0:
        Path(out).write_text(json.dumps(runs))
    bootstrap.shutdown()


def _fsdp_parity(family: str, step1: dict, grads: dict, ref: dict) -> tuple:
    """Step 1 against the one-process steps on the same global batch
    (phase seq's rule): loss, gradient norm and each parameter's gradient
    within BF16_NOISE_FACTOR x the one-process bf16 step's own distance
    from the f32 step (BERT's key biases, whose gradient is zero by
    symmetry, measured against their key kernel's, ``_grad_rel_err``).
    Returns (problems, the worst gradient's ratio to its floor and its
    name)."""
    bad = []
    f32, b16 = ref["float32"], ref["bfloat16"]
    for key in ("loss", "grad_norm"):
        got = step1[key]
        if abs(got - f32[key]) > max(
                BF16_NOISE_FACTOR * abs(b16[key] - f32[key]),
                SEQ_PARITY_RTOL * abs(f32[key])):
            bad.append(f"step 1 {key} {got} vs one process f32 {f32[key]} "
                       f"(bf16 {b16[key]})")
    if set(grads) != set(f32["grads"]):
        bad.append(f"step 1 gradients of "
                   f"{sorted(set(grads) ^ set(f32['grads']))} on one side "
                   f"only")
        return bad, (float("inf"), "")
    if family == "bert":
        got, floor = (_grad_rel_err(grads, f32["grads"]),
                      _grad_rel_err(b16["grads"], f32["grads"]))
    else:
        got = {n: _rel(grads[n], g) for n, g in f32["grads"].items()}
        floor = {n: _rel(b16["grads"][n], g) for n, g in f32["grads"].items()}
    worst, where = 0.0, ""
    for n in sorted(got):
        ratio = got[n] / max(floor[n], 1e-30)
        if ratio > worst:
            worst, where = ratio, n
        if not got[n] <= BF16_NOISE_FACTOR * floor[n]:
            bad.append(f"step 1 gradient {n}: {got[n]:.2e} from the one-"
                       f"process f32 step (noise floor {floor[n]:.2e})")
    return bad, (worst, where)


def _fsdp_kernel_checks(gen) -> list:
    """The flash kernels at a rank's shapes on phase fsdp's paths against
    their plain versions: (c)'s BERT at 6 heads of the rank's 16 rows,
    S=128, key masked, and (d)'s lm_long at one row of S=4096, causal,
    bf16 (the tensor cores)."""
    out = []
    for name, (b, s, n), masked, causal in (
            ("BERT fsdp=2 x model=2 rank", (16, BERT_SEQ, 6), True, False),
            ("lm_long fsdp=2 rank", (1, FSDP_LM_DATA["seq_len"], 12), False,
             True)):
        q, k, v, mask = _flash_inputs(b, s, n, 64, torch.bfloat16, masked,
                                      gen)
        _, _, err, err_lse = _flash_check(name, q, k, v, mask, causal)
        errs, route = _bwd_check(name, _bwd_inputs(
            b, s, n, 64, torch.bfloat16, masked, causal, gen), causal)
        out.append(f"{name} [{b}, {s}, {n}, 64]: forward err {err:.2e} "
                   f"(lse {err_lse:.2e}), backward {route} "
                   + ", ".join(f"{g} {e:.2e}" for g, e in errs.items()))
    return out


def _fsdp_conv_bn_checks(gen) -> dict:
    """The fused conv+BN backward kernel at (e)'s 15 shapes (a rank's 32
    images: every M half of a batch of 64's), bf16 on the tensor cores,
    each through the public wrapper against its plain version, then timed
    beside its plain version, the cuDNN yardstick and its bound (phase
    conv_bn's), the 36 calls of a rank's step summed."""
    dtype, batch = torch.bfloat16, FSDP_RESNET_CUTS["global_batch"] // 2
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "ops_ms",
                         "bytes_ms", "bound_ms"), 0.0)
    worst, calls_all = {"da": 0.0, "dw": 0.0}, 0
    shapes = resnet_conv_bn_shapes(batch=batch)
    for (n, h, w, k, c), calls in shapes.items():
        m = n * h * w
        if fcb.conv_bn_route(dtype, k, c) != "tensor_core":
            raise RuntimeError(f"fsdp rank M={m} K={k} C={c} is not on the "
                               f"tensor-core route")
        args = _conv_bn_inputs(m, k, c, dtype, gen)
        errs = _conv_bn_check(f"fsdp rank M={m} K={k} C={c}", args)
        for g in worst:
            worst[g] = max(worst[g], errs[g])
        flops = 4 * m * k * c
        nbytes = (2 * (m * k + 2 * m * c + k * c + m * k) + 4 * 3 * c
                  + 4 * k * c)
        t_ops = 1e3 * flops / PEAK_OPS_S[dtype]
        t_bytes = 1e3 * nbytes / PEAK_BYTES_S
        lib, _ = _conv_bn_library_ms(n, h, w, args, 10)
        for key, val in (
                ("ms", cuda_ms(lambda: fcb._launch(*args), 10)),
                ("plain_ms", cuda_ms(
                    lambda: fcb.fused_bwd_reference(*args), 3)),
                ("library_ms", lib), ("ops_ms", t_ops), ("bytes_ms", t_bytes),
                ("bound_ms", max(t_ops, t_bytes))):
            tot[key] += calls * val
        calls_all += calls
        del args
    tot.update(bound_by="operations" if tot["ops_ms"] >= tot["bytes_ms"]
               else "bytes", max_abs_err=max(worst.values()),
               shape=f"ResNet-50 {batch} images a rank (fsdp=2 of 64) bf16: "
                     f"the {calls_all} calls of a rank's step over "
                     f"{len(shapes)} shapes, times summed")
    log(f"[fsdp] kernels at (e)'s {len(shapes)} fused conv+BN shapes "
        f"({batch} images a rank), bf16 on the tensor cores against the "
        f"plain version: worst max abs err {worst}; the {calls_all} calls "
        f"of a rank's step: kernel {tot['ms']:.3f} ms, plain "
        f"{tot['plain_ms']:.3f} ms, cuDNN conv+BN backward "
        f"{tot['library_ms']:.3f} ms, bound {tot['bound_ms']:.4f} ms "
        f"({tot['bound_by']}; {tot['bound_ms'] / tot['ms']:.3f} of it)")
    return tot


def _resnet_checks(tag: str, r: dict, law: dict | None) -> list:
    """An (e0)/(e) run's launches: the fused conv+BN kernel 36 times a
    step (conv1, conv3 and the downsample of every Bottleneck, in the
    backward), nothing else, every launch on the tensor cores; its
    collectives a step equal to ``law``; finite losses and eval loss."""
    bad = []
    per = sum(resnet_conv_bn_shapes().values())
    want_step = {k: int(k == "fused_conv_bn_bwd") * per
                 for k in launch_counts()}
    for i, st in enumerate(r["steps"]):
        if st["launches"] != want_step:
            bad.append(f"step {i + 1} launches {st['launches']}, want "
                       f"{want_step}")
        if law is not None:
            got = {k: (st["calls"][k], st["bytes"][k]) for k in law}
            if got != law:
                bad.append(f"step {i + 1} collectives {got}, want the law "
                           f"{law}")
    want = {k: v * FSDP_STEPS for k, v in want_step.items()}
    if r["launches"] != want:
        bad.append(f"run launches {r['launches']}, want {want}")
    if r["routes"]["conv_bn"] != {"tensor_core": per * FSDP_STEPS,
                                  "cuda_core": 0}:
        bad.append(f"fused conv+BN routes {r['routes']['conv_bn']}, want "
                   f"every launch on the tensor cores")
    if (len(r["losses"]) != FSDP_STEPS
            or not all(math.isfinite(x) for x in r["losses"])
            or not math.isfinite(r["eval_loss"] or float("nan"))):
        bad.append(f"losses {r['losses']}, eval {r['eval_loss']}")
    return [f"{tag} rank {r['rank']}: {b}" for b in bad]


def _stats_parity(stats: dict, ref: dict) -> tuple:
    """The running statistics after step 1 against the one-process f32
    step's: each tensor within BF16_NOISE_FACTOR x the one-process bf16
    step's own distance from it, or SEQ_PARITY_RTOL of its norm.  Returns
    (problems, the worst ratio to the limit and its name)."""
    bad, worst, where = [], 0.0, ""
    want, noise = ref["float32"]["stats"], ref["bfloat16"]["stats"]
    if set(stats) != set(want):
        return [f"running statistics of {sorted(set(stats) ^ set(want))} on "
                f"one side only"], (float("inf"), "")
    for n in sorted(want):
        got = _rel(stats[n], want[n])
        limit = max(BF16_NOISE_FACTOR * _rel(noise[n], want[n]),
                    SEQ_PARITY_RTOL)
        if got / limit > worst:
            worst, where = got / limit, n
        if not got <= limit:
            bad.append(f"step 1 running statistic {n}: {got:.2e} from the "
                       f"one-process f32 step (limit {limit:.2e})")
    return bad, (worst, where)


def phase_fsdp(beside=None) -> dict:
    """fsdp's sharded state and BERT's tensor parallelism
    (``parallel/fsdp.py``, ``models/bert.py``, the batch and fsdp groups
    of ``parallel/mesh.py``), and the image models under fsdp
    (``models/resnet.py``'s BatchNorms over the batch group, the fused
    conv+BN op at a rank's rows, ``parallel/pspec.py``): the flash kernels
    and the fused conv+BN kernel at a rank's shapes, then glue_bert (a)
    as one process, (b) on fsdp=2, (c) on fsdp=2 x model=2, lm_long (d0)
    as one process, (d) on fsdp=2, and imagenet_resnet50 (e0) as one
    process, (e) on TPUFRAME_SPEC's fsdp=2 through ``train.main`` (the
    constants' comment).  Held: step 1 of (b), (c), (d), (e) against the
    one-process f32 and bf16 steps on their global batch (loss, gradient
    norm, every parameter's gradient, the ranks' blocks put together; for
    (e) the running statistics too); replicated leaves bit-identical
    across ranks (step-1 gradients, (e)'s running statistics and final
    values); each rank's parameters and moments the blocks of
    ``fsdp.state_shardings``; the sharded-state collectives of every step
    equal to :func:`_fsdp_law`; every flash launch on the tensor cores,
    the count a rank the path's, on 12 heads or (c)'s 6; (e0)'s and (e)'s
    36 fused conv+BN launches a step on the tensor cores; (e)'s run log
    naming its spec.  Prints each run's step p50 and p10-p90, peak memory
    and state bytes a rank and rank 0's idle share from one profiled
    step.  ``beside``: a function run beside the worlds (:func:`pp_worlds`
    in a whole run); its Future is returned under ``"beside"``."""
    gc.collect()
    torch.cuda.empty_cache()
    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(19)
    for line in _fsdp_kernel_checks(gen):
        log(f"[fsdp] kernels at {line}")
    conv_bn = _fsdp_conv_bn_checks(gen)
    problems, runs, parity = [], {}, {}
    keys = ("loss", "grad_norm")
    models = {f: _fsdp_model_cfg(f) for f in ("bert", "lm")}
    layers = {f: c.num_layers for f, c in models.items()}
    one = (("a", "bert"), ("d0", "lm"), ("e0", "resnet"))
    # BERT's attention follows TPUFRAME_ATTN_IMPL; the LM's config names
    # pallas itself
    with _attn_impl("pallas"):
        ref = {f: _fsdp_reference(f) for f in ("bert", "lm", "resnet")}
        for which, family in one:
            run, _ = _sharded_run(FSDP_TAGS[which],
                                  _fsdp_args(family, FSDP_ONE[family]), 0,
                                  profile=True, tries=PROFILE_TRIES,
                                  steps=FSDP_STEPS, keys=keys)
            runs[which] = [run]
        one_s = time.monotonic() - t0
        root = tempfile.mkdtemp(prefix="tpuframe_fsdp_")
        try:
            # the worlds at once, for the time limit (their step times
            # are read with the other worlds on the card and the host)
            def world(name, n, spec, env):
                out = os.path.join(root, f"fsdp_{name}.json")
                Path(out + ".runs.json").write_text(json.dumps(spec))
                LocalCluster(n, timeout=FSDP_TIMEOUT_S, extra_env={
                    "TPUFRAME_DIST_BACKEND": "gloo",
                    "TPUFRAME_ATTN_IMPL": "pallas", **env}).launch(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--fsdp-worker", out])

            with ThreadPoolExecutor(len(FSDP_WORLDS) + 1) as pool:
                worlds = [pool.submit(world, name, *item)
                          for name, item in FSDP_WORLDS.items()]
                if beside is not None:
                    beside = pool.submit(beside)
                for f in worlds:
                    f.result()
            for name, (n, spec, _) in FSDP_WORLDS.items():
                runs.update(json.loads(Path(os.path.join(
                    root, f"fsdp_{name}.json")).read_text()))
                for which, family, mesh in spec:
                    tag = FSDP_TAGS[which]
                    mesh = _fsdp_mesh(mesh)
                    blocks = [torch.load(os.path.join(
                        root, f"grads_{which}.{r}.pt")) for r in range(n)]
                    stats = [torch.load(os.path.join(
                        root, f"stats_{which}.{r}.pt")) for r in range(n)]
                    for name_, (idx, g) in blocks[0].items():
                        if idx is None and any(not torch.equal(
                                g, b[name_][1]) for b in blocks[1:]):
                            problems.append(f"{tag}: step-1 gradient of "
                                            f"replicated {name_} differs "
                                            f"across ranks")
                    for name_, t in stats[0].items():
                        if any(not torch.equal(t, st[name_])
                               for st in stats[1:]):
                            problems.append(f"{tag}: step-1 running "
                                            f"statistic {name_} differs "
                                            f"across ranks")
                    place, law = _fsdp_law(family, mesh)
                    for r in runs[which]:
                        if family == "resnet":
                            problems += _resnet_checks(tag, r, law)
                            if r.get("pspec") != [[FSDP_RESNET_SPEC,
                                                   "env"]]:
                                problems.append(
                                    f"{tag} rank {r['rank']}: run log's "
                                    f"pspec events {r.get('pspec')}, want "
                                    f"one naming {FSDP_RESNET_SPEC} (env)")
                        else:
                            heads = (models[family].num_heads
                                     // mesh.get("model", 1))
                            problems += _run_checks(
                                tag, r, heads, law, steps=FSDP_STEPS,
                                layers=layers[family],
                                fwd_per_step=2 if family == "lm" else 1,
                                eval_batches=FSDP_EVAL_BATCHES)
                        problems += [f"{tag} rank {r['rank']}: {b}"
                                     for b in _fsdp_blocks(r, place)]
                    r0 = runs[which][0]
                    for r in runs[which][1:]:
                        if r["replicated"] != r0["replicated"]:
                            diff = [k for k in r0["replicated"]
                                    if r0["replicated"][k]
                                    != r["replicated"].get(k)]
                            problems.append(f"{tag}: final replicated "
                                            f"leaves differ across ranks: "
                                            f"{diff[:6]}")
                        if r["step1"] != r0["step1"]:
                            problems.append(f"{tag}: ranks report other "
                                            f"step-1 metrics {r0['step1']}, "
                                            f"{r['step1']}")
                    bad, parity[which] = _fsdp_parity(
                        family, r0["step1"], _whole(blocks), ref[family])
                    problems += [f"{tag}: {p}" for p in bad]
                    if family == "resnet":
                        bad, parity[which + "_stats"] = _stats_parity(
                            stats[0], ref[family])
                        problems += [f"{tag}: {p}" for p in bad]
                    runs[which + "_law"] = law
                    del blocks, stats
        finally:
            shutil.rmtree(root, ignore_errors=True)
    world_s = time.monotonic() - t0 - one_s
    for which, family in one:
        if family == "resnet":
            problems += _resnet_checks(FSDP_TAGS[which], runs[which][0],
                                       None)
            continue
        problems += _run_checks(FSDP_TAGS[which], runs[which][0],
                                models[family].num_heads, None,
                                steps=FSDP_STEPS, layers=layers[family],
                                fwd_per_step=2 if family == "lm" else 1,
                                eval_batches=FSDP_EVAL_BATCHES)
    for family, what in (("bert", "glue_bert (BERT-base, dropout 0, batch "
                                  "32, S=128)"),
                         ("lm", f"lm_long (S={FSDP_LM_DATA['seq_len']}, "
                                f"batch {FSDP_LM_BATCH})"),
                         ("resnet", f"imagenet_resnet50 (bn=fused, batch "
                                    f"{FSDP_RESNET_CUTS['global_batch']})")):
        f32, b16 = ref[family]["float32"], ref[family]["bfloat16"]
        log(f"[fsdp] {what} one-process step 1 on the sharded runs' global "
            f"batch: f32 loss {f32['loss']:.6f} grad norm "
            f"{f32['grad_norm']:.6f} ({f32['s']:.1f} s), bf16 loss "
            f"{b16['loss']:.6f} grad norm {b16['grad_norm']:.6f}")
    total = {k: 0 for k in launch_counts()}
    bases = {"a": "a", "b": "a", "c": "a", "d0": "d0", "d": "d0",
             "e0": "e0", "e": "e0"}
    for which, base_of in bases.items():
        base = runs[base_of][0]
        for r in runs[which]:
            log(_moe_line(FSDP_TAGS[which], r, card, prefix="[fsdp]")
                + f"; state {r['state_bytes'] / base['state_bytes']:.3f} x "
                  f"and peak memory "
                  f"{r['peak_bytes'] / base['peak_bytes']:.3f} x one "
                  f"process's"
                + ("" if which == base_of else
                   "; times contended: the other worlds ran at once"))
            for k in total:
                total[k] += r["launches"][k]
        if which in parity:
            ratio, where = parity[which]
            s1 = runs[which][0]["step1"]
            stats = ("" if which + "_stats" not in parity else
                     "; running statistics: worst {:.2f} x their limit "
                     "({})".format(*parity[which + "_stats"]))
            log(f"[fsdp] {FSDP_TAGS[which]} step 1: loss {s1['loss']:.6f} "
                f"grad norm {s1['grad_norm']:.6f}; per-parameter gradients "
                f"against the one-process f32 step: worst {ratio:.2f} x the "
                f"bf16 step's own distance ({where}; limit "
                f"{BF16_NOISE_FACTOR}){stats}; law a step "
                f"{runs[which + '_law']}")
    log(f"[fsdp] kernel checks, references and the one-process runs "
        f"{one_s:.1f} s, the worlds {world_s:.1f} s; {card}")
    if problems:
        raise RuntimeError("fsdp: " + "; ".join(problems[:12]))
    return {"launches": total, "beside": beside, "conv_bn_rank": conv_bn}


def _pp_sets(mesh: dict) -> dict:
    """Phase pp's overrides of lm_long on ``mesh``."""
    kw = dict(get_config("lm_long").model_kwargs, seq_mode="none")
    return {"model": "transformer-lm-pp", "model_kwargs": kw,
            "shard_seq": False, "mesh": mesh, "dataset_kwargs": PP_DATA,
            "global_batch": PP_BATCH, "pp_microbatches": PP_MICRO,
            "total_steps": PP_STEPS, "eval_every": PP_STEPS,
            "eval_batches": PP_EVAL_BATCHES, "log_every": 1}


def _pp_args(mesh: dict) -> list:
    return ["--config", "lm_long"] + [
        a for k, v in _pp_sets(mesh).items()
        for a in ("--set", f"{k}={v!r}")]


def _pp_reference() -> dict:
    """Step 1 of phase pp's config as one process in f32 on the runs'
    global batch (the first loader batch, which every rank of (a) and (b)
    takes): loss, gradient norm and each parameter's gradient on the
    host, the noise floor's yardstick."""
    cfg = get_config("lm_long").with_overrides(
        **_pp_sets(PP_WORLDS["a"])).with_overrides(compute_dtype="float32")
    t0 = time.monotonic()
    h = train_lib.build_harness(cfg, device="cuda")
    m = h.train_step(h.state, next(iter(h.train_loader)))
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "grads": _grads(h.state.model), "s": time.monotonic() - t0}
    del h, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _pp_law(hidden: int, vocab: int) -> dict:
    """The pipe group's traffic of one training step of (b), by verb,
    ``{stage: {verb: (calls, bytes the stage sends)}}``
    (``collectives.PIPE_CALLS``/``PIPE_BYTES``).  Each of the M + S - 2
    ticks that hand on a value rotates once in the forward and once in
    the backward; stage s < S - 1 sends its M outputs forward, stage s >
    0 its M input cotangents back, a microbatch ``[B / M, S, H]`` in bf16
    each (the blocks' output dtype).  Stage 0 broadcasts the embedding's
    f32 gradient, the last stage the final LayerNorm's and the head's;
    the last stage hands on the step's loss and accuracy (two f32); the
    gradient norm sums one f32 over the stages."""
    stages = PP_WORLDS["b"]["pipe"]
    micro = PP_BATCH // PP_MICRO * PP_DATA["seq_len"] * hidden * 2
    table = vocab * hidden * 4
    law = {}
    for s in range(stages):
        law[s] = {
            "pipe_rotate": (2 * (PP_MICRO + stages - 2),
                            PP_MICRO * micro * ((s < stages - 1) + (s > 0))),
            "pipe_broadcast": (3, table if s == 0 else 0 if s < stages - 1
                               else table + hidden * 4),
            "last_stage_value": (1, 8 if s == stages - 1 else 0),
            "pipe_all_reduce": (1, 4)}
    return law


def pp_worker(out: str) -> None:
    """A rank of one of phase pp's worlds (``<out>.which`` names it): (a)
    the f32 reference step, then the one-process run; (b) the pipe=2
    run.  Each rank saves step 1's gradient blocks beside ``out``
    (``grads_<which>.<rank>.pt``, and ``ref.pt`` in (a)); rank 0 writes
    every rank's results to ``out``."""
    which = Path(out + ".which").read_text().strip()
    bootstrap.initialize(device="cuda")
    rank = collectives.world()[1]
    root = Path(out).parent
    if which == "a":
        torch.save(_pp_reference(), root / "ref.pt")
    run, grads = _sharded_run(PP_TAGS[which], _pp_args(PP_WORLDS[which]),
                              rank, profile=True, steps=PP_STEPS,
                              keys=("loss", "grad_norm"))
    torch.save(grads, root / f"grads_{which}.{rank}.pt")
    runs = bootstrap.allgather_object(run)
    del grads
    if rank == 0:
        Path(out).write_text(json.dumps(runs))
    bootstrap.shutdown()


def pp_worlds() -> dict:
    """Phase pp's two worlds at once, each ``chip_smoke.py --pp-worker``
    processes through ``LocalCluster`` with gloo; returns ``{"root":
    the directory of their files, "a": (a)'s results, "b": (b)'s}`` (the
    caller removes the directory), or raises the first world's error."""
    root = tempfile.mkdtemp(prefix="tpuframe_pp_")

    def world(which):
        out = os.path.join(root, f"{which}.json")
        Path(out + ".which").write_text(which)
        n = int(np.prod(list(PP_WORLDS[which].values())))
        LocalCluster(n, timeout=PP_TIMEOUT_S, extra_env={
            "TPUFRAME_DIST_BACKEND": "gloo"}).launch(
            [sys.executable, str(Path(__file__).resolve()), "--pp-worker",
             out])

    t0 = time.monotonic()
    try:
        with ThreadPoolExecutor(len(PP_WORLDS)) as pool:
            for f in [pool.submit(world, w) for w in PP_WORLDS]:
                f.result()
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    out = {"root": root, "s": time.monotonic() - t0}
    for which in PP_WORLDS:
        out[which] = json.loads(Path(root, f"{which}.json").read_text())
    return out


def _pp_kernel_checks(gen) -> tuple:
    """The flash kernels at a microbatch's attention, [B / M, S, N, D] =
    [2, 4096, 12, 64] bf16 causal, against their plain versions; then each
    kernel's time (CUDA events over 20 launches) beside its bound, its
    plain version (a batch row at a time) and SDPA's forward or whole
    backward on the same tensors (the delta pass: ``rowsum(dO * O)`` by
    :func:`_delta_library_ms`).  Bounds: 4, 6
    and 8 x D x the causal pairs in FLOPs for the forward, dq and dk/dv
    (their matmuls), or the bytes each reads once and writes once,
    whichever takes longer; the delta pass by :func:`_delta_bytes`.
    Returns the log line and ``{kernel: {"ms", "plain_ms", "library_ms",
    "bound_ms", "bound_by", "max_abs_err", "shape"}}``."""
    b, s, n = PP_BATCH // PP_MICRO, PP_DATA["seq_len"], _pp_cfg().num_heads
    d, dtype = 64, torch.bfloat16
    name = "lm_long pipe microbatch"
    q, k, v, mask = _flash_inputs(b, s, n, d, dtype, False, gen)
    _, _, err, err_lse = _flash_check(name, q, k, v, mask, True)
    args = _bwd_inputs(b, s, n, d, dtype, False, True, gen)
    errs, route = _bwd_check(name, args, True)
    tensors = args[:6]
    q, k, v, do, lse, delta = tensors
    pairs = _pairs(s, s, b, n, None, True)
    io, rows = q.numel() * q.element_size(), lse.numel() * 4
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    sdpa_bwd, _ = _sdpa_backward_ms(tensors, True)
    delta_lib, _ = _delta_library_ms(q, k, v, do, None, True, 20)

    def plain(fn, ins):
        return lambda: _by_row(fn, ins, None, True)

    # kernel: (launch, FLOPs, bytes, plain version, library ms, error)
    cases = {
        "flash_fwd": (lambda: fa._launch(q, k, v, None, True), 4 * d * pairs,
                      4 * io + rows, plain(fa.flash_mha_reference, (q, k, v)),
                      sdpa, err),
        "flash_bwd_delta": (lambda: fa._launch_bwd(
            "delta", q, k, v, do, lse, None, None, True), 0,
            _delta_bytes(do), plain(fa.flash_bwd_delta_reference,
                                    tensors[:5]), delta_lib, errs["delta"]),
        "flash_bwd_dq": (lambda: fa._launch_bwd(
            "dq", *tensors, None, True), 6 * d * pairs, 5 * io + 2 * rows,
            plain(fa.flash_bwd_dq_reference, tensors), sdpa_bwd, errs["dq"]),
        "flash_bwd_dkv": (lambda: fa._launch_bwd(
            "dkv", *tensors, None, True), 8 * d * pairs, 6 * io + 2 * rows,
            plain(fa.flash_bwd_dkv_reference, tensors), sdpa_bwd,
            max(errs["dk"], errs["dv"]))}
    out, times = {}, []
    for kernel, (fn, flops, nbytes, ref, lib, e) in cases.items():
        t_ops, t_bytes = flops / PEAK_OPS_S[dtype], nbytes / PEAK_BYTES_S
        r = out[kernel] = {
            "ms": cuda_ms(fn, 20), "plain_ms": cuda_ms(ref, 1),
            "library_ms": lib, "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "max_abs_err": e, "shape": f"B={b} S={s} N={n} D={d} bf16 causal"}
        times.append(f"{kernel} {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
                     f"ms, {r['bound_by']}; plain {r['plain_ms']:.2f} ms; "
                     f"library {'none' if lib is None else f'{lib:.4f} ms'})")
    line = (f"{name} [{b}, {s}, {n}, {d}]: forward err {err:.2e} (lse "
            f"{err_lse:.2e}), backward {route} "
            + ", ".join(f"{g} {x:.2e}" for g, x in errs.items())
            + "; " + ", ".join(times) + f"; sdpa forward {sdpa:.4f} ms, "
            f"its whole backward {sdpa_bwd:.4f} ms")
    return line, out


def _pp_cfg() -> LMConfig:
    """Phase pp's model."""
    return LMConfig(**_pp_sets(PP_WORLDS["a"])["model_kwargs"])


def _pp_checks(tag: str, r: dict, law: dict | None) -> list:
    """A run's flash launches a step and in all (:func:`_run_checks`: a
    stage's layers once a microbatch, twice in the forward under remat;
    (a) runs all its layers on the whole batch at once) and its pipe
    traffic a step equal to ``law`` (none in (a))."""
    cfg = _pp_cfg()
    stages = r["sizes"].get("pipe", 1)
    layers = cfg.num_layers // stages * (PP_MICRO if stages > 1 else 1)
    bad = _run_checks(tag, r, cfg.num_heads, None, steps=PP_STEPS,
                      layers=layers, fwd_per_step=2,
                      eval_batches=PP_EVAL_BATCHES)
    stage = r["coords"]["pipe"]
    for i, st in enumerate(r["steps"]):
        got = {k: (st["pipe_calls"][k], st["pipe_bytes"][k])
               for k in st["pipe_calls"]}
        want = (law[stage] if law is not None
                else {k: (0, 0) for k in got})
        if got != want:
            bad.append(f"{tag} rank {r['rank']}: step {i + 1} pipe traffic "
                       f"{got}, want the law {want}")
    return bad


def pp_kernels() -> dict:
    """Phase pp's kernel checks (:func:`_pp_kernel_checks`), logged;
    returns ``{"kernels": the timed rows, "s": their seconds}``."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.monotonic()
    gen = torch.Generator(device="cuda").manual_seed(20)
    line, kernels = _pp_kernel_checks(gen)
    log(f"[pp] kernels at {line}; {_card_line()}")
    return {"kernels": kernels, "s": time.monotonic() - t0}


def phase_pp(done: Future | None = None,
             checked: dict | None = None) -> dict:
    """Pipeline parallelism (``parallel/pp.py``, ``parallel/pp_lm.py``,
    the pipe groups of ``parallel/mesh.py``): the flash kernels at a
    microbatch's shapes, then (a) and (b) (the constants' comment), run
    by :func:`pp_worlds` (or read from ``done``, its Future, when phase
    fsdp ran it beside its own worlds).  Held: step 1 of (b) against
    the one-process f32 step by the bf16 noise rule, with (a) the bf16
    yardstick (loss, gradient norm, every parameter's gradient, the
    stages' blocks put together); replicated leaves bit-identical across
    the stages (step-1 gradients and final values); each rank's
    parameters and moments its stage's layers; the pipe traffic of
    every step equal to :func:`_pp_law`; every flash launch on the tensor
    cores, the count a rank the path's.  Prints each run's step p50 and
    p10-p90, peak memory, state bytes a rank against (a)'s, and rank 0's
    idle share from one profiled step.  ``checked``: :func:`pp_kernels`'s
    result, when the whole run took it before other phases shared the
    card (None: the checks run here first)."""
    checked = pp_kernels() if checked is None else checked
    card = _card_line()
    done = pp_worlds() if done is None else done.result()
    t1 = time.monotonic()
    root = done["root"]
    problems = []
    try:
        ref = {"float32": torch.load(os.path.join(root, "ref.pt"))}
        a, b = done["a"][0], done["b"]
        ref["bfloat16"] = {
            "loss": a["step1"]["loss"], "grad_norm": a["step1"]["grad_norm"],
            "grads": {n: g for n, (_, g) in torch.load(
                os.path.join(root, "grads_a.0.pt")).items()}}
        blocks = [torch.load(os.path.join(root, f"grads_b.{r}.pt"))
                  for r in range(len(b))]
        for name, (idx, g) in blocks[0].items():
            if idx is None and any(not torch.equal(g, x[name][1])
                                   for x in blocks[1:]):
                problems.append(f"{PP_TAGS['b']}: step-1 gradient of "
                                f"replicated {name} differs across stages")
        bad, parity = _fsdp_parity("lm", b[0]["step1"], _whole(blocks), ref)
        problems += [f"{PP_TAGS['b']}: {p}" for p in bad]
        del blocks
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg = _pp_cfg()
    law = _pp_law(cfg.hidden_size, cfg.vocab_size)
    place = {n: (tuple(shape[0]), ("pipe",) + (None,) * (len(shape[0]) - 1)
                 if n.startswith("blocks.") else ())
             for n, shape in a["shapes"].items()}
    problems += _pp_checks(PP_TAGS["a"], a, None)
    for r in b:
        problems += _pp_checks(PP_TAGS["b"], r, law)
        problems += [f"{PP_TAGS['b']} rank {r['rank']}: {x}"
                     for x in _fsdp_blocks(r, place)]
    for r in b[1:]:
        if r["replicated"] != b[0]["replicated"]:
            diff = [k for k in b[0]["replicated"]
                    if b[0]["replicated"][k] != r["replicated"].get(k)]
            problems.append(f"{PP_TAGS['b']}: final replicated leaves "
                            f"differ across stages: {diff[:6]}")
        if r["step1"] != b[0]["step1"] or r["losses"] != b[0]["losses"]:
            problems.append(f"{PP_TAGS['b']}: stages report other metrics "
                            f"{b[0]['losses']}, {r['losses']}")
    f32 = ref["float32"]
    log(f"[pp] one-process f32 step 1 on the runs' global batch: loss "
        f"{f32['loss']:.6f} grad norm {f32['grad_norm']:.6f} "
        f"({f32['s']:.1f} s); (a) bf16 loss {a['step1']['loss']:.6f} grad "
        f"norm {a['step1']['grad_norm']:.6f}")
    for r in [a] + b:
        st = r["steps"][-1]
        log(_moe_line(PP_TAGS["a" if r is a else "b"], r, card,
                      prefix="[pp]")
            + f"; pipe traffic a step {st['pipe_calls']} calls, "
              f"{st['pipe_bytes']} bytes; state "
              f"{r['state_bytes'] / a['state_bytes']:.3f} x and peak memory "
              f"{r['peak_bytes'] / a['peak_bytes']:.3f} x (a)'s; times "
              f"contended: the other worlds ran at once")
    ratio, where = parity
    s1 = b[0]["step1"]
    log(f"[pp] {PP_TAGS['b']} step 1: loss {s1['loss']:.6f} grad norm "
        f"{s1['grad_norm']:.6f}; per-parameter gradients against the "
        f"one-process f32 step: worst {ratio:.2f} x the bf16 step's own "
        f"distance ({where}; limit {BF16_NOISE_FACTOR}); pipe law a step "
        f"{law}")
    log(f"[pp] the kernel checks {checked['s']:.1f} s, the worlds "
        f"{done['s']:.1f} s, the checks after them "
        f"{time.monotonic() - t1:.1f} s; {card}")
    if problems:
        raise RuntimeError("pp: " + "; ".join(problems[:12]))
    total = {k: 0 for k in launch_counts()}
    for r in [a] + b:
        for k in total:
            total[k] += r["launches"][k]
    return {"launches": total, "kernels": checked["kernels"]}


HVD_WORKERS = {"nccl": hvd_worker_nccl, "probe": hvd_worker_probe,
               "nccl_pair": hvd_worker_nccl_pair, "cifar": hvd_worker_cifar,
               "resnet2": hvd_worker_resnet2, "spmd": hvd_worker_spmd,
               "zero1": hvd_worker_zero1}


def wall_ms(fn, calls: int) -> float:
    fn()
    t = time.monotonic()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.monotonic() - t) / calls


def device_time(fn, calls: int = 1, tries: int = 1, agree=None):
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
    state it changes) may be taken again, ``tries`` times in all.
    ``agree``: where ``fn`` runs collectives, a function from this rank's
    verdict (True: whole) to all ranks' (True: every rank's record is
    whole), so that the ranks take a window again together or not at
    all."""
    for _ in range(tries - 1):
        kernels = _device_time(fn, calls, quiet=True)
        whole = kernels is not None
        if agree(whole) if agree is not None else whole:
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


def hvd_chain(out: str) -> None:
    """Phases hvd and zero1, one after the other, in a process of their
    own (``--hvd-chain OUT``; :func:`start_hvd_chain` starts it): phase
    12's losses and phase ckpt's ResNet noise are read from ``OUT.in``,
    each phase's launches and seconds written to ``OUT``.  A process,
    not a thread, so that its launch counts and random streams stay
    apart from the phases that run beside it."""
    given = json.loads(Path(out + ".in").read_text())
    walls = {}
    keep = tempfile.mkdtemp(prefix="tpuframe_keep_")
    try:
        t = time.monotonic()
        hvd_run = phase_hvd(given["resnet_losses"], given["resnet_noise"],
                            keep)
        walls["hvd"] = round(time.monotonic() - t, 1)
        t = time.monotonic()
        zero1_run = phase_zero1(hvd_run["resnet2"])
        walls["zero1"] = round(time.monotonic() - t, 1)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    Path(out).write_text(json.dumps({
        "walls": walls,
        "hvd": {k: hvd_run[k] for k in ("launches", "launches_2proc")},
        "zero1": {"launches": zero1_run["launches"]}}))


def start_hvd_chain(root: str, resnet_losses: list,
                    resnet_noise: float) -> tuple:
    """Start :func:`hvd_chain` in a session of its own, its output to a
    file under ``root``; returns ``(process, out)``."""
    out = os.path.join(root, "hvd_chain.json")
    Path(out + ".in").write_text(json.dumps(
        {"resnet_losses": resnet_losses, "resnet_noise": resnet_noise}))
    with open(out + ".log", "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--hvd-chain",
             out], stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)
    return proc, out


def end_hvd_chain(proc, out: str) -> dict:
    """Wait for the chain (HVD_CHAIN_TIMEOUT_S), print its output and
    return its results; raises with the end of its output if it failed.
    No process of its session outlives the call."""
    try:
        rc = proc.wait(timeout=HVD_CHAIN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = f"still running after {HVD_CHAIN_TIMEOUT_S} s"
    finally:
        stop_hvd_chain(proc)
    text = Path(out + ".log").read_text(errors="replace")
    sys.stdout.write(text)
    sys.stdout.flush()
    if rc != 0:
        raise RuntimeError(f"phases hvd and zero1 (their process: {rc}): "
                           f"{text[-3000:]}")
    return json.loads(Path(out).read_text())


def stop_hvd_chain(proc) -> None:
    """Kill the chain's session (its worlds too) if anything is left."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _leave(rc: int) -> None:
    """Exit with ``rc`` once the smoke's output is flushed, without the
    interpreter's teardown: every phase has waited for its processes and
    removed its files by then, and a library's thread can still abort
    the process in the teardown ("terminate called without an active
    exception", exit 134)."""
    if _DATA_SHARE is not None:
        shutil.rmtree(_DATA_SHARE, ignore_errors=True)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--train-worker"]:
        # ``--train-worker OUT [--] <train args>``: the launcher drops the
        # separators, so everything after OUT is the trainer's
        rest = [a for a in argv[2:] if a != "--"]
        return train_worker(argv[1], rest)
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
    ap.add_argument("--seq-worker", metavar="OUT",
                    help="run one rank of phase seq's world (the phase "
                         "starts these)")
    ap.add_argument("--moe-worker", metavar="OUT",
                    help="run one rank of phase moe's world (the phase "
                         "starts these)")
    ap.add_argument("--fsdp-worker", metavar="OUT",
                    help="run one rank of one of phase fsdp's worlds (the "
                         "phase starts these)")
    ap.add_argument("--pp-worker", metavar="OUT",
                    help="run one rank of one of phase pp's worlds (the "
                         "phase starts these)")
    ap.add_argument("--hvd-chain", metavar="OUT",
                    help="run phases hvd and zero1 in a process of their "
                         "own (the whole run starts this)")
    ap.add_argument("--train-worker", metavar="OUT",
                    help="run one attempt of phase supervise (its "
                         "supervisor starts these; the trainer's arguments "
                         "follow OUT)")
    args = ap.parse_args(argv)
    if args.hvd_worker is not None:
        name, out = args.hvd_worker
        HVD_WORKERS[name](out)
        return 0
    if args.replica_worker is not None:
        rank, out, ready = args.replica_worker
        return replica_worker(int(rank), out, ready)
    if args.seq_worker is not None:
        seq_worker(args.seq_worker)
        return 0
    if args.moe_worker is not None:
        moe_worker(args.moe_worker)
        return 0
    if args.fsdp_worker is not None:
        fsdp_worker(args.fsdp_worker)
        return 0
    if args.pp_worker is not None:
        pp_worker(args.pp_worker)
        return 0
    if args.hvd_chain is not None:
        hvd_chain(args.hvd_chain)
        return 0
    phase_card()
    t0 = time.monotonic()
    phase_build()
    global _DATA_SHARE
    _DATA_SHARE = tempfile.mkdtemp(prefix="tpuframe_data_")
    os.environ[DATA_SHARE_ENV] = _DATA_SHARE
    if args.phases is not None:
        for name in args.phases.split(","):
            PHASES[name]()
        log(f"[done] partial run in {time.monotonic() - t0:.1f} s")
        _leave(0)
    walls = {}

    def timed(name, fn, *a):
        t = time.monotonic()
        # on stderr too, whose end is what a cut run shows
        print(f"[chip_smoke] phase {name} from {t - t0:.1f} s",
              file=sys.stderr, flush=True)
        out = fn(*a)
        walls[name] = round(time.monotonic() - t, 1)
        return out

    cases = timed("kernels", phase_kernels)
    bwd = timed("backward", phase_backward)
    probe = timed("probe", phase_probe)
    timed("parity", phase_parity)
    serve_launches, serve_routes, serve_summary = timed("serve", phase_serve)
    fleet = timed("fleet", phase_fleet, serve_summary)
    rollout = timed("rollout", phase_rollout, serve_summary)
    timed("grad_parity", phase_grad_parity)
    timed("grad_parity_bf16", phase_grad_parity_bf16)
    train = timed("train", phase_train)
    conv_bn = timed("conv_bn", phase_conv_bn)
    timed("resnet_grad_parity", phase_resnet_grad_parity)
    resnet = timed("resnet_train", phase_resnet_train)
    bert_delta = timed("bert_parity", phase_bert_parity)
    bert_serve = timed("bert_serve", phase_bert_serve)
    bert_train = timed("bert_train", phase_bert_train)
    mnist = timed("mnist_train", phase_mnist_train)
    cifar = timed("cifar_train", phase_cifar_train)
    variants = timed("resnet_variants", phase_resnet_variants, resnet)
    ckpt_run = timed("ckpt", phase_ckpt, resnet["losses"])
    supervise = timed("supervise", phase_supervise,
                      ckpt_run["lm"]["straight"], train["mfu"])
    # For the time limit, phases hvd and zero1 run in a process of their
    # own beside phases moe, fsdp, pp and seq, and phase pp's worlds
    # beside phase fsdp's; phase pp's kernels are timed first, with the
    # card to themselves.
    pp_checked = timed("pp_kernels", pp_kernels)
    chain_root = tempfile.mkdtemp(prefix="tpuframe_chain_")
    t = time.monotonic()
    chain = start_hvd_chain(chain_root, resnet["losses"],
                            ckpt_run["resnet"]["noise"])
    try:
        moe_run = timed("moe", phase_moe)
        fsdp_run = timed("fsdp", phase_fsdp, pp_worlds)
        pp_run = timed("pp", phase_pp, fsdp_run["beside"], pp_checked)
        seq_run = timed("seq", phase_seq)
        side = timed("hvd_chain_wait", end_hvd_chain, *chain)
    finally:
        stop_hvd_chain(chain[0])
        shutil.rmtree(chain_root, ignore_errors=True)
    hvd_run, zero1_run = side["hvd"], side["zero1"]
    walls.update(side["walls"])
    walls["hvd_chain"] = round(time.monotonic() - t, 1)
    log(f"[done] phase wall s {walls}")

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
                      "supervise": supervise["launches"][name],
                      "hvd_resnet": hvd_run["launches"][name],
                      "hvd_resnet50_x2": hvd_run["launches_2proc"][name],
                      "zero1": zero1_run["launches"][name],
                      "seq": seq_run["launches"][name],
                      "moe": moe_run["launches"][name],
                      "fsdp": fsdp_run["launches"][name],
                      "pp": pp_run["launches"][name]}
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
        if row["name"].startswith("flash_"):
            row["pp_microbatch"] = pp_run["kernels"][row["name"]]
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
            row["fsdp_rank"] = fsdp_run["conv_bn_rank"]
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
    _leave(0)


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
          "supervise": phase_supervise, "hvd": phase_hvd,
          "zero1": phase_zero1, "seq": phase_seq, "moe": phase_moe,
          "fsdp": phase_fsdp, "pp": phase_pp}


if __name__ == "__main__":
    # Every way out goes through ``_leave``, the workers' too: a worker's
    # code is part of its phase's checks (an attempt of phase supervise
    # that is preempted must exit 14), and the teardown's abort would
    # turn it into -6.
    try:
        code = main()
    except SystemExit as exc:
        code = exc.code
        if code is not None and not isinstance(code, int):
            print(code, file=sys.stderr)
            code = 1
    except Exception as exc:
        # A failed check's message can end in a long tail of a child's
        # output; repeat its head as the last line of stderr, where the
        # end of a failed run's log shows it.
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(exc).__name__}: "
              f"{str(exc)[:2000]}", file=sys.stderr, flush=True)
        code = 1
    _leave(code or 0)
