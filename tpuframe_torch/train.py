"""Training harness (counterpart of ``tpuframe/train.py``): the MNIST,
CIFAR-10 and ImageNet image workloads, the LM and BERT/GLUE.

    python -m tpuframe_torch.train --config mnist_single
    python -m tpuframe_torch.train --config cifar10_resnet18 \\
        --set 'mesh={"data": 1}'
    python -m tpuframe_torch.train --config lm_long \\
        --set 'mesh={"data": 1, "seq": 1}' --set dataset_kwargs='{"seq_len": 4096}'
    TPUFRAME_DIST_BACKEND=gloo python -m tpuframe_torch.launch local \\
        --nprocs 4 -- python -m tpuframe_torch.train --config lm_long
    python -m tpuframe_torch.train --config imagenet_resnet50 \\
        --set 'model_kwargs={"bn": "fused"}' --set 'mesh={"data": 1}' \\
        --set global_batch=256
    python -m tpuframe_torch.train --config glue_bert
    TPUFRAME_DIST_BACKEND=gloo TPUFRAME_SPEC="dp=1,fsdp=2" \\
        python -m tpuframe_torch.launch local --nprocs 2 -- \\
        python -m tpuframe_torch.train --config imagenet_resnet50 \\
        --set 'model_kwargs={"bn": "fused"}' --set global_batch=64
    TPUFRAME_DIST_BACKEND=gloo python -m tpuframe_torch.launch local \\
        --nprocs 4 -- python -m tpuframe_torch.train --config glue_bert \\
        --set 'mesh={"data": 1, "fsdp": 2, "model": 2}'
    python -m tpuframe_torch.train --config mnist_single --device cpu \\
        --set total_steps=20

Config → model (random weights from ``seed``) → data → optimizer → the
replicated data-parallel step → a host loop that feeds batches, logs and
evaluates, printing the JAX harness's ``[tpuframe] ...``, ``[train N]`` and
``[eval N]`` lines (``--log-file`` appends them as JSONL, and
``TPUFRAME_TB_DIR`` or ``tb_dir`` writes them as TensorBoard scalars).
It runs on the GPU unless ``--device cpu`` is given; with no GPU visible
it raises instead of falling back.  Several ranks come
from the launcher's environment, as in the JAX harness
(``TPUFRAME_COORDINATOR``, ``TPUFRAME_NUM_PROCESSES``,
``TPUFRAME_PROCESS_ID``; ``TPUFRAME_DIST_BACKEND`` names the backend, by
default NCCL on the GPU and gloo on the CPU): the harness starts the world
itself (``parallel.bootstrap``), one process a card, or joins a default
group the caller made (torchrun).  ``launch.launcher.LocalCluster`` starts
N ranks of this command on one host.  The config's mesh degrees must
multiply to the world size.  A seq degree above 1 (``shard_seq`` configs,
an LM with ``seq_mode`` ring or ulysses) lays the ranks out as the JAX
mesh does (``parallel/mesh.py``: rank = data index x seq + seq index),
hands each rank's seq ring to the model's attention
(``TransformerLM.seq``, ``ops/seq_parallel.py``), hands each rank its data rows and its block of
the sequence, and keeps the loss's valid-token mean and the gradient mean
over the whole world, as the JAX step's ``('data', 'fsdp', 'seq')``
axes.  An fsdp, expert or model degree above 1 (the LM or BERT) is the
JAX harness's sharded-state mode: rank = row-major over data, fsdp, seq,
expert and model (``parallel/mesh.py``), each rank holds its blocks of
the parameters and their moments by the JAX placement
(``parallel/fsdp.py``: the tensor-parallel rules of ``parallel/tp.py``,
Megatron placement over model and the experts over expert, with the
fsdp axis on the largest dim they leave whole), the model gathers each
fsdp block before its use and reduce-scatters its gradient, runs the
collectives over its model and shard groups, and its MoE layers route
the global batch; the batch's rows split over data x fsdp, the loss's
mean and the metrics are averaged over the batch group (data x fsdp),
each gradient over the batch group or, split over fsdp, over the data
group after its reduce-scatter, dropout is seeded by the batch index,
the gradient norm counts every element once, the fusion knob is
ignored, as the JAX jit step ignores it, and ``accum_steps`` splits the
global batch's rows into microbatches, as the JAX jit step does; zero1,
the int8 wire, Adasum and a seq degree above 1 are refused there.  The
image models (``resnet*``, ``convnet``) take fsdp with a data degree, not
the model or expert axes (the JAX package has no tensor-parallel rules
for them): their BatchNorms take the batch group's statistics, as the
JAX jit step's global batch does, and their running statistics are then
the same on every rank and are not averaged.  A pipe degree
above 1 with ``model="transformer-lm-pp"`` is pipeline parallelism
(``parallel/pp_lm.py``): each stage holds its layers of the
layer-stacked blocks and their moments, the GPipe schedule runs
``pp_microbatches`` through the stages, the loss and the gradients are
averaged over the data group, the fusion knob is ignored, and what the
JAX harness refuses under pp is refused with its reason (another model,
the sharded-state axes, seq, ``accum_steps``, Adasum, ``shard_seq``,
zero1, the int8 wire, hier).  An MoE LM
(``moe_experts > 0``) adds ``moe_aux_weight`` times its layers' mean
load-balance loss and reports it as ``moe_aux``.  A config with ``distributed=False``
(``mnist_single``) trains on one device with no collective, even in a
process group, as the JAX harness's config-1 path does.  f32 means f32:
the harness turns TF32 off for cuDNN's convolutions and for matmuls.

The image workloads (``mnist``, ``cifar10`` and ``imagenet`` data; the
``convnet`` with dropout drawn from the step's generator, the ``resnet*``
with every ``bn``, ``stem`` and ``remat`` option; on-device augmentation
and uint8 normalisation, label smoothing, top-5 eval for ImageNet), the LM
workloads (``lm_text`` data, ``transformer-lm``) and the GLUE tasks
(``glue_sst2``, ``glue_mnli``, ``glue_stsb``, ``glue_cola`` data,
``bert-base``; cross-entropy, or MSE when ``num_classes`` is 1; Pearson
and Matthews correlation at eval) train here.  What the JAX harness has and
the port does not yet refuses loudly, naming its ROADMAP.md item: the
profiler server (item 11), named remat policies (item 14),
multi-slice meshes (a ``TPUFRAME_SPEC`` with ``;slices=N``), hierarchical
collectives and their DCN wire
(``TPUFRAME_HIER``, ``TPUFRAME_WIRE_FORMAT_DCN``) and elastic resizing.
``grad_reduce="adasum"`` reduces the gradients by Adasum.
``TPUFRAME_FUSION_THRESHOLD`` (bytes) reduces the mean in fusion buckets
whose collectives start during the backward (``parallel/fusion.py``);
Horovod's ``HOROVOD_FUSION_THRESHOLD`` is refused, as the JAX harness never
reads it.  ``TPUFRAME_WEIGHT_UPDATE=zero1`` shards the optimizer's update
and state over the data ranks (``parallel/zero1.py``; each rank holds
``[padded / n]`` of every moment; an element-wise optimizer only, no seq
degree above 1), and ``TPUFRAME_WIRE_FORMAT=int8-block`` sends the
gradients over the block-quantized wire (``parallel/quantwire.py``): an
env ask that the run cannot serve raises the step's own error, as in the
JAX harness.  ``TPUFRAME_CHECK_SPMD=1`` checks, before the first step,
that every rank built the same config and step program
(``obs/spmd_check.py``).  ``TPUFRAME_SPEC`` (``"dp=1,fsdp=2"``, the JAX
grammar, ``parallel/pspec.py``) declares the mesh and wins over the
config's, as in the JAX harness: the run prints the spec and the mesh it
lowers to and writes a ``pspec`` event.

Run telemetry, as in the JAX harness: with ``TPUFRAME_EVENTS_DIR`` (or
``--events-dir``) the run writes ``run_start`` (with the step's model
FLOPs, ``obs/flops.py``), ``step`` (and ``compile`` for the first),
``devmem`` every ``TPUFRAME_DEVMEM_INTERVAL_S`` (30 s) on a card and
``run_end`` with the goodput buckets (``obs/goodput.GoodputMeter``: init,
compile, productive, input, ckpt, eval, stall, other, summing to wall)
and MFU, keeps a flight recorder's ring beside the log
(``flight_<attempt>.json`` on a crash, a preemption or a stall abort), and
``TPUFRAME_TRACE_STEPS="<start>:<count>"`` (or ``--trace-dir``) traces a
window of steps with ``torch.profiler``.  ``TPUFRAME_TIMELINE`` writes the
loop's phases as a Chrome trace; ``TPUFRAME_METRICS_PORT`` and
``TPUFRAME_METRICS_TEXTFILE`` serve the goodput buckets, the step gauges
and the memory peaks as OpenMetrics, with ``/healthz`` following the
watchdog.  A caller that opened the event log, the flight recorder or the
exporter itself keeps them open across its in-process runs.

The stall watchdog of the JAX harness: after the first step, a run that
completes no step for ``TPUFRAME_STALL_TIMEOUT_S`` (300 s; polled every
``TPUFRAME_STALL_POLL_S``, 5 s) emits a ``stall`` event and, unless
``TPUFRAME_STALL_ABORT=0``, exits with rc 13 for a supervisor to restart
it, rather than waiting in a collective until the process group's
timeout, after writing its ``run_end`` and dumping its flight ring.
``TPUFRAME_HANG_STEP`` (with ``TPUFRAME_HANG_RANK``) hangs the loop after
that step, to drive it.  ``python -m tpuframe_torch.launch local
--relaunch N -- ...`` restarts such a run (see ``launch/launcher.py``).

Checkpoints and preemption, as in the JAX harness and on its on-disk
format (``tpuframe_torch.ckpt``): with ``--ckpt-dir DIR`` (or ``ckpt_dir``)
the run saves every ``ckpt_every`` steps (async with ``ckpt_async`` or
``TPUFRAME_ASYNC_CKPT=1``), keeps ``ckpt_keep``, keeps the best eval loss
under ``DIR/best`` with ``track_best``, always saves its final state, and
resumes from the newest readable checkpoint.  SIGTERM or SIGINT sets a
flag; at the next step boundary the run saves, drains its async saves
within ``TPUFRAME_FLUSH_DEADLINE_S`` and exits with rc 14 (``SystemExit``
when :func:`main` is called in process).  ``TPUFRAME_FAULTS`` injects
faults at named seams (``tpuframe_torch.resilience.faults``), e.g.
``host:step=3:kind=sigterm``.
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import hashlib
import itertools
import math
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpuframe_torch import _device
from tpuframe_torch import models
from tpuframe_torch import ckpt as ckpt_lib
from tpuframe_torch.data import augment as augment_lib
from tpuframe_torch.data import datasets
from tpuframe_torch.data.pipeline import ShardedLoader
from tpuframe_torch.models import losses
from tpuframe_torch.obs import devmem as devmem_lib
from tpuframe_torch.obs import events
from tpuframe_torch.obs import exporter as exporter_lib
from tpuframe_torch.obs import flight
from tpuframe_torch.obs import flops as obs_flops
from tpuframe_torch.obs import goodput
from tpuframe_torch.obs import spmd_check
from tpuframe_torch.obs import metrics as obs_metrics
from tpuframe_torch.obs.heartbeat import Heartbeat
from tpuframe_torch.obs.metrics import MetricLogger, RateMeter
from tpuframe_torch.obs.timeline import (StepTimeline, parse_trace_steps,
                                         profile_trace)
from tpuframe_torch.ops import fused_xent as fx
from tpuframe_torch.parallel import bootstrap
from tpuframe_torch.parallel import collectives
from tpuframe_torch.parallel import fsdp
from tpuframe_torch.parallel import fusion
from tpuframe_torch.parallel import hvd
from tpuframe_torch.parallel import mesh as mesh_lib
from tpuframe_torch.parallel import pp_lm
from tpuframe_torch.parallel import pspec as pspec_lib
from tpuframe_torch.parallel import quantwire
from tpuframe_torch.parallel import step as step_lib
from tpuframe_torch.parallel import tp
from tpuframe_torch.parallel import zero1
from tpuframe_torch.resilience import faults
from tpuframe_torch.resilience.preempt import RC_PREEMPTED, PreemptionGuard
from tpuframe_torch.utils.config import TrainConfig, get_config
from tpuframe_torch.utils.optim import build_optimizer

ITEM_11 = ("ROADMAP.md queue 1, item 11 (the profiler server, the GPU-VM "
           "launcher)")
ITEM_12 = bootstrap.ITEM_12
ITEM_14 = "ROADMAP.md queue 1, item 14 (elastic, mem, tune, analysis)"
RC_STALLED = 13

# Environment knobs of the JAX harness that select what the port lacks,
# with the value that means "off".
_UNPORTED_ENV = {
    "TPUFRAME_WIRE_FORMAT_DCN": ("fp", f"the DCN leg's wire of the "
                                       f"hierarchical collectives, "
                                       f"{ITEM_12}"),
    "TPUFRAME_HIER": ("flat", f"hierarchical collectives, {ITEM_12}"),
    "TPUFRAME_ELASTIC": (None, "elastic resizing, ROADMAP.md queue 1, "
                               "item 14"),
    # the JAX default "none" (tpuframe/mem/policy.py resolve); the legacy
    # alias acts only on "1" there, so "0" is its off value here
    "TPUFRAME_REMAT_POLICY": ("none", f"named remat policies, {ITEM_14}"),
    "TPUFRAME_BENCH_REMAT": ("0", f"named remat policies, {ITEM_14}"),
    # the JAX harness's on-demand profiler server, which PyTorch lacks
    "TPUFRAME_PROFILER_PORT": (None, f"the profiler server, {ITEM_11}"),
}


def _refuse_unported(cfg: TrainConfig, world: int) -> dict:
    """Raise ``NotImplementedError`` for anything the port cannot run;
    returns the mesh degrees on ``world`` ranks."""
    bootstrap.check_fusion_env()
    if cfg.mesh.slices > 1:
        # before the degrees: a spec's slices may not fit this world
        raise NotImplementedError(f"mesh slices={cfg.mesh.slices}: "
                                  f"multi-slice meshes are not ported yet "
                                  f"({ITEM_12})")
    sizes = cfg.mesh.sizes(world)
    if sizes["pipe"] > 1:
        _refuse_pp(cfg, sizes)
    for var, (off, what) in _UNPORTED_ENV.items():
        val = os.environ.get(var, "").strip()
        if val and val != off:
            raise NotImplementedError(f"{var}={val!r}: {what} is not "
                                      f"ported yet")
    datasets.check(cfg.dataset)
    if sizes["fsdp"] > 1 and sizes["seq"] > 1:
        raise NotImplementedError(
            f"mesh fsdp={sizes['fsdp']} x seq={sizes['seq']}: sequence "
            f"parallelism in fsdp's sharded state is not ported yet "
            f"({ITEM_12})")
    if any(sizes[a] > 1 for a in mesh_lib.STATE_AXES):
        _refuse_sharded(cfg, sizes)
    if sizes["seq"] > 1 and not cfg.shard_seq:
        raise ValueError(f"mesh seq={sizes['seq']} needs shard_seq=True: "
                         f"the batch's sequence dimension is what the seq "
                         f"ranks split")
    if sizes["seq"] > 1 and cfg.model_kwargs.get("seq_mode",
                                                 "none") == "none":
        raise ValueError(f"mesh seq={sizes['seq']} needs a model with "
                         f"seq_mode 'ring' or 'ulysses': seq_mode 'none' "
                         f"would attend within each rank's chunk only")
    return sizes


def _refuse_pp(cfg: TrainConfig, sizes: dict) -> None:
    """What the JAX harness refuses with a pipe degree above 1, with its
    messages (the pipeline step owns its microbatching, its reduction and
    its communication), and a run with no ranks."""
    if cfg.model != "transformer-lm-pp":
        raise ValueError(f"mesh pipe={sizes['pipe']} needs model="
                         f"'transformer-lm-pp' (layer-stacked blocks); got "
                         f"{cfg.model!r}")
    if any(sizes[a] > 1 for a in mesh_lib.STATE_AXES):
        raise ValueError("pipe parallelism does not compose with "
                         "fsdp/model/expert sharded-state axes yet")
    if cfg.accum_steps != 1:
        raise ValueError("pipe parallelism has its own microbatching "
                         "(pp_microbatches); accum_steps must be 1")
    if cfg.grad_reduce != "mean":
        raise ValueError("pipe parallelism supports grad_reduce='mean' "
                         "only (the pp step has its own cross-stage "
                         "reduction)")
    if cfg.shard_seq:
        raise ValueError("pipe parallelism does not compose with "
                         "shard_seq sequence parallelism yet")
    if not cfg.distributed:
        raise ValueError(f"mesh pipe={sizes['pipe']} with distributed="
                         f"False: the pipeline's stages are ranks")
    if zero1.resolve()[0] == "zero1":
        raise ValueError("TPUFRAME_WEIGHT_UPDATE=zero1 is the plain-DP "
                         "shard_map path; the pipeline step owns its "
                         "own stage-sharded update")
    if quantwire.resolve_legs()[0][0] != "fp":
        raise ValueError("TPUFRAME_WIRE_FORMAT=int8-block is the "
                         "plain-DP shard_map path; the pipeline step "
                         "owns its own cross-stage communication")
    if os.environ.get("TPUFRAME_HIER", "").strip() not in ("", "flat"):
        raise ValueError("TPUFRAME_HIER=hier is the plain-DP "
                         "shard_map path; the pipeline step owns its "
                         "own cross-stage communication")


def _refuse_sharded(cfg: TrainConfig, sizes: dict) -> None:
    """The sharded-state mode (an fsdp, expert or model degree above 1:
    the JAX trainer's auto-SPMD step) serves the LM and BERT on every
    such axis and the image models on fsdp, and refuses what the JAX
    harness refuses there."""
    shape = (f"mesh fsdp={sizes['fsdp']} x expert={sizes['expert']} x "
             f"model={sizes['model']}")
    image = cfg.model.startswith("resnet") or cfg.model == "convnet"
    if cfg.model not in ("transformer-lm", "bert-base") and not image:
        raise NotImplementedError(
            f"{shape}: model {cfg.model!r} in fsdp's sharded state is "
            f"not ported yet ({ITEM_12})")
    if image and (sizes["model"] > 1 or sizes["expert"] > 1):
        raise ValueError(f"{shape}: no tensor-parallel rules for model "
                         f"{cfg.model!r} (the JAX package has them for "
                         f"transformer-lm and bert-base)")
    if not cfg.distributed:
        raise ValueError(f"{shape} with distributed=False: the sharded "
                         f"state needs its ranks")
    if cfg.grad_reduce == "adasum":
        raise ValueError("grad_reduce='adasum' needs shard_map mode — "
                         "auto-SPMD has no per-replica grads to combine")
    if sizes["seq"] > 1:
        raise ValueError(f"{shape} with mesh seq={sizes['seq']}: the port "
                         f"runs sequence parallelism on the replicated "
                         f"(shard_map) path only; the JAX sharded-state "
                         f"step runs whole-sequence attention there")
    if image:
        return
    kw = dict(cfg.model_kwargs)
    tiny = kw.pop("tiny", False)
    # models.get_model's configs (BERT takes no ``tiny``)
    if cfg.model == "bert-base":
        model_cfg = models.BertConfig.base(**kw)
    else:
        model_cfg = (models.LMConfig.tiny if tiny else models.LMConfig)(**kw)
    tp.check_degrees(model_cfg, sizes)


@dataclass
class Harness:
    """Everything the loop needs, built once from a config."""

    cfg: TrainConfig
    device: torch.device
    state: step_lib.TrainState
    train_step: object
    eval_step: object
    train_loader: ShardedLoader
    eval_loader: ShardedLoader
    world: int
    layout: mesh_lib.Layout | None = None
    manager: ckpt_lib.CheckpointManager | None = None
    start_step: int = 0
    # the step's fusion threshold and its source (``_resolved_fusion``)
    fusion_threshold: tuple = (None, "default")
    # the parallelism spec the mesh came from and its source
    # (``pspec.resolve``): (None, "default") when the config's mesh stands
    pspec: tuple = (None, "default")
    # the weight update and the wire format with their sources
    # (``_resolved_update``)
    weight_update: tuple = ("replicated", "default")
    wire_format: tuple = ("fp", "default")


def _group(cfg: TrainConfig):
    """The data-parallel group of the step's reductions: None (no
    collective) for a config that is not ``distributed``."""
    return collectives.group() if cfg.distributed else None


def _resolved_fusion(cfg: TrainConfig) -> tuple:
    """The step's fusion threshold with its provenance, ``(bytes | None,
    "env" | "default")``: ``TPUFRAME_FUSION_THRESHOLD``, else None (one
    reduction a tensor).  The JAX harness's tuning-DB and quantized-wire
    legs have no counterpart (both are refused).  One resolution for
    :func:`build_harness` and :func:`_lm_reduce`, so that the bucketed
    step and its local loss cannot disagree about whether fusion is
    on."""
    model_tag = cfg.model.replace("-", "_")
    return fusion.resolve(program=f"train_{model_tag}_b{cfg.global_batch}",
                          family="fusion_threshold")


def _resolved_update(sizes: dict) -> tuple:
    """``((weight_update, source), (wire_format, source))`` of the step:
    the env knob, else the default.  The JAX harness demotes a tuning-DB
    pick that the run cannot serve; the port has no DB and its defaults
    (replicated, fp) serve every run, so only an env ask can be refused,
    with the step's specific error (no world, Adasum, int8 with a fusion
    threshold) or, for zero1 with a seq degree above 1, this one."""
    update = zero1.resolve()
    wire, _ = quantwire.resolve_legs()
    if any(sizes.get(a, 1) > 1 for a in mesh_lib.STATE_AXES):
        # the JAX make_train_step's refusals with state_shardings
        if update[0] == "zero1":
            raise ValueError(
                "weight_update='zero1' is the shard_map DP path; "
                "state_shardings (auto-SPMD ZeRO-3) already shards the "
                "update")
        if wire[0] != "fp":
            raise ValueError(
                f"wire_format={wire[0]!r} needs shard_map mode — auto-SPMD "
                f"programs have no explicit collectives to quantize")
    if update[0] == "zero1" and sizes["seq"] > 1:
        raise ValueError(
            f"{zero1.ENV_VAR}=zero1 with mesh seq={sizes['seq']}: the seq "
            f"ranks hold replicas of one data shard's update, and the "
            f"JAX package's zero1 layout and seq layout do not agree there "
            f"(ROADMAP.md queue 3); use a seq degree of 1")
    return update, wire


def _lm_reduce(cfg: TrainConfig, layout: mesh_lib.Layout | None = None):
    """The group of the global valid-token mean (``losses.masked_mean``):
    the world, which spans the data and seq ranks alike (the JAX
    ``_lm_reduce_axis``'s ``('data', 'fsdp', 'seq')``).  Gradient
    accumulation differentiates a local loss per microbatch, Adasum needs
    each rank's own gradients, and the fusion buckets reduce the gradients
    themselves (a collective inside the loss would run in the backward
    before the buckets), so all three take a local loss, as the JAX
    harness's explicit step modes do; a per-rank valid-token mean would be
    biased by unequal padding, so ``padded_docs`` is refused with them.
    In the sharded-state mode (``layout.sharded``) the group is the data
    group (the ranks with other rows), as the JAX jit step's global mean,
    which ignores the fusion knob: over the batch group."""
    if layout is not None and layout.sharded:
        return layout.batch_group
    if (cfg.accum_steps > 1 or cfg.grad_reduce == "adasum"
            or _resolved_fusion(cfg)[0] is not None):
        if cfg.distributed and cfg.dataset_kwargs.get("padded_docs"):
            raise ValueError(
                "padded_docs with TPUFRAME_FUSION_THRESHOLD, accum_steps>1 "
                "or grad_reduce='adasum': these paths need a local loss, and"
                " a per-rank valid-token mean would be biased by unequal "
                "padding across ranks")
        return None
    return _group(cfg)


def _is_lm_task(cfg: TrainConfig) -> bool:
    return cfg.dataset == "lm_text"


def _is_text_task(cfg: TrainConfig) -> bool:
    return cfg.dataset in ("glue_sst2", "glue_mnli", "glue_stsb",
                           "glue_cola")


def _is_regression_task(cfg: TrainConfig) -> bool:
    """HF's convention, as the JAX harness enforces it: one output is a
    regression (STS-B), trained with MSE on the squeezed logit."""
    return cfg.model_kwargs.get("num_classes") == 1


def _maybe_normalize(cfg: TrainConfig, x):
    """Normalise a uint8 image batch on the device (datasets built with
    ``keep_u8``): ``(x / 255 - mean) / std`` in f32, with the dataset's
    mean and std for real ImageNet or CIFAR-10 data and (0, 1) for
    synthetic data, which is quantised [0, 1] data.  Float batches pass
    through: they were normalised on the host."""
    if x.dtype != torch.uint8:
        return x
    mean, std = np.float32(0.0), np.float32(1.0)
    if cfg.data_dir is not None:
        mean, std = {
            "imagenet": (datasets.IMAGENET_MEAN, datasets.IMAGENET_STD),
            "cifar10": (datasets.CIFAR_MEAN, datasets.CIFAR_STD),
        }.get(cfg.dataset, (mean, std))
    mean = torch.as_tensor(mean, device=x.device)
    std = torch.as_tensor(std, device=x.device)
    return (x.float() / 255.0 - mean) / std


def _check_labels(cfg: TrainConfig, splits) -> None:
    """Labels beyond the head's range would train on a nonsense loss
    without an error: refuse them at build time, as the JAX harness
    does."""
    n_cls = cfg.model_kwargs.get("num_classes")
    if n_cls is None or n_cls <= 1 or _is_lm_task(cfg):
        return
    for name, ds in splits:
        labels = ds.columns.get("label")
        if (labels is not None and np.issubdtype(labels.dtype, np.integer)
                and len(labels) and int(labels.max()) >= n_cls):
            raise ValueError(
                f"{name} labels reach {int(labels.max())} but the model "
                f"head has num_classes={n_cls} — label range and head size "
                f"must match (check model_kwargs/dataset)")


def make_loss_fn(cfg: TrainConfig, layout: mesh_lib.Layout | None = None):
    """``loss_fn(model, batch, seed) -> (loss, {"accuracy"})``.

    LM: next-token cross-entropy over valid tokens (labels -100 ignored),
    through the fused chunked head when ``cfg.fused_xent``; ``seed``
    seeds dropout.  An MoE LM adds ``moe_aux_weight`` (``model_kwargs``,
    default 0.01) times the mean of its layers' load-balance losses and
    reports that mean as ``moe_aux``, as the JAX harness does.
    ``layout``: the rank's layout (the sharded-state mode's groups).
    Images: ``cfg.augment`` on the device from a generator seeded with
    ``seed``, normalisation, the training forward (BN batch statistics,
    running statistics updated; the ConvNet's dropout masks from the same
    generator, after the augmentation's draws) and
    cross-entropy with ``cfg.label_smoothing``.  GLUE: the training
    forward with dropout masks drawn from ``seed``, then cross-entropy and
    accuracy, or, for a regression (``num_classes`` 1), the MSE of the
    squeezed logit."""
    if _is_text_task(cfg):
        regression = _is_regression_task(cfg)

        def text_loss_fn(model, batch, dropout_seed):
            logits = model(batch["input_ids"], batch["attention_mask"],
                           batch["token_type_ids"], train=True,
                           dropout_seed=dropout_seed)
            if regression:
                loss = ((logits[..., 0] - batch["label"]) ** 2).mean()
                return loss, {"mse": loss.detach()}
            loss = losses.softmax_cross_entropy(logits, batch["label"])
            return loss, {"accuracy": losses.accuracy(logits.detach(),
                                                      batch["label"])}

        return text_loss_fn
    if not _is_lm_task(cfg):
        dropout = cfg.model == "convnet"

        def image_loss_fn(model, batch, seed):
            images = batch["image"]
            gen = torch.Generator(device=images.device)
            gen.manual_seed(seed)
            if cfg.augment != "none":
                images = augment_lib.apply(cfg.augment, images, gen,
                                           crop_size=cfg.augment_crop)
            kw = {"generator": gen} if dropout else {}
            logits = model(_maybe_normalize(cfg, images), train=True, **kw)
            loss = losses.softmax_cross_entropy(logits, batch["label"],
                                                cfg.label_smoothing)
            acc = losses.accuracy(logits.detach(), batch["label"])
            return loss, {"accuracy": acc}

        return image_loss_fn
    reduce = _lm_reduce(cfg, layout)
    aux_w = float(cfg.model_kwargs.get("moe_aux_weight", 0.01))

    def loss_fn(model, batch, dropout_seed):
        ids, labels = batch["input_ids"], batch["labels"]
        aux = []
        if cfg.fused_xent:
            hidden = model(ids, train=True, hidden_only=True,
                           dropout_seed=dropout_seed, aux_out=aux)
            loss, acc = fx.mean_xent_and_accuracy(
                hidden, model.head_weight().T, labels, ignore_index=-100,
                reduce=reduce)
        else:
            logits = model(ids, train=True, dropout_seed=dropout_seed,
                           aux_out=aux)
            loss = losses.softmax_cross_entropy(logits, labels,
                                                ignore_index=-100,
                                                reduce=reduce)
            acc = losses.accuracy(logits.detach(), labels,
                                  ignore_index=-100, reduce=reduce)
        metrics = {"accuracy": acc.detach()}
        if aux:
            # the MoE load-balance penalty (ops/moe.py)
            mean_aux = sum(aux) / len(aux)
            loss = loss + aux_w * mean_aux
            metrics["moe_aux"] = mean_aux.detach()
        return loss, metrics

    return loss_fn


def make_metric_fn(cfg: TrainConfig, layout: mesh_lib.Layout | None = None):
    """Eval metrics.  LM: loss, perplexity and token accuracy over valid
    tokens, global over the world.  Images: accuracy and cross-entropy
    (no smoothing) with running statistics, plus ``top5`` for ImageNet;
    ``crop_flip`` training pairs with a center crop here.  GLUE: accuracy
    and loss, or MSE for a regression, plus the per-batch means
    (``_m_*``) from which :func:`_finalize_eval` derives Pearson (STS-B)
    and the Matthews correlation (CoLA) over the whole pass."""
    if _is_text_task(cfg):
        regression = _is_regression_task(cfg)

        def text_metric_fn(model, batch):
            logits = model(batch["input_ids"], batch["attention_mask"],
                           batch["token_type_ids"])
            y = batch["label"]
            if regression:
                pred = logits[..., 0]
                mse = ((pred - y) ** 2).mean()
                # Moments as per-batch means: averaged over equal-size
                # batches they are the whole pass's.
                return {"loss": mse, "mse": mse, "_m_pred": pred.mean(),
                        "_m_y": y.mean(), "_m_pred2": (pred ** 2).mean(),
                        "_m_y2": (y ** 2).mean(),
                        "_m_py": (pred * y).mean()}
            out = {"accuracy": losses.accuracy(logits, y),
                   "loss": losses.softmax_cross_entropy(logits, y)}
            if cfg.dataset == "glue_cola":
                pred = logits.argmax(dim=-1)
                out.update(
                    _m_tp=((pred == 1) & (y == 1)).float().mean(),
                    _m_fp=((pred == 1) & (y == 0)).float().mean(),
                    _m_tn=((pred == 0) & (y == 0)).float().mean(),
                    _m_fn=((pred == 0) & (y == 1)).float().mean())
            return out

        return text_metric_fn
    if not _is_lm_task(cfg):
        def image_metric_fn(model, batch):
            images = batch["image"]
            if cfg.augment == "crop_flip" and cfg.augment_crop:
                images = augment_lib.center_crop(images, cfg.augment_crop)
            logits = model(_maybe_normalize(cfg, images))
            labels = batch["label"]
            out = {"accuracy": losses.accuracy(logits, labels),
                   "loss": losses.softmax_cross_entropy(logits, labels)}
            if cfg.dataset == "imagenet":
                out["top5"] = losses.topk_accuracy(logits, labels, 5)
            return out

        return image_metric_fn

    def metric_fn(model, batch):
        ids, labels = batch["input_ids"], batch["labels"]
        reduce = (layout.batch_group if layout is not None
                  and layout.sharded else _group(cfg))
        if cfg.fused_xent:
            hidden = model(ids, hidden_only=True)
            loss, acc = fx.mean_xent_and_accuracy(
                hidden, model.head_weight().T, labels, ignore_index=-100,
                reduce=reduce)
        else:
            logits = model(ids)
            loss = losses.softmax_cross_entropy(logits, labels,
                                                ignore_index=-100,
                                                reduce=reduce)
            acc = losses.accuracy(logits, labels, ignore_index=-100,
                                  reduce=reduce)
        return {"loss": loss, "perplexity": torch.exp(loss), "accuracy": acc}

    return metric_fn


def _resolved_spec(cfg: TrainConfig) -> tuple:
    """``(cfg, (canonical spec | None, source))``: a ``TPUFRAME_SPEC``
    declaration (``parallel/pspec.py``) wins over the config's mesh, as
    in the JAX harness, which prints it; a spec that does not parse
    raises.  The JAX harness's tuning-DB leg has no counterpart: env >
    config."""
    spec, source = pspec_lib.resolve()
    if spec is None:
        return cfg, (None, source)
    cfg = cfg.with_overrides(mesh=spec.mesh_spec())
    if bootstrap.is_primary():
        print(f"[tpuframe] parallelism spec '{spec.canonical()}' "
              f"({source}) -> mesh {cfg.mesh}", flush=True)
    return cfg, (spec.canonical(), source)


def build_harness(cfg: TrainConfig, device="cuda") -> Harness:
    """Everything a run needs from ``cfg`` (its mesh replaced by a
    ``TPUFRAME_SPEC`` declaration's, ``Harness.cfg``)."""
    bootstrap.initialize(device=device)
    cfg, spec = _resolved_spec(cfg)
    world, rank = collectives.world() if cfg.distributed else (1, 0)
    sizes = _refuse_unported(cfg, world)
    # every rank makes every seq ring's group, in the same order
    layout = mesh_lib.build(sizes, rank)
    dev = _device.resolve(device)
    # f32 means f32: PyTorch runs cuDNN's f32 convolutions as TF32 unless
    # told otherwise
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = models.get_model(cfg.model, dtype=cfg.compute_dtype, device=dev,
                             seed=cfg.seed, **cfg.model_kwargs)
    if layout.seq is not None:
        # _refuse_unported let a seq degree through for a seq_mode LM only
        model.seq = layout.seq
    if cfg.distributed:
        # parameters and buffers (BatchNorm statistics), as the reference
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    if layout.sharded:
        # fsdp, tensor and expert parallelism: each rank keeps its blocks
        # of the JAX placement
        tp_axes = sizes["model"] > 1 or sizes["expert"] > 1
        model.shard_specs = fsdp.shard_(
            model, layout,
            tp.rules_for_model(cfg.model) if tp_axes else None)
        model.layout = layout
    elif layout.pipe is not None:
        # pipeline parallelism: each stage keeps its layers
        pp_lm.shard_(model, layout)
    train_ds, eval_ds = datasets.build(cfg.dataset, cfg.data_dir,
                                       **cfg.dataset_kwargs)
    _check_labels(cfg, (("train", train_ds), ("eval", eval_ds)))
    # Float inputs are cast to the compute dtype on the host, as the JAX
    # loader does.
    cast = (None if cfg.compute_dtype == "float32"
            else getattr(torch, cfg.compute_dtype))
    # rows over the batch ranks (data x fsdp), sequence blocks over the
    # seq ranks
    shard = dict(world=layout.batch_size, rank=layout.batch_index,
                 seq=(layout.seq_size, layout.seq_index))
    train_loader = ShardedLoader(train_ds, cfg.global_batch, device=dev,
                                 seed=cfg.seed, cast_floats=cast, **shard)
    eval_loader = ShardedLoader(eval_ds, cfg.global_batch, device=dev,
                                shuffle=False, cast_floats=cast, **shard)
    update, wire = _resolved_update(sizes)
    if layout.pipe is not None:
        return _pp_harness(cfg, dev, model, layout, world, train_loader,
                           eval_loader, update, wire, spec)
    threshold, source = _resolved_fusion(cfg)
    # the sharded-state mode averages over the batch group (an fsdp-split
    # gradient over the data group), seeds dropout by batch index and
    # ignores the fusion knob, as the JAX jit step does (and splits the
    # global batch's rows into its microbatches)
    sharded = layout if layout.sharded else None
    # the step first: it refuses what the state could not serve
    train_step = step_lib.make_train_step(
        make_loss_fn(cfg, layout), accum_steps=cfg.accum_steps,
        grad_reduce=cfg.grad_reduce, distributed=cfg.distributed,
        fusion_threshold=None if layout.sharded else threshold,
        weight_update=update[0], wire_format=wire[0], layout=sharded)
    if update[0] == "zero1":
        # the moments born as this rank's chunks of the flat layout
        state = zero1.make_state(cfg, model, _group(cfg), seed=cfg.seed + 1)
    else:
        state = step_lib.TrainState(model=model,
                                    opt=build_optimizer(cfg, model),
                                    seed=cfg.seed + 1)
        if layout.sharded:
            specs = [model.shard_specs.get(n) for n in state.opt.names]
            state.opt.global_sq = lambda sq: tp.global_sq(sq, specs, layout)
    manager = _resume(cfg, state)
    return Harness(
        cfg=cfg, device=dev, state=state, manager=manager,
        start_step=state.step, fusion_threshold=(threshold, source),
        pspec=spec,
        weight_update=update, wire_format=wire, train_step=train_step,
        eval_step=step_lib.make_eval_step(
            make_metric_fn(cfg, layout), distributed=cfg.distributed,
            layout=sharded),
        train_loader=train_loader, eval_loader=eval_loader, world=world,
        layout=layout)


def _pp_harness(cfg: TrainConfig, dev, model, layout, world, train_loader,
                eval_loader, update, wire, spec) -> Harness:
    """The harness of a pipeline run (``parallel/pp_lm.py``): the stage's
    model, its optimizer with the cross-stage gradient norm, the pipeline
    train and eval steps.  The fusion knob is ignored, as the JAX
    pipeline step takes none."""
    kw = dict(n_micro=cfg.pp_microbatches, fused_xent=cfg.fused_xent)
    train_step = pp_lm.make_pp_lm_step(model.cfg, layout, **kw)
    state = step_lib.TrainState(model=model, opt=build_optimizer(cfg, model),
                                seed=cfg.seed + 1)
    specs = [model.shard_specs.get(n) for n in state.opt.names]
    state.opt.global_sq = lambda sq: pp_lm.global_sq(sq, specs, layout)
    manager = _resume(cfg, state)
    return Harness(
        cfg=cfg, device=dev, state=state, manager=manager,
        start_step=state.step, fusion_threshold=(None, "default"),
        pspec=spec,
        weight_update=update, wire_format=wire, train_step=train_step,
        eval_step=pp_lm.make_pp_lm_eval(model.cfg, layout, **kw),
        train_loader=train_loader, eval_loader=eval_loader, world=world,
        layout=layout)


def _resume(cfg: TrainConfig, state: step_lib.TrainState):
    """The checkpoint manager of ``cfg.ckpt_dir`` (None without one), after
    restoring ``state`` in place from the newest readable checkpoint when
    ``cfg.resume``.  ``TPUFRAME_ASYNC_CKPT`` overrides ``ckpt_async``."""
    if cfg.track_best and cfg.ckpt_dir is None:
        raise ValueError("track_best=True needs ckpt_dir (the best/ "
                         "checkpoint lives under it)")
    if cfg.ckpt_dir is None:
        return None
    async_env = os.environ.get("TPUFRAME_ASYNC_CKPT", "")
    ckpt_async = (async_env not in ("0", "false", "") if async_env
                  else cfg.ckpt_async)
    manager = ckpt_lib.CheckpointManager(
        cfg.ckpt_dir, every_steps=cfg.ckpt_every, keep=cfg.ckpt_keep,
        async_write=ckpt_async)
    if cfg.resume:
        resumed = manager.restore_latest(target=state.to_tree())
        if resumed is not None:
            state.load_tree(resumed[1])
            if bootstrap.is_primary():
                print(f"[tpuframe] resumed from step {state.step}",
                      flush=True)
    return manager


def evaluate(h: Harness, max_batches: int) -> dict:
    """Mean of the per-batch eval metrics over the first ``max_batches``
    batches of the (unshuffled) eval set, through :func:`_finalize_eval`."""
    agg, n = None, 0
    for i, batch in enumerate(h.eval_loader.epoch(0)):
        if i >= max_batches:
            break
        m = h.eval_step(h.state, batch)
        agg = m if agg is None else {k: agg[k] + m[k] for k in agg}
        n += 1
    if agg is None:
        return {}
    return _finalize_eval({k: float(v) / n for k, v in agg.items()})


def _finalize_eval(avg: dict) -> dict:
    """Set-level metrics from the averaged moments (keys ``_m_*``, dropped
    from the report): the Matthews correlation, omitted when its
    denominator is 0 (a class never predicted), and Pearson's r, omitted
    when either variance is 0."""
    if "_m_tp" in avg:
        tp, fp = avg["_m_tp"], avg["_m_fp"]
        tn, fn = avg["_m_tn"], avg["_m_fn"]
        denom = ((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) ** 0.5
        if denom > 0:
            avg["mcc"] = (tp * tn - fp * fn) / denom
    if "_m_py" in avg:
        var_p = avg["_m_pred2"] - avg["_m_pred"] ** 2
        var_y = avg["_m_y2"] - avg["_m_y"] ** 2
        cov = avg["_m_py"] - avg["_m_pred"] * avg["_m_y"]
        if var_p > 0 and var_y > 0:
            avg["pearson"] = cov / (var_p * var_y) ** 0.5
    return {k: v for k, v in avg.items() if not k.startswith("_m_")}


def _generation(device: torch.device) -> str:
    """The hardware ``run_start`` names, whose peaks MFU is held to:
    ``"h100"`` on an H100 (``goodput.PEAKS``), else the card's name or
    ``"cpu"``, which have no peaks and so get no MFU."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    if "H100" in name:
        return goodput.DEFAULT_GENERATION
    return name.lower().replace(" ", "_")


class _Telemetry:
    """One run's books and sinks: the goodput meter, the event log, the
    flight recorder, the metric logger, the rate meter, the step timeline,
    the exporter and the device-memory sampler.

    It closes only what it opened.  A caller that opened the event log
    (``events.init``), installed a flight recorder or started the exporter
    keeps them open across the runs it makes in process; the run removes
    its own collectors from such an exporter.  (The JAX harness reopens
    the log from ``TPUFRAME_EVENTS_DIR`` and closes whatever is open at
    its end.)"""

    def __init__(self):
        # everything before the first step (harness build, data, restore)
        # is the "init" bucket
        self.meter = goodput.GoodputMeter()
        self.owns_events = not events.enabled() and events.init() is not None
        self.owns_flight = (flight.get() is None
                            and flight.install() is not None)
        self.logger: MetricLogger | None = None
        self.rate = RateMeter()
        self.timeline: StepTimeline | None = None
        self.exporter = None
        self.owns_exporter = False
        self._collectors: list = []
        self.devmem: devmem_lib.DevmemSampler | None = None
        # facts the closures read, the watchdog's thread among them
        self.flops: float | None = None
        self.generation = goodput.DEFAULT_GENERATION
        self.world = 1
        self.step = 0

    def open_sinks(self, cfg: TrainConfig, log_file: str | None,
                   health) -> None:
        """The metric logger, the timeline and the exporter (after the
        harness, as in the JAX harness)."""
        self.logger = MetricLogger(
            log_file, tb_dir=cfg.tb_dir or os.environ.get("TPUFRAME_TB_DIR"))
        self.timeline = StepTimeline.from_env()
        self.owns_exporter = exporter_lib.get() is None
        self.exporter = exporter_lib.start_from_env(health=health)
        if self.exporter is None:
            return
        self._collectors = [self._goodput_samples, self._devmem_samples]
        for fn in self._collectors:
            self.exporter.add_collector(fn)

    def _goodput_samples(self):
        s = self.meter.summary()
        out = [("tpuframe_goodput_bucket_seconds", {"bucket": k}, v)
               for k, v in s["buckets"].items()]
        out.append(("tpuframe_wall_seconds", {}, s["wall_s"]))
        out.append(("tpuframe_steps_completed", {}, s["steps"]))
        return out

    def _devmem_samples(self):
        if self.devmem is None:
            return []
        peaks = self.devmem.peak_summary()
        out = []
        if peaks.get("peak_hbm_bytes") is not None:
            out.append(("tpuframe_hbm_peak_bytes", {},
                        peaks["peak_hbm_bytes"]))
        for did, b in (peaks.get("per_device") or {}).items():
            out.append(("tpuframe_hbm_device_peak_bytes",
                        {"device": did}, b))
        return out

    def emit_run_end(self, final_step: int) -> None:
        """Close the books: goodput buckets, both MFU flavours, the peak
        device memory and the counters, in one ``run_end`` record."""
        if not events.enabled():
            return
        summary = self.meter.summary()
        extra: dict = {}
        prod_steps = summary["productive_steps"]
        prod_s = summary["buckets"]["productive"]
        if self.flops and prod_steps and prod_s > 0:
            mfu = goodput.mfu(self.flops, prod_s / prod_steps,
                              generation=self.generation,
                              n_devices=self.world)
            if mfu is not None:
                extra["mfu_productive"] = round(mfu, 6)
                if summary["wall_s"] > 0:
                    extra["mfu_goodput"] = round(goodput.mfu(
                        self.flops * prod_steps, summary["wall_s"],
                        generation=self.generation,
                        n_devices=self.world), 6)
        if self.devmem is not None and self.devmem.active:
            self.devmem.sample_now()
            extra.update(self.devmem.peak_summary())
        events.emit("run_end", final_step=final_step,
                    wall_s=summary["wall_s"], goodput=summary,
                    counters=obs_metrics.counters(), **extra)

    def close(self) -> None:
        """Close what this run opened; idempotent."""
        if self.devmem is not None:
            self.devmem.stop()
        if self.timeline is not None:
            self.timeline.close()
            self.timeline = None
        if self.logger is not None:
            self.logger.close()
            self.logger = None
        if self.owns_events:
            events.close()
            self.owns_events = False
        if self.owns_flight:
            flight.uninstall()
            self.owns_flight = False
        if self.exporter is not None:
            if self.owns_exporter:
                exporter_lib.stop()    # its last textfile flush too
            else:
                for fn in self._collectors:
                    self.exporter.remove_collector(fn)
            self.exporter = None


def train(cfg: TrainConfig, *, device="cuda", trace_dir: str | None = None,
          log_file: str | None = None) -> dict:
    """Run the workload; returns the final metrics, plus ``losses`` and
    ``step_ms`` (each step's loss and host wall time, synchronised by
    reading the loss) of the steps this call ran.  Raises
    ``SystemExit(14)`` when preempted (see the module docstring).  An
    escaping exception first dumps the flight recorder's ring."""
    # installed before the harness, so a signal during the build or the
    # restore is caught too
    guard = PreemptionGuard().install()
    try:
        return _train(cfg, device, guard, trace_dir, log_file)
    finally:
        guard.uninstall()


def _train(cfg: TrainConfig, device, guard: PreemptionGuard,
           trace_dir: str | None, log_file: str | None) -> dict:
    # the log opens before the harness, so restore's events land in it
    tel = _Telemetry()
    try:
        # in-process callers train repeatedly under different environments
        faults.reset_from_env()
        h = build_harness(cfg, device)
        cfg = h.cfg             # the mesh a TPUFRAME_SPEC declared
        tel.world = h.world
        tel.generation = _generation(h.device)
        tel.step = h.start_step
        primary = bootstrap.is_primary()
        n_params = obs_flops.param_count(h.state.model)
        if primary:
            print(f"[tpuframe] {cfg.name}: model={cfg.model} "
                  f"params={n_params / 1e6:.2f}M devices={h.world} "
                  f"global_batch={cfg.global_batch} "
                  f"steps={cfg.total_steps}", flush=True)
        # once=1 faults are dropped on a resumed run
        faults.set_resumed(h.start_step > 0)
        # The legacy hang injection that drives the stall path: rank
        # TPUFRAME_HANG_RANK (every rank when unset) hangs after step
        # TPUFRAME_HANG_STEP.
        hang_step = int(os.environ.get("TPUFRAME_HANG_STEP", "0") or "0")
        hang_rank = int(os.environ.get("TPUFRAME_HANG_RANK", "-1") or "-1")
        if hang_rank >= 0 and bootstrap.process_index() != hang_rank:
            hang_step = 0
        if os.environ.get("TPUFRAME_CHECK_SPMD") == "1":
            _check_spmd(cfg, h)
        heartbeat = _stall_watchdog(tel)
        tel.open_sinks(cfg, log_file, health=lambda: not heartbeat.stalled)
        try:
            data_iter = _run_start(cfg, h, tel, n_params)
            return _loop(cfg, h, guard, heartbeat, hang_step, tel,
                         data_iter, trace_dir)
        except Exception:
            # A peer that stalls on this rank's step never beat the step
            # this rank last completed, so its watchdog fires up to one
            # beat interval before this one, and its abort closes the
            # collective under this rank.  A loop that fails within that
            # interval (plus one poll) of its own deadline reports the
            # stall, as its watchdog would have an interval later; an
            # earlier failure (a peer's crash) propagates at once.
            heartbeat.check(slack_s=heartbeat.last_interval_s
                            + heartbeat.poll_s)
            raise
        finally:
            heartbeat.stop()
    except SystemExit:
        raise               # preemption (rc 14) is not a crash
    except BaseException:
        flight.dump("exception")
        raise
    finally:
        tel.close()


def _check_spmd(cfg: TrainConfig, h: Harness) -> None:
    """Debug mode (``TPUFRAME_CHECK_SPMD=1``): every rank checks that it
    built the same config and the same step program before the first
    step's collectives (``obs/spmd_check.py``); a divergent rank raises on
    every rank."""
    spmd_check.assert_uniform_across_hosts("config", repr(cfg))
    metric = "mse" if (_is_text_task(cfg)
                       and _is_regression_task(cfg)) else "accuracy"
    spmd_check.check_step_program(
        h.state.model, "train_step", grad_reduce=cfg.grad_reduce,
        accum_steps=cfg.accum_steps,
        fusion_threshold=h.fusion_threshold[0],
        metric_names=(metric, "loss"), mesh=h.layout.sizes,
        seq_mode=cfg.model_kwargs.get("seq_mode", "none"),
        weight_update=h.weight_update[0], wire_format=h.wire_format[0],
        pp_microbatches=cfg.pp_microbatches)


def _run_start(cfg: TrainConfig, h: Harness, tel: _Telemetry,
               n_params: int):
    """The run's manifest (``run_start`` with the step's FLOP count, and
    the step program's provenance records), the device-memory sampler and
    the ``init`` charge; returns the data iterator, its first batch
    already taken for the count."""
    data_iter = h.train_loader.from_step(h.start_step)
    if events.enabled():
        first = None
        if h.start_step < cfg.total_steps:
            first = next(data_iter)
            data_iter = itertools.chain([first], data_iter)
        tel.flops, src = obs_flops.step_flops_or_fallback(
            cfg, h.state.model, first, seq_shards=h.layout.seq_size)
        sizes = cfg.mesh.sizes(h.world)
        # The JAX manifest's keys: jax_version, the tuning DB and the XLA
        # options are null here, beside the torch and CUDA versions.
        events.emit(
            "run_start", config=cfg.name,
            config_hash=hashlib.sha256(repr(cfg).encode()).hexdigest()[:16],
            jax_version=None, torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            devices=h.world, processes=bootstrap.process_count(),
            mesh=sizes, tune_db=None, xla_opts=None,
            start_step=h.start_step, total_steps=cfg.total_steps,
            global_batch=cfg.global_batch, n_params=n_params,
            generation=tel.generation, flops_per_step=tel.flops,
            flops_source=src, bytes_per_step=None)
        # What the step program runs with, in the JAX records' shape (the
        # remat policy, the DCN leg and hier have one value each: the
        # others refuse, items 12 and 14).  n_shards is the data-parallel
        # degree, whatever the mode, as the JAX record's mesh size.
        events.emit("remat_policy", policy="none", source="default",
                    predicted_bytes_per_step=None)
        events.emit("weight_update", mode=h.weight_update[0],
                    source=h.weight_update[1],
                    n_shards=h.layout.batch_size if cfg.distributed else 1)
        events.emit("wire_format", format=h.wire_format[0],
                    source=h.wire_format[1], format_dcn="fp",
                    source_dcn="default", hier="flat",
                    hier_source="default")
        events.emit("fusion_threshold", threshold=h.fusion_threshold[0],
                    source=h.fusion_threshold[1])
        if h.pspec[0] is not None:
            events.emit("pspec", spec=h.pspec[0], source=h.pspec[1])
        tel.devmem = devmem_lib.DevmemSampler(
            interval_s=float(os.environ.get("TPUFRAME_DEVMEM_INTERVAL_S",
                                            "30")),
            device=h.device).start()
    tel.meter.charge("init", tel.meter.wall_s())
    return data_iter


def _stall_watchdog(tel: _Telemetry) -> Heartbeat:
    """The heartbeat of the JAX harness: a peer that dies mid-collective,
    a wedged loader or hung I/O becomes a clean exit 13 (the supervisor
    restarts and the run resumes from its last checkpoint) instead of a
    wait until the process group's timeout.  It arms after the first
    completed step, which builds the kernels and tunes cuDNN and has no
    bound.  ``TPUFRAME_STALL_TIMEOUT_S`` (300), ``TPUFRAME_STALL_POLL_S``
    (5) and ``TPUFRAME_STALL_ABORT`` (1; 0 only logs the ``stall``
    event)."""
    timeout_s = float(os.environ.get("TPUFRAME_STALL_TIMEOUT_S", "300"))
    poll_s = float(os.environ.get("TPUFRAME_STALL_POLL_S", "5"))
    abort = os.environ.get("TPUFRAME_STALL_ABORT", "1") == "1"

    def _on_stall(idle: float) -> None:
        if not abort:
            return
        print(f"[tpuframe] STALL: no step completed in {idle:.0f}s — "
              f"aborting for clean restart + checkpoint resume "
              f"(exit {RC_STALLED})", file=sys.stderr, flush=True)
        try:
            # The heartbeat already emitted the stall event; the dying
            # attempt closes its own books so that the analyzer reads its
            # run_end.  The charge is capped at the unattributed rest: the
            # idle window can overlap a step that ended without a beat.
            tel.meter.charge("stall", min(idle, tel.meter.unaccounted_s()))
            tel.emit_run_end(tel.step)
            flight.dump("stall_abort")
            if tel.timeline is not None:
                tel.timeline.instant("stall_abort", idle_s=idle)
            # os._exit skips every finally: close the sinks here, shared
            # ones too (the process ends)
            tel.owns_events = tel.owns_exporter = True
            tel.close()
        finally:
            os._exit(RC_STALLED)

    return Heartbeat(timeout_s=timeout_s, poll_s=poll_s, on_stall=_on_stall,
                     arm_after_first_beat=True).start()


@contextlib.contextmanager
def _phase(tel: _Telemetry, name: str, on: bool = True, **args):
    """A timeline phase when the timeline is on (and ``on``)."""
    if tel.timeline is None or not on:
        yield
        return
    with tel.timeline.phase(name, **args):
        yield


def _loop(cfg: TrainConfig, h: Harness, guard: PreemptionGuard,
          heartbeat: Heartbeat, hang_step: int, tel: _Telemetry,
          data_iter, trace_dir: str | None) -> dict:
    primary = bootstrap.is_primary()
    meter, rate = tel.meter, tel.rate
    final: dict = {}
    step_ms, step_losses = [], []

    # The profiler's window, TPUFRAME_TRACE_STEPS="<start>:<count>"
    # (absolute steps); --trace-dir alone traces 3 steps from the 5th
    # after the start.  trace_start/trace_end carry the artifact's path.
    window = parse_trace_steps(os.environ.get("TPUFRAME_TRACE_STEPS"))
    if window is None and trace_dir is not None:
        window = (h.start_step + 5, 3)
    events_dir = os.environ.get(events.ENV_DIR, "").strip()
    trace_path = trace_dir or (os.path.join(events_dir, "trace")
                               if events_dir else "trace")
    tracer = None

    def _trace_end(at_step: int) -> None:
        nonlocal tracer
        if tracer is None:
            return
        try:
            tracer.__exit__(None, None, None)
        except Exception:  # noqa: BLE001 — profiling must not kill the run
            pass
        tracer = None
        events.emit("trace_end", step=at_step, path=trace_path)

    while h.state.step < cfg.total_steps:
        if (window is not None and tracer is None
                and h.state.step == window[0]):
            try:
                tracer = profile_trace(trace_path)
                tracer.__enter__()
            except Exception:  # noqa: BLE001 — no profiler: run untraced
                tracer, window = None, None
            else:
                events.emit("trace_start", step=h.state.step,
                            path=trace_path)
        if tracer is not None and h.state.step >= window[0] + window[1]:
            _trace_end(h.state.step)
            window = None                    # one window a run

        t_step0 = time.perf_counter()
        with _phase(tel, "data_wait", step=h.state.step):
            batch = next(data_iter)
        t_compute0 = time.perf_counter()
        with _phase(tel, "train_step", step=h.state.step):
            metrics = h.train_step(h.state, batch)
            loss = float(metrics["loss"])    # waits for the step
        t_end = time.perf_counter()
        step = h.state.step
        # the input wait is its own bucket; the loss read's sync is the
        # step's
        input_wait_s, dt = t_compute0 - t_step0, t_end - t_compute0
        first_step = meter.first_step_s is None
        meter.charge("input", input_wait_s)
        meter.step(dt)
        tel.step = step
        step_ms.append(1e3 * dt)
        step_losses.append(loss)
        is_log_step = step % cfg.log_every == 0 or step == cfg.total_steps
        # before the fault seam: a crash must not erase the step's record
        events.emit("step", step=step, wall_ms=round(dt * 1e3, 3),
                    input_wait_ms=round(input_wait_s * 1e3, 3),
                    examples=cfg.global_batch,
                    **({"loss": loss} if is_log_step else {}))
        if first_step:
            events.emit("compile", step=step, wall_ms=round(dt * 1e3, 3),
                        source="first_step")
        faults.set_step(step)
        faults.fire("host")                  # crash and signal faults
        if hang_step and step == hang_step:
            print(f"[tpuframe] FAULT INJECTION: hanging at step {step}",
                  flush=True)
            time.sleep(10 ** 6)
        rate.update(cfg.global_batch)
        heartbeat.beat(step)
        if is_log_step:
            final = {k: float(v) for k, v in metrics.items()}
            r = rate.rate()
            if r is not None:
                final["examples_per_sec"] = r
                final["examples_per_sec_per_chip"] = rate.per_chip(h.world)
            # retry activity: empty unless the storage layer retried
            final.update(obs_metrics.counters("retry."))
            tel.logger.log(step, final)
            if tel.exporter is not None:
                tel.exporter.set_gauge("tpuframe_step", step)
                tel.exporter.set_gauge("tpuframe_step_time_ms", dt * 1e3)
                tel.exporter.set_gauge("tpuframe_input_wait_ms",
                                       input_wait_s * 1e3)
                if r is not None:
                    tel.exporter.set_gauge("tpuframe_examples_per_sec", r)
                tel.exporter.flush()         # keep the textfile current
        if step % cfg.eval_every == 0 or step == cfg.total_steps:
            t_eval0 = time.perf_counter()
            with rate.paused(), _phase(tel, "eval", step=step):
                eval_metrics = evaluate(h, cfg.eval_batches)
            meter.charge("eval", time.perf_counter() - t_eval0)
            tel.logger.log(step, eval_metrics, prefix="eval")
            final.update({f"eval_{k}": v for k, v in eval_metrics.items()})
            if (cfg.track_best and "loss" in eval_metrics
                    and h.manager.save_best(step, h.state.to_tree(),
                                            float(eval_metrics["loss"]))
                    and primary):
                print(f"[tpuframe] new best eval loss "
                      f"{eval_metrics['loss']:.4f} at step {step}",
                      flush=True)
            heartbeat.beat(step)             # eval is progress
        if h.manager is not None:
            will_save = h.manager.should_save(step)
            t_ckpt0 = time.perf_counter()
            with rate.paused(), _phase(tel, "checkpoint", on=will_save,
                                       step=step):
                h.manager.maybe_save(step, h.state.to_tree())
            heartbeat.beat(step)             # so is a long blocking save
            if will_save:
                meter.charge("ckpt", time.perf_counter() - t_ckpt0)
        if guard.requested:
            _exit_preempted(h, step, guard, heartbeat, tel,
                            lambda: _trace_end(step))
    _trace_end(h.state.step)
    if h.manager is not None:
        t_ckpt0 = time.perf_counter()
        if h.state.step % cfg.ckpt_every != 0:
            h.manager.save(h.state.step, h.state.to_tree())   # final state
        h.manager.wait_pending()
        meter.charge("ckpt", time.perf_counter() - t_ckpt0)
    heartbeat.stop()
    if tel.timeline is not None and primary:
        print(f"[tpuframe] step timeline written to {tel.timeline.path}",
              flush=True)
    if tel.devmem is not None:
        tel.devmem.stop()
    tel.emit_run_end(h.state.step)
    tel.close()
    final["step"] = h.state.step
    final.update(obs_metrics.counters("retry."))
    final["losses"] = step_losses
    final["step_ms"] = step_ms
    if not all(math.isfinite(x) for x in step_losses):
        raise FloatingPointError(f"non-finite training loss: {step_losses}")
    return final


def _exit_preempted(h: Harness, step: int, guard: PreemptionGuard,
                    heartbeat: Heartbeat, tel: _Telemetry, trace_end):
    """The preemption contract at a step boundary: save this step unless
    it was just saved, drain the async saves within
    ``TPUFRAME_FLUSH_DEADLINE_S`` (each commits or is quarantined), close
    the books (``run_end``), then exit with rc 14."""
    primary = bootstrap.is_primary()
    if h.manager is not None:
        t_ckpt0 = time.perf_counter()
        if not h.manager.should_save(step):
            h.manager.save(step, h.state.to_tree())
        flushed = h.manager.flush(deadline_s=float(os.environ.get(
            "TPUFRAME_FLUSH_DEADLINE_S", "60")))
        if not flushed and primary:
            print("[tpuframe] flush deadline expired — in-flight save "
                  "quarantined; resume uses the previous committed step",
                  flush=True)
        tel.meter.charge("ckpt", time.perf_counter() - t_ckpt0)
    heartbeat.stop()
    trace_end()
    if tel.timeline is not None:
        tel.timeline.instant("preempted", step=step)
    if tel.devmem is not None:
        tel.devmem.stop()
    tel.emit_run_end(step)
    tel.close()
    guard.uninstall()
    if primary:
        print(f"[tpuframe] preempted ({guard.signal_name}): checkpoint "
              f"committed at step {step}; exiting rc {RC_PREEMPTED} for "
              f"supervisor resume", flush=True)
    raise SystemExit(RC_PREEMPTED)


def _parse_set(values: list[str]) -> dict:
    out: dict = {}
    for item in values:
        key, _, raw = item.partition("=")
        if not raw:
            raise ValueError(f"--set needs key=value, got {item!r}")
        try:
            out[key] = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            out[key] = raw
    return out


def main(argv: list[str] | None = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True,
                   help="workload name (tpuframe_torch.utils.config"
                        ".WORKLOADS)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any TrainConfig field")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--log-file", default=None,
                   help="append the metric lines as JSONL")
    p.add_argument("--trace-dir", default=None,
                   help="trace a few steps with torch.profiler")
    p.add_argument("--events-dir", default=None,
                   help="write structured run events "
                        "(events.<host>.jsonl; same as TPUFRAME_EVENTS_DIR)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never chosen for you")
    args = p.parse_args(argv)
    if args.events_dir:
        # through the environment, so that every layer sees the switch
        os.environ[events.ENV_DIR] = args.events_dir
    cfg = get_config(args.config)
    overrides = _parse_set(args.set)
    if args.data_dir:
        overrides["data_dir"] = args.data_dir
    if args.ckpt_dir:
        overrides["ckpt_dir"] = args.ckpt_dir
    cfg = cfg.with_overrides(**overrides)
    t0 = time.time()
    metrics = train(cfg, device=args.device, trace_dir=args.trace_dir,
                    log_file=args.log_file)
    if bootstrap.is_primary():
        shown = {k: round(v, 5) if isinstance(v, float) else v
                 for k, v in metrics.items()
                 if k not in ("losses", "step_ms")}
        print(f"[tpuframe] done in {time.time() - t0:.1f}s: {shown}",
              flush=True)
    return metrics


def _leave(rc: int) -> None:
    """Exit with ``rc`` once the output is flushed, without the
    interpreter's teardown.  By then the run has closed its sinks, drained
    its saves and stopped its threads; the teardown can still abort the
    process ("terminate called without an active exception", -6) when a
    library's thread is torn down mid-call, and a supervisor must see the
    preempted run's 14, not a crash."""
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(rc)


if __name__ == "__main__":
    try:
        main()
    except SystemExit as exc:          # preemption (rc 14), argparse
        if exc.code is not None and not isinstance(exc.code, int):
            raise
        _leave(exc.code or 0)
    bootstrap.shutdown()
    _leave(0)
