"""Training harness (counterpart of ``tpuframe/train.py``): the MNIST,
CIFAR-10 and ImageNet image workloads, the LM and BERT/GLUE.

    python -m tpuframe_torch.train --config mnist_single
    python -m tpuframe_torch.train --config cifar10_resnet18 \\
        --set 'mesh={"data": 1}'
    python -m tpuframe_torch.train --config lm_long \\
        --set 'mesh={"data": 1, "seq": 1}' --set dataset_kwargs='{"seq_len": 4096}'
    python -m tpuframe_torch.train --config imagenet_resnet50 \\
        --set 'model_kwargs={"bn": "fused"}' --set 'mesh={"data": 1}' \\
        --set global_batch=256
    python -m tpuframe_torch.train --config glue_bert
    python -m tpuframe_torch.train --config mnist_single --device cpu \\
        --set total_steps=20

Config → model (random weights from ``seed``) → data → optimizer → the
replicated data-parallel step → a host loop that feeds batches, logs and
evaluates, printing the JAX harness's ``[tpuframe] ...``, ``[train N]`` and
``[eval N]`` lines.  It runs on the GPU unless ``--device cpu`` is given;
with no GPU visible it raises instead of falling back.  Several ranks come
from ``torch.distributed`` (initialise the default group before
:func:`main`, e.g. through ``torchrun``); the data degree of the config's
mesh must equal the world size.  A config with ``distributed=False``
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
and Matthews correlation at eval) train here.  What the JAX harness has
and the port does not yet refuses loudly, naming its ROADMAP.md item:
the observability plane (the trainer's run events, TensorBoard, traces,
the metrics exporter: item 11), pipeline, fsdp, tensor and expert
parallelism, ZeRO-1, quantized or hierarchical collectives, bucketed
fusion, adasum, sequence parallelism (a seq degree above 1) and elastic
resizing.

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
import math
import os
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
from tpuframe_torch.ops import fused_xent as fx
from tpuframe_torch.parallel import collectives
from tpuframe_torch.parallel import step as step_lib
from tpuframe_torch.resilience import faults
from tpuframe_torch.resilience.preempt import RC_PREEMPTED, PreemptionGuard
from tpuframe_torch.utils.config import TrainConfig, get_config
from tpuframe_torch.utils.optim import build_optimizer

ITEM_11 = "ROADMAP.md queue 1, item 11 (run plumbing: obs, the launcher)"
ITEM_12 = "ROADMAP.md queue 1, item 12 (beyond-DP parallelism)"

# Environment knobs of the JAX harness that select what the port lacks,
# with the value that means "off".
_UNPORTED_ENV = {
    "TPUFRAME_SPEC": (None, f"declarative parallelism specs, {ITEM_12}"),
    "TPUFRAME_WEIGHT_UPDATE": ("replicated", f"ZeRO-1, {ITEM_12}"),
    "TPUFRAME_WIRE_FORMAT": ("fp", f"quantized collectives, {ITEM_12}"),
    "TPUFRAME_WIRE_FORMAT_DCN": ("fp", f"quantized collectives, {ITEM_12}"),
    "TPUFRAME_HIER": ("flat", f"hierarchical collectives, {ITEM_12}"),
    "TPUFRAME_FUSION_THRESHOLD": (None, f"bucketed fusion, {ITEM_12}"),
    "TPUFRAME_EVENTS_DIR": (None, f"the trainer's run events (run_start, "
                                  f"step, run_end need the goodput meter),"
                                  f" {ITEM_11}"),
    "TPUFRAME_TB_DIR": (None, f"TensorBoard, {ITEM_11}"),
    "TPUFRAME_TRACE_STEPS": (None, f"profiler traces, {ITEM_11}"),
    "TPUFRAME_METRICS_PORT": (None, f"the metrics exporter, {ITEM_11}"),
    "TPUFRAME_ELASTIC": (None, "elastic resizing, ROADMAP.md queue 1, "
                               "item 14"),
}


def _refuse_unported(cfg: TrainConfig, world: int) -> dict:
    """Raise ``NotImplementedError`` for anything the port cannot run;
    returns the mesh degrees on ``world`` ranks."""
    for var, (off, what) in _UNPORTED_ENV.items():
        val = os.environ.get(var, "").strip()
        if val and val != off:
            raise NotImplementedError(f"{var}={val!r}: {what} is not "
                                      f"ported yet")
    if cfg.tb_dir is not None:
        raise NotImplementedError(f"TensorBoard logging is not ported yet "
                                  f"({ITEM_11})")
    if cfg.grad_reduce != "mean":
        raise NotImplementedError(f"grad_reduce={cfg.grad_reduce!r} is not "
                                  f"ported yet (ROADMAP.md queue 1, item 6)")
    datasets.check(cfg.dataset)
    sizes = cfg.mesh.sizes(world)
    if sizes["pipe"] > 1 or cfg.model == "transformer-lm-pp":
        raise NotImplementedError(f"pipeline parallelism is not ported yet "
                                  f"({ITEM_12})")
    for axis in ("fsdp", "model", "expert", "slices"):
        if sizes[axis] > 1:
            raise NotImplementedError(f"mesh {axis}={sizes[axis]}: sharded "
                                      f"state and multi-slice meshes are not"
                                      f" ported yet ({ITEM_12})")
    if sizes["seq"] > 1:
        raise NotImplementedError(
            f"mesh seq={sizes['seq']}: sequence parallelism is not ported "
            f"yet ({ITEM_12}); run with a seq degree of 1, e.g. --set "
            f"'mesh={{\"data\": {world}, \"seq\": 1}}'")
    return sizes


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
    manager: ckpt_lib.CheckpointManager | None = None
    start_step: int = 0


def _group(cfg: TrainConfig):
    """The data-parallel group of the step's reductions: None (no
    collective) for a config that is not ``distributed``."""
    return collectives.group() if cfg.distributed else None


def _lm_reduce(cfg: TrainConfig):
    """The group of the global valid-token mean (``losses.masked_mean``).
    Gradient accumulation differentiates a local loss per microbatch, and
    a per-rank valid-token mean would be biased by unequal padding, so
    that pairing is refused, as in the JAX harness."""
    if cfg.accum_steps > 1:
        if cfg.distributed and cfg.dataset_kwargs.get("padded_docs"):
            raise ValueError(
                "padded_docs with accum_steps>1: that path needs a local "
                "loss, and a per-rank valid-token mean would be biased by "
                "unequal padding across ranks")
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


def make_loss_fn(cfg: TrainConfig):
    """``loss_fn(model, batch, seed) -> (loss, {"accuracy"})``.

    LM: next-token cross-entropy over valid tokens (labels -100 ignored),
    through the fused chunked head when ``cfg.fused_xent``; ``seed``
    seeds dropout.  Images: ``cfg.augment`` on the device from a generator
    seeded with ``seed``, normalisation, the training forward (BN batch
    statistics, running statistics updated; the ConvNet's dropout masks
    from the same generator, after the augmentation's draws) and
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
    reduce = _lm_reduce(cfg)

    def loss_fn(model, batch, dropout_seed):
        ids, labels = batch["input_ids"], batch["labels"]
        if cfg.fused_xent:
            hidden = model(ids, train=True, hidden_only=True,
                           dropout_seed=dropout_seed)
            loss, acc = fx.mean_xent_and_accuracy(
                hidden, model.lm_head.weight.T, labels, ignore_index=-100,
                reduce=reduce)
        else:
            logits = model(ids, train=True, dropout_seed=dropout_seed)
            loss = losses.softmax_cross_entropy(logits, labels,
                                                ignore_index=-100,
                                                reduce=reduce)
            acc = losses.accuracy(logits.detach(), labels,
                                  ignore_index=-100, reduce=reduce)
        return loss, {"accuracy": acc.detach()}

    return loss_fn


def make_metric_fn(cfg: TrainConfig):
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
        reduce = _group(cfg)
        if cfg.fused_xent:
            hidden = model(ids, hidden_only=True)
            loss, acc = fx.mean_xent_and_accuracy(
                hidden, model.lm_head.weight.T, labels, ignore_index=-100,
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


def build_harness(cfg: TrainConfig, device="cuda") -> Harness:
    world, rank = collectives.world() if cfg.distributed else (1, 0)
    _refuse_unported(cfg, world)
    dev = _device.resolve(device)
    # f32 means f32: PyTorch runs cuDNN's f32 convolutions as TF32 unless
    # told otherwise
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = models.get_model(cfg.model, dtype=cfg.compute_dtype, device=dev,
                             seed=cfg.seed, **cfg.model_kwargs)
    if cfg.distributed:
        step_lib.broadcast_parameters(model)
    train_ds, eval_ds = datasets.build(cfg.dataset, cfg.data_dir,
                                       **cfg.dataset_kwargs)
    _check_labels(cfg, (("train", train_ds), ("eval", eval_ds)))
    # Float inputs are cast to the compute dtype on the host, as the JAX
    # loader does.
    cast = (None if cfg.compute_dtype == "float32"
            else getattr(torch, cfg.compute_dtype))
    train_loader = ShardedLoader(train_ds, cfg.global_batch, device=dev,
                                 seed=cfg.seed, cast_floats=cast,
                                 world=world, rank=rank)
    eval_loader = ShardedLoader(eval_ds, cfg.global_batch, device=dev,
                                shuffle=False, cast_floats=cast, world=world,
                                rank=rank)
    state = step_lib.TrainState(model=model,
                                opt=build_optimizer(cfg, model),
                                seed=cfg.seed + 1)
    manager = _resume(cfg, state)
    return Harness(
        cfg=cfg, device=dev, state=state, manager=manager,
        start_step=state.step,
        train_step=step_lib.make_train_step(make_loss_fn(cfg),
                                            accum_steps=cfg.accum_steps,
                                            grad_reduce=cfg.grad_reduce,
                                            distributed=cfg.distributed),
        eval_step=step_lib.make_eval_step(make_metric_fn(cfg),
                                          distributed=cfg.distributed),
        train_loader=train_loader, eval_loader=eval_loader, world=world)


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
            if collectives.world()[1] == 0:
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


def _log(prefix: str, step: int, metrics: dict) -> None:
    body = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in metrics.items())
    print(f"[{prefix} {step}] {body}", flush=True)


def train(cfg: TrainConfig, *, device="cuda") -> dict:
    """Run the workload; returns the final metrics, plus ``losses`` and
    ``step_ms`` (each step's loss and host wall time, synchronised by
    reading the loss) of the steps this call ran.  Raises
    ``SystemExit(14)`` when preempted (see the module docstring)."""
    # installed before the harness, so a signal during the build or the
    # restore is caught too
    guard = PreemptionGuard().install()
    try:
        return _train(cfg, device, guard)
    finally:
        guard.uninstall()


def _train(cfg: TrainConfig, device, guard: PreemptionGuard) -> dict:
    # in-process callers train repeatedly under different environments
    faults.reset_from_env()
    h = build_harness(cfg, device)
    primary = collectives.world()[1] == 0
    if primary:
        n_params = sum(p.numel() for p in h.state.model.parameters())
        print(f"[tpuframe] {cfg.name}: model={cfg.model} "
              f"params={n_params / 1e6:.2f}M devices={h.world} "
              f"global_batch={cfg.global_batch} steps={cfg.total_steps}",
              flush=True)
    # once=1 faults are dropped on a resumed run
    faults.set_resumed(h.start_step > 0)
    data_iter = h.train_loader.from_step(h.state.step)
    final: dict = {}
    step_ms, step_losses, window = [], [], []
    while h.state.step < cfg.total_steps:
        batch = next(data_iter)
        t0 = time.perf_counter()
        metrics = h.train_step(h.state, batch)
        loss = float(metrics["loss"])        # waits for the step
        dt = time.perf_counter() - t0
        step = h.state.step
        step_ms.append(1e3 * dt)
        step_losses.append(loss)
        window.append(dt)
        faults.set_step(step)
        faults.fire("host")                  # crash and signal faults
        if step % cfg.log_every == 0 or step == cfg.total_steps:
            final = {k: float(v) for k, v in metrics.items()}
            rate = cfg.global_batch * len(window) / sum(window)
            final["examples_per_sec"] = rate
            final["examples_per_sec_per_chip"] = rate / h.world
            window = []
            if primary:
                _log("train", step, final)
        if step % cfg.eval_every == 0 or step == cfg.total_steps:
            eval_metrics = evaluate(h, cfg.eval_batches)
            if primary:
                _log("eval", step, eval_metrics)
            final.update({f"eval_{k}": v for k, v in eval_metrics.items()})
            if (cfg.track_best and "loss" in eval_metrics
                    and h.manager.save_best(step, h.state.to_tree(),
                                            float(eval_metrics["loss"]))
                    and primary):
                print(f"[tpuframe] new best eval loss "
                      f"{eval_metrics['loss']:.4f} at step {step}",
                      flush=True)
        if h.manager is not None:
            h.manager.maybe_save(step, h.state.to_tree())
        if guard.requested:
            _exit_preempted(h, step, guard)
    if h.manager is not None:
        if h.state.step % cfg.ckpt_every != 0:
            h.manager.save(h.state.step, h.state.to_tree())   # final state
        h.manager.wait_pending()
    final["step"] = h.state.step
    final["losses"] = step_losses
    final["step_ms"] = step_ms
    if not all(math.isfinite(x) for x in step_losses):
        raise FloatingPointError(f"non-finite training loss: {step_losses}")
    return final


def _exit_preempted(h: Harness, step: int, guard: PreemptionGuard):
    """The preemption contract at a step boundary: save this step unless
    it was just saved, drain the async saves within
    ``TPUFRAME_FLUSH_DEADLINE_S`` (each commits or is quarantined), then
    exit with rc 14."""
    primary = collectives.world()[1] == 0
    if h.manager is not None:
        if not h.manager.should_save(step):
            h.manager.save(step, h.state.to_tree())
        flushed = h.manager.flush(deadline_s=float(os.environ.get(
            "TPUFRAME_FLUSH_DEADLINE_S", "60")))
        if not flushed and primary:
            print("[tpuframe] flush deadline expired — in-flight save "
                  "quarantined; resume uses the previous committed step",
                  flush=True)
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
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never chosen for you")
    args = p.parse_args(argv)
    cfg = get_config(args.config)
    overrides = _parse_set(args.set)
    if args.data_dir:
        overrides["data_dir"] = args.data_dir
    if args.ckpt_dir:
        overrides["ckpt_dir"] = args.ckpt_dir
    cfg = cfg.with_overrides(**overrides)
    t0 = time.time()
    metrics = train(cfg, device=args.device)
    if collectives.world()[1] == 0:
        shown = {k: round(v, 5) if isinstance(v, float) else v
                 for k, v in metrics.items()
                 if k not in ("losses", "step_ms")}
        print(f"[tpuframe] done in {time.time() - t0:.1f}s: {shown}",
              flush=True)
    return metrics


if __name__ == "__main__":
    main()
