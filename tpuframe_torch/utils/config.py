"""Workload configs (counterpart of ``tpuframe/utils/config.py``).

The same ``TrainConfig`` fields, defaults and ``WORKLOADS`` names as the JAX
package, so a config and its ``--set`` overrides read the same in both.
``MeshSpec`` is a local copy of the JAX package's dataclass (its fields
only): the port's data-parallel world comes from ``torch.distributed``, and
the trainer holds the mesh's degrees against it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass(frozen=True)
class MeshSpec:
    """Logical parallelism degrees; -1 on one axis means "all remaining
    ranks" (``tpuframe.parallel.mesh.MeshSpec``'s fields)."""

    data: int = -1
    fsdp: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1
    model: int = 1
    slices: int = 1

    def sizes(self, n_ranks: int) -> dict[str, int]:
        """Each axis's degree on ``n_ranks`` ranks, the wildcard resolved;
        raises when the degrees do not multiply to ``n_ranks``."""
        sizes = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError("at most one mesh axis may be -1")
        fixed = 1
        for v in sizes.values():
            if v != -1:
                fixed *= v
        if wild:
            if n_ranks % fixed:
                raise ValueError(f"{n_ranks} ranks not divisible by fixed "
                                 f"axes product {fixed}")
            sizes[wild[0]] = n_ranks // fixed
        elif fixed != n_ranks:
            raise ValueError(f"mesh {sizes} needs {fixed} ranks, the world "
                             f"has {n_ranks}")
        return sizes


@dataclass(frozen=True)
class TrainConfig:
    name: str
    model: str                      # registry name (tpuframe_torch.models)
    model_kwargs: dict[str, Any] = field(default_factory=dict)
    dataset: str = "mnist"          # mnist | cifar10 | imagenet | glue_sst2
    dataset_kwargs: dict[str, Any] = field(default_factory=dict)
    data_dir: str | None = None     # local dir (gs:// is not ported)

    # distribution
    distributed: bool = True
    mesh: MeshSpec = field(default_factory=MeshSpec)
    shard_seq: bool = False         # shard batch seq dim over the seq axis

    # optimization
    optimizer: str = "sgd"          # sgd | adamw | lars (large-batch)
    base_lr: float = 0.1            # per-256-examples; scaled by global batch
    scale_lr_by_batch: bool = True  # the hvd.size() linear-scaling rule
    warmup_steps: int = 0
    schedule: str = "cosine"        # cosine | linear | constant
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip_norm: float | None = None
    label_smoothing: float = 0.0

    # loop
    global_batch: int = 64
    total_steps: int = 200
    # Gradient accumulation: microbatches per optimizer step; the per-rank
    # batch is split by this (the effective batch is unchanged).
    accum_steps: int = 1
    grad_reduce: str = "mean"       # mean | adasum
    pp_microbatches: int = 4
    eval_every: int = 100
    eval_batches: int = 8
    log_every: int = 10
    seed: int = 42

    augment: str = "none"
    augment_crop: int | None = None

    # precision
    compute_dtype: str = "float32"

    # LM loss path: chunked fused softmax-xent (tpuframe_torch.ops
    # .fused_xent): the [B, S, V] logits never exist whole.
    fused_xent: bool = False

    # observability
    tb_dir: str | None = None

    # checkpoint
    ckpt_dir: str | None = None
    ckpt_every: int = 500
    ckpt_keep: int = 3
    resume: bool = True
    ckpt_async: bool = False
    track_best: bool = False

    def with_overrides(self, **kv) -> "TrainConfig":
        known = {f.name for f in dataclasses.fields(self)}
        bad = set(kv) - known
        if bad:
            raise ValueError(f"unknown config fields {sorted(bad)}")
        if "mesh" in kv and isinstance(kv["mesh"], dict):
            kv["mesh"] = MeshSpec(**kv["mesh"])
        # Dict-valued fields merge instead of replace; a None value deletes
        # that key (the replace escape hatch).
        for field_name in ("model_kwargs", "dataset_kwargs"):
            if field_name in kv and isinstance(kv[field_name], dict):
                merged = dict(getattr(self, field_name))
                merged.update(kv[field_name])
                kv[field_name] = {k: v for k, v in merged.items()
                                  if v is not None}
        return dataclasses.replace(self, **kv)


def _mnist_single() -> TrainConfig:
    return TrainConfig(
        name="mnist_single", model="convnet", dataset="mnist",
        distributed=False, optimizer="sgd", base_lr=0.02,
        scale_lr_by_batch=False, schedule="constant", global_batch=64,
        total_steps=400, eval_every=200,
    )


def _cifar10_resnet18() -> TrainConfig:
    return TrainConfig(
        name="cifar10_resnet18", model="resnet18",
        model_kwargs={"num_classes": 10, "cifar_stem": True},
        dataset="cifar10", dataset_kwargs={"keep_u8": True},
        optimizer="sgd", base_lr=0.1, warmup_steps=200,
        schedule="cosine", weight_decay=5e-4, global_batch=256,
        total_steps=2000, eval_every=500,
        augment="pad_crop_flip",
    )


def _imagenet_resnet50() -> TrainConfig:
    return TrainConfig(
        name="imagenet_resnet50", model="resnet50",
        model_kwargs={"num_classes": 1000},
        dataset="imagenet", optimizer="sgd", base_lr=0.1, warmup_steps=1565,
        schedule="cosine", weight_decay=1e-4, label_smoothing=0.1,
        global_batch=2048, total_steps=56300, eval_every=2000,
        compute_dtype="bfloat16", ckpt_every=2000,
        augment="flip",
    )


def _glue_bert() -> TrainConfig:
    return TrainConfig(
        name="glue_bert", model="bert-base", dataset="glue_sst2",
        dataset_kwargs={"seq_len": 128}, optimizer="adamw", base_lr=2e-5,
        scale_lr_by_batch=False, warmup_steps=200, schedule="linear",
        weight_decay=0.01, grad_clip_norm=1.0, global_batch=32,
        total_steps=6000, eval_every=500, compute_dtype="bfloat16",
    )


def _glue_bert_mnli() -> TrainConfig:
    return _glue_bert().with_overrides(
        name="glue_bert_mnli", dataset="glue_mnli",
        model_kwargs={"num_classes": 3}, total_steps=36000, warmup_steps=1200,
    )


def _glue_bert_stsb() -> TrainConfig:
    return _glue_bert().with_overrides(
        name="glue_bert_stsb", dataset="glue_stsb",
        model_kwargs={"num_classes": 1}, total_steps=720, warmup_steps=72,
    )


def _glue_bert_cola() -> TrainConfig:
    return _glue_bert().with_overrides(
        name="glue_bert_cola", dataset="glue_cola", total_steps=800,
        warmup_steps=80,
    )


def _imagenet_resnet50_pod() -> TrainConfig:
    return _imagenet_resnet50().with_overrides(
        name="imagenet_resnet50_pod", global_batch=8192, warmup_steps=391,
        total_steps=14075,
    )


def _lm_long() -> TrainConfig:
    """Long-context causal LM (hidden 768, 12 layers, 12 heads, vocab
    32000, S=32768), ring-attention sequence parallelism over a data=2 x
    seq mesh in the JAX package."""
    return TrainConfig(
        name="lm_long", model="transformer-lm",
        model_kwargs={"seq_mode": "ring", "attn_impl": "pallas",
                      "remat": True,
                      "max_seq": 32768, "vocab_size": 32000},
        dataset="lm_text", dataset_kwargs={"seq_len": 32768},
        shard_seq=True, mesh=MeshSpec(data=2, seq=-1),
        optimizer="adamw", base_lr=3e-4, scale_lr_by_batch=False,
        warmup_steps=200, schedule="cosine", weight_decay=0.1,
        grad_clip_norm=1.0, global_batch=8, total_steps=5000,
        eval_every=500, compute_dtype="bfloat16",
        fused_xent=True,
    )


def _lm_smoke() -> TrainConfig:
    return TrainConfig(
        name="lm_smoke", model="transformer-lm",
        model_kwargs={"tiny": True, "seq_mode": "ring", "vocab_size": 64},
        dataset="lm_text",
        dataset_kwargs={"seq_len": 64, "vocab_size": 64, "synthetic_size": 64},
        shard_seq=True, mesh=MeshSpec(data=2, seq=4),
        optimizer="adamw", base_lr=3e-3, scale_lr_by_batch=False,
        schedule="constant", global_batch=8, total_steps=40,
        eval_every=20, eval_batches=2, log_every=10, ckpt_every=20,
    )


def _lm_pp_smoke() -> TrainConfig:
    return TrainConfig(
        name="lm_pp_smoke", model="transformer-lm-pp",
        model_kwargs={"tiny": True, "vocab_size": 64, "num_layers": 4},
        dataset="lm_text",
        dataset_kwargs={"seq_len": 64, "vocab_size": 64, "synthetic_size": 64},
        mesh=MeshSpec(data=2, pipe=4), pp_microbatches=2,
        optimizer="adamw", base_lr=3e-3, scale_lr_by_batch=False,
        schedule="constant", global_batch=8, total_steps=40,
        eval_every=20, eval_batches=2, log_every=10, ckpt_every=20,
    )


def _smoke() -> TrainConfig:
    return TrainConfig(
        name="smoke", model="convnet", dataset="mnist",
        dataset_kwargs={"synthetic_size": 512}, optimizer="sgd", base_lr=0.02,
        scale_lr_by_batch=False, schedule="constant", global_batch=32,
        total_steps=30, eval_every=15, eval_batches=2, log_every=5,
        ckpt_every=10,
    )


WORKLOADS = {
    "mnist_single": _mnist_single,
    "cifar10_resnet18": _cifar10_resnet18,
    "imagenet_resnet50": _imagenet_resnet50,
    "glue_bert": _glue_bert,
    "glue_bert_mnli": _glue_bert_mnli,
    "glue_bert_stsb": _glue_bert_stsb,
    "glue_bert_cola": _glue_bert_cola,
    "imagenet_resnet50_pod": _imagenet_resnet50_pod,
    "lm_long": _lm_long,
    "lm_smoke": _lm_smoke,
    "lm_pp_smoke": _lm_pp_smoke,
    "smoke": _smoke,
}


def get_config(name: str) -> TrainConfig:
    if name not in WORKLOADS:
        raise ValueError(f"unknown config {name!r}; have {sorted(WORKLOADS)}")
    return WORKLOADS[name]()
