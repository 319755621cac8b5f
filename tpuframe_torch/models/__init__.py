"""Model registry (counterpart of ``tpuframe/models/__init__.py``)."""

from __future__ import annotations

from tpuframe_torch.models.bert import (BertConfig,
                                        BertForSequenceClassification)
from tpuframe_torch.models.convnet import ConvNet
from tpuframe_torch.models.resnet import (ResNet, ResNet18, ResNet34,
                                          ResNet50, ResNet101, ResNet152)
from tpuframe_torch.models.transformer_lm import LMConfig, TransformerLM

_RESNETS = {"resnet18": ResNet18, "resnet34": ResNet34,
            "resnet50": ResNet50, "resnet101": ResNet101,
            "resnet152": ResNet152}

# Registry names of the JAX package that the port does not build yet, and
# the ROADMAP.md item that brings each.
_LATER = {
    "transformer-lm-pp": "queue 1, item 12 (pipeline parallelism)",
}


def get_model(name: str, *, dtype=None, tiny: bool = False, device="cuda",
              seed: int = 0, **kwargs):
    """Construct a model by registry name: ``get_model(cfg.model,
    dtype=cfg.compute_dtype, **cfg.model_kwargs)`` as in the JAX harness,
    plus where it lives and the seed of its random weights."""
    if name == "transformer-lm":
        if dtype is not None:
            kwargs.setdefault("dtype", str(dtype).replace("torch.", ""))
        cfg = LMConfig.tiny(**kwargs) if tiny else LMConfig(**kwargs)
        return TransformerLM(cfg, device=device, seed=seed)
    if name == "bert-base":
        # The JAX adapter's call shape: dtype= becomes BertConfig.dtype,
        # num_classes, dropout and the widths are BertConfig fields.
        if dtype is not None:
            kwargs.setdefault("dtype", str(dtype).replace("torch.", ""))
        return BertForSequenceClassification(BertConfig.base(**kwargs),
                                             device=device, seed=seed)
    if name in _RESNETS or name == "convnet":
        if dtype is not None:
            kwargs.setdefault("dtype", dtype)
        build = ConvNet if name == "convnet" else _RESNETS[name]
        return build(device=device, seed=seed, **kwargs)
    if name in _LATER:
        raise NotImplementedError(f"model {name!r} is not ported yet: "
                                  f"ROADMAP.md {_LATER[name]}")
    raise ValueError(f"unknown model {name!r}")


__all__ = ["BertConfig", "BertForSequenceClassification", "ConvNet",
           "LMConfig",
           "ResNet", "ResNet18", "ResNet34", "ResNet50",
           "ResNet101", "ResNet152", "TransformerLM", "get_model"]
