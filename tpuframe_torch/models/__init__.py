"""Model registry (counterpart of ``tpuframe/models/__init__.py``)."""

from __future__ import annotations

from tpuframe_torch.models.transformer_lm import LMConfig, TransformerLM

# Registry names of the JAX package that the port does not build yet, and
# the ROADMAP.md slice that brings each.
_LATER = {
    "convnet": "slice 3 (ResNet data-parallel training)",
    "resnet18": "slice 3 (ResNet data-parallel training)",
    "resnet34": "slice 3 (ResNet data-parallel training)",
    "resnet50": "slice 3 (ResNet data-parallel training)",
    "resnet101": "slice 3 (ResNet data-parallel training)",
    "resnet152": "slice 3 (ResNet data-parallel training)",
    "bert-base": "slice 4 (BERT/GLUE training)",
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
    if name in _LATER:
        raise NotImplementedError(f"model {name!r} is not ported yet: "
                                  f"ROADMAP.md {_LATER[name]}")
    raise ValueError(f"unknown model {name!r}")


__all__ = ["LMConfig", "TransformerLM", "get_model"]
