"""fsdp: parameters, gradients and optimizer state sharded over the
``fsdp`` mesh axis (counterpart of ``tpuframe/parallel/fsdp.py``).

The JAX package makes fsdp a placement decision: each leaf of the
``TrainState`` shards its largest dim that the fsdp degree divides (a
leaf under :data:`MIN_SHARD_ELEMENTS` elements, or with no such dim,
stays whole), on top of the tensor-parallel rules' spec where those
apply, and GSPMD inserts the all-gathers before each use and the
reduce-scatters of the gradients.  Here the same placement
(:func:`state_shardings`) is chosen on each leaf's JAX shape and mapped
onto the port's tensor (``models/convert.py``'s :func:`~tpuframe_torch
.models.convert.jax_view`), so that both packages hold the same logical
blocks: read on the port's own ``[out, in]`` tensor, "the largest dim,
the first on a tie" would pick the other dim of a square kernel.  A
placement that would split the head dim inside the port's flattened
heads is refused (``convert.spec_to_port``).

The runtime GSPMD gave the JAX package is written out:

  - :func:`shard_` cuts each parameter of a whole model to this rank's
    block (fsdp, model and expert axes together) and marks each one
    split over fsdp with its dim and the fsdp group;
  - the models read every parameter through :func:`full`, which
    all-gathers such a block over the fsdp group just before its use
    (``collectives.fsdp_gather``); its backward reduce-scatters the
    whole gradient back onto the block, summing the fsdp ranks' partial
    gradients, each from its own rows.  The whole tensor is never an
    ``nn.Parameter``: it lives from its use to its backward, and a
    ``remat`` recompute gathers it again;
  - the optimizer is built after the cut, so its moments are born on the
    blocks;
  - a module with a ``stats_group`` (the image models' BatchNorms) takes
    its batch statistics over the batch group (data x fsdp), which
    :func:`shard_` hands it: GSPMD keeps the logical program, so the JAX
    step's BatchNorm normalises with the global batch's statistics.  Its
    running statistics are then the same on every rank, and they stay
    whole (the JAX placement splits a ``batch_stats`` leaf of 1024
    elements or more; a difference of placement, not of value);
  - the train step (``parallel/step.py``) averages an fsdp-split leaf's
    reduce-scattered gradient over the data group and divides it by the
    fsdp degree (the reduce-scatter summed over fsdp), and every other
    leaf's over the batch group (data x fsdp).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpuframe_torch.parallel import collectives, tp

MIN_SHARD_ELEMENTS = 1024  # below this, sharding overhead beats the savings


def choose_spec(shape: tuple, fsdp_size: int, axis: str = "fsdp") -> tuple:
    """Shard the largest divisible dim of ``shape`` over ``axis`` (the
    JAX function; ``()`` is its ``P()``, whole)."""
    return _add_fsdp(tuple(shape), None, fsdp_size, axis)


def _add_fsdp(shape: tuple, base, fsdp_size: int, axis: str) -> tuple:
    """Overlay ``axis`` on the largest dim of ``shape`` that ``base`` (a
    spec or None) leaves unsharded and ``fsdp_size`` divides; a tie goes
    to the first such dim (``sorted`` is stable)."""
    base = tuple(base or ())
    entries = list(base) + [None] * (len(shape) - len(base))
    if fsdp_size <= 1 or int(np.prod(shape or (1,))) < MIN_SHARD_ELEMENTS:
        return tuple(entries) if base else ()
    for i in sorted(range(len(shape)), key=lambda i: shape[i], reverse=True):
        if entries[i] is None and shape[i] % fsdp_size == 0:
            entries[i] = axis
            return tuple(entries)
    return tuple(entries) if base else ()


def _rule_spec(name: str, shape: tuple, rules: tuple):
    """The tensor-parallel rule's spec of ``name`` as the JAX
    ``match_spec`` applies it under the sharded-state mode's rules: the
    first matching rule's, axes of degree 1 included (they still occupy
    their dim), or None."""
    spec = tp.rule_for(name, rules)
    if spec is None or len(spec) > len(shape):
        return None
    return tuple(spec) + (None,) * (len(shape) - len(spec))


def state_shardings(model: nn.Module, sizes: dict, rules: tuple | None = None,
                    axis: str = "fsdp") -> dict:
    """``{parameter name: port spec}`` of every parameter of a whole
    ``model`` (``TransformerLM``, BERT, a ResNet or the ConvNet) on a
    mesh of ``sizes``: the spec the JAX ``state_shardings`` gives the
    parameter's leaf (with the tensor-parallel ``rules`` where a model or
    expert degree is above 1, as the JAX trainer passes them), mapped
    onto the port's tensor (``()``: whole).  The optimizer's moments
    take their parameter's spec.  Raises ValueError where the JAX
    placement would split a head dim inside the port's flattened heads,
    and, through ``tp.specs_for``, where a model or expert degree does
    not divide the dims its rules split."""
    from tpuframe_torch.models import convert

    if sizes.get("model", 1) == 1 and sizes.get("expert", 1) == 1:
        rules = None
    if rules is not None:
        tp.specs_for(model, rules, sizes)
    out = {}
    heads = getattr(getattr(model, "cfg", None), "num_heads", 1)
    for name, p in model.named_parameters():
        view = convert.jax_view(name, tuple(p.shape), heads)
        base = None
        if rules is not None:
            port_base = _rule_spec(name, tuple(p.shape), rules)
            if port_base is not None:
                base = convert.spec_to_jax(view, port_base)
        spec = _add_fsdp(view.shape, base, sizes.get(axis, 1), axis)
        out[name] = convert.spec_to_port(view, spec, name) if spec else ()
    return out


def split_dim(spec, axis: str = "fsdp"):
    """The dim ``spec`` splits over ``axis``, or None."""
    for d, a in enumerate(spec or ()):
        if a == axis:
            return d
    return None


def param_fraction_sharded(model: nn.Module, axis: str = "fsdp") -> float:
    """Diagnostics: the share of the model's parameter elements (counted
    whole) whose placement splits ``axis``."""
    specs = getattr(model, "shard_specs", {})
    layout = getattr(model, "layout", None)
    total = sharded = 0
    for name, p in model.named_parameters():
        spec = specs.get(name)
        n = p.numel()
        for a in spec or ():
            if a is not None and layout is not None:
                n *= layout.sizes.get(a, 1)
        total += n
        if split_dim(spec, axis) is not None:
            sharded += n
    return sharded / max(total, 1)


@torch.no_grad()
def shard_(model: nn.Module, layout, rules: tuple | None = None) -> dict:
    """Cut each parameter of the whole ``model`` (the same on every rank)
    to this rank's block under :func:`state_shardings` in place, mark the
    ones split over fsdp for :func:`full`, and return ``{name: spec}`` of
    the split ones (every axis of degree 1 aside, a spec that splits
    nothing is left out).  Every module with a ``stats_group`` gets the
    batch group.  The optimizer must be built after."""
    sizes = layout.sizes
    specs = {name: spec for name, spec in
             state_shardings(model, sizes, rules).items()
             if tp.split_axes(spec, sizes)}
    tp.cut_(model, specs, layout)
    for name, p in model.named_parameters():
        d = split_dim(specs.get(name))
        if d is not None and layout.fsdp is not None:
            p.fsdp = (layout.fsdp, d)
    for mod in model.modules():
        if hasattr(mod, "stats_group"):
            mod.stats_group = layout.batch
    return specs


def full(p: torch.Tensor) -> torch.Tensor:
    """The tensor a model computes with for parameter ``p``: ``p`` itself,
    or, for a block split over fsdp (:func:`shard_`), the whole of it
    along that dim, gathered over the fsdp group, its gradient
    reduce-scattered back in the backward."""
    split = getattr(p, "fsdp", None)
    if split is None:
        return p
    grp, dim = split
    return collectives.fsdp_gather(p, grp, dim)
