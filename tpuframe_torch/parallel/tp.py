"""Tensor parallelism over the ``model`` axis and expert parallelism over
the ``expert`` axis (counterpart of ``tpuframe/parallel/tp.py``).

The JAX package places parameters by rules (name pattern -> partition
spec) and lets GSPMD insert the collectives.  Here the same rules, mapped
onto the port's parameter names and layouts (``nn.Linear``-style
``[out, in]`` weights; the JAX ``[H, N, D]`` head kernels flattened), say
which dim of each parameter a rank holds a block of, and the model runs
the Megatron collectives by hand (``models/transformer_lm.py``):

  - ``query``/``key``/``value``: column-parallel over heads; ``out``:
    row-parallel, one all-reduce over the model group;
  - ``up``: column-parallel, ``down``: row-parallel; inside each expert
    ``up_experts`` splits the intermediate dim and ``down_experts`` is
    row-parallel; the expert dim splits over the expert group;
  - ``embed``: split on hidden (local columns looked up, then gathered);
    ``lm_head``: split on vocab (the head's weight gathered before the
    loss, each rank keeping its rows' gradient);
  - the LayerNorms and the MoE router replicated.

BERT (``models/bert.py``) runs the same pairs: ``query``/``key``/
``value`` and ``intermediate`` (weights and biases) column-parallel,
``attention.out`` and ``output`` row-parallel with the bias added once
after the sum, ``embeddings.word`` split on hidden and gathered; its
LayerNorms, position and type embeddings, pooler and classifier
replicated.

Where the JAX ``match_spec`` replicates a leaf whose dims the degrees do
not divide, the port refuses the mesh (:func:`check_degrees`): a
Megatron pair cannot mix a split half with a replicated one.

fsdp (``parallel/fsdp.py``) overlays its axis on these specs, so a spec
can split two dims over two axes (say ``("model", "fsdp")``), and
``fsdp.shard_`` cuts a model's parameters by them.  :func:`cut` takes a
rank's block of a full tensor, :func:`cut_` a model's parameters in
place, and :func:`paste` puts blocks back together; :func:`global_sq`
counts each element of such blocks once.
"""

from __future__ import annotations

import re

import torch
from torch import nn

# (name regex, spec).  First match wins; a spec names an axis (or None)
# for each dim of the port's tensor.  The optimizer's moments carry the
# parameter's name, so the rules cover them.
TRANSFORMER_LM_RULES: tuple = (
    (r"attn\.(query|key|value)\.weight$", ("model", None)),
    (r"attn\.out\.weight$", (None, "model")),
    (r"(^|\.)up\.weight$", ("model", None)),
    (r"(^|\.)down\.weight$", (None, "model")),
    (r"^lm_head\.weight$", ("model", None)),
    (r"^embed\.weight$", (None, "model")),
    (r"moe\.up_experts$", ("expert", None, "model")),
    (r"moe\.down_experts$", ("expert", "model", None)),
    (r"moe\.router\.weight$", ()),
)

BERT_RULES: tuple = (
    (r"attention\.(query|key|value)\.weight$", ("model", None)),
    (r"attention\.(query|key|value)\.bias$", ("model",)),
    (r"attention\.out\.weight$", (None, "model")),
    (r"intermediate\.weight$", ("model", None)),
    (r"intermediate\.bias$", ("model",)),
    (r"(^|\.)output\.weight$", (None, "model")),
    (r"embeddings\.word\.weight$", (None, "model")),
)

RULES_BY_MODEL = {"transformer-lm": TRANSFORMER_LM_RULES,
                  "bert-base": BERT_RULES}


def rules_for_model(name: str) -> tuple:
    if name not in RULES_BY_MODEL:
        raise ValueError(f"no tensor-parallel rules for model {name!r}; "
                         f"have {sorted(RULES_BY_MODEL)}")
    return RULES_BY_MODEL[name]


def rule_for(name: str, rules: tuple):
    """The spec of the first rule whose pattern ``name`` matches, or
    None."""
    for pattern, spec in rules:
        if re.search(pattern, name):
            return spec
    return None


def match_spec(name: str, shape: tuple, sizes: dict, rules: tuple):
    """The spec of parameter ``name`` (a tuple with an axis or None a
    dim), or None when no rule applies or no named axis has a degree
    above 1.  Raises ValueError where a degree does not divide the dim it
    splits (the JAX function replicates there; see the module
    docstring)."""
    spec = rule_for(name, rules)
    if spec is None or len(spec) > len(shape):
        return None
    if not any(a is not None and sizes.get(a, 1) > 1 for a in spec):
        return None
    for dim, axis in zip(shape, spec):
        n = 1 if axis is None else sizes.get(axis, 1)
        if dim % n:
            raise ValueError(
                f"mesh {axis}={n} does not divide dim {dim} of {name} "
                f"{tuple(shape)}: the port refuses a mesh whose expert or "
                f"model degree does not divide the dims its rules split")
    return tuple(spec) + (None,) * (len(shape) - len(spec))


def check_degrees(cfg, sizes: dict) -> None:
    """Refuse a ``transformer-lm`` config (``LMConfig``) or a BERT one
    (``BertConfig``, which has no experts and no vocab split) whose model
    or expert degree does not divide the dims the rules split: heads,
    intermediate, hidden (and the LM's vocab) over model; experts over
    expert."""
    m, e = sizes.get("model", 1), sizes.get("expert", 1)
    dims = {"num_heads": (cfg.num_heads, m),
            "intermediate_size": (cfg.intermediate_size, m),
            "hidden_size": (cfg.hidden_size, m)}
    if hasattr(cfg, "moe_experts"):
        dims["vocab_size"] = (cfg.vocab_size, m)
    elif e > 1:
        raise ValueError(f"mesh expert={e}: BERT has no experts to shard")
    if e > 1:
        if cfg.moe_experts <= 0:
            raise ValueError(f"mesh expert={e} needs an MoE model "
                             f"(moe_experts > 0): expert parallelism shards "
                             f"the experts")
        dims["moe_experts"] = (cfg.moe_experts, e)
    bad = {k: f"{v} over {n}" for k, (v, n) in dims.items() if v % n}
    if bad:
        raise ValueError(f"mesh model={m} x expert={e} does not divide "
                         f"{bad}: the port refuses a degree that does not "
                         f"divide the dims its rules split")


def index(shape: tuple, spec, sizes: dict, coords: dict) -> tuple:
    """The block a rank at ``coords`` holds: ``((lo, hi), ...)`` a dim."""
    out = []
    for d, dim in enumerate(shape):
        axis = spec[d] if spec is not None and d < len(spec) else None
        n = 1 if axis is None else sizes.get(axis, 1)
        i = 0 if axis is None else coords.get(axis, 0)
        out.append((i * dim // n, (i + 1) * dim // n))
    return tuple(out)


def cut(full: torch.Tensor, spec, sizes: dict, coords: dict) -> torch.Tensor:
    """The block of ``full`` that the rank at ``coords`` holds (a copy)."""
    idx = index(tuple(full.shape), spec, sizes, coords)
    return full[tuple(slice(lo, hi) for lo, hi in idx)].clone()


def blocks(shape: tuple, spec, sizes: dict) -> list:
    """Every distinct block of a tensor of ``shape`` under ``spec``,
    sorted (the JAX checkpoint's shard-table order)."""
    axes = [a for a in (spec or ()) if a is not None]
    coords = [{}]
    for a in axes:
        coords = [dict(c, **{a: i}) for c in coords
                  for i in range(sizes.get(a, 1))]
    return sorted({index(shape, spec, sizes, c) for c in coords})


def paste(shape: tuple, parts) -> torch.Tensor:
    """Blocks ``[(index, tensor)]`` put back together into a tensor of
    ``shape`` (every element covered)."""
    parts = list(parts)
    out = torch.empty(shape, dtype=parts[0][1].dtype)
    for idx, t in parts:
        out[tuple(slice(lo, hi) for lo, hi in idx)] = t.cpu()
    return out


def specs_for(model: nn.Module, rules: tuple, sizes: dict) -> dict:
    """``{parameter name: spec}`` of the split parameters of ``model``
    (full-size), refusing indivisible degrees."""
    out = {}
    for name, p in model.named_parameters():
        spec = match_spec(name, tuple(p.shape), sizes, rules)
        if spec is not None:
            out[name] = spec
    return out


@torch.no_grad()
def cut_(model: nn.Module, specs: dict, layout) -> None:
    """Cut each parameter of ``model`` named in ``specs`` (full-size, the
    same on every rank) to this rank's block in place, as a new
    ``nn.Parameter``."""
    coords = layout.coords()
    params = dict(model.named_parameters())
    for name, spec in specs.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        block = cut(params[name].data, spec, layout.sizes, coords)
        setattr(mod, attr, nn.Parameter(block.contiguous(),
                                        requires_grad=params[name]
                                        .requires_grad))


def split_axes(spec, sizes: dict) -> frozenset:
    """The axes (degree above 1) that ``spec`` splits a tensor over."""
    return frozenset(a for a in (spec or ()) if a is not None
                     and sizes.get(a, 1) > 1)


# The kinds of split leaf whose squares the norm sums across ranks, in
# the order of the numbers one all-reduce carries: a mesh with no fsdp
# degree sums the first three over the shard group; with one, all seven,
# over the shard group and then over the fsdp group.
_KINDS = tuple(frozenset(k) for k in (
    {"model"}, {"expert"}, {"expert", "model"}, {"fsdp"},
    {"fsdp", "model"}, {"fsdp", "expert"}, {"fsdp", "expert", "model"}))


def global_sq(sq: list, specs: list, layout) -> torch.Tensor:
    """The global sum of squares of a sharded tree: ``sq`` holds each
    local tensor's sum of squares (f32 0-d), ``specs`` its spec (None:
    replicated).  Every element counts once: a split tensor's squares are
    summed over the ranks that hold its other blocks, taken on the ranks
    whose coordinate is 0 on each of fsdp, expert and model that it is
    not split over (one all-reduce of a number a kind over the shard
    group, and one over the fsdp group), a replicated one's taken once
    on every rank."""
    from tpuframe_torch.parallel import collectives

    sizes = layout.sizes
    zero = sq[0].new_zeros(()) if sq else torch.zeros(())
    kinds = dict.fromkeys((frozenset(),) + _KINDS, zero)
    for s, spec in zip(sq, specs):
        key = split_axes(spec, sizes)
        kinds[key] = kinds[key] + s
    if layout.shard is None and layout.fsdp is None:
        return sum(kinds.values(), zero)
    c = layout.coords()
    n = 7 if layout.fsdp is not None else 3
    part = torch.stack([
        kinds[k] * float(all(c[a] == 0 for a in ("fsdp", "expert", "model")
                             if a not in k))
        for k in _KINDS[:n]])
    part = collectives.group_sum(part, layout.shard)
    part = collectives.group_sum(part, layout.fsdp)
    return kinds[frozenset()] + part.sum()


def shard_leaf(local: torch.Tensor, spec, layout):
    """``local``, this rank's block of a tensor split by ``spec``, as a
    checkpoint leaf (``ckpt.Shard``: the global shape, the shard table,
    written by the lowest rank that holds the block)."""
    from tpuframe_torch.ckpt import Shard

    sizes = layout.sizes
    shape = tuple(d * (sizes.get(spec[i], 1) if i < len(spec)
                       and spec[i] is not None else 1)
                  for i, d in enumerate(local.shape))
    split = split_axes(spec, sizes)
    coords = layout.coords()
    return Shard(tensor=local, shape=shape,
                 index=index(shape, spec, sizes, coords),
                 blocks=tuple(blocks(shape, spec, sizes)),
                 spec=tuple(spec),
                 writer=all(coords[a] == 0 for a in coords
                            if a not in split))


def ckpt_tree(tensors: dict, specs: dict, layout) -> dict:
    """``{name: tensor}`` with each split tensor (by ``specs``) made a
    ``ckpt.Shard`` leaf; the others as they are."""
    if layout is None or not specs:
        return tensors
    return {name: shard_leaf(t, specs[name], layout) if name in specs else t
            for name, t in tensors.items()}
