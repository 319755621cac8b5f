"""ZeRO-1 weight-update sharding for the plain data-parallel step
(counterpart of ``tpuframe/parallel/zero1.py``).

The replicated step all-reduces the gradients and then runs the whole
optimizer update on every rank, each holding the whole optimizer state.
ZeRO stage 1 (arXiv:2004.13336) keeps the update math and shards its work
and its state:

    all-reduce(grads); update(all params)          # replicated update
        =>
    g_i = reduce-scatter(grads)                    # the same wire bytes
    p_i = update(param chunk i, g_i)               # 1/n compute and state
    params = all-gather(p_i)                       # param bytes out

The optimizer must be element-wise (sgd with momentum, adamw): global-norm
clipping and LARS's per-tensor trust ratio couple the elements of a leaf
and are refused (``utils/optim.py``).

Layout.  Each parameter is flattened (in its logical, row-major order)
and zero-padded to a multiple of the world size ``n``: every parameter
takes the sharded path, and :func:`padding_census` reports the waste.
Rank ``i`` owns chunk ``i`` of ``padded / n`` elements of every leaf, the
chunk the reduce-scatter hands it; its optimizer moments are those chunks
only (``Optimizer(shards=(n, i))``), built as zeros, which is the
replicated init in this layout, and no rank ever holds a whole moment.
The parameters stay whole on every rank (ZeRO-1 shards the update, not the
forward and backward), and the gradients reach :func:`sharded_update`
unreduced.

:func:`sharded_update` runs: pad each gradient -> reduce-scatter (mean) ->
the optimizer on the rank's chunks -> all-gather -> copy back into the
parameters.  The gradient norm is the chunks' sums of squares plus one
scalar all-reduce: the padding adds zeros, so it is the norm of the mean
gradient.  With ``fusion_threshold`` both gradient-sized collectives go
one a bucket (``parallel/fusion.py``'s shard-aligned packing), every
bucket issued before any is unpacked: the same bytes in fewer calls.  With
``wire_format="int8-block"`` (``parallel/quantwire.py``) a leaf of at
least ``MIN_QUANT_ELEMS`` padded elements takes the quantized scatter, and
the gather carries the quantized update DELTA (new chunk minus old), added
to the old parameters: the parameters keep full-precision accumulation,
as in the JAX package.

Where this module and the JAX one differ:

  - :func:`resolve` is env > ``replicated``: the port has no tuning DB;
  - the world is the data-parallel group of ``torch.distributed``
    (:func:`world_size`), not mesh axes; the two-level ``hier`` lowering
    is not ported (ROADMAP.md queue 1, item 12);
  - the JAX module's jitted, born-sharded init and its placement helpers
    are XLA artefacts: :func:`make_state` builds the moments as chunks.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from tpuframe_torch.ckpt import FlatShard, Shard
from tpuframe_torch.parallel import collectives, fusion, quantwire

MODES = ("replicated", "zero1")
ENV_VAR = "TPUFRAME_WEIGHT_UPDATE"


def validate_mode(mode: str) -> str:
    mode = (mode or "replicated").strip().lower()
    if mode not in MODES:
        raise ValueError(f"unknown weight-update mode {mode!r}; "
                         f"expected one of {MODES} ({ENV_VAR})")
    return mode


def mode_from_env(env=os.environ) -> str | None:
    """The explicit ``TPUFRAME_WEIGHT_UPDATE``, or None."""
    raw = env.get(ENV_VAR, "").strip()
    return validate_mode(raw) if raw else None


def resolve() -> tuple:
    """``(mode, source)``: the env knob, else ``replicated``; ``source``
    is ``"env"`` or ``"default"``."""
    env_val = mode_from_env()
    if env_val is not None:
        return env_val, "env"
    return "replicated", "default"


def padded_len(size: int, n: int) -> int:
    """The flat length a ``size``-element leaf occupies sharded ``n``
    ways.  The pad is zero at init and stays zero (zero gradients there,
    element-wise optimizers), so resharding a flat moment from ``n`` to
    ``n'`` ranks is exactly a truncate or a zero-pad to
    ``padded_len(size, n')`` (``ckpt.restore`` does it)."""
    size, n = int(size), int(n)
    return -(-size // n) * n


def chunk_len(size: int, n: int) -> int:
    """The elements of one rank's chunk of a ``size``-element leaf."""
    return padded_len(size, n) // int(n)


def opt_tree(opt) -> dict:
    """``opt.state_dict()`` for a checkpoint: in the ZeRO-1 layout each
    moment as a ``ckpt.FlatShard`` leaf (a ``ckpt.Shard``: this rank's
    chunk of the global flat ``[padded]`` vector, the JAX layout on
    disk)."""
    tree = opt.state_dict()
    if opt.shards is None:
        return tree
    n, idx = opt.shards
    return {key: val if key == "count" else
            {name: FlatShard(t, idx, n) for name, t in val.items()}
            for key, val in tree.items()}


def load_opt_tree(tree: dict) -> dict:
    """The inverse of :func:`opt_tree`: a ``Shard`` leaf by its tensor,
    for ``Optimizer.load_state_dict``."""
    return {key: val if key == "count" else
            {name: t.tensor if isinstance(t, Shard) else t
             for name, t in val.items()}
            for key, val in tree.items()}


def world_size(grp) -> int:
    """The number of weight-update shards: ``grp``'s size (1 for None)."""
    return 1 if grp is None else torch.distributed.get_world_size(grp)


def shard_index(grp) -> int:
    """This rank's chunk: its rank in ``grp`` (0 for None)."""
    return 0 if grp is None else torch.distributed.get_rank(grp)


def _named(params) -> list:
    if isinstance(params, nn.Module):
        return list(params.named_parameters())
    return list(params.items())


def padded_bytes(params, n: int) -> int:
    """Bytes of the flat pad-to-``n`` layout of ``params`` (a module or a
    name -> tensor map): the operand bytes of the step's reduce-scatter
    and the result bytes of its all-gather."""
    return int(sum(padded_len(p.numel(), n) * p.element_size()
                   for _, p in _named(params)))


def padding_census(params, n: int) -> dict:
    """Per-leaf padding of the layout, in the JAX census's shape: rows of
    name, shape, dtype, size, padded, pad_waste and padded_bytes, and the
    totals with ``waste_frac``."""
    rows = []
    total_b = 0
    for name, p in _named(params):
        size, padded = p.numel(), padded_len(p.numel(), n)
        rows.append({"name": name, "shape": tuple(p.shape),
                     "dtype": fusion._dtype_name(p.dtype), "size": size,
                     "padded": padded, "pad_waste": padded - size,
                     "padded_bytes": padded * p.element_size()})
        total_b += size * p.element_size()
    total = sum(r["size"] for r in rows)
    padded_total = sum(r["padded"] for r in rows)
    return {
        "n_shards": int(n),
        "leaves": rows,
        "total_elems": total,
        "padded_elems": padded_total,
        "total_bytes": total_b,
        "padded_bytes": sum(r["padded_bytes"] for r in rows),
        "waste_frac": (padded_total - total) / max(total, 1),
    }


def flat_pad(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` flattened in its logical order and zero-padded to a multiple
    of ``n``."""
    flat = t.reshape(-1)
    pad = padded_len(flat.numel(), n) - flat.numel()
    return F.pad(flat, (0, pad)) if pad else flat


def make_state(cfg, model: nn.Module, grp, *, seed: int = 0):
    """The replicated ``TrainState``'s twin for the zero1 step: the
    optimizer's moments born as this rank's chunks of the flat layout over
    ``grp`` (None: a world of one, n=1)."""
    from tpuframe_torch.parallel.step import TrainState
    from tpuframe_torch.utils.optim import build_optimizer

    return TrainState(model=model, opt=build_optimizer(
        cfg, model, shards=(world_size(grp), shard_index(grp))), seed=seed)


def check_state_layout(opt, n: int):
    """Raise ``ValueError`` unless ``opt``'s moments are chunks of the
    flat pad-to-``n`` layout (a replicated optimizer reaching the zero1
    step would otherwise fail later on a shape)."""
    if opt.shards is None or opt.shards[0] != n:
        raise ValueError(
            f"the optimizer's moments are not in the ZeRO-1 flat "
            f"pad-to-{n} layout (shards={opt.shards}) — build the state "
            f"with zero1.make_state, not a replicated optimizer, when "
            f"weight_update='zero1'")
    for key, ts in opt.moments.items():
        for name, p, t in zip(opt.names, opt.params, ts):
            want = chunk_len(p.numel(), n)
            if t.dim() != 1 or t.numel() != want:
                raise ValueError(
                    f"{key} {name}: {tuple(t.shape)} is not a [{want}] "
                    f"chunk of the ZeRO-1 flat pad-to-{n} layout — build "
                    f"the state with zero1.make_state")
    return opt


def _quantized(flat: torch.Tensor, wire_format: str) -> bool:
    return (wire_format == "int8-block"
            and flat.numel() >= quantwire.MIN_QUANT_ELEMS)


def scatter_grads(flats: list, grp, *, wire_format: str = "fp",
                  fusion_threshold: int | None = None) -> tuple:
    """The reduce-scatter (mean) of the padded flat gradients ``flats``:
    ``(chunks, buckets)``, this rank's ``[padded / n]`` chunk of each
    leaf's world mean and the fp leaves' index buckets.  One collective a
    bucket of :func:`fusion.plan` (a leaf each without a threshold), all
    started before any is unpacked; a quantized leaf goes through
    ``quantwire.reduce_scatter_mean``."""
    n = world_size(grp)
    if n == 1:
        return list(flats), [[i] for i in range(len(flats))]
    out: list = [None] * len(flats)
    fp = []
    for i, f in enumerate(flats):
        if _quantized(f, wire_format):
            out[i] = quantwire.reduce_scatter_mean(f, grp)
        else:
            fp.append(i)
    threshold = -1 if fusion_threshold is None else fusion_threshold
    buckets = [[fp[j] for j in b]
               for b in fusion.plan([flats[i] for i in fp], threshold)]
    started = [collectives.reduce_scatter_start(
        fusion.pack_for_scatter([flats[i] for i in b], n) if len(b) > 1
        else flats[b[0]], grp) for b in buckets]
    for b, (shard, work) in zip(buckets, started):
        work.wait()
        shard.div_(n)
        for i, part in zip(b, fusion.split_scattered(
                shard, [flats[i].numel() // n for i in b])):
            out[i] = part
    return out, buckets


def _gather_params(params: list, chunks: list, old: list, grp, n: int,
                   buckets: list) -> None:
    """The all-gather of the updated chunks into the parameters: the fp
    leaves one collective a bucket (all started before any is unpacked),
    a quantized leaf (``old[i]`` not None) as its quantized delta added to
    the old parameter."""
    for i, prev in enumerate(old):
        if prev is not None:
            p = params[i]
            delta = quantwire.all_gather(chunks[i] - prev, grp)
            p.add_(delta[:p.numel()].view(p.shape).to(p.dtype))
    started = [collectives.all_gather_start(
        torch.cat([chunks[i] for i in b]) if len(b) > 1 else chunks[b[0]],
        grp) for b in buckets]
    for b, (full, work) in zip(buckets, started):
        work.wait()
        parts = (fusion.split_gathered(full, n, [chunks[i].numel()
                                                 for i in b])
                 if len(b) > 1 else [full])
        for i, part in zip(b, parts):
            p = params[i]
            p.copy_(part[:p.numel()].view(p.shape))


@torch.no_grad()
def sharded_update(opt, grp, *, wire_format: str = "fp",
                   fusion_threshold: int | None = None) -> torch.Tensor:
    """reduce-scatter -> 1/n optimizer update -> all-gather, in place on
    ``opt``'s parameters and moments, from each parameter's LOCAL
    ``.grad`` (unreduced; a parameter without one counts as zeros).
    Returns the mean gradient's global norm.  ``grp`` is the data-parallel
    group (None: a world of one, where this is the replicated update on
    the flat layout's one chunk)."""
    n = world_size(grp)
    check_state_layout(opt, n)
    idx = shard_index(grp)
    params = opt.params
    flats = [flat_pad((torch.zeros_like(p) if p.grad is None
                       else p.grad).to(p.dtype), n) for p in params]
    chunks, buckets = scatter_grads(flats, grp, wire_format=wire_format,
                                    fusion_threshold=fusion_threshold)
    sq = torch.stack([g.float().square().sum() for g in chunks]).sum()
    if grp is not None:
        sq = collectives.allreduce(sq, grp)
    # the replicated parameters' chunks: a local slice at the index the
    # reduce-scatter handed this rank
    pshard = []
    for p, f in zip(params, flats):
        c = f.numel() // n
        pshard.append(flat_pad(p.detach(), n)[idx * c:(idx + 1) * c].clone())
    old = [t.clone() if n > 1 and _quantized(f, wire_format) else None
           for t, f in zip(pshard, flats)]
    opt.update_shards(pshard, chunks)
    if n == 1:
        for p, t in zip(params, pshard):
            p.copy_(t[:p.numel()].view(p.shape))
    else:
        _gather_params(params, pshard, old, grp, n, buckets)
    return sq.sqrt()


def check() -> list:
    """The mode registry, the env knob and the census arithmetic; []
    means healthy."""
    problems: list[str] = []
    for m in MODES:
        try:
            validate_mode(m)
        except ValueError as e:
            problems.append(f"mode {m!r} failed validation: {e}")
    try:
        mode_from_env()
    except ValueError as e:
        problems.append(f"{ENV_VAR} is set to an invalid mode: {e}")
    probe = {"w": torch.empty(3, 5, device="meta"),
             "b": torch.empty(7, device="meta")}
    census = padding_census(probe, 8)
    if any(row["padded"] % 8 for row in census["leaves"]):
        problems.append("padding census produced a non-multiple shard")
    if census["padded_bytes"] != padded_bytes(probe, 8):
        problems.append("padding census / padded_bytes disagree")
    return problems

