"""Block-quantized int8 wire format for the gradient-path collectives
(counterpart of ``tpuframe/parallel/quantwire.py``).

The mean of a gradient over the data-parallel world is decomposed into its
two phases, each of which can carry an int8 payload:

  reduce-scatter(mean)  ->  all-to-all of (s8 payload, f32 block scales)
                            + a dequantize a source and an f32 sum, local
  all-gather            ->  all-gather of (s8 payload, scales)
                            + a local dequantize
  all-reduce(mean)      =   the two composed

Quantization is symmetric per block: ``DEFAULT_BLOCK`` elements share one
f32 scale ``max|block| / 127``; an all-zero block keeps scale 0 and comes
back as exact zeros.  The scale is computed as XLA compiles the JAX
function (a multiply by the f32 reciprocal of 127, which rounds otherwise
than a division in about one block in ten), and ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the payload and the scales are
the JAX package's bits.  Accumulation is f32 and local (the s8 payload
only crosses the wire), one rounding a source: each source's product is
added as a fused multiply-add would add it (exactly, through f64), as
XLA's compiled reduce does, and the same on the CPU and the card.  The
error an element is at most one quantization step a phase, ``2 *
blockmax / 254`` for the composed mean.

Leaves under ``MIN_QUANT_ELEMS`` elements stay full precision (a plain
mean), and a world of one has no wire to shrink.  The collectives are
``parallel/collectives.py``'s counted ones: a reduce-scatter leg counts
its s8 payload and f32 scales as ``all_to_all`` operand bytes, a gather
leg as ``all_gather`` result bytes, a full-precision leaf as an
``all_reduce`` (:data:`collectives.WIRE_BYTES`): a leg of a flat operand
of ``padded`` elements over ``n`` ranks is ``n * ceil(padded / n / 256) *
(256 + 4)`` bytes.

Where this module and the JAX one differ:

  - :func:`resolve_legs` is env > ``fp`` (the port has no tuning DB), and
    its DCN leg accepts only ``fp``: that leg belongs to the two-level
    lowering (``TPUFRAME_HIER``), which the port does not have yet
    (ROADMAP.md queue 1, item 12);
  - :func:`all_reduce_mean` takes a list of tensors and returns their
    means: PyTorch has no varying manual axes, so every tensor is a local
    one (the JAX function's ``varying`` branch);
  - the shardflow registration, the lint self-check and the deprecated
    ``resolve`` are XLA and analysis artefacts and are not ported.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.nn.functional as F

from tpuframe_torch.parallel import bootstrap, collectives

FORMATS = ("fp", "int8-block")
ENV_VAR = "TPUFRAME_WIRE_FORMAT"
ENV_VAR_DCN = "TPUFRAME_WIRE_FORMAT_DCN"

# Elements a shared f32 scale: 4/256 = 1.6% scale overhead on the wire.
DEFAULT_BLOCK = 256
# Leaves under this stay full precision: a 4x cut on a sub-KiB bias is
# noise on the wire but doubles its collectives (payload and scales).
MIN_QUANT_ELEMS = 1024
_QMAX = 127.0


def validate_format(fmt: str) -> str:
    fmt = (fmt or "fp").strip().lower()
    if fmt not in FORMATS:
        raise ValueError(f"unknown wire format {fmt!r}; "
                         f"expected one of {FORMATS} ({ENV_VAR})")
    return fmt


def format_from_env(env=os.environ) -> str | None:
    """The explicit ``TPUFRAME_WIRE_FORMAT``, or None."""
    raw = env.get(ENV_VAR, "").strip()
    return validate_format(raw) if raw else None


def format_from_env_dcn(env=os.environ) -> str | None:
    """The explicit ``TPUFRAME_WIRE_FORMAT_DCN``, or None."""
    raw = env.get(ENV_VAR_DCN, "").strip()
    return validate_format(raw) if raw else None


def resolve_legs() -> tuple:
    """``((format, source), (format_dcn, source_dcn))``: each leg the env
    knob, else ``fp``; ``source`` is ``"env"`` or ``"default"``.  A DCN
    leg other than ``fp`` raises ``NotImplementedError``: it needs the
    two-level lowering, which is not ported."""
    env_val = format_from_env()
    ici = (env_val, "env") if env_val is not None else ("fp", "default")
    env_dcn = format_from_env_dcn()
    dcn = (env_dcn, "env") if env_dcn is not None else ("fp", "default")
    if dcn[0] != "fp":
        raise NotImplementedError(
            f"{ENV_VAR_DCN}={dcn[0]!r}: the DCN leg's wire rides the "
            f"two-level lowering (TPUFRAME_HIER), which is not ported yet "
            f"({bootstrap.ITEM_12})")
    return ici, dcn


def quantize_blocks(flat: torch.Tensor):
    """Symmetric per-block s8 quantization of a flat f32 tensor whose
    length is a multiple of ``DEFAULT_BLOCK``: ``(q s8 [m/256, 256],
    scales f32 [m/256])`` with ``scale = max|row| / 127``."""
    rows = flat.reshape(-1, DEFAULT_BLOCK)
    scales = rows.abs().amax(dim=1) * (1.0 / _QMAX)
    safe = torch.where(scales == 0.0, 1.0, scales)
    q = torch.clamp(torch.round(rows / safe[:, None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scales.float()


def dequantize_blocks(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`quantize_blocks` (``[rows, block]`` f32)."""
    return q.float() * scales[..., None]


def _dequantize_sum(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """The f32 sum over sources (dim 0) of the dequantized ``q``: the
    first source's product rounded, each later one added with a single
    rounding (a q * scale product is exact in f64, and so is its sum with
    an f32 partial sum whenever the two are within 2^29 of each other)."""
    acc = dequantize_blocks(q[0], scales[0])
    for i in range(1, q.shape[0]):
        acc = (acc.double() + q[i].double()
               * scales[i].double()[..., None]).float()
    return acc


def _pad_to(flat: torch.Tensor, multiple: int) -> torch.Tensor:
    pad = (-flat.numel()) % multiple
    return F.pad(flat, (0, pad)) if pad else flat


def _blocks(c: int) -> int:
    return -(-c // DEFAULT_BLOCK)


def _rs_mean_flat(flat: torch.Tensor, grp, n: int) -> torch.Tensor:
    """Quantized reduce-scatter (mean) of an f32 ``(n * c,)`` operand:
    this rank's ``(c,)`` mean shard, in f32.  Rank ``i`` owns chunk ``i``,
    as with the fp reduce-scatter."""
    c = flat.numel() // n
    nb = _blocks(c)
    rows = flat.view(n, c)
    if nb * DEFAULT_BLOCK != c:
        rows = F.pad(rows, (0, nb * DEFAULT_BLOCK - c))
    q, scales = quantize_blocks(rows.reshape(-1))
    # each source's scales travel with its payload: a dequantize a source
    q, wq = collectives.all_to_all_start(q.view(n, nb, DEFAULT_BLOCK), grp)
    scales, ws = collectives.all_to_all_start(scales.view(n, nb), grp)
    wq.wait()
    ws.wait()
    total = _dequantize_sum(q, scales)                 # f32 accumulate
    return total.reshape(-1)[:c] / n


def _gather_flat(shard: torch.Tensor, grp) -> torch.Tensor:
    """Quantized tiled all-gather of an f32 ``(c,)`` shard: the ``(n *
    c,)`` vector every rank reconstructs, in f32."""
    c = shard.numel()
    nb = _blocks(c)
    q, scales = quantize_blocks(_pad_to(shard, DEFAULT_BLOCK))
    gq, wq = collectives.all_gather_start(q, grp)
    gs, ws = collectives.all_gather_start(scales, grp)
    wq.wait()
    ws.wait()
    full = dequantize_blocks(gq, gs).view(-1, nb * DEFAULT_BLOCK)
    return full[:, :c].reshape(-1)


def _world(grp) -> int:
    return 1 if grp is None else torch.distributed.get_world_size(grp)


def _require_flat(x: torch.Tensor, who: str) -> None:
    if x.dim() != 1:
        raise ValueError(f"{who} takes a flat 1-d operand (the zero1 "
                         f"pad-to-multiple layout), got shape "
                         f"{tuple(x.shape)}; reshape(-1) first")


def reduce_scatter_mean(x: torch.Tensor, grp) -> torch.Tensor:
    """The quantized twin of ``collectives.reduce_scatter_start`` with the
    mean: this rank's chunk of the world's mean of the flat ``x`` (length
    a multiple of the world size), in ``x``'s dtype.  A world of one
    returns ``x``."""
    n = _world(grp)
    if n == 1:
        return x
    _require_flat(x, "quantwire.reduce_scatter_mean")
    if x.numel() % n:
        raise ValueError(f"quantwire.reduce_scatter_mean: size {x.numel()} "
                         f"is not divisible by the {n} ranks; pad to a "
                         f"multiple of {n} first (zero1's pad-to-multiple "
                         f"layout)")
    return _rs_mean_flat(x.float(), grp, n).to(x.dtype)


def all_gather(x: torch.Tensor, grp) -> torch.Tensor:
    """The quantized twin of the tiled all-gather of a flat shard: every
    rank's ``x`` in rank order, rebuilt from s8 payloads and scales, in
    ``x``'s dtype.  A world of one returns ``x``."""
    if _world(grp) == 1:
        return x
    _require_flat(x, "quantwire.all_gather")
    return _gather_flat(x.float(), grp).to(x.dtype)


def all_reduce_mean(tensors: Sequence[torch.Tensor], grp, *,
                    min_elems: int = MIN_QUANT_ELEMS) -> list:
    """The world's mean of each tensor over the int8-block wire: flattened,
    padded to a multiple of the world size, the quantized reduce-scatter,
    then the quantized all-gather; returns new tensors of the inputs'
    shapes and dtypes.  A tensor under ``min_elems`` elements (and every
    tensor in a world of one) takes the full-precision mean.  Error an
    element: at most ``2 * blockmax / 254``."""
    n = _world(grp)
    out = []
    for g in tensors:
        if n == 1:
            out.append(g)
        elif g.numel() < max(min_elems, 1):
            out.append(collectives.wire_mean_(
                g.clone(memory_format=torch.contiguous_format), grp))
        else:
            flat = _pad_to(g.float().reshape(-1), n)
            full = _gather_flat(_rs_mean_flat(flat, grp, n), grp)
            out.append(full[:g.numel()].view(g.shape).to(g.dtype))
    return out
