"""Ring KV-cache for the decode path (counterpart of
``tpuframe/serve/kv_cache.py``).

Per layer one ``(k, v)`` pair of ``[slots, capacity, num_heads, head_dim]``
tensors plus a ``lengths [slots]`` vector counting tokens already cached
per slot.  The model updates the tensors in place.

Ring semantics: token ``t`` is written at index ``t % capacity`` and
attention is masked to ``min(t + 1, capacity)`` valid entries, so a
sequence that outlives its bucket degrades to sliding-window attention
instead of faulting.  Keys are stored post-RoPE.

Every prompt bucket and the capacity are multiples of the decode block.
Bucket sets resolve env > default (``TPUFRAME_SERVE_BUCKETS`` /
``TPUFRAME_DECODE_BLOCK``); the JAX package's tuning-database tier is
TPU-specific and has no counterpart here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

DEFAULT_DECODE_BLOCK = 128
DEFAULT_PROMPT_BUCKETS = (128, 256, 512)


@dataclass(frozen=True)
class CacheSpec:
    """Static shape contract of one engine's cache."""

    slots: int           # decode batch size (concurrent sequences)
    capacity: int        # KV entries per slot (ring length)
    num_layers: int
    num_heads: int
    head_dim: int
    dtype: str = "float32"

    def __post_init__(self):
        if self.capacity % 8:
            raise ValueError(f"capacity {self.capacity} not a multiple of "
                             f"8 (the JAX engine's alignment contract)")
        if self.slots < 1:
            raise ValueError(f"need at least one slot, got {self.slots}")

    def layer_shape(self) -> tuple:
        return (self.slots, self.capacity, self.num_heads, self.head_dim)

    def bytes_per_token(self) -> int:
        """Device bytes one cached token costs across all layers (K + V)."""
        itemsize = getattr(torch, self.dtype).itemsize
        return 2 * self.num_layers * self.num_heads * self.head_dim \
            * itemsize

    def total_bytes(self) -> int:
        return self.slots * self.capacity * self.bytes_per_token()


def init_cache(spec: CacheSpec, device):
    """Zeroed per-layer ``(k, v)`` pairs + zero int64 lengths.  Returns
    ``(layers, lengths)``."""
    shape = spec.layer_shape()
    dtype = getattr(torch, spec.dtype)
    layers = tuple((torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))
                   for _ in range(spec.num_layers))
    lengths = torch.zeros((spec.slots,), dtype=torch.int64, device=device)
    return layers, lengths


def spec_for_model(cfg, *, slots: int, capacity: int) -> CacheSpec:
    """CacheSpec derived from an ``LMConfig``."""
    return CacheSpec(slots=slots, capacity=capacity,
                     num_layers=cfg.num_layers, num_heads=cfg.num_heads,
                     head_dim=cfg.head_dim, dtype=cfg.dtype)


def parse_buckets(text: str) -> tuple:
    """``"64,128,256"`` -> ``(64, 128, 256)`` (sorted, deduplicated)."""
    vals = sorted({int(v) for v in text.replace(";", ",").split(",")
                   if v.strip()})
    if not vals:
        raise ValueError(f"no buckets in {text!r}")
    if any(v < 8 or v % 8 for v in vals):
        raise ValueError(f"buckets must be multiples of 8, got {vals}")
    return tuple(vals)


def resolve_buckets(default=DEFAULT_PROMPT_BUCKETS) -> tuple:
    """Prompt-length buckets: ``TPUFRAME_SERVE_BUCKETS`` > default."""
    env = os.environ.get("TPUFRAME_SERVE_BUCKETS")
    if env and env.strip():
        return parse_buckets(env)
    return tuple(default)


def resolve_decode_block(default: int = DEFAULT_DECODE_BLOCK) -> int:
    """KV-capacity granularity: ``TPUFRAME_DECODE_BLOCK`` > default."""
    env = os.environ.get("TPUFRAME_DECODE_BLOCK")
    if env and env.strip():
        return int(env)
    return default


def bucket_for(length: int, buckets) -> int:
    """Smallest bucket that fits ``length``; raises when the request
    exceeds every bucket (admission control rejects it)."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket "
                     f"{max(buckets)} — reject at admission")


def capacity_for(max_context: int, decode_block: int) -> int:
    """KV capacity for a target context, rounded up to the decode block."""
    if max_context < 1:
        raise ValueError(f"max_context must be positive, got {max_context}")
    blocks = (max_context + decode_block - 1) // decode_block
    return blocks * decode_block


def check_buckets(buckets, capacity: int) -> list:
    """Bucket/capacity invariants.  Returns problem strings; [] = healthy."""
    problems = []
    bl = tuple(buckets)
    if bl != tuple(sorted(set(bl))):
        problems.append(f"buckets not sorted/unique: {bl}")
    if any(b < 8 or b % 8 for b in bl):
        problems.append(f"buckets not multiples of 8: {bl}")
    if bl and max(bl) > capacity:
        problems.append(f"largest bucket {max(bl)} exceeds KV capacity "
                        f"{capacity} — prefill would overrun the ring")
    if capacity % 8:
        problems.append(f"capacity {capacity} not a multiple of 8")
    return problems
