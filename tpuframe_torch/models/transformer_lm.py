"""Decoder-only causal transformer LM (counterpart of
``tpuframe/models/transformer_lm.py``).

Pre-LN, interleaved RoPE, tanh-GELU MLP, untied LM head.  The numerics
follow the flax model exactly where the two could drift:

  - LayerNorm has a scale and no bias, epsilon 1e-6, statistics in f32
    with ``var = E[x^2] - E[x]^2`` clipped at 0, and an f32 result.
  - GELU is the tanh approximation (``flax.linen.gelu``'s default).
  - RoPE rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` in f32.
  - Dense layers cast input and kernel to the compute dtype; the
    embedding looks up in f32 and casts; ``lm_head`` runs in f32, so the
    logits are f32.

Weights that only ever enter a compute-dtype product (query, key, value,
out, up, down) are stored in the compute dtype.  Rounding them once when
they are loaded gives the same bits as the flax model's cast at every
call, and a decode step then reads half the bytes.

Only the dense model is ported: ``seq_mode`` must be ``"none"`` and MoE
off (see ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from tpuframe_torch import _device
from tpuframe_torch.ops import attention as attn_ops


@dataclass(frozen=True)
class LMConfig:
    """Same fields and defaults as ``tpuframe.models.transformer_lm
    .LMConfig``."""

    vocab_size: int = 32000
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_seq: int = 8192
    dropout: float = 0.0
    rope_theta: float = 10000.0
    dtype: str = "float32"          # "bfloat16" for tensor-core throughput
    attn_impl: str | None = None    # None → TPUFRAME_ATTN_IMPL env / xla
    seq_axis: str = "seq"
    seq_mode: str = "none"          # none | ring | ulysses
    remat: bool = False
    moe_experts: int = 0
    moe_every: int = 2
    moe_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "LMConfig":
        base = dict(vocab_size=512, hidden_size=64, num_layers=2,
                    num_heads=4, intermediate_size=128, max_seq=512)
        base.update(kw)
        return cls(**base)


def rope(x, positions, theta: float):
    """Rotary position embedding on interleaved pairs.  x ``[B, S, N, D]``;
    positions ``[S]`` shared, or ``[B, S]`` per sequence (decode)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    angles = positions[..., None].float() * freqs        # [..., S, D/2]
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm(use_bias=False)``: scale only, eps 1e-6."""

    def __init__(self, size: int, *, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        return (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: LMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        kw = dict(bias=False, device=device, dtype=cfg.torch_dtype)
        self.query = nn.Linear(cfg.hidden_size, inner, **kw)
        self.key = nn.Linear(cfg.hidden_size, inner, **kw)
        self.value = nn.Linear(cfg.hidden_size, inner, **kw)
        self.out = nn.Linear(inner, cfg.hidden_size, **kw)

    def forward(self, x, positions, *, kv_cache=None, cache_length=None,
                decode: bool = False):
        c = self.cfg
        b, s, _ = x.shape
        x = x.to(c.torch_dtype)

        def heads(t):
            return t.view(b, s, c.num_heads, c.head_dim)

        q = rope(heads(self.query(x)), positions, c.rope_theta)
        k = rope(heads(self.key(x)), positions, c.rope_theta)
        v = heads(self.value(x))
        if kv_cache is None:
            y = attn_ops.multihead_attention(q, k, v, causal=True,
                                             impl=c.attn_impl)
        else:
            # Serving path: the cache holds post-RoPE keys and is updated
            # in place (the JAX engine gets the same effect by donating the
            # cache buffers to its compiled programs).
            k_cache, v_cache = kv_cache
            cap = k_cache.shape[1]
            if decode:
                # Ring write at each sequence's own index, then query-
                # length-1 attention over the valid entries.
                idx = cache_length % cap
                rows = torch.arange(b, device=x.device)
                k_cache[rows, idx] = k[:, 0].to(k_cache.dtype)
                v_cache[rows, idx] = v[:, 0].to(v_cache.dtype)
                valid = torch.clamp(cache_length + 1, max=cap)
                y = attn_ops.decode_attention(q, k_cache, v_cache,
                                              lengths=valid,
                                              impl=c.attn_impl)
            else:
                # Prefill: the training forward's causal attention over
                # the padded prompt, plus the cache write at [0:S].
                if s > cap:
                    raise ValueError(f"prompt bucket {s} exceeds KV-cache "
                                     f"capacity {cap}")
                k_cache[:, :s] = k.to(k_cache.dtype)
                v_cache[:, :s] = v.to(v_cache.dtype)
                y = attn_ops.multihead_attention(q, k, v, causal=True,
                                                 impl=c.attn_impl)
        return self.out(y.reshape(b, s, c.num_heads * c.head_dim))


class Block(nn.Module):
    def __init__(self, cfg: LMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(bias=False, device=device, dtype=cfg.torch_dtype)
        self.attn_ln = LayerNorm(cfg.hidden_size, device=device)
        self.attn = CausalSelfAttention(cfg, device=device)
        self.mlp_ln = LayerNorm(cfg.hidden_size, device=device)
        self.up = nn.Linear(cfg.hidden_size, cfg.intermediate_size, **kw)
        self.down = nn.Linear(cfg.intermediate_size, cfg.hidden_size, **kw)

    def forward(self, x, positions, *, kv_cache=None, cache_length=None,
                decode: bool = False):
        h = self.attn(self.attn_ln(x), positions, kv_cache=kv_cache,
                      cache_length=cache_length, decode=decode)
        x = x + h
        h = self.up(self.mlp_ln(x).to(self.cfg.torch_dtype))
        return x + self.down(F.gelu(h, approximate="tanh"))


class TransformerLM(nn.Module):
    """input_ids ``[B, S]`` → logits ``[B, S, V]`` (f32).

    Serving path: ``kv_cache`` is a per-layer sequence of ``(k, v)``
    pairs, each ``[B, capacity, N, D]``, updated in place;
    ``cache_length [B]`` counts tokens already cached.  ``decode=False``
    prefills a left-aligned (padded) prompt; ``decode=True`` runs one new
    token per sequence at its own ring index.  Returns ``(logits,
    kv_cache)`` then.

    Weights are random, drawn from ``seed`` with flax's initialisers
    (lecun-normal kernels, an embedding of std ``hidden**-0.5``,
    unit LayerNorm scales); load trained or converted ones with
    ``load_state_dict``.
    """

    def __init__(self, cfg: LMConfig = LMConfig(), *, device="cuda",
                 seed: int = 0):
        super().__init__()
        if cfg.seq_mode != "none" or cfg.moe_experts > 0:
            raise ValueError("the port has the dense model only: seq_mode "
                             "must be 'none' and moe off")
        device = _device.resolve(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  device=device)
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, device=device)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 device=device)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator(device=self.embed.weight.device)
        gen.manual_seed(seed)
        h = self.cfg.hidden_size
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(h), generator=gen)
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                # lecun_normal: truncated at 2 sigma, std rescaled so the
                # variance is 1 / fan_in.
                std = 1.0 / math.sqrt(mod.in_features) / .87962566103423978
                # drawn in f32, then rounded into the weight's dtype
                w = torch.empty(mod.weight.shape, device=mod.weight.device)
                nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                mod.weight.copy_(w)

    def forward(self, input_ids, *, kv_cache=None, cache_length=None,
                decode: bool = False):
        c = self.cfg
        s = input_ids.shape[-1]
        if kv_cache is not None:
            if len(kv_cache) != c.num_layers:
                raise ValueError(f"kv_cache has {len(kv_cache)} layers; "
                                 f"model has {c.num_layers}")
            if decode and s != 1:
                raise ValueError(f"decode wants one token per sequence, "
                                 f"got S={s}")
        if decode:
            positions = cache_length[:, None]
        else:
            positions = torch.arange(s, device=input_ids.device)
        x = self.embed(input_ids).to(c.torch_dtype)
        for i, block in enumerate(self.blocks):
            x = block(x, positions,
                      kv_cache=None if kv_cache is None else kv_cache[i],
                      cache_length=cache_length, decode=decode)
        logits = self.lm_head(self.final_ln(x))
        if kv_cache is not None:
            return logits, kv_cache
        return logits
