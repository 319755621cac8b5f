"""Decoder-only causal transformer LM (counterpart of
``tpuframe/models/transformer_lm.py``).

Pre-LN, interleaved RoPE, tanh-GELU MLP, untied LM head.  The numerics
follow the flax model exactly where the two could drift:

  - LayerNorm has a scale and no bias, epsilon 1e-6, statistics in f32
    with ``var = E[x^2] - E[x]^2`` clipped at 0, and an f32 result.
  - GELU is the tanh approximation (``flax.linen.gelu``'s default).
  - RoPE rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` in f32.
  - Every parameter is stored in f32, as flax keeps them; each
    :class:`Dense` casts its input and kernel to the compute dtype at the
    call.  The embedding looks up in f32 and casts; ``lm_head`` runs in
    f32, so the logits (and ``hidden_only``'s normed states) are f32.

Training (``train=True``) adds residual dropout, with masks drawn inside
each block from ``(dropout_seed, layer, site)`` so that a ``remat``
recompute draws the same masks, and ``remat`` recomputes each block in the
backward (``torch.utils.checkpoint``; the JAX model's ``nn.remat`` with no
policy).  With a seq ring set on the model (:attr:`TransformerLM.seq`, a
``parallel.mesh.SeqGroup``: the trainer sets its layout's on a seq degree
above 1) ``seq_mode`` ring or ulysses runs attention over the ring
(``ops/seq_parallel.py``) on this rank's chunk of the sequence, whose RoPE
positions start at ``seq_index * S_local``; with none set it runs
whole-sequence causal attention, as the JAX model does when its seq axis
is unbound.

Mixture of experts: with ``moe_experts > 0`` every ``moe_every``-th block
(``(i + 1) % moe_every == 0``) swaps its MLP for :class:`MoEMLP`, top-k
routing with a capacity (``ops/moe.py``).  The router is an f32 ``Dense``
on f32 tokens, the four expert einsums run in the compute dtype with the
tanh GELU between them, and each MoE layer's load-balance loss is handed
out per forward: ``forward(..., aux_out=list)`` appends the layers'
values (the JAX model's ``sow``), and nothing outlives the call.

Tensor and expert parallelism (``parallel/tp.py``): with a layout set on
the model (:attr:`TransformerLM.layout`, a ``parallel.mesh.Layout`` in
the sharded-state mode, whose parameters ``fsdp.shard_`` cut to the rank's
blocks) each block runs its rank's heads and intermediate columns and the
experts of its expert index, with Megatron's collectives over the model
group (the MoE layer's over the shard group), the embedding's columns
gathered and the head's rows gathered before the loss.  The router then
routes the whole batch: each rank's tokens take the queue positions of
rows ``[d * T, (d + 1) * T)`` of the global token order over the data
group, with the capacity of the global token count, and the aux loss's
means are global (the JAX trainer's sharded-state mode, whose logical
program routes the global batch).  Without a layout the routing is this
rank's own (the JAX shard_map step's per-device routing).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils import checkpoint

from tpuframe_torch import _device
from tpuframe_torch.ops import attention as attn_ops
from tpuframe_torch.ops import moe as moe_ops
from tpuframe_torch.ops import seq_parallel
from tpuframe_torch.parallel import collectives
from tpuframe_torch.parallel.fsdp import full

SEQ_MODES = ("none", "ring", "ulysses")


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
    """``flax.linen.LayerNorm``: scale only and eps 1e-6 by default (the
    LM's ``use_bias=False``); ``bias=True`` adds flax's bias after the
    scale (BERT's, with eps 1e-12).  The result is f32."""

    def __init__(self, size: int, *, eps: float = 1e-6, bias: bool = False,
                 device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(size, device=device))
        self.bias = (nn.Parameter(torch.zeros(size, device=device))
                     if bias else None)

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True)
                          - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * full(self.weight))
        return y if self.bias is None else y + full(self.bias)


class Dense(nn.Module):
    """``flax.linen.Dense(use_bias=False, dtype=dtype)``: an f32 kernel,
    stored as ``[out, in]`` like ``nn.Linear.weight``; input and kernel
    are cast to ``dtype`` at the call, so the output is in ``dtype``.
    ``bias=True`` adds an f32 bias (zeros at init), cast like the kernel
    (flax's ``use_bias=True``)."""

    def __init__(self, in_features: int, out_features: int, *,
                 dtype=torch.float32, bias: bool = False, device=None):
        super().__init__()
        self.in_features = in_features
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((out_features, in_features),
                                               device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device))
                     if bias else None)

    def forward(self, x):
        b = None if self.bias is None else full(self.bias).to(self.dtype)
        return F.linear(x.to(self.dtype), full(self.weight).to(self.dtype),
                        b)

    def row_parallel(self, x, grp):
        """A row-parallel layer's output: this rank's partial product
        summed over the model group ``grp`` (``collectives.reduce_from``,
        in f32), then the bias added once (None or a group of one: the
        plain call)."""
        if grp is None or grp.size == 1:
            return self(x)
        y = collectives.reduce_from(F.linear(
            x.to(self.dtype), full(self.weight).to(self.dtype)), grp)
        return y if self.bias is None else y + full(self.bias).to(self.dtype)


def _seed_for(*parts: int) -> int:
    """A 64-bit torch seed from integer parts (numpy's SeedSequence)."""
    return int(np.random.SeedSequence(list(parts)).generate_state(
        1, np.uint64)[0])


def dropout(x, rate: float, seed: int):
    """``flax.linen.Dropout``: keep with probability ``1 - rate`` and scale
    kept entries by ``1 / (1 - rate)``.  The mask comes from a generator
    seeded with ``seed`` here, so the same seed draws the same mask, in a
    recompute too."""
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0).to(x.dtype)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: LMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.head_dim
        kw = dict(dtype=cfg.torch_dtype, device=device)
        self.query = Dense(cfg.hidden_size, inner, **kw)
        self.key = Dense(cfg.hidden_size, inner, **kw)
        self.value = Dense(cfg.hidden_size, inner, **kw)
        self.out = Dense(inner, cfg.hidden_size, **kw)

    def forward(self, x, positions, *, ring=None, kv_cache=None,
                cache_length=None, decode: bool = False, model=None):
        """``ring``: the seq ring this rank's chunk attends over (None:
        whole-sequence attention).  ``model``: the model group whose
        ranks each hold a block of the heads (None: all of them)."""
        c = self.cfg
        b, s, _ = x.shape
        # this rank's heads: query/key/value are column-parallel
        x = collectives.copy_to(x, model)

        def heads(t):
            return t.view(b, s, -1, c.head_dim)

        q = rope(heads(self.query(x)), positions, c.rope_theta)
        k = rope(heads(self.key(x)), positions, c.rope_theta)
        v = heads(self.value(x))
        if kv_cache is None:
            if ring is None:
                y = attn_ops.multihead_attention(q, k, v, causal=True,
                                                 impl=c.attn_impl)
            elif c.seq_mode == "ring":
                y = seq_parallel.ring_attention(q, k, v, seq=ring,
                                                causal=True,
                                                impl=c.attn_impl)
            else:
                y = seq_parallel.ulysses_attention(q, k, v, seq=ring,
                                                   causal=True,
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
        # out is row-parallel: the ranks' partial products summed
        return self.out.row_parallel(y.reshape(b, s, -1), model)


def _lecun_normal_(w, fan_in: int, gen) -> None:
    """flax's ``lecun_normal``: a normal truncated at 2 sigma, its std
    rescaled so that the variance is ``1 / fan_in``."""
    std = 1.0 / math.sqrt(fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


class MoEMLP(nn.Module):
    """Top-k routed expert FFN (``MoEMLP`` of the JAX model): the router
    (``router.weight`` ``[E, H]``, f32), ``up_experts`` ``[E, H, I]`` and
    ``down_experts`` ``[E, I, H]``; under expert and tensor parallelism a
    rank holds experts ``[e * E/n, (e + 1) * E/n)`` and its block of their
    intermediate dim.  Tokens past an expert's capacity get no MLP
    contribution from it; the residual carries them."""

    def __init__(self, cfg: LMConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        e, h, inter = cfg.moe_experts, cfg.hidden_size, cfg.intermediate_size
        self.router = Dense(h, e, device=device)
        self.up_experts = nn.Parameter(torch.empty((e, h, inter),
                                                   device=device))
        self.down_experts = nn.Parameter(torch.empty((e, inter, h),
                                                     device=device))

    def forward(self, x, par=None):
        """``(y, aux)`` of ``x`` ``[B, S, H]``.  ``par``: the model's
        layout in the sharded-state mode (global routing over its batch
        group; the experts of its expert index; partial results summed
        over its shard group), or None."""
        c = self.cfg
        b, s, h = x.shape
        e = c.moe_experts
        tokens = x.reshape(b * s, h)
        logits = self.router(tokens.float())
        route_grp = None if par is None else par.batch
        shard_grp = None if par is None else par.shard
        n_route = 1 if route_grp is None else route_grp.size
        cap = moe_ops.capacity_for(b * s * n_route, e, c.moe_k,
                                   c.moe_capacity_factor)
        prior = None
        if route_grp is not None:
            def prior(counts):
                # every batch rank's counts, in batch-index order
                every = collectives.group_gather(counts, route_grp)
                return (every[:route_grp.index].sum(dim=0),
                        every.sum(dim=0))
        r = moe_ops.route(logits, k=c.moe_k, capacity=cap, prior=prior)
        me, ce = r.me, r.ce
        if route_grp is not None:
            # the global batch's means: the mean of the batch ranks' means
            me = collectives.group_sum(me, route_grp) / n_route
            ce = collectives.group_sum(ce, route_grp) / n_route
        aux = moe_ops.aux_loss(me, ce)
        lo, hi = 0, e
        if par is not None and par.expert is not None:
            per = e // par.expert.size
            lo, hi = par.expert.index * per, (par.expert.index + 1) * per
        dtype = c.torch_dtype
        # this rank's experts use part of the tokens and weights: their
        # cotangents are summed over the shard group in the backward
        tokens = collectives.copy_to(tokens, shard_grp)
        weight = collectives.copy_to(r.weight, shard_grp)
        dispatch = r.dispatch(lo, hi).to(dtype)
        combine = r.combine(lo, hi, weight=weight).to(dtype)
        expert_in = torch.einsum("tec,th->ech", dispatch, tokens.to(dtype))
        hmid = F.gelu(torch.einsum("ech,ehi->eci", expert_in,
                                   full(self.up_experts).to(dtype)),
                      approximate="tanh")
        expert_out = torch.einsum("eci,eih->ech", hmid,
                                  full(self.down_experts).to(dtype))
        y = torch.einsum("tec,ech->th", combine, expert_out)
        y = collectives.reduce_from(y, shard_grp)
        return y.reshape(b, s, h), aux


class Block(nn.Module):
    def __init__(self, cfg: LMConfig, *, layer: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        kw = dict(dtype=cfg.torch_dtype, device=device)
        self.attn_ln = LayerNorm(cfg.hidden_size, device=device)
        self.attn = CausalSelfAttention(cfg, device=device)
        self.mlp_ln = LayerNorm(cfg.hidden_size, device=device)
        # the JAX Block's choice
        self.use_moe = (cfg.moe_experts > 0
                        and (layer + 1) % cfg.moe_every == 0)
        if self.use_moe:
            self.moe = MoEMLP(cfg, device=device)
        else:
            self.up = Dense(cfg.hidden_size, cfg.intermediate_size, **kw)
            self.down = Dense(cfg.intermediate_size, cfg.hidden_size, **kw)

    def _drop(self, h, dropout_seed, site: int):
        if dropout_seed is None or self.cfg.dropout == 0.0:
            return h
        return dropout(h, self.cfg.dropout,
                       _seed_for(dropout_seed, self.layer, site))

    def forward(self, x, positions, dropout_seed=None, *, ring=None,
                kv_cache=None, cache_length=None, decode: bool = False,
                par=None, aux_out: list | None = None):
        """``dropout_seed`` (an int) turns residual dropout on: the
        training forward.  ``par``: the model's layout in the
        sharded-state mode, or None.  ``aux_out`` (a list) takes the MoE
        layer's aux loss."""
        model = None if par is None else par.model
        h = self.attn(self.attn_ln(x), positions, ring=ring,
                      kv_cache=kv_cache, cache_length=cache_length,
                      decode=decode, model=model)
        x = x + self._drop(h, dropout_seed, 0)
        if self.use_moe:
            h, aux = self.moe(self.mlp_ln(x), par)
            if aux_out is not None:
                aux_out.append(aux)
        else:
            # up column-parallel, down row-parallel
            h = self.up(collectives.copy_to(self.mlp_ln(x), model))
            h = self.down.row_parallel(F.gelu(h, approximate="tanh"), model)
        return x + self._drop(h, dropout_seed, 1)


class TransformerLM(nn.Module):
    """input_ids ``[B, S]`` → logits ``[B, S, V]`` (f32).

    ``train=True`` is the training forward: residual dropout at
    ``cfg.dropout`` with masks drawn from ``dropout_seed``, and each block
    recomputed in the backward when ``cfg.remat``.  ``hidden_only=True``
    returns the post-final-LayerNorm hidden states ``[B, S, H]`` (f32)
    instead of logits: the input of the chunked fused cross-entropy
    (:mod:`tpuframe_torch.ops.fused_xent`), which applies ``lm_head``
    itself.

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

    ``seq``: the seq ring (``parallel.mesh.SeqGroup``) whose ranks each
    hold one chunk of every sequence, set by whoever shards the sequence
    (the trainer); None, the default, is whole-sequence attention.  A
    ``seq_mode="none"`` model, and the serving path, ignore it.

    ``layout``: the ``parallel.mesh.Layout`` of the sharded-state mode,
    set with ``shard_specs`` by whoever cut the parameters (the trainer,
    ``parallel/fsdp.shard_``: fsdp, tensor and expert
    parallelism, global MoE routing; the module docstring); None, the
    default, holds every parameter whole.  ``aux_out`` (a list) collects
    the MoE layers' aux losses of the call.
    """

    seq = None
    layout = None
    shard_specs: dict = {}

    def __init__(self, cfg: LMConfig = LMConfig(), *, device="cuda",
                 seed: int = 0):
        super().__init__()
        if cfg.moe_experts > 0 and not 1 <= cfg.moe_k <= cfg.moe_experts:
            raise ValueError(f"moe_k={cfg.moe_k} must lie in [1, "
                             f"moe_experts={cfg.moe_experts}]")
        if cfg.seq_mode not in SEQ_MODES:
            raise ValueError(f"unknown seq_mode {cfg.seq_mode!r}")
        device = _device.resolve(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  device=device)
        self.blocks = nn.ModuleList(Block(cfg, layer=i, device=device)
                                    for i in range(cfg.num_layers))
        self.final_ln = LayerNorm(cfg.hidden_size, device=device)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, device=device)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator(device=self.embed.weight.device)
        gen.manual_seed(seed)
        h = self.cfg.hidden_size
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(h), generator=gen)
        for mod in self.modules():
            if isinstance(mod, Dense):
                _lecun_normal_(mod.weight, mod.in_features, gen)
            elif isinstance(mod, MoEMLP):
                # flax's fan-in of an [E, in, out] kernel is in * E
                for w in (mod.up_experts, mod.down_experts):
                    _lecun_normal_(w, w.shape[0] * w.shape[1], gen)

    def head_weight(self) -> torch.Tensor:
        """``lm_head``'s whole ``[V, H]`` weight: under tensor parallelism
        every rank's rows gathered, each rank keeping its rows'
        gradient."""
        par = self.layout
        return collectives.gather_along(full(self.lm_head.weight),
                                        None if par is None else par.model,
                                        0)

    def forward(self, input_ids, *, train: bool = False,
                hidden_only: bool = False, dropout_seed: int | None = None,
                kv_cache=None, cache_length=None, decode: bool = False,
                aux_out: list | None = None):
        c = self.cfg
        s = input_ids.shape[-1]
        par = self.layout
        if kv_cache is not None:
            if c.seq_mode != "none" or train or par is not None:
                raise ValueError("the KV-cache path serves unsharded, "
                                 "batch-parallel configs only, not in "
                                 "train mode")
            if len(kv_cache) != c.num_layers:
                raise ValueError(f"kv_cache has {len(kv_cache)} layers; "
                                 f"model has {c.num_layers}")
            if decode and s != 1:
                raise ValueError(f"decode wants one token per sequence, "
                                 f"got S={s}")
        # (the KV-cache path has refused a seq_mode above)
        ring = self.seq if c.seq_mode != "none" else None
        if decode:
            positions = cache_length[:, None]
        else:
            # global positions: this rank's chunk of a sharded sequence
            start = 0 if ring is None else ring.index * s
            positions = start + torch.arange(s, device=input_ids.device)
        if not train:
            dropout_seed = None
        elif c.dropout > 0.0 and dropout_seed is None:
            raise ValueError("train=True with dropout needs a dropout_seed")
        # the embedding's columns are split over the model group
        x = collectives.gather_along(
            F.embedding(input_ids, full(self.embed.weight)),
            None if par is None else par.model, -1).to(c.torch_dtype)
        for i, block in enumerate(self.blocks):
            # a list a block: a remat recompute appends its value again
            aux = []
            if kv_cache is not None:
                x = block(x, positions, kv_cache=kv_cache[i],
                          cache_length=cache_length, decode=decode)
            elif c.remat and torch.is_grad_enabled():
                x = checkpoint.checkpoint(block, x, positions, dropout_seed,
                                          ring=ring, par=par, aux_out=aux,
                                          use_reentrant=False)
            else:
                x = block(x, positions, dropout_seed, ring=ring, par=par,
                          aux_out=aux)
            if aux and aux_out is not None:
                aux_out.append(aux[0])
        x = self.final_ln(x)
        if hidden_only:
            return x
        w = self.head_weight()
        logits = F.linear(x.float(), w.float())
        if kv_cache is not None:
            return logits, kv_cache
        return logits


class ScanBlockLM(nn.Module):
    """The LM with its block stack layer-stacked (``ScanBlockLM`` of the
    JAX model, whose ``nn.scan`` over the layers is the parameterization
    pipeline parallelism shards): each block weight is one parameter
    ``blocks.<name>`` of shape ``[L, ...]`` (the per-layer tensor of
    :class:`TransformerLM`'s ``blocks.<i>.<name>`` stacked), and layer
    ``i`` runs the one :class:`Block` on slice ``i``
    (``torch.func.functional_call``), so the dense architecture cannot
    drift from :class:`TransformerLM`'s.  ``remat`` recomputes each block
    in the backward.  A seed draws the same weights as
    :class:`TransformerLM`'s of the same config and seed.

    Apply modes, as the JAX model's: the full forward (``TransformerLM``'s
    training contract: ``train``, ``hidden_only``, ``dropout_seed``);
    ``stage=True``, the blocks this model holds on hidden states ``[B, S,
    H]`` (after ``parallel/pp_lm.py`` has cut them to a stage's layers);
    ``embed_only=True``; ``head_only=True``, the final LayerNorm and the
    head on hidden states (with ``hidden_only``, the normed states for
    the fused loss).  Sequence parallelism and MoE are refused, as in
    JAX; so is the KV-cache path, which the JAX model lacks."""

    layout = None
    shard_specs: dict = {}

    def __init__(self, cfg: LMConfig = LMConfig(), *, device="cuda",
                 seed: int = 0):
        super().__init__()
        if cfg.seq_mode != "none" or cfg.moe_experts > 0:
            raise ValueError("ScanBlockLM composes with pipeline parallelism"
                             " only; seq_mode must be 'none' and moe off")
        device = _device.resolve(device)
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                  device=device)
        # the one Block, its parameters replaced by their layer stacks
        self.blocks = Block(cfg, device="meta")
        for name, p in list(self.blocks.named_parameters()):
            mod_name, _, attr = name.rpartition(".")
            setattr(self.blocks.get_submodule(mod_name), attr,
                    nn.Parameter(torch.empty((cfg.num_layers, *p.shape),
                                             device=device)))
        with torch.no_grad():
            for mod in self.blocks.modules():
                if isinstance(mod, LayerNorm):
                    mod.weight.fill_(1.0)
        self.final_ln = LayerNorm(cfg.hidden_size, device=device)
        self.lm_head = Dense(cfg.hidden_size, cfg.vocab_size, device=device)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        """:class:`TransformerLM`'s draws in its order: the embedding,
        then each layer's query, key, value, out, up and down, then the
        head."""
        gen = torch.Generator(device=self.embed.weight.device)
        gen.manual_seed(seed)
        h = self.cfg.hidden_size
        self.embed.weight.normal_(0.0, 1.0 / math.sqrt(h), generator=gen)
        dense = [m for m in self.blocks.modules() if isinstance(m, Dense)]
        for i in range(self.cfg.num_layers):
            for mod in dense:
                _lecun_normal_(mod.weight[i], mod.in_features, gen)
        _lecun_normal_(self.lm_head.weight, h, gen)

    @property
    def num_stacked(self) -> int:
        """The layers this model holds (a stage's, once cut)."""
        return int(self.blocks.attn_ln.weight.shape[0])

    def head_weight(self) -> torch.Tensor:
        """``lm_head``'s ``[V, H]`` weight (the fused loss's)."""
        return self.lm_head.weight

    def _stack(self, x, train: bool, dropout_seed):
        positions = torch.arange(x.shape[1], device=x.device)
        names = [n for n, _ in self.blocks.named_parameters()]
        layers = zip(*(p.unbind(0) for p in self.blocks.parameters()))
        for i, weights in enumerate(layers):
            params = dict(zip(names, weights))
            # a seed a layer (the JAX scan splits its dropout rng a layer)
            seed = (None if dropout_seed is None
                    else _seed_for(dropout_seed, i))

            def run(h, params=params, seed=seed):
                return functional_call(self.blocks, params,
                                       (h, positions, seed))

            if self.cfg.remat and train and torch.is_grad_enabled():
                x = checkpoint.checkpoint(run, x, use_reentrant=False)
            else:
                x = run(x)
        return x

    def _head(self, x, hidden_only: bool):
        x = self.final_ln(x)
        if hidden_only:
            return x
        return F.linear(x.float(), self.lm_head.weight.float())

    def forward(self, inputs, *, train: bool = False,
                hidden_only: bool = False, dropout_seed: int | None = None,
                aux_out: list | None = None, stage: bool = False,
                embed_only: bool = False, head_only: bool = False):
        c = self.cfg
        if not train:
            dropout_seed = None
        elif c.dropout > 0.0 and dropout_seed is None:
            raise ValueError("train=True with dropout needs a dropout_seed")
        if stage:
            return self._stack(inputs, train, dropout_seed)
        if head_only:
            return self._head(inputs, hidden_only)
        x = F.embedding(inputs, self.embed.weight).to(c.torch_dtype)
        if embed_only:
            return x
        if self.num_stacked != c.num_layers:
            raise ValueError(f"the full forward needs all {c.num_layers} "
                             f"layers; this model holds a stage's "
                             f"{self.num_stacked}")
        return self._head(self._stack(x, train, dropout_seed), hidden_only)
