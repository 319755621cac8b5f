"""BERT-base for GLUE fine-tuning (counterpart of
``tpuframe/models/bert.py``).

Post-LN encoder, learned position and segment embeddings, exact-GELU
FFN, tanh pooler and a classification head.  The numerics follow the
flax model where the two could drift:

  - Every parameter is stored in f32; each :class:`Dense` with
    ``dtype=bf16`` casts its input, kernel and bias at the call, and the
    classifier (no dtype in flax) computes in f32, so the logits are f32.
  - The embeddings sum in f32, go through their LayerNorm in f32, then
    dropout, then the cast to the compute dtype.
  - LayerNorm has a bias and eps 1e-12, statistics in f32, and returns
    f32 (flax's ``LayerNorm`` with f32 params and ``dtype=None``).  So
    the residual stream is f32 after the first layer's ``attention_ln``,
    and each add promotes as flax's does: bf16 + bf16 in the first
    layer's attention residual, f32 + bf16 after it.
  - The GELU is exact (``approximate=False``), not the LM's tanh form.
  - Query, key and value are ``DenseGeneral`` ``[H, N, D]`` kernels in
    flax and ``out`` is ``[N, D, H]``; here each is one ``[out, in]``
    matrix over the flattened heads (``models/convert.py`` maps them).

Training (``train=True``) drops at five sites: the embeddings, the
attention probabilities, the attention output, the FFN output and the
pooled vector.  Each site's mask is drawn from ``(dropout_seed, layer,
site)``; the embeddings and the pooler use layer ``num_layers``.  The
attention probabilities are dropped inside ``multihead_attention``, which
for that reason runs the einsum, as the JAX package's does, with the
mask of the whole layer drawn from the site's seed; a model rank takes
its heads' block of that mask.

Tensor parallelism (``parallel/tp.py``'s ``BERT_RULES``): with a layout
set on the model (:attr:`BertForSequenceClassification.layout`, the
sharded-state mode, whose parameters ``parallel/fsdp.shard_`` cut to the
rank's blocks) each layer runs its rank's heads and intermediate
columns, Megatron's pairs over the model group: ``query``/``key``/
``value`` and ``intermediate`` column-parallel, ``attention.out`` and
``output`` row-parallel with the bias added once after the f32 sum;
``embeddings.word`` is split on hidden, its columns looked up and
gathered.  A rank's attention-probability masks are those its heads have
in the whole layer, and the hidden-state sites come after the
row-parallel sums, the same on every model rank, so the sharded model
trains the one-process model.  Every parameter is read through
``parallel/fsdp.full``, which gathers an fsdp block before its use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from tpuframe_torch import _device
from tpuframe_torch.models.transformer_lm import (Dense, LayerNorm,
                                                  _seed_for, dropout)
from tpuframe_torch.ops import attention as attn_ops
from tpuframe_torch.parallel import collectives
from tpuframe_torch.parallel.fsdp import full

# Dropout sites inside a layer, and of the layer index num_layers.
_ATTN_PROBS, _ATTN_OUT, _FFN_OUT = 0, 1, 2
_EMBED, _POOLED = 0, 1


@dataclass(frozen=True)
class BertConfig:
    """Same fields and defaults as ``tpuframe.models.bert.BertConfig``."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    num_classes: int = 2
    dtype: str = "float32"  # "bfloat16" for tensor-core throughput

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def base(cls, **kw) -> "BertConfig":
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw) -> "BertConfig":
        """4 layers, 128 wide: the same graph at test sizes."""
        base = dict(vocab_size=1024, hidden_size=128, num_layers=4,
                    num_heads=4, intermediate_size=256, max_position=128)
        base.update(kw)
        return cls(**base)


def _drop(x, cfg: BertConfig, dropout_seed, layer: int, site: int):
    if dropout_seed is None or cfg.dropout == 0.0:
        return x
    return dropout(x, cfg.dropout, _seed_for(dropout_seed, layer, site))


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.word = nn.Embedding(cfg.vocab_size, h, device=device)
        self.position = nn.Embedding(cfg.max_position, h, device=device)
        self.token_type = nn.Embedding(cfg.type_vocab_size, h, device=device)
        self.ln = LayerNorm(h, eps=cfg.layer_norm_eps, bias=True,
                            device=device)

    def forward(self, input_ids, token_type_ids, dropout_seed=None,
                model=None):
        """``model``: the model group whose ranks each hold a block of
        the word table's hidden columns (None: all of them)."""
        c = self.cfg
        pos = torch.arange(input_ids.shape[-1], device=input_ids.device)
        word = collectives.gather_along(
            F.embedding(input_ids, full(self.word.weight)), model, -1)
        x = (word + F.embedding(pos, full(self.position.weight))[None]
             + F.embedding(token_type_ids, full(self.token_type.weight)))
        x = _drop(self.ln(x), c, dropout_seed, c.num_layers, _EMBED)
        return x.to(c.torch_dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, *, layer: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        h = cfg.hidden_size
        kw = dict(dtype=cfg.torch_dtype, bias=True, device=device)
        self.query = Dense(h, h, **kw)
        self.key = Dense(h, h, **kw)
        self.value = Dense(h, h, **kw)
        self.out = Dense(h, h, **kw)

    def forward(self, x, attention_mask, dropout_seed=None, model=None):
        """``model``: the model group whose ranks each hold a block of
        the heads (None: all of them)."""
        c = self.cfg
        b, s, _ = x.shape

        def heads(t):
            return t.view(b, s, -1, c.head_dim)

        # this rank's heads: query/key/value are column-parallel
        x = collectives.copy_to(x, model)
        q, k, v = (heads(self.query(x)), heads(self.key(x)),
                   heads(self.value(x)))
        rate, seed = 0.0, None
        if dropout_seed is not None and c.dropout > 0.0:
            rate = c.dropout
            seed = _seed_for(dropout_seed, self.layer, _ATTN_PROBS)
        y = attn_ops.multihead_attention(
            q, k, v, mask=attention_mask, dropout_rate=rate,
            dropout_seed=seed,
            heads=(None if model is None
                   else (model.index * q.shape[2], c.num_heads)))
        # out is row-parallel: the partial products summed, then the bias
        return self.out.row_parallel(y.reshape(b, s, -1), model)


class BertLayer(nn.Module):
    """Post-LN: sublayer, dropout, residual add, LayerNorm."""

    def __init__(self, cfg: BertConfig, *, layer: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        self.layer = layer
        h, eps = cfg.hidden_size, cfg.layer_norm_eps
        kw = dict(dtype=cfg.torch_dtype, bias=True, device=device)
        self.attention = BertSelfAttention(cfg, layer=layer, device=device)
        self.attention_ln = LayerNorm(h, eps=eps, bias=True, device=device)
        self.intermediate = Dense(h, cfg.intermediate_size, **kw)
        self.output = Dense(cfg.intermediate_size, h, **kw)
        self.output_ln = LayerNorm(h, eps=eps, bias=True, device=device)

    def forward(self, x, attention_mask, dropout_seed=None, model=None):
        c, i = self.cfg, self.layer
        a = self.attention(x, attention_mask, dropout_seed, model)
        x = self.attention_ln(x + _drop(a, c, dropout_seed, i, _ATTN_OUT))
        # intermediate column-parallel, output row-parallel
        h = self.intermediate(collectives.copy_to(x, model))
        h = self.output.row_parallel(F.gelu(h, approximate="none"), model)
        return self.output_ln(x + _drop(h, c, dropout_seed, i, _FFN_OUT))


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.layers = nn.ModuleList(BertLayer(cfg, layer=i, device=device)
                                    for i in range(cfg.num_layers))

    def forward(self, x, attention_mask, dropout_seed=None, model=None):
        for layer in self.layers:
            x = layer(x, attention_mask, dropout_seed, model)
        return x


class BertForSequenceClassification(nn.Module):
    """Encoder + tanh pooler + classification head: ``input_ids [B, S]``
    → logits ``[B, num_classes]`` (f32).

    ``attention_mask`` ``[B, S]`` (1 = a real token) defaults to all ones
    and ``token_type_ids`` to all zeros.  ``train=True`` turns dropout on,
    with masks drawn from ``dropout_seed`` (an int).  Weights are random,
    drawn from ``seed`` with flax's initialisers (lecun-normal kernels,
    embeddings of std ``hidden**-0.5``, zero biases, unit LayerNorm
    scales); load converted or imported ones with ``load_state_dict``.

    ``layout``: the ``parallel.mesh.Layout`` of the sharded-state mode,
    set with ``shard_specs`` by whoever cut the parameters (the trainer;
    the module docstring); None, the default, holds every parameter
    whole."""

    layout = None
    shard_specs: dict = {}

    def __init__(self, cfg: BertConfig = BertConfig(), *, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = _device.resolve(device)
        self.cfg = cfg
        h = cfg.hidden_size
        self.embeddings = BertEmbeddings(cfg, device=device)
        self.encoder = BertEncoder(cfg, device=device)
        self.pooler = Dense(h, h, dtype=cfg.torch_dtype, bias=True,
                            device=device)
        self.classifier = Dense(h, cfg.num_classes, bias=True, device=device)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator(device=self.pooler.weight.device)
        gen.manual_seed(seed)
        std = 1.0 / math.sqrt(self.cfg.hidden_size)
        for emb in (self.embeddings.word, self.embeddings.position,
                    self.embeddings.token_type):
            emb.weight.normal_(0.0, std, generator=gen)
        for mod in self.modules():
            if isinstance(mod, Dense):
                # lecun_normal: truncated at 2 sigma, std rescaled so the
                # variance is 1 / fan_in.
                s = 1.0 / math.sqrt(mod.in_features) / .87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, s, -2 * s, 2 * s,
                                      generator=gen)

    def encode(self, input_ids, attention_mask=None, token_type_ids=None, *,
               train: bool = False, dropout_seed=None):
        """``(sequence states [B, S, H] f32, pooled [B, H])``: the
        encoder's last layer and the pooler's tanh output before its
        dropout."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        if not train:
            dropout_seed = None
        elif self.cfg.dropout > 0.0 and dropout_seed is None:
            raise ValueError("train=True with dropout needs a dropout_seed")
        model = None if self.layout is None else self.layout.model
        x = self.embeddings(input_ids, token_type_ids, dropout_seed, model)
        x = self.encoder(x, attention_mask, dropout_seed, model)
        return x, torch.tanh(self.pooler(x[:, 0]))

    def forward(self, input_ids, attention_mask=None, token_type_ids=None, *,
                train: bool = False, dropout_seed=None):
        _, pooled = self.encode(input_ids, attention_mask, token_type_ids,
                                train=train, dropout_seed=dropout_seed)
        if train:
            pooled = _drop(pooled, self.cfg, dropout_seed,
                           self.cfg.num_layers, _POOLED)
        return self.classifier(pooled)


def load_hf_weights(state_dict: dict, cfg: BertConfig) -> dict:
    """A HuggingFace ``bert-base-uncased`` ``state_dict`` (a dict of
    tensors or arrays under the ``bert.`` names) → this model's
    ``state_dict`` entries for the embeddings, the encoder and the pooler,
    f32 on the CPU.  Both store linear weights ``[out, in]``, so nothing
    is transposed.  The classifier is not mapped: as the JAX function
    keeps its params' head, load the result with ``strict=False`` into a
    model whose head was initialised."""

    def t(name):
        return torch.as_tensor(state_dict[name]).float().clone()

    out = {"embeddings.word.weight": t("bert.embeddings.word_embeddings.weight"),
           "embeddings.position.weight":
               t("bert.embeddings.position_embeddings.weight"),
           "embeddings.token_type.weight":
               t("bert.embeddings.token_type_embeddings.weight"),
           "embeddings.ln.weight": t("bert.embeddings.LayerNorm.weight"),
           "embeddings.ln.bias": t("bert.embeddings.LayerNorm.bias"),
           "pooler.weight": t("bert.pooler.dense.weight"),
           "pooler.bias": t("bert.pooler.dense.bias")}
    names = {"attention.query": "attention.self.query",
             "attention.key": "attention.self.key",
             "attention.value": "attention.self.value",
             "attention.out": "attention.output.dense",
             "attention_ln": "attention.output.LayerNorm",
             "intermediate": "intermediate.dense",
             "output": "output.dense",
             "output_ln": "output.LayerNorm"}
    for i in range(cfg.num_layers):
        for dst, src in names.items():
            for leaf in ("weight", "bias"):
                out[f"encoder.layers.{i}.{dst}.{leaf}"] = t(
                    f"bert.encoder.layer.{i}.{src}.{leaf}")
    return out
