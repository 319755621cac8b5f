"""Carry flax ``TransformerLM`` parameters (and optax Adam moments), flax
ResNet parameters and batch statistics, and flax BERT parameters into the
port's models.

The flax tree (``{"embed": {"embedding"}, "block_<i>": {...},
"final_ln": {"scale"}, "lm_head": {"kernel"}}``) arrives as nested dicts of
numpy arrays, so this module needs no jax.  Layouts differ in two ways:

  - ``Dense`` kernels are ``[in, out]``; ``nn.Linear.weight`` is
    ``[out, in]``: transposed.
  - ``DenseGeneral`` kernels keep the head axes: query/key/value are
    ``[H, N, D]`` and out is ``[N, D, H]``: flattened to ``[H, N*D]`` /
    ``[N*D, H]``, then transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(params) -> dict:
    """flax ``params`` (nested dicts of numpy arrays) → the port model's
    ``state_dict`` (f32 tensors on the CPU).  Raises on a tree that holds
    leaves the dense model does not have (MoE, for one)."""
    sd = {"embed.weight": params["embed"]["embedding"],
          "final_ln.weight": params["final_ln"]["scale"],
          "lm_head.weight": np.asarray(params["lm_head"]["kernel"]).T}
    n_leaves = 3
    i = 0
    while f"block_{i}" in params:
        blk = params[f"block_{i}"]
        pre = f"blocks.{i}."
        for name in ("query", "key", "value"):
            k = np.asarray(blk["attn"][name]["kernel"])      # [H, N, D]
            sd[pre + f"attn.{name}.weight"] = k.reshape(k.shape[0], -1).T
        k = np.asarray(blk["attn"]["out"]["kernel"])         # [N, D, H]
        sd[pre + "attn.out.weight"] = k.reshape(-1, k.shape[-1]).T
        sd[pre + "attn_ln.weight"] = blk["attn_ln"]["scale"]
        sd[pre + "mlp_ln.weight"] = blk["mlp_ln"]["scale"]
        sd[pre + "up.weight"] = np.asarray(blk["up"]["kernel"]).T
        sd[pre + "down.weight"] = np.asarray(blk["down"]["kernel"]).T
        n_leaves += 8
        i += 1
    total = sum(1 for _ in _leaves(params))
    if total != n_leaves:
        raise ValueError(f"params hold {total} leaves, the dense model "
                         f"{n_leaves}: not a dense TransformerLM tree")
    # np.array copies: arrays that come from jax are read-only.
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def adam_state_from_jax(mu, nu, count) -> dict:
    """optax ``ScaleByAdamState`` moments (two trees shaped like the flax
    params, as numpy) and its count → the port optimizer's
    ``state_dict()`` layout: ``{"count": int, "mu": {...}, "nu": {...}}``
    keyed by the model's parameter names."""
    return {"count": int(count), "mu": params_from_jax(mu),
            "nu": params_from_jax(nu)}


def _conv(k):
    """flax conv kernel ``HWIO`` → ``OIHW``."""
    return np.asarray(k).transpose(3, 2, 0, 1)


def resnet_from_jax(params, batch_stats) -> dict:
    """A flax ``tpuframe.models.resnet.ResNet``'s ``params`` and
    ``batch_stats`` (nested dicts of numpy arrays), built with ``bn="flax"``
    or ``bn="fused"`` → the port ResNet's ``state_dict`` (f32 CPU tensors,
    torchvision's names).

    Flax names its blocks ``<Block>_<n>`` with one running index across
    stages; a stage opens at block 0 and at each later block that has a
    downsample.  In a block, flax's ``Conv_j``/``BatchNorm_j`` are the
    ``conv{j+1}``/``bn{j+1}`` pairs in order; under ``bn="fused"`` the
    Bottleneck's 1x1 pairs are ``FusedConvBN_0`` (conv1, bn1) and
    ``FusedConvBN_1`` (conv3, bn3), its 3x3 pair ``Conv_0``/``BatchNorm_0``
    (conv2, bn2), and the downsample ``downsample_fused``.  Raises on a
    tree that leaves a leaf unmapped."""
    sd = {}
    used = set()

    def get(tree, path):
        node = tree
        for p in path:
            node = node[p]
        used.add((id(tree), path))
        return node

    def bn(dst, src):
        sd[f"{dst}.weight"] = get(params, (*src, "scale"))
        sd[f"{dst}.bias"] = get(params, (*src, "bias"))
        sd[f"{dst}.running_mean"] = get(batch_stats, (*src, "mean"))
        sd[f"{dst}.running_var"] = get(batch_stats, (*src, "var"))

    def pair(conv_dst, bn_dst, conv_src, bn_src):
        sd[f"{conv_dst}.weight"] = _conv(get(params, (*conv_src, "kernel")))
        bn(bn_dst, bn_src)

    pair("conv1", "bn1", ("stem_conv",), ("stem_bn",))
    block = next(p for p in ("Bottleneck", "BasicBlock")
                 if f"{p}_0" in params)
    layer, i, n = 1, 0, 0
    while f"{block}_{n}" in params:
        b = f"{block}_{n}"
        blk = params[b]
        has_ds = "downsample_conv" in blk or "downsample_fused" in blk
        if n > 0 and has_ds:
            layer, i = layer + 1, 0
        pre = f"layer{layer}.{i}."
        if "FusedConvBN_0" in blk:
            for dst, src in (("1", "FusedConvBN_0"), ("3", "FusedConvBN_1")):
                pair(pre + f"conv{dst}", pre + f"bn{dst}", (b, src), (b, src))
            pair(pre + "conv2", pre + "bn2", (b, "Conv_0"), (b, "BatchNorm_0"))
            if has_ds:
                pair(pre + "downsample.0", pre + "downsample.1",
                     (b, "downsample_fused"), (b, "downsample_fused"))
        else:
            j = 0
            while f"Conv_{j}" in blk:
                pair(pre + f"conv{j + 1}", pre + f"bn{j + 1}",
                     (b, f"Conv_{j}"), (b, f"BatchNorm_{j}"))
                j += 1
            if has_ds:
                pair(pre + "downsample.0", pre + "downsample.1",
                     (b, "downsample_conv"), (b, "downsample_bn"))
        i += 1
        n += 1
    sd["fc.weight"] = np.asarray(get(params, ("Dense_0", "kernel"))).T
    sd["fc.bias"] = get(params, ("Dense_0", "bias"))
    total = (sum(1 for _ in _leaves(params))
             + sum(1 for _ in _leaves(batch_stats)))
    if len(used) != total:
        raise ValueError(f"the flax tree holds {total} leaves, "
                         f"{len(used)} were mapped: not a tpuframe ResNet")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def bert_params_from_jax(params) -> dict:
    """A flax ``tpuframe.models.bert.BertForSequenceClassification``'s
    ``params`` (nested dicts of numpy arrays) → the port model's
    ``state_dict`` (f32 CPU tensors).  Embedding tables and LayerNorm
    scales and biases carry over as they are; ``Dense`` kernels are
    transposed; the ``DenseGeneral`` query/key/value kernels ``[H, N, D]``
    and biases ``[N, D]`` and the out kernel ``[N, D, H]`` are flattened
    over the heads first.  Raises on a tree that leaves a leaf
    unmapped."""
    used = set()

    def get(*path):
        node = params
        for p in path:
            node = node[p]
        used.add(path)
        return np.asarray(node)

    def dense(dst, *src):
        k = get(*src, "kernel")
        sd[f"{dst}.weight"] = k.reshape(-1, k.shape[-1]).T
        sd[f"{dst}.bias"] = get(*src, "bias").reshape(-1)

    def ln(dst, *src):
        sd[f"{dst}.weight"] = get(*src, "scale")
        sd[f"{dst}.bias"] = get(*src, "bias")

    sd = {}
    for dst, src in (("word", "word"), ("position", "position"),
                     ("token_type", "type")):
        sd[f"embeddings.{dst}.weight"] = get("embeddings", src, "embedding")
    ln("embeddings.ln", "embeddings", "ln")
    i = 0
    while f"layer_{i}" in params["encoder"]:
        src, dst = ("encoder", f"layer_{i}"), f"encoder.layers.{i}."
        for name in ("query", "key", "value"):
            k = get(*src, "attention", name, "kernel")      # [H, N, D]
            sd[dst + f"attention.{name}.weight"] = k.reshape(k.shape[0], -1).T
            sd[dst + f"attention.{name}.bias"] = get(
                *src, "attention", name, "bias").reshape(-1)
        dense(dst + "attention.out", *src, "attention", "out")  # [N, D, H]
        ln(dst + "attention_ln", *src, "attention_ln")
        dense(dst + "intermediate", *src, "intermediate")
        dense(dst + "output", *src, "output")
        ln(dst + "output_ln", *src, "output_ln")
        i += 1
    dense("pooler", "pooler")
    dense("classifier", "classifier")
    total = sum(1 for _ in _leaves(params))
    if len(used) != total:
        raise ValueError(f"the flax tree holds {total} leaves, {len(used)} "
                         f"were mapped: not a tpuframe BERT")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}
