"""Carry flax ``TransformerLM`` and ``ScanBlockLM`` parameters (and optax
Adam moments), flax ResNet parameters and batch statistics, flax BERT parameters and the flax
MNIST ConvNet's parameters into the port's models, and whole JAX training
states (a ``TrainState`` checkpoint: parameters, statistics, optimizer
moments and step) into the port's model and optimizer
(:func:`train_state_from_jax`), a JAX ZeRO-1 state's flat moments to each
rank's chunks of the port's flat layout and back (:func:`flat_order`),
and a JAX leaf's partition spec to the port tensor's (:func:`jax_view`,
:func:`spec_to_port`), so that both packages split the same logical
blocks.

The flax tree (``{"embed": {"embedding"}, "block_<i>": {...},
"final_ln": {"scale"}, "lm_head": {"kernel"}}``) arrives as nested dicts of
numpy arrays, so this module needs no jax.  Layouts differ in two ways:

  - ``Dense`` kernels are ``[in, out]``; ``nn.Linear.weight`` is
    ``[out, in]``: transposed.
  - ``DenseGeneral`` kernels keep the head axes: query/key/value are
    ``[H, N, D]`` and out is ``[N, D, H]``: flattened to ``[H, N*D]`` /
    ``[N*D, H]``, then transposed.

``ScanBlockLM``'s blocks are layer-stacked on both sides
(``blocks/block/...`` ``[L, ...]`` there, ``blocks.<name>`` ``[L, ...]``
here): each layer maps as a ``TransformerLM`` block does
(:func:`scan_params_from_jax`, :func:`scan_params_to_jax`), and a
pipeline stage's slice of a leaf is its block on dim 0 (the
``blocks=`` argument of :func:`train_state_from_jax` with
``parallel/pp_lm.state_partition``'s specs).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np
import torch

from tpuframe_torch.parallel import tp
from tpuframe_torch.parallel.zero1 import chunk_len, flat_pad, padded_len


def params_from_jax(params) -> dict:
    """flax ``params`` (nested dicts of numpy arrays) → the port model's
    ``state_dict`` (f32 tensors on the CPU).  An MoE block's ``moe``
    leaves map to ``moe.router.weight`` (the ``[H, E]`` kernel
    transposed), ``moe.up_experts`` ``[E, H, I]`` and
    ``moe.down_experts`` ``[E, I, H]`` as they are.  Raises on a tree
    that holds leaves the model does not have."""
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
        if "moe" in blk and "up" not in blk:
            moe = blk["moe"]
            sd[pre + "moe.router.weight"] = np.asarray(
                moe["router"]["kernel"]).T
            sd[pre + "moe.up_experts"] = moe["up_experts"]
            sd[pre + "moe.down_experts"] = moe["down_experts"]
            n_leaves += 9
        else:
            sd[pre + "up.weight"] = np.asarray(blk["up"]["kernel"]).T
            sd[pre + "down.weight"] = np.asarray(blk["down"]["kernel"]).T
            n_leaves += 8
        i += 1
    total = sum(1 for _ in _leaves(params))
    if total != n_leaves:
        raise ValueError(f"params hold {total} leaves, the model "
                         f"{n_leaves}: not a TransformerLM tree")
    # np.array copies: arrays that come from jax are read-only.
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def lm_params_to_jax(sd: dict, num_heads: int) -> dict:
    """The inverse of :func:`params_from_jax` for a model of
    ``num_heads`` heads: a whole (unsharded) ``TransformerLM``
    ``state_dict`` (tensors or arrays) → flax ``params``, nested dicts of
    f32 numpy arrays.  Raises on a name it does not map."""
    def a(name):
        v = sd[name]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
        return np.array(v, dtype=np.float32)

    used = set()

    def take(name):
        used.add(name)
        return a(name)

    out = {"embed": {"embedding": take("embed.weight")},
           "final_ln": {"scale": take("final_ln.weight")},
           "lm_head": {"kernel": take("lm_head.weight").T}}
    i = 0
    while f"blocks.{i}.attn_ln.weight" in sd:
        pre = f"blocks.{i}."
        attn = {}
        for name in ("query", "key", "value"):
            w = take(pre + f"attn.{name}.weight")            # [N*D, H]
            attn[name] = {"kernel": w.T.reshape(w.shape[1], num_heads, -1)}
        w = take(pre + "attn.out.weight")                    # [H, N*D]
        attn["out"] = {"kernel": w.T.reshape(num_heads, -1, w.shape[0])}
        blk = {"attn": attn,
               "attn_ln": {"scale": take(pre + "attn_ln.weight")},
               "mlp_ln": {"scale": take(pre + "mlp_ln.weight")}}
        if pre + "moe.router.weight" in sd:
            blk["moe"] = {
                "router": {"kernel": take(pre + "moe.router.weight").T},
                "up_experts": take(pre + "moe.up_experts"),
                "down_experts": take(pre + "moe.down_experts")}
        else:
            blk["up"] = {"kernel": take(pre + "up.weight").T}
            blk["down"] = {"kernel": take(pre + "down.weight").T}
        out[f"block_{i}"] = blk
        i += 1
    if set(sd) != used:
        raise ValueError(f"unmapped TransformerLM leaves: "
                         f"{sorted(set(sd) - used)}")
    return out


def _unstack(params) -> dict:
    """A ``ScanBlockLM`` flax tree with its ``blocks/block`` leaves
    (``[L, ...]``) cut into ``block_<i>`` subtrees: a ``TransformerLM``
    tree."""
    if set(params.get("blocks", {})) != {"block"}:
        raise ValueError("not a ScanBlockLM tree: want blocks/block")
    stacked = list(_paths(params["blocks"]["block"]))
    n = {np.asarray(leaf).shape[0] for _, leaf in stacked}
    if len(n) != 1:
        raise ValueError(f"blocks/block leaves hold {sorted(n)} layers")
    out = {k: v for k, v in params.items() if k != "blocks"}
    for i in range(n.pop()):
        out[f"block_{i}"] = _build((path, np.asarray(leaf)[i])
                                   for path, leaf in stacked)
    return out


_LAYER = re.compile(r"^blocks\.(\d+)\.(.+)$")


def scan_params_from_jax(params) -> dict:
    """A flax ``ScanBlockLM``'s ``params`` (its blocks stacked as
    ``params/blocks/block/...`` ``[L, ...]``) → the port ``ScanBlockLM``'s
    ``state_dict``: each layer mapped as :func:`params_from_jax` maps a
    ``TransformerLM`` block, then stacked again as ``blocks.<name>``
    ``[L, ...]``."""
    sd = params_from_jax(_unstack(params))
    out, layers = {}, {}
    for k, v in sd.items():
        m = _LAYER.match(k)
        if m is None:
            out[k] = v
        else:
            layers.setdefault(m.group(2), {})[int(m.group(1))] = v
    for name, by_layer in layers.items():
        out[f"blocks.{name}"] = torch.stack(
            [by_layer[i] for i in range(len(by_layer))])
    return out


def scan_params_to_jax(sd: dict, num_heads: int) -> dict:
    """The inverse of :func:`scan_params_from_jax`: a whole port
    ``ScanBlockLM`` ``state_dict`` → flax ``params`` with the blocks
    stacked under ``blocks/block``."""
    flat, n = {}, None
    for k, v in sd.items():
        if not k.startswith("blocks."):
            flat[k] = v
            continue
        v = v.detach().cpu() if isinstance(v, torch.Tensor) else \
            torch.from_numpy(np.asarray(v))
        n = v.shape[0]
        for i in range(n):
            flat[f"blocks.{i}.{k[len('blocks.'):]}"] = v[i]
    tree = lm_params_to_jax(flat, num_heads)
    blocks = [tree.pop(f"block_{i}") for i in range(n or 0)]
    tree["blocks"] = {"block": _build(
        (path, np.stack([_at(b, path) for b in blocks]))
        for path, _ in _paths(blocks[0]))}
    return tree


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


def convnet_from_jax(params) -> dict:
    """A flax ``tpuframe.models.convnet.ConvNet``'s ``params`` → the port
    ConvNet's ``state_dict`` (f32 CPU tensors): ``Conv_0``, ``Conv_1`` →
    ``conv1``, ``conv2`` (kernels ``HWIO`` → ``OIHW``), ``Dense_0``,
    ``Dense_1`` → ``fc1``, ``fc2`` (kernels transposed); biases as they
    are.  Raises on a tree that leaves a leaf unmapped."""
    sd = {}
    for src, dst, kernel in (("Conv_0", "conv1", _conv),
                             ("Conv_1", "conv2", _conv),
                             ("Dense_0", "fc1", lambda k: np.asarray(k).T),
                             ("Dense_1", "fc2", lambda k: np.asarray(k).T)):
        sd[f"{dst}.weight"] = kernel(params[src]["kernel"])
        sd[f"{dst}.bias"] = params[src]["bias"]
    total = sum(1 for _ in _leaves(params))
    if total != len(sd):
        raise ValueError(f"the flax tree holds {total} leaves, {len(sd)} "
                         f"were mapped: not a tpuframe ConvNet")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in sd.items()}


def resnet_from_jax(params, batch_stats) -> dict:
    """A flax ``tpuframe.models.resnet.ResNet``'s ``params`` and
    ``batch_stats`` (nested dicts of numpy arrays), built with any ``bn``,
    ``stem`` and ``remat`` → the port ResNet's ``state_dict`` (f32 CPU
    tensors, torchvision's names).

    Flax names its blocks ``<Block>_<n>`` with one running index across
    stages (``remat`` keeps these names); a stage opens at block 0 and at
    each later block that has a downsample.  The space-to-depth stem's
    ``[4, 4, 12, O]`` kernel maps as any conv kernel.  In a block, flax's
    ``Conv_j``/``BatchNorm_j`` (``FoldedBatchNorm_j`` under
    ``bn="folded"``) are the ``conv{j+1}``/``bn{j+1}`` pairs in order;
    under ``bn="fused"`` the
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
            norm = ("FoldedBatchNorm" if "FoldedBatchNorm_0" in blk
                    else "BatchNorm")
            j = 0
            while f"Conv_{j}" in blk:
                pair(pre + f"conv{j + 1}", pre + f"bn{j + 1}",
                     (b, f"Conv_{j}"), (b, f"{norm}_{j}"))
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


@dataclass(frozen=True)
class JaxView:
    """How a port tensor (of any model the port maps) holds its JAX
    leaf: the leaf's ``shape`` and, for each of its dims,
    ``(port dim, part)``: the port dim it lies along and whether it is
    that dim ``"whole"``, or the ``"outer"`` or ``"inner"`` factor of a
    flattened one (the head kernels' ``N*D``: heads outer, head dim
    inner)."""

    shape: tuple
    dims: tuple

    @property
    def port_ndim(self) -> int:
        return 1 + max((d for d, _ in self.dims), default=-1)


# the port names whose JAX leaf has another layout
_QKV = re.compile(r"(attn|attention)\.(query|key|value)\.weight$")
_QKV_BIAS = re.compile(r"attention\.(query|key|value)\.bias$")
_OUT = re.compile(r"(attn|attention)\.out\.weight$")
# a ScanBlockLM block leaf: ``blocks.<name>`` with no layer index
_STACKED = re.compile(r"^blocks\.(?!\d+\.)")
_EMBEDDING = re.compile(r"(^embed|embeddings\.(word|position|token_type))"
                        r"\.weight$")


def jax_view(name: str, shape: tuple, num_heads: int) -> JaxView:
    """The :class:`JaxView` of the port's whole tensor ``name`` of
    ``shape`` (a parameter, or its moment) in a model of ``num_heads``
    heads (1 for the image models): query/key/value ``[N*D, H]`` hold
    the JAX ``[H, N, D]``, their BERT biases ``[N*D]`` the ``[N, D]``,
    out ``[H, N*D]`` the ``[N, D, H]``; a 4-d tensor is a convolution's
    ``[O, I, kh, kw]`` kernel, flax's ``HWIO``; every other 2-d tensor
    but an embedding table is a transposed ``Dense`` kernel (the image
    models' classifiers among them); the rest (embeddings, LayerNorms,
    BatchNorm scales and biases, biases, the MoE experts) are as the JAX
    leaf."""
    shape = tuple(shape)
    if _STACKED.match(name):
        # a ScanBlockLM leaf: the per-layer view behind the layer dim
        inner = jax_view("blocks.0." + name[len("blocks."):], shape[1:],
                         num_heads)
        return JaxView((shape[0], *inner.shape),
                       ((0, "whole"), *((d + 1, part)
                                        for d, part in inner.dims)))
    if _QKV.search(name):
        return JaxView((shape[1], num_heads, shape[0] // num_heads),
                       ((1, "whole"), (0, "outer"), (0, "inner")))
    if _QKV_BIAS.search(name):
        return JaxView((num_heads, shape[0] // num_heads),
                       ((0, "outer"), (0, "inner")))
    if _OUT.search(name):
        return JaxView((num_heads, shape[1] // num_heads, shape[0]),
                       ((1, "outer"), (1, "inner"), (0, "whole")))
    if len(shape) == 4:
        return JaxView((shape[2], shape[3], shape[1], shape[0]),
                       ((2, "whole"), (3, "whole"), (1, "whole"),
                        (0, "whole")))
    if len(shape) == 2 and not _EMBEDDING.search(name):
        return JaxView(shape[::-1], ((1, "whole"), (0, "whole")))
    return JaxView(shape, tuple((d, "whole") for d in range(len(shape))))


def spec_to_port(view: JaxView, spec, name: str = "") -> tuple:
    """A JAX leaf's partition spec (an axis name or None a dim; shorter
    specs pad with None) → the port tensor's.  A split of a flattened
    dim's outer factor is a contiguous block of the port dim; a split of
    its inner factor (the head dim under several heads) is a strided one,
    which the port's blocks cannot hold: raises ValueError."""
    out = [None] * view.port_ndim
    for j, axis in enumerate(tuple(spec or ())[:len(view.dims)]):
        if axis is None:
            continue
        d, part = view.dims[j]
        if part == "inner" and view.shape[j - 1] > 1:
            raise ValueError(
                f"{name}: the JAX placement splits dim {j} of {view.shape} "
                f"(the head dim, inside the port's flattened heads x head "
                f"dim) over {axis!r}: a strided block the port cannot hold; "
                f"the port refuses this mesh")
        out[d] = axis
    return tuple(out)


def spec_to_jax(view: JaxView, spec) -> tuple:
    """The port tensor's spec → the JAX leaf's (a split port dim that
    holds flattened heads splits the heads)."""
    spec = tuple(spec or ())
    return tuple(spec[d] if part != "inner" and d < len(spec) else None
                 for d, part in view.dims)


_MOMENTS = ("mu", "nu", "trace")
_JAX_STATE_KEYS = {"step", "params", "opt_state", "model_state", "rng"}


def _param_map(family: str, stats):
    """The family's map of a flax params tree (or a tree shaped like it)
    to the port's parameters, by name."""
    if family == "transformer-lm":
        return params_from_jax
    if family == "transformer-lm-pp":
        return scan_params_from_jax
    if family.startswith("resnet"):
        if stats is None:
            raise ValueError("a ResNet TrainState needs "
                             "model_state/batch_stats")

        def to_port(p):
            return {k: v for k, v in resnet_from_jax(p, stats).items()
                    if not k.endswith(("running_mean", "running_var"))}

        return to_port
    if family == "bert-base":
        return bert_params_from_jax
    if family == "convnet":
        return convnet_from_jax
    raise ValueError(f"no JAX TrainState map for model {family!r}")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _paths(sub, (*prefix, key))
    else:
        yield prefix, tree


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _build(pairs) -> dict:
    out: dict = {}
    for path, leaf in pairs:
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


_DIGIT = 4096      # f32 holds every integer below 2^24 exactly


def flat_order(params, family: str, batch_stats=None) -> dict:
    """``{port parameter name: (flax leaf path, order)}``: ``order[k]`` is
    the index, in the flax leaf flattened row-major, of the port
    parameter's element ``k`` (flattened in its logical order).  Found by
    running the family's map over trees of leaf ids and of element
    indices (as two base-4096 digits, which f32 carries exactly), so it
    follows every transpose and reshape the map makes."""
    to_port = _param_map(family, batch_stats)
    leaves = list(_paths(params))

    def tree(fill):
        return _build((path, fill(i, np.asarray(leaf)))
                      for i, (path, leaf) in enumerate(leaves))

    ids = to_port(tree(lambda i, a: np.full(a.shape, i, np.float32)))
    hi = to_port(tree(lambda i, a: (np.arange(a.size) // _DIGIT)
                      .reshape(a.shape).astype(np.float32)))
    lo = to_port(tree(lambda i, a: (np.arange(a.size) % _DIGIT)
                      .reshape(a.shape).astype(np.float32)))
    out = {}
    for name, t in ids.items():
        leaf = {int(v) for v in t.reshape(-1).tolist()}
        if len(leaf) != 1:
            raise ValueError(f"{name} mixes flax leaves {sorted(leaf)}: not "
                             f"a one-leaf map")
        order = (hi[name].reshape(-1).long() * _DIGIT
                 + lo[name].reshape(-1).long())
        out[name] = (leaves[leaf.pop()][0], order)
    return out


def zero1_moments_from_jax(moment, order: dict, n: int, index: int) -> dict:
    """One moment of a JAX ZeRO-1 state (a tree shaped like the flax
    params whose leaves are flat ``[padded]`` vectors, of any world) →
    rank ``index``'s ``[padded / n]`` chunks of the port's flat layout
    over ``n`` ranks, by port parameter name (``order`` from
    :func:`flat_order`)."""
    out = {}
    for name, (path, idx) in order.items():
        v = np.asarray(_at(moment, path)).reshape(-1)
        full = torch.from_numpy(np.array(v[idx.numpy()], dtype=np.float32))
        c = chunk_len(full.numel(), n)
        out[name] = flat_pad(full, n)[index * c:(index + 1) * c].clone()
    return out


def zero1_moments_to_jax(moments: dict, order: dict, n: int) -> dict:
    """The inverse of :func:`zero1_moments_from_jax` over whole vectors:
    the port's flat moments by name (each at least its parameter's size
    long: a whole ``[padded]`` vector, gathered or read from a
    checkpoint) → the JAX ZeRO-1 layout over ``n`` ranks, a tree shaped
    like the flax params of flat f32 ``[padded]`` numpy vectors."""
    pairs = []
    for name, (path, idx) in order.items():
        size = idx.numel()
        v = np.zeros(padded_len(size, n), np.float32)
        v[idx.numpy()] = np.asarray(moments[name], np.float32)[:size]
        pairs.append((path, v))
    return _build(pairs)


def train_state_from_jax(tree, family: str, *, zero1: tuple | None = None,
                         blocks: tuple | None = None):
    """A JAX ``TrainState`` checkpoint, as ``tpuframe.ckpt.restore(dir,
    step)`` (or the port's ``ckpt.restore``) returns it without a target,
    → ``(model state_dict, optimizer state_dict, step)`` for the port's
    model of ``family`` (``transformer-lm``, ``transformer-lm-pp``,
    ``resnet*``, ``bert-base``,
    ``convnet``) and its :class:`~tpuframe_torch.utils.optim.Optimizer`.

    The optax chain's state is a nest of tuples whose indices depend on
    the chain (clip or not, decay or not), so the moments are found by key
    under ``opt_state`` (``mu``/``nu`` for adamw, ``trace`` for sgd and
    lars) and mapped with the family's parameter map, as
    :func:`adam_state_from_jax` does; ``count`` is the update count, the
    moment's own or the schedule's (they must agree).  The JAX ``rng``
    leaf is dropped: the port draws dropout and augmentation from
    ``dropout_seed(seed, step, rank)``, not from a saved key, so a resumed
    run's draws differ from the JAX run's.  Any other leaf that maps
    nowhere raises.

    ``zero1=(n, index)``: the JAX state is in the ZeRO-1 layout (its
    moments flat ``[padded]`` vectors, ``tpuframe.parallel.zero1``'s
    ``make_state``), and the moments come back as rank ``index``'s chunks
    of the port's layout over ``n`` ranks (:func:`flat_order`), for an
    optimizer built with ``shards=(n, index)``.

    ``blocks=(specs, sizes, coords)``: the state of a sharded-state run
    (fsdp, tensor or expert parallelism; the JAX checkpoint's leaves come
    back whole, however the JAX run placed them), cut to the blocks the
    rank at ``coords`` of a mesh of ``sizes`` holds of each parameter
    and moment named in ``specs`` (port specs, as
    ``parallel/fsdp.state_shardings`` gives them)."""
    if blocks is not None and zero1 is not None:
        raise ValueError("zero1= and blocks= are two layouts of one state")
    params = tree["params"]
    extra = set(tree) - _JAX_STATE_KEYS
    model_state = dict(tree.get("model_state") or {})
    stats = model_state.pop("batch_stats", None)
    if extra or model_state:
        raise ValueError(f"unmapped JAX TrainState leaves: "
                         f"{sorted(extra | set(model_state))}")
    to_port = _param_map(family, stats)
    if stats is not None and not family.startswith("resnet"):
        raise ValueError(f"{family}: unmapped model_state/batch_stats")
    moment_map = to_port
    if zero1 is not None:
        order = flat_order(params, family, stats)

        def moment_map(moment):
            return zero1_moments_from_jax(moment, order, *zero1)

    moments: dict = {}
    counts: list[int] = []

    def walk(node, path):
        for key, sub in node.items():
            where = f"{path}/{key}"
            if key in _MOMENTS and isinstance(sub, dict):
                if key in moments:
                    raise ValueError(f"two {key} moments under opt_state")
                moments[key] = moment_map(sub)
            elif key == "count" and not isinstance(sub, dict):
                counts.append(int(np.asarray(sub)))
            elif isinstance(sub, dict):
                walk(sub, where)
            else:
                raise ValueError(f"unmapped JAX optimizer leaf {where}")

    walk(tree["opt_state"], "opt_state")
    if not counts or len(set(counts)) != 1:
        raise ValueError(f"opt_state update counts {counts}: want one "
                         f"value")
    if set(moments) not in ({"mu", "nu"}, {"trace"}):
        raise ValueError(f"opt_state holds moments {sorted(moments)}: "
                         f"neither adamw's mu/nu nor sgd's or lars' trace")
    model = (resnet_from_jax(params, stats) if family.startswith("resnet")
             else to_port(params))
    if blocks is not None:
        specs, sizes, coords = blocks

        def cut(tensors):
            return {k: tp.cut(v, specs[k], sizes, coords) if k in specs
                    else v for k, v in tensors.items()}

        model = cut(model)
        moments = {k: cut(v) for k, v in moments.items()}
    return (model, {"count": counts[0], **moments},
            int(np.asarray(tree["step"])))
