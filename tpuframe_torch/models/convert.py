"""Carry flax ``TransformerLM`` parameters (and optax Adam moments) into
the port's model.

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
