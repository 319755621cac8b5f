"""Multi-head attention dispatch (counterpart of
``tpuframe/ops/attention.py``).

  - ``xla``: the einsum formulation, plain PyTorch here (in JAX it is XLA
    code, not a Pallas kernel).
  - ``pallas``: the flash-attention kernel, ``tpuframe_torch.ops
    .flash_attention``.  Unlike the JAX package there is no quiet fall
    back to ``xla`` for a shape: the CUDA kernel takes every sequence
    length, and on a CUDA tensor it launches or raises.

The one rule that sends ``pallas`` to the einsum is the reference's own
(``tpuframe/ops/attention.py:41-45``): the flash kernels take no dropout,
so a call with ``dropout_rate > 0`` runs the einsum with attention
dropout after the f32 softmax.  :data:`IMPLS` counts the calls by the path
taken, so a run can show which one its attention went through.

Both paths are differentiable: ``xla`` through PyTorch's autograd,
``pallas`` through the flash kernels' backward.  Selection: explicit
``impl=``, else the ``TPUFRAME_ATTN_IMPL`` env var, else ``xla``.
"""

from __future__ import annotations

import os

import torch

from tpuframe_torch.ops import flash_attention

# Calls of multihead_attention by the path taken: the flash kernel, the
# einsum without dropout, the einsum with attention dropout.
IMPLS = {"pallas": 0, "xla": 0, "xla_dropout": 0}


def resolve_impl(impl=None) -> str:
    """The attention path: ``impl``, else ``TPUFRAME_ATTN_IMPL``, else
    ``xla``; raises on any other name."""
    impl = impl or os.environ.get("TPUFRAME_ATTN_IMPL", "xla")
    if impl not in ("pallas", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    return impl


def multihead_attention(q, k, v, *, mask=None, causal=False,
                        dropout_rate: float = 0.0, dropout_seed=None,
                        impl=None, heads: tuple[int, int] | None = None):
    """q, k, v ``[B, S, N, D]``; mask ``[B, S_kv]`` (1 = keep) or, on the
    ``xla`` path, anything broadcastable to ``[B, N, S_q, S_kv]``.

    ``dropout_rate > 0`` drops attention probabilities with a mask drawn
    from a generator seeded with ``dropout_seed`` (an int), on the einsum
    path whatever ``impl`` says, as in the JAX package.  ``heads =
    (offset, total)`` says that ``q`` holds heads ``offset`` onwards of a
    layer of ``total`` (tensor parallelism): the mask is drawn for all
    ``total`` and this block's heads taken, so that the ranks together
    draw the mask of the whole layer."""
    impl = resolve_impl(impl)
    if impl == "pallas" and dropout_rate == 0.0:
        if mask is not None and mask.ndim != 2:
            raise ValueError(f"the flash kernel takes a [B, S_kv] key mask; "
                             f"got {mask.ndim}-d")
        IMPLS["pallas"] += 1
        return flash_attention.flash_mha(q, k, v, mask=mask, causal=causal)
    if mask is not None and mask.ndim == 2:
        mask = mask[:, None, None, :]
    if causal:
        tri = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                         device=q.device).tril()
        mask = tri if mask is None else tri & mask.bool()
    keep = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            raise ValueError("dropout_rate > 0 requires dropout_seed")
        gen = torch.Generator(device=q.device)
        gen.manual_seed(dropout_seed)
        b, s_q, n, _ = q.shape
        offset, total = heads or (0, n)
        keep = torch.rand((b, total, s_q, k.shape[1]), generator=gen,
                          device=q.device)[:, offset:offset + n]
        keep = keep >= dropout_rate
        IMPLS["xla_dropout"] += 1
    else:
        IMPLS["xla"] += 1
    return _xla_attention(q, k, v, mask=mask, dropout_rate=dropout_rate,
                          keep=keep)


def decode_attention(q, k_cache, v_cache, *, lengths, impl=None):
    """Decode-mode attention: one new query token against the KV-cache.

    q ``[B, 1, N, D]``; caches ``[B, S_kv, N, D]``; ``lengths [B]`` counts
    the valid cache entries.  Causality is the length mask ``arange(S_kv)
    < lengths``.  This stays plain PyTorch for every ``impl``, as in the
    JAX package (``tpuframe/ops/attention.py:decode_attention``): at query
    length 1 the scores are one cache row per head, so the einsum already
    moves only cache and query bytes.  ``impl`` is accepted for parity."""
    del impl
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention wants q [B, 1, N, D]; "
                         f"got {tuple(q.shape)}")
    s_kv = k_cache.shape[1]
    keep = (torch.arange(s_kv, device=q.device)[None, :]
            < lengths[:, None])
    return _xla_attention(q, k_cache, v_cache, mask=keep[:, None, None, :])


def _xla_attention(q, k, v, *, mask, dropout_rate: float = 0.0, keep=None):
    """``tpuframe/ops/attention.py:_xla_attention``: q pre-scaled in its own
    dtype, f32 scores (f64 for f64 inputs), masked scores filled with
    -1e9, softmax in that dtype, then,
    with ``dropout_rate > 0``, kept probabilities (``keep``, a bool
    ``[B, N, S_q, S_kv]``) scaled by ``1 / (1 - rate)`` and the rest
    zeroed, and probs cast to v's dtype for the PV product."""
    acc = torch.promote_types(q.dtype, torch.float32)   # f32, or f64
    depth = torch.tensor(q.shape[-1], dtype=torch.float32)
    scale = (1.0 / depth.sqrt().to(q.dtype)).item()
    scores = torch.einsum("bqnd,bknd->bnqk", (q * scale).to(acc), k.to(acc))
    if mask is not None:
        scores = torch.where(mask.bool(), scores, -1e9)
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate > 0.0:
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bnqk,bknd->bqnd", probs.to(v.dtype), v)
