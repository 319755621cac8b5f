"""Multi-head attention dispatch (counterpart of
``tpuframe/ops/attention.py``).

  - ``xla``: the einsum formulation, plain PyTorch here (in JAX it is XLA
    code, not a Pallas kernel).
  - ``pallas``: the flash-attention kernel, ``tpuframe_torch.ops
    .flash_attention``.  Unlike the JAX package there is no quiet fall
    back to ``xla``: the CUDA kernel takes every sequence length, and on a
    CUDA tensor it launches or raises.

Selection: explicit ``impl=``, else the ``TPUFRAME_ATTN_IMPL`` env var,
else ``xla``.  The port serves only, so there is no dropout.
"""

from __future__ import annotations

import os

import torch

from tpuframe_torch.ops import flash_attention


def multihead_attention(q, k, v, *, mask=None, causal=False, impl=None):
    """q, k, v ``[B, S, N, D]``; mask ``[B, S_kv]`` (1 = keep) or, on the
    ``xla`` path, anything broadcastable to ``[B, N, S_q, S_kv]``."""
    impl = impl or os.environ.get("TPUFRAME_ATTN_IMPL", "xla")
    if impl == "pallas":
        if mask is not None and mask.ndim != 2:
            raise ValueError(f"the flash kernel takes a [B, S_kv] key mask; "
                             f"got {mask.ndim}-d")
        return flash_attention.flash_mha(q, k, v, mask=mask, causal=causal)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    if mask is not None and mask.ndim == 2:
        mask = mask[:, None, None, :]
    if causal:
        tri = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                         device=q.device).tril()
        mask = tri if mask is None else tri & mask.bool()
    return _xla_attention(q, k, v, mask=mask)


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


def _xla_attention(q, k, v, *, mask):
    """``tpuframe/ops/attention.py:_xla_attention``: q pre-scaled in its own
    dtype, f32 scores, masked scores filled with -1e9, f32 softmax, probs
    cast to v's dtype for the PV product."""
    depth = torch.tensor(q.shape[-1], dtype=torch.float32)
    scale = (1.0 / depth.sqrt().to(q.dtype)).item()
    scores = torch.einsum("bqnd,bknd->bnqk", (q * scale).float(), k.float())
    if mask is not None:
        scores = torch.where(mask.bool(), scores, -1e9)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", probs, v)
