"""Chunked, fused softmax cross-entropy over a large vocabulary
(counterpart of ``tpuframe/ops/fused_xent.py``).

The ``[T, V]`` logits never exist whole: the forward walks vocab chunks
keeping running (max, sumexp, target logit, argmax) per token, the online
logsumexp of flash attention applied to the vocab axis, and the backward
recomputes each chunk's logits from the saved logsumexp instead of storing
probabilities.  Peak extra memory is a few ``[T, chunk]`` f32 blocks.  The
JAX package's version is plain JAX (a ``lax.scan`` with a custom VJP), not
a Pallas kernel, so here the loop is Python, the chunk products are
``torch.matmul`` and the VJP is a ``torch.autograd.Function``.

Products run in the hidden states' dtype with f32 accumulation and an f32
result (``preferred_element_type=f32``): both operands are rounded to that
dtype and multiplied in f32, which with TF32 off is exact in the products.
"""

from __future__ import annotations

import torch

from tpuframe_torch.models.losses import masked_mean

DEFAULT_CHUNK = 8192
NEG_INF = -1e30


def _chunk_logits(h, w, c0: int, chunk: int):
    """f32 ``[T, cw]`` logits of vocab columns ``c0 .. c0 + cw``, where
    ``cw = min(chunk, V - c0)`` (the JAX version pads V to a multiple of
    the chunk with NEG_INF columns; the last chunk is just narrower
    here)."""
    wc = w[:, c0:c0 + chunk]
    return h.float() @ wc.to(h.dtype).float(), wc


class _Fused(torch.autograd.Function):
    """``(per-token loss, argmax)`` of ``softmax(h @ w)`` against
    ``labels`` (negative = ignored: zero loss, zero gradient)."""

    @staticmethod
    def forward(ctx, h, w, labels, chunk):
        t, v = h.shape[0], w.shape[1]
        m = torch.full((t,), NEG_INF, device=h.device)
        l = torch.zeros((t,), device=h.device)
        tgt = torch.zeros((t,), device=h.device)
        arg = torch.zeros((t,), dtype=torch.int64, device=h.device)
        for c0 in range(0, v, chunk):
            s, _ = _chunk_logits(h, w, c0, chunk)
            m_c, a_c = s.max(dim=-1)
            m_new = torch.maximum(m, m_c)
            l = l * torch.exp(m - m_new) + torch.exp(
                s - m_new[:, None]).sum(dim=-1)
            # argmax rides along: an earlier chunk wins a tie
            arg = torch.where(m_c > m, a_c + c0, arg)
            loc = labels - c0
            in_c = (loc >= 0) & (loc < s.shape[1])
            picked = s.gather(1, loc.clamp(0, s.shape[1] - 1)[:, None])[:, 0]
            tgt = tgt + torch.where(in_c, picked, 0.0)
            m = m_new
        lse = m + torch.log(l)
        loss = torch.where(labels >= 0, lse - tgt, 0.0)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(arg)
        return loss, arg

    @staticmethod
    def backward(ctx, g, _):
        h, w, labels, lse = ctx.saved_tensors
        chunk = ctx.chunk
        gvec = torch.where(labels >= 0, g, 0.0)  # ignored tokens: no grad
        dh = torch.zeros(h.shape, device=h.device)
        dw = torch.empty(w.shape, device=w.device)
        for c0 in range(0, w.shape[1], chunk):
            s, wc = _chunk_logits(h, w, c0, chunk)
            p = torch.exp(s - lse[:, None])
            loc = labels - c0
            cols = torch.arange(s.shape[1], device=s.device)
            onehot = (cols[None, :] == loc[:, None]) & (loc >= 0)[:, None]
            gmat = ((p - onehot.float()) * gvec[:, None]).to(h.dtype).float()
            dh += gmat @ wc.to(h.dtype).float().T
            dw[:, c0:c0 + s.shape[1]] = h.float().T @ gmat
        return dh.to(h.dtype), dw.to(w.dtype), None, None


def fused_softmax_xent_and_argmax(hidden, w, labels, *,
                                  chunk: int = DEFAULT_CHUNK,
                                  ignore_index: int | None = None):
    """Per-token cross-entropy of ``softmax(hidden @ w)`` against
    ``labels`` and the per-token argmax, from one sweep of the vocab.

    ``hidden [..., H]``, ``w [H, V]`` (the LM head's kernel, which for the
    port's model is ``lm_head.weight.T``), ``labels [...]`` ints.  Tokens
    whose label is ``ignore_index`` get zero loss and zero gradient.
    Returns ``(loss f32, argmax int64)``, each with ``labels``' shape."""
    lead = hidden.shape[:-1]
    hid = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1).long()
    if ignore_index is not None:
        lab = torch.where(lab == ignore_index, -1, lab)
    if hid.shape[0] != lab.shape[0]:
        raise ValueError(f"hidden {tuple(hidden.shape)} / labels "
                         f"{tuple(labels.shape)} token counts differ")
    loss, arg = _Fused.apply(hid, w, lab, int(chunk))
    return loss.reshape(lead), arg.reshape(lead)


def fused_softmax_xent(hidden, w, labels, *, chunk: int = DEFAULT_CHUNK,
                       ignore_index: int | None = None):
    """Per-token losses only (see :func:`fused_softmax_xent_and_argmax`)."""
    return fused_softmax_xent_and_argmax(hidden, w, labels, chunk=chunk,
                                         ignore_index=ignore_index)[0]


def mean_xent_and_accuracy(hidden, w, labels, *, chunk: int = DEFAULT_CHUNK,
                           ignore_index: int | None = None, reduce=None):
    """(mean loss, token accuracy) through the fused head: the one
    definition the train and eval steps share.  With ``ignore_index`` both
    divide by the valid-token count, summed over ``reduce`` (a process
    group; see :func:`tpuframe_torch.models.losses.masked_mean`)."""
    per_tok, pred = fused_softmax_xent_and_argmax(
        hidden, w, labels, chunk=chunk, ignore_index=ignore_index)
    hit = (pred == labels).float()
    if ignore_index is None:
        return per_tok.mean(), hit.mean()
    return (masked_mean(per_tok, labels, ignore_index, reduce),
            masked_mean(hit, labels, ignore_index, reduce))


@torch.no_grad()
def chunked_argmax(hidden, w, *, chunk: int = DEFAULT_CHUNK):
    """argmax of ``hidden @ w`` without the whole logits."""
    lead = hidden.shape[:-1]
    hid = hidden.reshape(-1, hidden.shape[-1])
    best = torch.full((hid.shape[0],), NEG_INF, device=hid.device)
    arg = torch.zeros((hid.shape[0],), dtype=torch.int64, device=hid.device)
    for c0 in range(0, w.shape[1], chunk):
        m, a = _chunk_logits(hid, w, c0, chunk)[0].max(dim=-1)
        take = m > best
        best = torch.where(take, m, best)
        arg = torch.where(take, a + c0, arg)
    return arg.reshape(lead)
