"""Sequence parallelism: ring attention and Ulysses (counterpart of
``tpuframe/ops/seq_parallel.py``).

Both run over a seq ring (``parallel/mesh.py``'s ``SeqGroup``): each rank
holds one chunk ``[B, S/n, N, D]`` of the sequence, rank ``i`` the
positions ``[i*S/n, (i+1)*S/n)``.

  * **Ring attention**: K/V chunks rotate round the ring
    (``collectives.ring_rotate``); each rank merges its query chunk's
    attention over every K/V chunk, so the ``S x S`` scores never exist on
    one rank.  The rotation's backward sends each visiting chunk's
    ``dk``/``dv`` back to its owner.  ``n - 1`` rotations a call: the JAX
    scan also rotates after its last stage, which returns the chunks to
    their owners unused.
  * **Ulysses**: two all-to-alls re-shard ``[B, S/n, N, D] -> [B, S,
    N/n, D]`` and back, so each rank runs whole-sequence attention
    (``ops/attention.py``, the flash kernels on ``pallas``) on ``N/n``
    heads.

``impl`` picks the ring's stages as ``ops/attention.py`` picks its path
(``attention.resolve_impl``): the explicit argument, else
``TPUFRAME_ATTN_IMPL``, else ``xla``.  ``xla`` is the plain f32 stages
(:func:`_chunk_attn`), each under ``torch.utils.checkpoint`` so the
backward keeps the rotated chunks and not a stage's scores; ``pallas``
runs each stage through the flash kernels
(``flash_attention.flash_mha_lse``) and merges the stages by their
logsumexp rows, the lse cotangent flowing into the kernels' backward.
Differences from the JAX module, on purpose: it keeps the XLA stages on
its Pallas interpreter (the CPU), where the port's flash wrappers run
their plain versions on CPU tensors, so the port takes the flash stages
whenever they are asked for; and, as ``ops/attention.py`` does, it never
falls back to ``xla`` for a shape (the CUDA kernels take every sequence
length; a key mask that is not ``[B, S/n]`` raises).  The flash stages are
not checkpointed either: a stage saves its inputs and its lse rows, never
its scores, so a checkpoint would only run its forward kernel once more.
"""

from __future__ import annotations

import torch
from torch.utils import checkpoint

from tpuframe_torch.ops import attention as attn_ops
from tpuframe_torch.ops import flash_attention as fa
from tpuframe_torch.parallel import collectives

NEG_INF = -1e30  # flash_attention.NEG_INF


def _chunk_attn_whole(q, k, v, keep, scale):
    """Unnormalised blockwise attention in f32, scores whole.

    q ``[B, Cq, N, D]``; k, v ``[B, Ck, N, D]``; keep ``[B or 1, 1, Cq,
    Ck]`` bool or None.  Returns ``(acc [B, Cq, N, D], m [B, N, Cq], l
    [B, N, Cq])``, all f32; a fully masked row keeps ``acc = l = 0``
    exactly."""
    s = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    if keep is not None:
        p = torch.where(keep, p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bnqk,bknd->bqnd", p, v.float())
    return acc, m, l


def _chunk_attn(q, k, v, keep, scale, q_chunk=None):
    """:func:`_chunk_attn_whole` over query sub-chunks of ``q_chunk`` rows,
    each checkpointed, so at most one ``[B, N, q_chunk, Ck]`` score block
    is live in the forward and in the backward.  Rows are independent
    given the K/V chunk, so the results concatenate exactly."""
    cq = q.shape[1]
    if q_chunk is None or cq <= q_chunk:
        return _chunk_attn_whole(q, k, v, keep, scale)
    parts = []
    for lo in range(0, cq, q_chunk):
        sub = (keep if keep is None or keep.shape[2] == 1
               else keep[:, :, lo:lo + q_chunk])
        parts.append(checkpoint.checkpoint(
            _chunk_attn_whole, q[:, lo:lo + q_chunk], k, v, sub, scale,
            use_reentrant=False))
    acc, m, l = zip(*parts)
    return torch.cat(acc, 1), torch.cat(m, -1), torch.cat(l, -1)


def _ring(seq):
    if seq is None:
        raise ValueError("sequence-parallel attention needs a seq ring "
                         "(seq=, a parallel.mesh.SeqGroup)")
    return seq


def _t(x):
    """``[B, N, C]`` row statistics as ``[B, C, N, 1]``."""
    return x.transpose(1, 2)[..., None]


def ring_attention(q, k, v, *, seq=None, mask=None, causal: bool = False,
                   q_chunk: int | None = 1024, impl: str | None = None):
    """Exact attention over a sequence sharded round the ring ``seq`` (a
    ``mesh.SeqGroup``; raises without one).

    q, k, v ``[B, S/n, N, D]``: this rank's chunk; ``mask`` ``[B, S/n]``
    (nonzero = attend) for its keys.  Returns the local queries'
    attention over the whole sequence, ``[B, S/n, N, D]`` in q's dtype.
    ``causal`` masks by global position.  ``q_chunk`` bounds the plain
    stages' live score block (None: whole chunks); the flash stages never
    hold one."""
    seq = _ring(seq)
    if mask is not None:
        if mask.ndim != 2:
            raise ValueError(f"ring attention takes a [B, S/n] key mask; "
                             f"got {mask.ndim}-d")
        mask = (mask != 0).to(torch.int32)
    if attn_ops.resolve_impl(impl) == "pallas":
        return _ring_flash(q, k, v, seq=seq, mask=mask, causal=causal)
    n, my = seq.size, seq.index
    b, c, heads, d = q.shape
    scale = d ** -0.5

    def stage(qq, kk, vv, kmask, owner):
        # the keep mask is built inside, so the checkpoint recomputes it
        keep = None
        if kmask is not None:
            keep = (kmask != 0)[:, None, None, :]
        if causal:
            q_pos = my * c + torch.arange(c, device=q.device)[:, None]
            kv_pos = owner * c + torch.arange(c, device=q.device)[None, :]
            tri = (q_pos >= kv_pos)[None, None]
            keep = tri if keep is None else keep & tri
        return _chunk_attn(qq, kk, vv, keep, scale, q_chunk=q_chunk)

    acc = torch.zeros((b, c, heads, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, heads, c), NEG_INF, device=q.device)
    l = torch.zeros((b, heads, c), device=q.device)
    kk, vv, km = k, v, mask
    for i in range(n):
        owner = (my - i) % n
        acc_c, m_c, l_c = checkpoint.checkpoint(
            stage, q, kk, vv, km, owner, use_reentrant=False)
        m_new = torch.maximum(m, m_c)
        a1, a2 = torch.exp(m - m_new), torch.exp(m_c - m_new)
        acc = acc * _t(a1) + acc_c * _t(a2)
        l = l * a1 + l_c * a2
        m = m_new
        if i < n - 1:
            kk, vv = collectives.ring_rotate((kk, vv), seq)
            if km is not None:
                (km,) = collectives.ring_rotate((km,), seq)
    l = _t(l)
    return (acc / torch.where(l == 0.0, 1.0, l)).to(q.dtype)


class _Above(torch.autograd.Function):
    """A stage wholly above the diagonal: no launch, a zero output, lse
    ``NEG_INF`` and zero gradients.  It keeps the visiting chunk in the
    graph, so that the rotation that brought it runs its backward on this
    rank too: the ring's collectives match on every rank."""

    @staticmethod
    def forward(ctx, q, k, v):
        b, c, n, _ = q.shape
        ctx.meta = [(t.shape, t.dtype) for t in (q, k, v)]
        ctx.device = q.device
        return (torch.zeros_like(q),
                torch.full((b, n, c), NEG_INF, device=q.device))

    @staticmethod
    def backward(ctx, do, dlse):
        return tuple(torch.zeros(shape, dtype=dtype, device=ctx.device)
                     for shape, dtype in ctx.meta)


def _ring_flash(q, k, v, *, seq, mask, causal):
    """Ring attention with flash-kernel stages.  Each stage gives the
    kernel's normalised output and its logsumexp rows; the stages merge
    exactly as

        LSE' = logaddexp(LSE, lse_i)
        out' = out * exp(LSE - LSE') + out_i * exp(lse_i - LSE')

    and both merge factors carry gradient: ``flash_mha_lse``'s backward
    folds the lse cotangent into its delta rows.  The stage's kind comes
    from the chunk's owner: below the diagonal non-causal, on it causal,
    above it nothing (:class:`_Above`)."""
    n, my = seq.size, seq.index
    b, c, heads, d = q.shape
    out = torch.zeros((b, c, heads, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, heads, c), NEG_INF, device=q.device)
    kk, vv, km = k, v, mask
    for i in range(n):
        owner = (my - i) % n
        if causal and owner > my:
            o_i, lse_i = _Above.apply(q, kk, vv)
        else:
            o_i, lse_i = fa.flash_mha_lse(q, kk, vv, mask=km,
                                          causal=causal and owner == my)
        lse_new = torch.logaddexp(lse, lse_i)
        w1, w2 = torch.exp(lse - lse_new), torch.exp(lse_i - lse_new)
        out = out * _t(w1) + o_i.float() * _t(w2)
        lse = lse_new
        if i < n - 1:
            kk, vv = collectives.ring_rotate((kk, vv), seq)
            if km is not None:
                (km,) = collectives.ring_rotate((km,), seq)
    return out.to(q.dtype)


def ulysses_attention(q, k, v, *, seq=None, mask=None, causal: bool = False,
                      impl: str | None = None):
    """All-to-all (DeepSpeed-Ulysses) sequence-parallel attention over the
    ring ``seq`` (raises without one): re-shard seq -> heads, run
    ``ops/attention.multihead_attention`` over the whole sequence on
    ``N/n`` heads (the flash kernels on ``pallas``), re-shard back.
    Raises unless ``heads % n == 0``.  ``mask`` ``[B, S/n]`` is gathered
    to ``[B, S]``."""
    seq = _ring(seq)
    n, heads = seq.size, q.shape[2]
    if heads % n:
        raise ValueError(f"ulysses needs heads ({heads}) % seq ring ({n}) "
                         f"== 0")
    qh, kh, vh = (collectives.seq_to_heads(x, seq) for x in (q, k, v))
    full_mask = None
    if mask is not None:
        full_mask = collectives.gather_seq((mask != 0).to(torch.int32), seq)
    out = attn_ops.multihead_attention(qh, kh, vh, mask=full_mask,
                                       causal=causal, impl=impl)
    return collectives.heads_to_seq(out, seq)
