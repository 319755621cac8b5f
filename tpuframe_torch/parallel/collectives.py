"""The data-parallel world and its collectives, on ``torch.distributed``
(counterpart of ``tpuframe/parallel/collectives.py``).

The JAX package names mesh axes and reduces over them with ``psum`` /
``pmean`` inside its compiled step.  Here the world is the default process
group that ``tpuframe_torch.parallel.bootstrap.initialize`` makes from the
launcher's environment (NCCL on the card, gloo on the CPU, or the backend
``TPUFRAME_DIST_BACKEND`` names), or a world of one when there is no
group, where every collective is the identity.

Each collective takes the group it runs over: :func:`group` (None in a
world of one: the train step's shortcut) or :func:`process_group` (the
default group whenever one exists: the ``hvd`` verbs, which go through
``torch.distributed`` even in a world of one).  A ``None`` group is the
identity.  Ranks are the group's, and the group spans the world.

gloo takes CUDA tensors for some verbs only (:data:`GLOO_CUDA_VERBS`); the
others (point-to-point: Adasum) raise, naming the verb and the backend,
and nothing is staged through the host by this module.

The sequence-parallel verbs (:func:`ring_rotate`, :func:`seq_to_heads`,
:func:`heads_to_seq`, :func:`gather_seq`) run over a seq ring's own group
(``parallel/mesh.py``) and are differentiable, each the transpose of the
other's backward as in JAX.  They are built on the verbs gloo takes on
CUDA, so one code path serves gloo and NCCL: the ring rotation, JAX's
``lax.ppermute``, is an ``all_to_all_single`` whose splits send the whole
chunk to the next rank and take the whole of the previous rank's.
:data:`SEQ_BYTES` counts the bytes each verb sent to other ranks.

The pipeline's verbs (:func:`pipe_rotate`, JAX's ``ppermute`` over the
``pipe`` axis; :func:`last_stage_value`; :func:`pipe_broadcast_`;
:func:`pipe_sum`) run over a pipe group and are built the same way, the
rotation as an ``all_to_all_single`` whose splits carry the whole tensor
on the one leg that is used; :data:`PIPE_CALLS` and :data:`PIPE_BYTES`
count them.

The gradient wire of the ZeRO-1 and int8-block paths (``parallel/zero1.py``,
``parallel/quantwire.py``) runs on :func:`reduce_scatter_start` (the tiled
reduce-scatter, JAX's ``psum_scatter(tiled=True)``),
:func:`all_gather_start` (the tiled all-gather, ``allgather_invariant``),
:func:`all_to_all_start` and :func:`wire_mean_`, each counted in
:data:`WIRE_BYTES` and :data:`WIRE_CALLS`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.distributed as dist

# The verbs this module calls whose gloo implementation takes CUDA
# tensors.  torch.distributed's backend table lists all_reduce and
# broadcast; on an H100 with torch 2.11 (chip_smoke.py's hvd phase) gloo
# also gave the right results for all_gather, all_gather_into_tensor and
# all_to_all_single (and reduce, gather, scatter, reduce_scatter_tensor),
# while its point-to-point sends failed.  chip_smoke.py's zero1 phase holds
# the reduce-scatter's results on CUDA tensors under gloo bit for bit.
GLOO_CUDA_VERBS = frozenset({"all_reduce", "broadcast", "all_gather",
                             "all_to_all", "reduce_scatter"})

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def world() -> tuple[int, int]:
    """``(size, rank)`` of the default process group; ``(1, 0)`` when none
    is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def group():
    """The default group when it spans more than one rank, else None: the
    ``reduce`` argument of the loss functions."""
    return dist.group.WORLD if world()[0] > 1 else None


def process_group():
    """The default group whenever one is initialised, of any size, else
    None."""
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def _check_device(verb: str, t: torch.Tensor, grp) -> None:
    """Raise where gloo cannot take ``t``'s device for ``verb``."""
    if (t.device.type != "cpu" and dist.get_backend(grp) == "gloo"
            and verb not in GLOO_CUDA_VERBS):
        raise RuntimeError(
            f"{verb} on a {t.device.type} tensor: the gloo backend takes "
            f"{t.device.type} tensors only for {sorted(GLOO_CUDA_VERBS)}; "
            f"use the nccl backend or CPU tensors")


def _check_ranks(grp, ranks: Sequence[int]) -> None:
    """Every rank must exist in the world, else a masked or rooted
    collective would drop contributions (Horovod raises too)."""
    n = dist.get_world_size(grp)
    bad = [int(r) for r in ranks if not 0 <= int(r) < n]
    if bad:
        raise ValueError(f"ranks {bad} out of range for a {n}-rank world")


def _dense(t: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of ``t``, for a collective to work in."""
    return t.clone(memory_format=torch.contiguous_format)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, differentiable: the backward sums the
    cotangents too (the transpose of ``psum`` is ``psum``)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        out = x.clone()
        dist.all_reduce(out, group=grp)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.grp)
        return g, None


def all_reduce_sum(x, grp):
    """``psum`` of ``x`` over ``grp`` (None: identity), differentiable."""
    if grp is None:
        return x
    return _AllReduceSum.apply(x, grp)


def mean_(tensors, grp) -> None:
    """In-place mean of each tensor over ``grp`` (None: identity): the
    DP gradient and metric reduction (Horovod's averaged allreduce)."""
    if grp is None:
        return
    n = dist.get_world_size(grp)
    for t in tensors:
        dist.all_reduce(t, group=grp)
        t.div_(n)


def allreduce(t: torch.Tensor, grp, op: str = "sum") -> torch.Tensor:
    """``t`` reduced over ``grp`` elementwise by ``op``: ``sum``, ``mean``
    (the sum over the world size), ``min`` or ``max``."""
    if grp is None:
        return t
    _check_device("all_reduce", t, grp)
    out = _dense(t)
    dist.all_reduce(out, op=_OPS["sum" if op == "mean" else op], group=grp)
    if op == "mean":
        out.div_(dist.get_world_size(grp))
    return out


def allreduce_start_(t: torch.Tensor, grp, op: str = "sum"):
    """Start an in-place allreduce of ``t`` over ``grp`` and return its
    ``Work`` (``async_op=True``).  ``mean`` sums: the caller divides by
    the world size once the work is done."""
    if not t.is_contiguous():
        raise ValueError("an in-place allreduce needs a contiguous tensor")
    _check_device("all_reduce", t, grp)
    return dist.all_reduce(t, op=_OPS["sum" if op == "mean" else op],
                           group=grp, async_op=True)


def reduce_prod(t: torch.Tensor, grp) -> torch.Tensor:
    """Elementwise product over the world (Horovod ``op=hvd.Product``),
    as the JAX package computes it: gather every rank's tensor, then
    multiply in rank order, so zeros and negative values stay exact."""
    if grp is None:
        return t
    return allgather(t.unsqueeze(0), grp).prod(dim=0)


def broadcast(t: torch.Tensor, grp, root: int = 0) -> torch.Tensor:
    """``root``'s ``t`` on every rank (Horovod broadcast)."""
    if grp is None:
        return t
    _check_ranks(grp, (root,))
    _check_device("broadcast", t, grp)
    out = _dense(t)
    dist.broadcast(out, dist.get_global_rank(grp, root), group=grp)
    return out


def allgather(t: torch.Tensor, grp) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in rank order (Horovod
    allgather; equal shapes on every rank, as in the JAX package)."""
    if grp is None:
        return t
    _check_device("all_gather", t, grp)
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(grp))]
    dist.all_gather(parts, t.contiguous(), group=grp)
    return torch.cat(parts)


def alltoall(t: torch.Tensor, grp) -> torch.Tensor:
    """Horovod alltoall with equal splits: dim 0 cut into one block a
    rank, block ``j`` sent to rank ``j``, the received blocks
    concatenated in rank order."""
    if grp is None:
        return t
    n = dist.get_world_size(grp)
    if t.shape[0] % n:
        raise ValueError(f"alltoall: dim 0 ({t.shape[0]}) does not split "
                         f"evenly over {n} ranks")
    _check_device("all_to_all", t, grp)
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, t.contiguous(), group=grp)
    return out


def adasum_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Adasum's pairwise combine (arXiv:2006.02924):

        (1 - a.b / 2|a|^2) a + (1 - a.b / 2|b|^2) b

    with each coefficient 0 where its norm is 0.  The dots and the
    combine are in f32 whatever the dtype, and the result has ``a``'s
    dtype.  It is the input when ``a == b`` and the sum when ``a`` is
    orthogonal to ``b``.  Swapping the operands gives the same bits (each
    dot multiplies the same pairs and sums them in the same order), which
    keeps the two ranks of a pair in lockstep."""
    a32, b32 = a.float(), b.float()
    dot = (a32 * b32).sum()
    na = (a32 * a32).sum()
    nb = (b32 * b32).sum()
    ca = torch.where(na > 0, dot / (2 * na), 0.0)
    cb = torch.where(nb > 0, dot / (2 * nb), 0.0)
    return ((1 - ca) * a32 + (1 - cb) * b32).to(a.dtype)


def adasum_(tensors: Sequence[torch.Tensor], grp) -> None:
    """Adaptive summation of each tensor over the world, in place
    (Horovod ``op=hvd.Adasum``; the JAX package's ``collectives.adasum``).

    A butterfly: at stage ``k`` rank ``i`` swaps its vectors with rank
    ``i ^ 2**k`` (one batch of point-to-point sends and receives) and
    both apply :func:`adasum_combine`, so after log2(world) stages every
    rank holds the same bits.  Per tensor, in f32 from the first stage to
    the last, then cast back.  The world must be a power of two; a world
    of one is the identity."""
    if grp is None:
        return
    n = dist.get_world_size(grp)
    if n & (n - 1):
        raise ValueError(f"adasum butterfly needs a power-of-two replica "
                         f"count, got {n}")
    if n == 1:
        return
    for t in tensors:
        _check_device("send/recv", t, grp)
    rank = dist.get_rank(grp)
    vs = [t.float().clone(memory_format=torch.contiguous_format)
          for t in tensors]
    for k in range(n.bit_length() - 1):
        peer = dist.get_global_rank(grp, rank ^ (1 << k))
        others = [torch.empty_like(v) for v in vs]
        ops = [dist.P2POp(dist.isend, v, peer, grp) for v in vs]
        ops += [dist.P2POp(dist.irecv, o, peer, grp) for o in others]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        vs = [adasum_combine(v, o) for v, o in zip(vs, others)]
    for t, v in zip(tensors, vs):
        t.copy_(v)


def masked_allreduce(t: torch.Tensor, grp, ranks: Sequence[int], *,
                     average: bool = True) -> torch.Tensor:
    """Allreduce over the ranks in ``ranks`` only (Horovod
    ``process_set=``): members get the subgroup's sum or mean, the others
    keep their ``t``.  One reduction over the whole world with zeros from
    non-members, as in the JAX package."""
    if grp is None:
        return t
    _check_ranks(grp, ranks)
    members = {int(r) for r in ranks}
    member = dist.get_rank(grp) in members
    total = _dense(t) if member else torch.zeros_like(
        t, memory_format=torch.contiguous_format)
    _check_device("all_reduce", total, grp)
    dist.all_reduce(total, group=grp)
    if average:
        total = (total.float() / len(members)).to(t.dtype)
    return total if member else t


def masked_broadcast(t: torch.Tensor, grp, ranks: Sequence[int], *,
                     root: int) -> torch.Tensor:
    """``root``'s ``t`` on the ranks in ``ranks`` only; the others keep
    theirs (Horovod ``broadcast(..., process_set=...)``)."""
    if grp is None:
        return t
    members = {int(r) for r in ranks}
    if root not in members:
        raise ValueError(f"root {root} is not a member of the process set "
                         f"{sorted(members)}")
    _check_ranks(grp, ranks)
    out = broadcast(t, grp, root)
    return out if dist.get_rank(grp) in members else t


# Bytes this process sent to other ranks of its seq ring, by verb (the
# forward and the backward alike): what a run reads as its traffic
# through the seq group.
SEQ_BYTES = {"ring_rotate": 0, "all_to_all": 0, "all_gather": 0}


def _shift(flat: torch.Tensor, seq, shift: int) -> torch.Tensor:
    """``flat`` (1-d, contiguous) sent whole to the ring member ``shift``
    places on; returns the one received from ``shift`` places back."""
    n = seq.size
    if n == 1:
        return flat
    m = flat.numel()
    dst, src = (seq.index + shift) % n, (seq.index - shift) % n
    _check_device("all_to_all", flat, seq.group)
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat,
                           [m if j == src else 0 for j in range(n)],
                           [m if j == dst else 0 for j in range(n)],
                           group=seq.group)
    SEQ_BYTES["ring_rotate"] += m * flat.element_size()
    return out


def _shift_all(tensors, seq, shift: int) -> list:
    """:func:`_shift` of several tensors of one dtype, packed into one
    collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    out = _shift(flat, seq, shift)
    got, at = [], 0
    for t in tensors:
        got.append(out[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return got


class _Rotate(torch.autograd.Function):
    """The ring rotation of same-dtype tensors: each rank receives the
    previous rank's and sends its own to the next; the backward sends the
    cotangents the other way, so a visiting chunk's gradient lands on its
    owner (the transpose of ``lax.ppermute``)."""

    @staticmethod
    def forward(ctx, seq, *tensors):
        ctx.seq = seq
        return tuple(_shift_all(tensors, seq, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift_all(grads, ctx.seq, -1))


def ring_rotate(tensors, seq) -> list:
    """``tensors`` (one dtype, the same on every rank) rotated one place
    round the seq ring ``seq`` (a ``mesh.SeqGroup``), differentiably, in
    one collective.  A ring of one is the identity."""
    if seq.size == 1:
        return list(tensors)
    return list(_Rotate.apply(seq, *(t.contiguous() for t in tensors)))


def _all_to_all(send: torch.Tensor, seq) -> torch.Tensor:
    """Equal-split all-to-all over dim 0 (one block a ring member)."""
    _check_device("all_to_all", send, seq.group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=seq.group)
    SEQ_BYTES["all_to_all"] += (send.numel() * send.element_size()
                                * (seq.size - 1) // seq.size)
    return recv


def _to_heads(x, seq):
    b, c, nh, d = x.shape
    n = seq.size
    send = x.reshape(b, c, n, nh // n, d).permute(2, 0, 1, 3, 4).contiguous()
    recv = _all_to_all(send, seq)          # [source's seq chunk, B, C, h, D]
    return recv.permute(1, 0, 2, 3, 4).reshape(b, n * c, nh // n, d)


def _to_seq(y, seq):
    b, s, h, d = y.shape
    n = seq.size
    send = y.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = _all_to_all(send, seq)          # [source's head group, B, C, h, D]
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        return _to_heads(x, seq)

    @staticmethod
    def backward(ctx, g):
        return _to_seq(g, ctx.seq), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, seq):
        ctx.seq = seq
        return _to_seq(y, seq)

    @staticmethod
    def backward(ctx, g):
        return _to_heads(g, ctx.seq), None


def seq_to_heads(x: torch.Tensor, seq) -> torch.Tensor:
    """``[B, S/n, N, D] -> [B, S, N/n, D]`` over the ring ``seq``: rank
    ``i`` gets head group ``i`` of the whole sequence (JAX's tiled
    ``all_to_all(split_axis=2, concat_axis=1)``).  ``N % n == 0``."""
    if x.shape[2] % seq.size:
        raise ValueError(f"{x.shape[2]} heads do not split over a seq ring "
                         f"of {seq.size}")
    return _SeqToHeads.apply(x, seq)


def heads_to_seq(y: torch.Tensor, seq) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads`: ``[B, S, N/n, D] -> [B, S/n,
    N, D]``."""
    if y.shape[1] % seq.size:
        raise ValueError(f"sequence {y.shape[1]} does not split over a seq "
                         f"ring of {seq.size}")
    return _HeadsToSeq.apply(y, seq)


class _GatherSeq(torch.autograd.Function):
    """All-gather along dim 1 in ring order; the backward sums each
    rank's slice of the cotangents over the ring (``psum_scatter``, the
    transpose of a tiled ``all_gather``)."""

    @staticmethod
    def forward(ctx, x, seq):
        ctx.seq = seq
        _check_device("all_gather", x, seq.group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(seq.size)]
        dist.all_gather(parts, x, group=seq.group)
        SEQ_BYTES["all_gather"] += (x.numel() * x.element_size()
                                    * (seq.size - 1))
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, g):
        n = ctx.seq.size
        b, s = g.shape[:2]
        send = g.reshape(b, n, s // n, *g.shape[2:]).transpose(0, 1)
        return _all_to_all(send.contiguous(), ctx.seq).sum(dim=0), None


def gather_seq(x: torch.Tensor, seq) -> torch.Tensor:
    """Every ring member's ``[B, S/n, ...]`` joined into ``[B, S, ...]`` in
    ring order (JAX's tiled ``all_gather(axis=1)``): the key mask's
    gather of Ulysses."""
    if seq.size == 1:
        return x
    return _GatherSeq.apply(x, seq)


# Calls and bytes this process sent to other ranks of its pipe group
# (``parallel/mesh.py``), by verb, the forward and the backward alike:
# what a pipeline run reads as its traffic between stages.  A rotation
# counts the payload it sent (0 on a leg it only receives on), a
# broadcast its payload on the root, an all-reduce its operand.
PIPE_CALLS = {"pipe_rotate": 0, "last_stage_value": 0, "pipe_broadcast": 0,
              "pipe_all_reduce": 0}
PIPE_BYTES = dict.fromkeys(PIPE_CALLS, 0)


def reset_pipe() -> None:
    for d in (PIPE_CALLS, PIPE_BYTES):
        for k in d:
            d[k] = 0


def _pipe_shift(x: torch.Tensor, pipe, shift: int, send: bool, recv: bool,
                shape: tuple) -> torch.Tensor:
    """``x`` sent whole to the stage ``shift`` places on, when ``send`` and
    that stage exists; returns what the stage ``shift`` places back sent
    (a tensor of ``shape``) when ``recv`` and that stage exists, else an
    empty tensor.  One ``all_to_all_single`` over the pipe group, with
    0-element splits on the legs that carry nothing (no wrap from the
    last stage to stage 0)."""
    n, i = pipe.size, pipe.index
    dst, src = i + shift, i - shift
    send = send and 0 <= dst < n
    recv = recv and 0 <= src < n
    flat = x.reshape(-1).contiguous() if send else x.new_empty(0)
    out = x.new_empty(math.prod(shape) if recv else 0)
    _check_device("all_to_all", flat, pipe.group)
    dist.all_to_all_single(out, flat,
                           [out.numel() if j == src else 0 for j in range(n)],
                           [flat.numel() if j == dst else 0
                            for j in range(n)],
                           group=pipe.group)
    PIPE_CALLS["pipe_rotate"] += 1
    PIPE_BYTES["pipe_rotate"] += flat.numel() * flat.element_size()
    return out.view(shape) if recv else out


class _PipeRotate(torch.autograd.Function):
    """One tick's rotation of the pipeline: the stage's output to the next
    stage, the previous stage's output in; the backward sends the
    cotangent of what came in back to the previous stage and takes the
    one of what went out from the next (the transpose of
    ``lax.ppermute``)."""

    @staticmethod
    def forward(ctx, y, pipe, send, recv, shape):
        ctx.pipe, ctx.send, ctx.recv = pipe, send, recv
        ctx.y_shape = tuple(y.shape)
        return _pipe_shift(y, pipe, 1, send, recv, shape)

    @staticmethod
    def backward(ctx, g):
        got = _pipe_shift(g, ctx.pipe, -1, ctx.recv, ctx.send, ctx.y_shape)
        if got.numel() != math.prod(ctx.y_shape):
            # nothing came back: the output went nowhere (the last stage,
            # or a bubble's empty output)
            got = g.new_zeros(ctx.y_shape)
        return got, None, None, None, None


def pipe_rotate(y: torch.Tensor, pipe, *, send: bool, recv: bool,
                shape: tuple):
    """JAX's ``lax.ppermute(y, "pipe", [(i, i + 1)])``, differentiably:
    ``y`` goes to the next stage (when ``send``), and the previous
    stage's output, of ``shape``, comes back (when ``recv``; else an
    empty tensor).  The last stage sends nothing and
    stage 0 receives nothing: the JAX wrap from the last stage to stage
    0, whose value stage 0 discards, costs 0 bytes here, and so does a
    leg whose sender and receiver both know it carries a bubble.  The
    backward is the reverse shift.  Every stage calls it once a tick, in
    the same order, as a collective of the pipe group ``pipe`` (a
    ``mesh.Group``; None or one stage: nothing comes in)."""
    if pipe is None or pipe.size == 1:
        return y.new_empty(0)
    return _PipeRotate.apply(y, pipe, bool(send), bool(recv), tuple(shape))


class _LastStage(torch.autograd.Function):
    """The last stage's value on every stage; the backward keeps the last
    stage's own cotangent and gives the others zeros (the masked
    ``psum``'s transpose for a cotangent that is the same on every stage,
    as JAX's is: no communication)."""

    @staticmethod
    def forward(ctx, x, pipe):
        ctx.last = pipe.index == pipe.size - 1
        out = _dense(x)
        _check_device("broadcast", out, pipe.group)
        dist.broadcast(out, pipe.ranks[-1], group=pipe.group)
        PIPE_CALLS["last_stage_value"] += 1
        if ctx.last:
            PIPE_BYTES["last_stage_value"] += out.numel() * out.element_size()
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


def last_stage_value(x: torch.Tensor, pipe) -> torch.Tensor:
    """The last stage's ``x`` on every stage of ``pipe`` (JAX's
    ``pp.last_stage_value``, a masked ``psum``; here a broadcast from the
    last stage, so every stage holds its bits), differentiably (None or
    one stage: ``x``)."""
    if pipe is None or pipe.size == 1:
        return x
    return _LastStage.apply(x, pipe)


def pipe_broadcast_(t: torch.Tensor, pipe, stage: int) -> torch.Tensor:
    """``stage``'s ``t`` onto every stage of ``pipe``, in place (a
    contiguous tensor), counted; None or one stage: nothing."""
    if pipe is None or pipe.size == 1:
        return t
    _check_device("broadcast", t, pipe.group)
    dist.broadcast(t, pipe.ranks[stage], group=pipe.group)
    PIPE_CALLS["pipe_broadcast"] += 1
    if pipe.index == stage:
        PIPE_BYTES["pipe_broadcast"] += t.numel() * t.element_size()
    return t


def pipe_sum(t: torch.Tensor, pipe) -> torch.Tensor:
    """The sum of ``t`` over the stages of ``pipe`` (no gradient), counted;
    None or one stage: ``t``."""
    if pipe is None or pipe.size == 1:
        return t
    out = _dense(t)
    _check_device("all_reduce", out, pipe.group)
    dist.all_reduce(out, group=pipe.group)
    PIPE_CALLS["pipe_all_reduce"] += 1
    PIPE_BYTES["pipe_all_reduce"] += out.numel() * out.element_size()
    return out


# Bytes and calls of the gradient wire of the zero1 and int8-block paths,
# by collective, in the JAX budgets' convention
# (``tpuframe/analysis/budgets.py``): a reduce-scatter, an all-to-all and
# an all-reduce count their operand's bytes, an all-gather its result's.
# The statistics', metrics' and gradient norm's reductions are not
# counted here.
WIRE_BYTES = {"reduce_scatter": 0, "all_gather": 0, "all_to_all": 0,
              "all_reduce": 0}
WIRE_CALLS = dict.fromkeys(WIRE_BYTES, 0)


def reset_wire() -> None:
    """Set every :data:`WIRE_BYTES` and :data:`WIRE_CALLS` count to 0."""
    for counts in (WIRE_BYTES, WIRE_CALLS):
        for kind in counts:
            counts[kind] = 0


def _wire(kind: str, t: torch.Tensor) -> None:
    WIRE_BYTES[kind] += t.numel() * t.element_size()
    WIRE_CALLS[kind] += 1


def _tiled_reduce_scatter(flat: torch.Tensor, grp, async_op: bool = False):
    """The sum over ``grp`` of every member's 1-d contiguous ``flat``,
    member ``i`` keeping chunk ``i`` of ``len(flat) / n`` elements (one
    tiled reduce-scatter, uncounted).  Returns ``(shard, work)``."""
    shard = flat.new_empty(flat.numel() // dist.get_world_size(grp))
    # reduce_scatter_tensor's successor from torch 2.13 on
    verb = (getattr(dist, "reduce_scatter_single", None)
            or dist.reduce_scatter_tensor)
    return shard, verb(shard, flat, group=grp, async_op=async_op)


def _tiled_all_gather(t: torch.Tensor, grp, async_op: bool = False):
    """Every member's contiguous ``t`` concatenated along dim 0 in group
    order (one tiled all-gather, uncounted).  Returns ``(full, work)``."""
    full = t.new_empty((dist.get_world_size(grp) * t.shape[0], *t.shape[1:]))
    return full, dist.all_gather_into_tensor(full, t, group=grp,
                                             async_op=async_op)


def reduce_scatter_start(flat: torch.Tensor, grp):
    """Start the tiled reduce-scatter (sum) of the 1-d ``flat`` over
    ``grp``: rank ``i`` gets the sum of every rank's chunk ``i`` of
    ``len(flat) / n`` elements (JAX's ``psum_scatter(tiled=True)``).
    Returns ``(shard, work)``; the shard holds the sum once ``work`` is
    done.  Counts ``flat``'s bytes."""
    n = dist.get_world_size(grp)
    if flat.dim() != 1 or flat.numel() % n:
        raise ValueError(f"reduce_scatter: a flat operand whose length is a "
                         f"multiple of the {n} ranks, got shape "
                         f"{tuple(flat.shape)}; pad it first (zero1's "
                         f"pad-to-multiple layout)")
    _check_device("reduce_scatter", flat, grp)
    flat = flat.contiguous()
    shard, work = _tiled_reduce_scatter(flat, grp, async_op=True)
    _wire("reduce_scatter", flat)
    return shard, work


def all_gather_start(t: torch.Tensor, grp):
    """Start the tiled all-gather of ``t`` along dim 0 over ``grp``: every
    rank's ``t`` concatenated in rank order.  Returns ``(full, work)``.
    Counts the result's bytes."""
    _check_device("all_gather", t, grp)
    full, work = _tiled_all_gather(t.contiguous(), grp, async_op=True)
    _wire("all_gather", full)
    return full, work


def all_to_all_start(t: torch.Tensor, grp):
    """Start the equal-split all-to-all of ``t`` along dim 0 over ``grp``
    (block ``j`` to rank ``j``, the received blocks in rank order).
    Returns ``(out, work)``.  Counts ``t``'s bytes."""
    n = dist.get_world_size(grp)
    if t.shape[0] % n:
        raise ValueError(f"all_to_all: dim 0 ({t.shape[0]}) does not split "
                         f"evenly over {n} ranks")
    _check_device("all_to_all", t, grp)
    t = t.contiguous()
    out = torch.empty_like(t)
    work = dist.all_to_all_single(out, t, group=grp, async_op=True)
    _wire("all_to_all", t)
    return out, work


def wire_mean_(t: torch.Tensor, grp) -> torch.Tensor:
    """In-place mean of the contiguous ``t`` over ``grp`` (JAX's
    ``pmean``: the sum, then divided by the world size), counted as the
    gradient wire's all-reduce.  Returns ``t``."""
    allreduce_start_(t, grp).wait()
    _wire("all_reduce", t)
    return t.div_(dist.get_world_size(grp))


# The verbs of tensor and expert parallelism (``parallel/tp.py``, the MoE
# layer of ``models/transformer_lm.py``) and of fsdp (``parallel/fsdp.py``:
# a parameter's blocks gathered before its use, its gradient
# reduce-scattered back onto them): calls and bytes this process sent
# into them, by verb, the forward and the backward alike (what a run
# reads as its sharded-state traffic).  The all-gathers count the block
# sent, the reduce-scatter the whole operand.  A group of one runs and
# counts nothing.  ``bn_stats`` counts a BatchNorm's per-channel sums over
# the batch group (:func:`bn_stats_sum`), forward and backward.
SHARD_CALLS = {"all_reduce": 0, "all_gather": 0, "fsdp_all_gather": 0,
               "fsdp_reduce_scatter": 0, "bn_stats": 0}
SHARD_BYTES = dict.fromkeys(SHARD_CALLS, 0)


def reset_shard() -> None:
    for d in (SHARD_CALLS, SHARD_BYTES):
        for k in d:
            d[k] = 0


def _shard_sum_(t: torch.Tensor, grp) -> torch.Tensor:
    """In-place sum of ``t`` (contiguous) over a sub-group, counted."""
    _check_device("all_reduce", t, grp.group)
    dist.all_reduce(t, group=grp.group)
    SHARD_CALLS["all_reduce"] += 1
    SHARD_BYTES["all_reduce"] += t.numel() * t.element_size()
    return t


def _bn_sum_(t: torch.Tensor, grp) -> torch.Tensor:
    """In-place sum of a BatchNorm's packed statistics ``t`` (contiguous)
    over the batch group, counted as ``bn_stats``."""
    _check_device("all_reduce", t, grp.group)
    dist.all_reduce(t, group=grp.group)
    SHARD_CALLS["bn_stats"] += 1
    SHARD_BYTES["bn_stats"] += t.numel() * t.element_size()
    return t


class _BnStatsSum(torch.autograd.Function):
    """``psum`` of packed statistics over the batch group: the sum
    forward and, as its transpose, backward."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _bn_sum_(x.contiguous().clone(), grp)

    @staticmethod
    def backward(ctx, g):
        return _bn_sum_(g.contiguous().clone(), ctx.grp), None


def bn_stats_sum(x: torch.Tensor, grp) -> torch.Tensor:
    """The sum over the batch group ``grp`` (a ``mesh.Group``; None or one
    member: the identity) of a BatchNorm's per-channel statistics, packed
    into one tensor so that a BatchNorm sends one all-reduce a pass:
    ``[sum x, sum x^2]`` in the forward (differentiable; its backward is
    one all-reduce of their cotangents), or the fused op's backward sums
    ``[sum dy, sum dy x_hat]``.  The sharded-state mode's BatchNorm
    statistics are the global batch's, as GSPMD computes them."""
    if grp is None or grp.size == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _BnStatsSum.apply(x, grp)
    return _bn_sum_(x.contiguous().clone(), grp)


def _shard_gather(t: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """Every member's ``t`` concatenated along ``dim`` in group order,
    counted."""
    t = t.contiguous()
    _check_device("all_gather", t, grp.group)
    parts = [torch.empty_like(t) for _ in range(grp.size)]
    dist.all_gather(parts, t, group=grp.group)
    SHARD_CALLS["all_gather"] += 1
    SHARD_BYTES["all_gather"] += t.numel() * t.element_size()
    return torch.cat(parts, dim=dim)


class _CopyTo(torch.autograd.Function):
    """Megatron's ``f``: the identity forward into a region whose members
    each use part of ``x``; the backward sums the members' partial
    cotangents (in f32)."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _shard_sum_(g.float().contiguous(), ctx.grp).to(g.dtype), None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's ``g``: the sum of the members' partial results (in f32,
    one rounding back to ``x``'s dtype); the backward is the identity."""

    @staticmethod
    def forward(ctx, x, grp):
        return _shard_sum_(x.float().contiguous().clone(), grp).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """A tensor split along ``dim`` made whole on every member; the
    backward keeps this member's block of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim, ctx.n = grp, dim, x.shape[dim]
        return _shard_gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.grp.index * ctx.n
        return g.narrow(ctx.dim, lo, ctx.n).contiguous(), None, None


class _GroupSum(torch.autograd.Function):
    """``psum`` over a sub-group: the sum forward and backward."""

    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return _shard_sum_(x.contiguous().clone(), grp)

    @staticmethod
    def backward(ctx, g):
        return _shard_sum_(g.contiguous().clone(), ctx.grp), None


def copy_to(x: torch.Tensor, grp) -> torch.Tensor:
    """:class:`_CopyTo` over ``grp`` (a ``mesh.Group``; None or a group of
    one: the identity)."""
    if grp is None or grp.size == 1:
        return x
    return _CopyTo.apply(x, grp)


def reduce_from(x: torch.Tensor, grp) -> torch.Tensor:
    """:class:`_ReduceFrom` over ``grp`` (None or one member: identity)."""
    if grp is None or grp.size == 1:
        return x
    return _ReduceFrom.apply(x, grp)


def gather_along(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """:class:`_Gather` of ``x`` along ``dim`` over ``grp`` (None or one
    member: identity)."""
    if grp is None or grp.size == 1:
        return x
    return _Gather.apply(x, grp, dim % x.dim())


def group_sum(x: torch.Tensor, grp) -> torch.Tensor:
    """The sum of ``x`` over ``grp``, differentiable with the sum as its
    backward too (``psum``), counted; None or one member: identity."""
    if grp is None or grp.size == 1:
        return x
    return _GroupSum.apply(x, grp)


def group_gather(x: torch.Tensor, grp) -> torch.Tensor:
    """Every member's ``x`` stacked on a new leading dim, in group order
    (no gradient), counted; None or one member: ``x[None]``."""
    if grp is None or grp.size == 1:
        return x[None]
    return _shard_gather(x.detach()[None], grp, 0)


def _fsdp_gather(t: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """Every member's block ``t`` concatenated along ``dim`` in group
    order (one tiled all-gather), counted."""
    moved = t.movedim(dim, 0).contiguous()
    _check_device("all_gather", moved, grp.group)
    full, _ = _tiled_all_gather(moved, grp.group)
    SHARD_CALLS["fsdp_all_gather"] += 1
    SHARD_BYTES["fsdp_all_gather"] += moved.numel() * moved.element_size()
    return full.movedim(0, dim)


def _fsdp_scatter(g: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """The sum over the group of every member's ``g``, each member
    keeping its block along ``dim`` (one tiled reduce-scatter), counted."""
    moved = g.movedim(dim, 0).contiguous()
    _check_device("reduce_scatter", moved, grp.group)
    block, _ = _tiled_reduce_scatter(moved.view(-1), grp.group)
    SHARD_CALLS["fsdp_reduce_scatter"] += 1
    SHARD_BYTES["fsdp_reduce_scatter"] += moved.numel() * moved.element_size()
    return block.view(-1, *moved.shape[1:]).movedim(0, dim)


class _FsdpGather(torch.autograd.Function):
    """A parameter's fsdp block made whole on every member of the fsdp
    group; the backward reduce-scatters the whole cotangent (the sum of
    the members' partial gradients, each from its own rows) back onto
    the block.  Nothing is saved: the whole tensor lives as long as the
    operation that uses it keeps it."""

    @staticmethod
    def forward(ctx, x, grp, dim):
        ctx.grp, ctx.dim = grp, dim
        return _fsdp_gather(x, grp, dim)

    @staticmethod
    def backward(ctx, g):
        return _fsdp_scatter(g, ctx.grp, ctx.dim), None, None


def fsdp_gather(x: torch.Tensor, grp, dim: int) -> torch.Tensor:
    """:class:`_FsdpGather` of the block ``x`` along ``dim`` over the
    fsdp group ``grp`` (None or one member: identity)."""
    if grp is None or grp.size == 1:
        return x
    return _FsdpGather.apply(x, grp, dim % x.dim())
