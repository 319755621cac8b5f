"""The data-parallel world, from ``torch.distributed``.

The JAX package names mesh axes and reduces over them with ``psum`` /
``pmean`` inside its compiled step; here the world is the default process
group (NCCL on the card, gloo on the CPU), or a world of one when no group
is initialised, where every reduction is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


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
