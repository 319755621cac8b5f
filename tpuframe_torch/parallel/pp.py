"""Pipeline parallelism over the ``pipe`` axis: GPipe microbatch
pipelining (counterpart of ``tpuframe/parallel/pp.py``).

Stage ``s`` holds its slice of the layer-stacked parameters and, at tick
``t``, works on microbatch ``t - s``; with ``M`` microbatches and ``S``
stages the pipeline runs ``M + S - 1`` ticks (the GPipe bubble,
``(S - 1) / (M + S - 1)`` of them idle).  After its compute every stage
takes part in one rotation (``collectives.pipe_rotate``, JAX's
``ppermute``), which hands its output to the next stage.

The whole pipeline is one autograd graph: the rotation's backward is the
reverse shift, so ``loss.backward()`` through the ticks is the backward
pipeline, as ``jax.grad`` of the JAX one is.  Every rank's backward must
issue the pipe group's collectives in the same order, so the graph a
stage builds is a chain through every tick, on every stage alike: each
tick's input comes out of the previous tick's rotation, and where JAX's
``where`` drops a value (stage 0's ingest of the feed in place of what
the ring brought, a bubble tick's output) a node of zero gradient keeps
the dropped value in the chain.  Unlike JAX, a stage does not compute on
its bubble ticks: a bubble's output is an empty tensor, and the rotation
legs that would carry it carry 0 bytes (sender and receiver both know
the schedule), as does JAX's wrap from the last stage to stage 0.
"""

from __future__ import annotations

from typing import Callable

import torch

from tpuframe_torch.parallel import collectives


def microbatch(x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """``[B, ...] -> [n_micro, B / n_micro, ...]``: microbatch ``m`` is rows
    ``[m B / M, (m + 1) B / M)``."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n_micro}")
    return x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])


class _Join(torch.autograd.Function):
    """Stage 0's input: the feed, with what the ring brought kept in the
    graph at a zero gradient (JAX's ``where(s == 0, feed, held)``)."""

    @staticmethod
    def forward(ctx, feed, held):
        ctx.held_shape = tuple(held.shape)
        return feed.view_as(feed)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.held_shape)


class _Bubble(torch.autograd.Function):
    """A bubble tick: no compute, an empty output, a zero gradient for the
    input."""

    @staticmethod
    def forward(ctx, x):
        ctx.x_shape = tuple(x.shape)
        return x.new_empty(0)

    @staticmethod
    def backward(ctx, g):
        return g.new_zeros(ctx.x_shape)


class _Tie(torch.autograd.Function):
    """``out`` as it is, with the chain's last tick tied to it at a zero
    gradient, so that a backward from ``out`` runs every tick's
    rotation."""

    @staticmethod
    def forward(ctx, out, tail):
        ctx.tail_shape = tuple(tail.shape)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return g, g.new_zeros(ctx.tail_shape)


def pipeline_apply(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                   micro_x: torch.Tensor, pipe) -> torch.Tensor:
    """Run the microbatched pipeline on this stage.

    ``stage_fn``: ``x -> y`` with ``y.shape == x.shape`` (equal-width
    stages), this stage's layers.  ``micro_x``: ``[M, mb, ...]``; only
    stage 0 reads its values, the other stages its shape and dtype (the
    JAX function takes it replicated over pipe).  ``pipe``: the pipe group
    (``mesh.Group``; None or one stage: ``stage_fn`` on each microbatch).

    Returns ``[M, mb, ...]``: this stage's output for each microbatch,
    the pipeline's on the last stage (combine with
    ``collectives.last_stage_value``).  A stage that takes no loss from
    the result starts its backward with :func:`backward_from`."""
    if pipe is None or pipe.size == 1:
        return torch.stack([stage_fn(x) for x in micro_x])
    s, n_stages = pipe.index, pipe.size
    n_micro = micro_x.shape[0]
    shape = tuple(micro_x.shape[1:])
    # a leaf that requires grad: the first rotation of a stage that
    # starts on bubbles joins the graph too, so that its backward runs
    held = micro_x.new_empty(0).requires_grad_(torch.is_grad_enabled())
    outs = []
    y = held
    for t in range(n_micro + n_stages - 1):
        valid = 0 <= t - s < n_micro
        if s == 0:
            x = _Join.apply(micro_x[t], held) if valid else held
        else:
            x = held
        y = stage_fn(x) if valid else _Bubble.apply(x)
        if valid:
            outs.append(y)
        if t < n_micro + n_stages - 2:
            # the next stage's microbatch t + 1 - (s + 1) = t - s: this
            # leg carries a bubble exactly when this tick was one
            held = collectives.pipe_rotate(
                y, pipe, send=valid,
                recv=0 <= t + 1 - s < n_micro, shape=shape)
    out = torch.stack(outs)
    if s < n_stages - 1:
        out = _Tie.apply(out, y)
    return out


def backward_from(out: torch.Tensor) -> None:
    """The backward pipeline of a stage whose :func:`pipeline_apply`
    result takes no loss (every stage but the last, when the head runs
    there alone): ``out``'s cotangent is zero, as JAX's masked
    ``last_stage_value`` gives it, and the ticks' rotations run."""
    torch.autograd.backward(out, torch.zeros_like(out))
