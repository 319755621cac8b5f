"""Mixture-of-experts routing (counterpart of ``tpuframe/ops/moe.py``):
top-k gating with a per-expert capacity, the Switch/GShard formulation.

All routing runs in f32.  ``argmax`` takes the first maximal index, as
``jnp.argmax`` does, and a token's place in its expert's queue is an f32
``cumsum`` of 0/1 masks, exact for every count below 2^24.  The dense
one-hot ``dispatch``/``combine`` tensors are those of the JAX function;
the JAX package computes them and the expert products outside any Pallas
kernel, so they stay plain PyTorch here too.

A token picks each expert at most once (each round masks the experts of
the rounds before it), so a slot ``[t, e, c]`` is filled by at most one
round and the routing has a factored form: :func:`route` returns which
``(t, e)`` pairs were kept, their slot and their combine weight, from
which ``dispatch = kept * one_hot(slot)`` and ``combine = dispatch *
weight`` are exactly the JAX tensors (every sum the JAX function forms
over rounds adds zeros to the one nonzero term).

Global routing (the JAX trainer's sharded-state mode, where the logical
program routes the whole batch at once): a rank whose tokens are rows
``[t0, t0 + T_local)`` of the global token order passes ``prior``, a
function from its own per-round, per-expert counts to those of the tokens
that earlier ranks sent (``before``) and of all ranks (``total``), and
the global capacity.  Its tokens then take the queue positions the whole
batch would give them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


def capacity_for(tokens: int, num_experts: int, k: int,
                 capacity_factor: float) -> int:
    """Static per-expert capacity: ``ceil(k*T/E * factor)``, at least 4 and
    a multiple of 4 (the JAX function's arithmetic, bit for bit)."""
    raw = int(tokens * k / num_experts * capacity_factor) + 1
    return max(4, (raw + 3) // 4 * 4)


def choices(gates: torch.Tensor, k: int) -> list:
    """The ``k`` rounds' one-hot choices ``[T, E]`` (f32) of f32 ``gates``:
    each round the first maximal gate among the experts not yet chosen."""
    e = gates.shape[-1]
    masked, out = gates, []
    for _ in range(k):
        mask = F.one_hot(masked.argmax(dim=-1), e).to(torch.float32)
        out.append(mask)
        masked = masked * (1.0 - mask)
    return out


@dataclass
class Routing:
    """The factored routing of ``T`` tokens over ``E`` experts.

    ``kept`` ``[T, E]`` 0/1 (f32): the token sits in the expert's queue;
    ``slot`` ``[T, E]`` (int64): its position there (0 where not kept);
    ``weight`` ``[T, E]`` (f32, differentiable): its renormalised combine
    weight (0 where not kept); ``me`` and ``ce`` ``[E]``: the mean gate and
    the first round's share of tokens an expert (before capacity), the
    factors of the load-balance loss."""

    kept: torch.Tensor
    slot: torch.Tensor
    weight: torch.Tensor
    me: torch.Tensor
    ce: torch.Tensor
    capacity: int

    def dispatch(self, lo: int = 0, hi: int | None = None) -> torch.Tensor:
        """``[T, hi - lo, C]`` 0/1: the dispatch tensor of experts
        ``[lo, hi)``."""
        kept = self.kept[:, lo:hi]
        return kept[..., None] * F.one_hot(self.slot[:, lo:hi],
                                           self.capacity).to(kept.dtype)

    def combine(self, lo: int = 0, hi: int | None = None,
                weight: torch.Tensor | None = None) -> torch.Tensor:
        """``[T, hi - lo, C]``: the combine tensor of experts ``[lo, hi)``
        (``weight``: a stand-in for :attr:`weight`, the same values)."""
        w = (self.weight if weight is None else weight)[:, lo:hi]
        return self.dispatch(lo, hi) * w[..., None]


def route(gate_logits: torch.Tensor, *, k: int, capacity: int,
          prior=None) -> Routing:
    """Route ``[T, E]`` gate logits (cast to f32).  ``prior``: a function
    from this rank's counts ``[k, E]`` to ``(before, total)``, the
    ``[k, E]`` counts of the tokens that earlier ranks, and all ranks,
    sent to each expert in each round (module docstring; one exchange
    among the ranks, since a token's choices do not depend on the
    capacity); None: these ``T`` tokens are the whole batch."""
    t, e = gate_logits.shape
    gates = torch.softmax(gate_logits.float(), dim=-1)
    masks = choices(gates.detach(), k)
    counts = torch.stack([m.sum(dim=0) for m in masks])
    if prior is None:
        before, total = torch.zeros_like(counts), counts
    else:
        before, total = prior(counts)
    queued = torch.zeros(e, dtype=torch.float32, device=gates.device)
    kept = torch.zeros((t, e), dtype=torch.float32, device=gates.device)
    slot = torch.zeros((t, e), dtype=torch.float32, device=gates.device)
    kept_w, chosen = 0.0, []
    for r, mask in enumerate(masks):
        # place in the chosen expert's queue in the global token order
        pos = (torch.cumsum(mask, dim=0) - mask) + before[r] + queued
        keep = mask * (pos < capacity).float()
        kept = kept + keep
        slot = slot + pos * keep
        w = (gates * keep).sum(dim=-1, keepdim=True)      # [T, 1]
        chosen.append(w)
        kept_w = kept_w + keep * w
        # the whole batch's kept tokens of this round: queue positions
        # queued .. queued + total - 1, those below the capacity
        queued = queued + torch.clamp(torch.minimum(total[r],
                                                    capacity - queued),
                                      min=0.0)
    denom = chosen[0]
    for w in chosen[1:]:
        denom = denom + w
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    return Routing(kept=kept, slot=slot.long(), weight=kept_w / denom,
                   me=gates.mean(dim=0), ce=masks[0].mean(dim=0),
                   capacity=capacity)


def aux_loss(me: torch.Tensor, ce: torch.Tensor) -> torch.Tensor:
    """The Switch load-balance loss ``E * sum_e me_e * ce_e``."""
    return me.shape[-1] * (me * ce).sum()


def route_topk(gate_logits: torch.Tensor, *, k: int, capacity: int):
    """``(dispatch [T, E, C], combine [T, E, C], aux)`` as the JAX
    ``route_topk`` returns them: tokens past an expert's capacity are
    dropped for that expert (zero combine weight; the residual carries
    them), and the kept tokens' k weights are renormalised to sum to 1."""
    r = route(gate_logits, k=k, capacity=capacity)
    return r.dispatch(), r.combine(), aux_loss(r.me, r.ce)
