"""Optimizer and learning-rate schedules (counterpart of
``tpuframe/utils/optim.py``).

The JAX package builds an optax chain; this module applies the same chain
in place on the model's f32 parameters, written out in optax's order and
arithmetic rather than through ``torch.optim``, whose habits differ where
parity is at stake:

  - the schedule is read at the update count *before* it is incremented,
    so with warmup the first update runs at lr 0;
  - clipping is optax's ``clip_by_global_norm``: grads are scaled by
    ``max / norm`` only when ``norm > max`` (``clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead);
  - AdamW is ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
    square root, bias corrections from the incremented count), then the
    decoupled decay ``+ wd * p`` on masked leaves, then ``-lr``;
  - nesterov SGD is ``trace(nesterov=True)`` then ``-lr``, with the decay
    added to the gradient before it when ``weight_decay > 0``;
  - LARS is ``optax.lars``: the decay added to the gradient, each
    tensor's update scaled by its trust ratio ``0.001 * |p| / |u|`` (1
    where either norm is 0), then ``-lr``, then ``trace(momentum)``
    without nesterov.  The momentum runs on the update after the learning
    rate, which ``torch.optim.SGD`` does not do.  Decay and trust ratio
    share the decay mask.

In the ZeRO-1 layout (``shards=(n, index)``, ``parallel/zero1.py``) each
moment is this rank's ``[padded / n]`` chunk of the parameter flattened
and zero-padded to a multiple of ``n``; :meth:`Optimizer.update_shards`
runs the same chain on such chunks of the parameters and of the reduced
gradients, each with its parameter's decay flag.  The chain must then be
element-wise: global-norm clipping and LARS's per-tensor trust ratio
raise ``ValueError``, as they are out of the JAX ``zero1``'s scope.

No decay on norm scales and biases (``_decay_mask`` in the JAX package
skips leaves named ``bias``, ``scale`` or ``b``): here by module type,
since a LayerNorm's or BatchNorm's scale is called ``weight``.  Embedding,
``lm_head`` and the convolution and Dense kernels are decayed.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpuframe_torch.models.resnet import BatchNorm
from tpuframe_torch.models.transformer_lm import LayerNorm
from tpuframe_torch.utils.config import TrainConfig

F32 = np.float32
LARS_TRUST = 0.001    # optax.lars's trust_coefficient (its eps is 0)
_NORMS = (LayerNorm, BatchNorm, nn.LayerNorm, nn.GroupNorm,
          nn.modules.batchnorm._NormBase)


def lr_schedule(cfg: TrainConfig, world_batch_scale: float):
    """``count -> lr`` as optax computes it (in f32): cosine, linear or
    constant decay after an optional linear warmup from 0."""
    peak = cfg.base_lr * (world_batch_scale if cfg.scale_lr_by_batch else 1.0)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)

    def linear(init, end, steps, count):
        frac = F32(1) - F32(min(max(count, 0), steps)) / F32(steps)
        return F32(init - end) * frac + F32(end)

    if cfg.schedule == "cosine":
        def sched(count):
            c = F32(min(count, decay_steps))
            return F32(peak) * (F32(0.5) * (F32(1) + np.cos(
                F32(np.pi) * c / F32(decay_steps))))
    elif cfg.schedule == "linear":
        def sched(count):
            return linear(peak, 0.0, decay_steps, count)
    elif cfg.schedule == "constant":
        def sched(count):
            return F32(peak)
    else:
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if cfg.warmup_steps <= 0:
        return lambda count: float(sched(count))
    w = cfg.warmup_steps
    return lambda count: float(linear(0.0, peak, w, count) if count < w
                               else sched(count - w))


def decay_mask(model: nn.Module) -> dict[str, bool]:
    """``{parameter name: decayed}``: False for norm scales and biases."""
    mask = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            full = f"{mod_name}.{name}" if mod_name else name
            mask[full] = not (isinstance(mod, _NORMS) or name == "bias")
    return mask


class Optimizer:
    """The optax chain of :func:`build_optimizer`, applied in place.

    :meth:`step` reads each parameter's ``.grad`` (already reduced over
    the data-parallel world), updates the parameters and returns the
    gradients' global norm before clipping.  ``global_sq``: None, or, for
    a model whose parameters are this rank's blocks (``parallel/tp.py``),
    a function from each parameter's local sum of squares to the whole
    tree's, every element counted once (``tp.global_sq``)."""

    def __init__(self, cfg: TrainConfig, model: nn.Module, schedule,
                 shards: tuple | None = None):
        named = [(n, p) for n, p in model.named_parameters()]
        mask = decay_mask(model)
        self.cfg = cfg
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.decay = [mask[n] for n in self.names]
        self.schedule = schedule
        self.count = 0
        # (n, index): the moments are this rank's chunks of the ZeRO-1
        # flat layout; None: shaped like the parameters
        self.shards = None if shards is None else tuple(map(int, shards))
        if self.shards is None:
            zeros = lambda: [torch.zeros_like(p)  # noqa: E731
                             for p in self.params]
        else:
            _check_elementwise(cfg)
            from tpuframe_torch.parallel.zero1 import chunk_len

            n = self.shards[0]
            zeros = lambda: [p.new_zeros(chunk_len(p.numel(), n))  # noqa: E731
                             for p in self.params]
        self.moments = ({"mu": zeros(), "nu": zeros()}
                        if cfg.optimizer == "adamw" else {"trace": zeros()})
        self.global_sq = None

    def state_dict(self) -> dict:
        """``{"count": int, <moment>: {parameter name: tensor}}``; the
        moments are ``mu``/``nu`` (adamw) or ``trace`` (sgd, lars)."""
        out = {"count": self.count}
        for key, ts in self.moments.items():
            out[key] = dict(zip(self.names, ts))
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """The inverse of :meth:`state_dict`: copies each moment into the
        existing tensor (the update's lists hold references to them) and
        restores ``count``, the schedule's position."""
        if set(sd) != {"count", *self.moments}:
            raise ValueError(f"optimizer state holds {sorted(sd)}, this "
                             f"{self.cfg.optimizer} optimizer "
                             f"{sorted({'count', *self.moments})}")
        for key, ts in self.moments.items():
            src = sd[key]
            if set(src) != set(self.names):
                raise ValueError(f"{key}: parameters differ; missing "
                                 f"{sorted(set(self.names) - set(src))}, "
                                 f"extra {sorted(set(src) - set(self.names))}")
            for name, t in zip(self.names, ts):
                if tuple(src[name].shape) != tuple(t.shape):
                    raise ValueError(f"{key} {name}: shape "
                                     f"{tuple(src[name].shape)}, parameter "
                                     f"{tuple(t.shape)}")
                t.copy_(src[name])
        self.count = int(sd["count"])

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        cfg = self.cfg
        if self.shards is not None:
            raise ValueError("an optimizer in the ZeRO-1 layout updates "
                             "through parallel.zero1.sharded_update")
        ps = self.params
        gs = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
        sq = [g.float().square().sum() for g in gs]
        norm = (torch.stack(sq).sum() if self.global_sq is None
                else self.global_sq(sq)).sqrt()
        if cfg.grad_clip_norm is not None:
            # (g / norm) * max when norm >= max, else g unchanged, in
            # optax's arithmetic and without a host sync
            keep = norm < cfg.grad_clip_norm
            div = torch.where(keep, 1.0, norm)
            mul = torch.where(keep, 1.0, cfg.grad_clip_norm)
            gs = [g / div * mul for g in gs]
        self._apply(ps, gs)
        return norm

    @torch.no_grad()
    def update_shards(self, ps: list, gs: list) -> None:
        """The ZeRO-1 update: the chain (no clipping; element-wise) on
        this rank's chunks ``ps`` of the parameters, in place, from the
        chunks ``gs`` of the world's mean gradients, one a parameter in
        :attr:`params`' order."""
        if self.shards is None:
            raise ValueError("update_shards needs an optimizer built in the "
                             "ZeRO-1 layout (shards=(n, index))")
        self._apply(ps, gs)

    def _apply(self, ps: list, gs: list) -> None:
        """Everything of the chain after the clip, in place on ``ps`` and
        the moments, then the count."""
        cfg = self.cfg
        lr = self.schedule(self.count)
        dec = [i for i, d in enumerate(self.decay) if d]
        wd = cfg.weight_decay
        if cfg.optimizer == "adamw":
            b1, b2, eps = 0.9, 0.999, 1e-8
            mu, nu = self.moments["mu"], self.moments["nu"]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, gs, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, gs, gs, value=1 - b2)
            n = F32(self.count + 1)
            bc1 = float(F32(1) - F32(b1) ** n)
            bc2 = float(F32(1) - F32(b2) ** n)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if dec:
                torch._foreach_add_([upd[i] for i in dec],
                                    [ps[i] for i in dec], alpha=wd)
        elif cfg.optimizer == "lars":
            gs = list(gs)
            for i in dec:
                u = gs[i] + wd * ps[i]
                pn, un = ps[i].norm(), u.norm()
                ratio = torch.where((pn == 0) | (un == 0), 1.0,
                                    LARS_TRUST * pn / un)
                gs[i] = u * ratio
            # -lr comes before the trace, and the trace is the update
            upd = self.moments["trace"]
            torch._foreach_mul_(upd, cfg.momentum)
            torch._foreach_add_(upd, torch._foreach_mul(gs, -lr))
        elif cfg.optimizer == "sgd":
            if wd > 0.0 and dec:
                gs = list(gs)
                for i in dec:
                    gs[i] = gs[i] + wd * ps[i]
            trace = self.moments["trace"]
            torch._foreach_mul_(trace, cfg.momentum)
            torch._foreach_add_(trace, gs)
            upd = torch._foreach_add(gs, torch._foreach_mul(
                trace, cfg.momentum))
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        torch._foreach_add_(ps, upd,
                            alpha=1.0 if cfg.optimizer == "lars" else -lr)
        self.count += 1


def _check_elementwise(cfg: TrainConfig) -> None:
    """ZeRO-1 updates each rank's chunk on its own: only an element-wise
    chain gives the replicated update's values."""
    if cfg.grad_clip_norm is not None:
        raise ValueError(
            f"grad_clip_norm={cfg.grad_clip_norm} with the ZeRO-1 weight "
            f"update: global-norm clipping couples every element of every "
            f"leaf, and zero1's update must be element-wise (each rank "
            f"would clip its own chunk by its own norm)")
    if cfg.optimizer == "lars":
        raise ValueError(
            "optimizer='lars' with the ZeRO-1 weight update: LARS's "
            "per-tensor trust ratio couples the elements of a leaf, and "
            "zero1's update must be element-wise")


def build_optimizer(cfg: TrainConfig, model: nn.Module,
                    shards: tuple | None = None) -> Optimizer:
    """``[clip] → optimizer(+wd) → schedule`` over ``model``'s parameters.
    LR linear-scaling rule: peak = base_lr * global_batch / 256 when
    ``scale_lr_by_batch``.  ``shards=(n, index)`` builds the moments in
    the ZeRO-1 layout (see the module docstring)."""
    if cfg.optimizer not in ("adamw", "sgd", "lars"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return Optimizer(cfg, model, lr_schedule(cfg, cfg.global_batch / 256.0),
                     shards)
