"""Folded BatchNorm (counterpart of ``tpuframe/models/folded_bn.py``):
``ResNet(bn="folded")``.

The statistics and the per-channel affine stay in f32, and the
normalisation is one activation-sized multiply-add in the compute dtype:

    a = gamma * rsqrt(var + eps)                       # f32, [C]
    b = beta - mean * a                                # f32, [C]
    y = x * a.to(dtype) + b.to(dtype)                  # compute dtype

The batch statistics come from ``x.to(f32)``, squared after the convert:
squaring in bf16 first would make ``E[x^2] - E[x]^2`` cancel
catastrophically for a channel with ``|mean| >> std``.  ``var = max(E[x^2]
- mean^2, 0)`` (biased), and the running statistics move as flax's do,
``0.9 * running + 0.1 * batch``.  In f32 the result equals
:class:`~tpuframe_torch.models.resnet.BatchNorm`'s up to rounding; in bf16
``a`` and ``b`` are rounded once before the activation math.

The parameters and buffers are :class:`BatchNorm`'s (``weight``/``bias``
for flax's scale/bias, ``running_mean``/``running_var`` for its
batch_stats), so both modes share one ``state_dict`` layout.
"""

from __future__ import annotations

import torch

from tpuframe_torch.models.resnet import EPS, BatchNorm


class FoldedBatchNorm(BatchNorm):
    """``tpuframe.models.folded_bn.FoldedBatchNorm(momentum=0.9,
    epsilon=1e-5, dtype=dtype)`` on ``[B, H, W, C]``."""

    def forward(self, x, train: bool, update: bool = True):
        mean, var = self.stats(x.float(), train, update)
        a = self.weight.float() * torch.rsqrt(var + EPS)
        b = self.bias.float() - mean * a
        x = x.to(self.dtype)
        return x * a.to(self.dtype) + b.to(self.dtype)
