"""The MNIST ConvNet (counterpart of ``tpuframe/models/convnet.py``): the
model of ``mnist_single``.

Two 3x3 convolutions (32 and 64 channels, each with a bias and ReLU), a
2x2 max pool, dropout, a Dense of 128 with ReLU, dropout, and the Dense
head.  It follows flax where the torch MNIST example differs:

  - ``SAME`` padding, so the pool sees 28x28 and ``fc1`` takes
    ``14 * 14 * 64 = 12544`` features (the torch example pads ``VALID``
    and takes 9216);
  - the input is ``[B, 28, 28, 1]`` and the pooled activations flatten in
    ``(H, W, C)`` order, as ``x.reshape((B, -1))`` does on flax's NHWC
    arrays;
  - ``dropout=None`` keeps the reference rates (0.25 after the pool, 0.5
    after ``fc1``), a number sets both, and 0.0 turns both off.  A
    training forward keeps each value with probability ``1 - p`` and
    scales it by ``1 / (1 - p)``, with the masks drawn from the
    ``generator`` it is given; eval applies none;
  - parameters are f32, the convolutions and Dense layers run in
    ``dtype``, the logits are f32;
  - init: flax's ``lecun_normal`` kernels (a normal truncated at 2 sigma,
    variance ``1 / fan_in``) and zero biases.

Under fsdp's sharded state every parameter is read through ``fsdp.full``;
the step seeds each rank's dropout generator by its batch index
(``parallel/step.py``), so ranks that take other rows draw other masks
and a sharded run draws other masks than one process on the same global
batch.

Parameter names: ``conv1``, ``conv2``, ``fc1``, ``fc2`` for flax's
``Conv_0``, ``Conv_1``, ``Dense_0``, ``Dense_1``
(``models.convert.convnet_from_jax``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from tpuframe_torch import _device
from tpuframe_torch.parallel.fsdp import full


def dropout(x, p: float, generator: torch.Generator):
    """flax's ``nn.Dropout``: keep with probability ``1 - p``, scale the
    kept values by ``1 / (1 - p)``; ``p = 0`` is the identity."""
    if p == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


class ConvNet(nn.Module):
    """``tpuframe.models.convnet.ConvNet``: images ``[B, 28, 28, 1]`` →
    f32 logits ``[B, num_classes]``."""

    def __init__(self, num_classes: int = 10, *, dtype="float32",
                 dropout: float | None = None, device="cuda", seed: int = 0):
        super().__init__()
        device = _device.resolve(device)
        self.dtype = getattr(torch, str(dtype).replace("torch.", ""))
        self.rates = ((0.25, 0.5) if dropout is None
                      else (float(dropout), float(dropout)))
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1, device=device)
        self.fc1 = nn.Linear(14 * 14 * 64, 128, device=device)
        self.fc2 = nn.Linear(128, num_classes, device=device)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator(device=self.fc1.weight.device)
        gen.manual_seed(seed)
        for mod in (self.conv1, self.conv2, self.fc1, self.fc2):
            w = mod.weight
            # lecun_normal: truncated at 2 sigma, std rescaled so that the
            # variance is 1 / fan_in
            std = math.sqrt(1.0 / (w[0].numel())) / .87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            mod.bias.zero_()

    def forward(self, x, *, train: bool = False,
                generator: torch.Generator | None = None):
        """``train`` applies dropout, with masks from ``generator`` (it is
        required then, unless the rates are 0)."""
        dt = self.dtype
        drop = train and any(self.rates)
        if drop and generator is None:
            raise ValueError("a training forward with dropout needs a "
                             "generator")
        w = {n: full(p).to(dt) for n, p in self.named_parameters()}
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.relu(F.conv2d(x, w["conv1.weight"], w["conv1.bias"],
                            padding=1))
        x = F.relu(F.conv2d(x, w["conv2.weight"], w["conv2.bias"],
                            padding=1))
        x = F.max_pool2d(x, 2, 2)
        if drop:
            x = dropout(x, self.rates[0], generator)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # (H, W, C)
        x = F.relu(F.linear(x, w["fc1.weight"], w["fc1.bias"]))
        if drop:
            x = dropout(x, self.rates[1], generator)
        x = F.linear(x, w["fc2.weight"], w["fc2.bias"])
        return x.float()
