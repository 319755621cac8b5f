"""ResNet-18/34/50/101/152 (counterpart of ``tpuframe/models/resnet.py``).

He et al. 2015 with v1.5 downsampling (stride 2 on a Bottleneck's 3x3),
with torchvision's module and parameter names (``conv1``, ``bn1``,
``layer{L}.{i}.conv{j}``, ``bn{j}``, ``downsample.0/1``, ``fc``), so that
``bn="flax"`` and ``bn="fused"`` models share one ``state_dict`` layout.

The input is ``[B, H, W, C]`` as in the JAX package, and activations stay
in that layout between modules; each convolution sees the ``[B, C, H, W]``
view that ``permute`` gives at no copy (channels_last storage), through
``F.conv2d``, as XLA computes convolutions in the JAX package.  The
numerics follow flax where the two could drift:

  - ``SAME`` padding: a stride-2 convolution on an even input pads
    asymmetrically, (2, 3) for the 7x7 stem at 224 and (0, 1) for a
    Bottleneck's stride-2 3x3; an explicit ``F.pad`` does that.  The max
    pool pads (1, 1) with -inf.
  - BatchNorm (:class:`BatchNorm`, flax ``nn.BatchNorm``): f32 statistics
    with ``var = max(E[x^2] - mu^2, 0)``, ``(x - mu) * (rsqrt(var + eps) *
    gamma) + beta`` in f32, then the compute dtype; running statistics
    ``0.9 * running + 0.1 * batch`` with the biased variance.
  - ``bn="fused"`` routes each Bottleneck 1x1 conv + BN pair (conv1,
    conv3, downsample) through :func:`tpuframe_torch.ops.fused_conv_bn
    .conv1x1_bn_train`, whose backward is the hand-written kernel, and
    whose forward affine runs in the compute dtype (``FusedConvBN``).
    The strided downsample slices ``a[:, ::s, ::s, :]`` first.  Eval mode
    folds the running statistics in the compute dtype.
  - Parameters and BN statistics are f32; convolutions, the Dense and the
    BN outputs run in ``dtype``; the logits are f32.
  - Init: convolutions flax's ``variance_scaling(2.0, "fan_out",
    "normal")`` (a normal truncated at 2 sigma), the last BN scale of each
    block zero, the Dense ``normal(0.01)`` with a zero bias.

  - ``bn="folded"`` normalises with :class:`~tpuframe_torch.models
    .folded_bn.FoldedBatchNorm` everywhere, the stem's and the
    downsample's included.
  - ``stem="space_to_depth"`` (ImageNet stem only) rearranges the input
    into ``[B, H/2, W/2, 12]`` (:func:`space_to_depth`) and runs a 4x4
    stride-1 conv; :func:`s2d_stem_kernel` turns a 7x7 stride-2 stem's
    weight into the equivalent 4x4 one.
  - ``remat=True`` recomputes each residual block in the backward
    (``torch.utils.checkpoint``, non-reentrant), as flax's ``nn.remat``
    does; the recomputed forward leaves the running statistics alone, so
    they move once a step, as in flax.

Under fsdp's sharded state (``parallel/fsdp.py``) every parameter is read
through ``fsdp.full``, and each BatchNorm (fused or not) takes its batch
statistics over its ``stats_group``, the batch group (data x fsdp) that
``fsdp.shard_`` hands it: the global batch's, as GSPMD computes flax's
``jnp.mean`` over a batch split over those axes.  One all-reduce a
BatchNorm a pass (``collectives.bn_stats_sum``); a ``remat`` recompute
issues its forward's again, in the same order on every rank.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tpuframe_torch import _device
from tpuframe_torch.ops import fused_conv_bn as fcb
from tpuframe_torch.parallel.fsdp import full

MOMENTUM = 0.9
EPS = 1e-5


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    """flax/XLA ``SAME`` padding of one spatial dim: (low, high)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """``flax.linen.Conv(use_bias=False, padding="SAME", dtype=dtype)`` on
    ``[B, H, W, C]``; the weight is stored ``[O, I, kh, kw]`` (f32)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.k, self.stride, self.dtype = k, stride, dtype
        self.weight = nn.Parameter(torch.empty((cout, cin, k, k),
                                               device=device))

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        stride = self.stride
        if self.k == 1 and stride > 1:
            # A strided 1x1 conv is a spatial slice and a stride-1 conv
            # (PyTorch 2.13's CPU backward of the strided one crashes on
            # channels_last inputs).
            x, stride = x[:, :, ::stride, ::stride], 1
        (hl, hh), (wl, wh) = (_same_pads(x.shape[d], self.k, stride)
                              for d in (2, 3))
        pad = 0
        if (hl, wl) == (hh, wh) and hl == wl:
            pad = hl
        else:
            x = F.pad(x, (wl, wh, hl, hh))
        y = F.conv2d(x, full(self.weight).to(self.dtype), stride=stride,
                     padding=pad)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` on
    ``[B, H, W, C]``: ``weight``/``bias`` are flax's scale/bias,
    ``running_mean``/``running_var`` its batch_stats.  ``stats_group``:
    the ``mesh.Group`` the batch statistics are taken over (None: this
    rank's rows alone)."""

    stats_group = None

    def __init__(self, features: int, *, zero_init: bool = False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.full((features,),
                                              0.0 if zero_init else 1.0,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(features, device=device))
        self.register_buffer("running_var",
                             torch.ones(features, device=device))

    @torch.no_grad()
    def update_running(self, mean, var) -> None:
        """``running = 0.9 * running + 0.1 * batch`` (flax's momentum)."""
        self.running_mean.mul_(MOMENTUM).add_((1 - MOMENTUM) * mean)
        self.running_var.mul_(MOMENTUM).add_((1 - MOMENTUM) * var)

    def stats(self, xf, train: bool, update: bool = True):
        """``(mean, var)`` to normalise the f32 ``xf`` with: the batch's
        in training (updating the running ones unless ``update`` is False,
        as in a recomputed forward), else the running ones."""
        if not train:
            return self.running_mean, self.running_var
        mean, var = fcb.batch_moments(xf, (0, 1, 2), self.stats_group)
        if update:
            self.update_running(mean.detach(), var.detach())
        return mean, var

    def forward(self, x, train: bool, update: bool = True):
        xf = x.float()
        mean, var = self.stats(xf, train, update)
        y = (xf - mean) * (torch.rsqrt(var + EPS) * full(self.weight)) \
            + full(self.bias)
        return y.to(self.dtype)


def conv_bn(conv: Conv, bn: BatchNorm, x, train: bool, fused: bool,
            update: bool = True):
    """A conv + BN pair; with ``fused`` (a 1x1 conv) one fused op."""
    if not fused:
        return bn(conv(x), train, update)
    s = conv.stride
    x = x.to(conv.dtype)
    if s > 1:
        x = x[:, ::s, ::s, :].contiguous()
    w = full(conv.weight)[:, :, 0, 0].T    # [K, C]
    gamma, beta = full(bn.weight), full(bn.bias)
    if not train:
        return fcb.conv1x1_bn_eval(x, w, gamma, beta, bn.running_mean,
                                   bn.running_var, eps=EPS)
    y, mean, var = fcb.conv1x1_bn_train(x, w, gamma, beta, eps=EPS,
                                        group=bn.stats_group)
    if update:
        bn.update_running(mean, var)
    return y


class Downsample(nn.Sequential):
    """``downsample.0`` (1x1 conv) and ``downsample.1`` (BN)."""

    def __init__(self, cin, cout, stride, fused, norm, dtype, device):
        super().__init__(Conv(cin, cout, 1, stride, dtype=dtype,
                              device=device),
                         norm(cout, dtype=dtype, device=device))
        self.fused = fused

    def forward(self, x, train: bool, update: bool = True):
        return conv_bn(self[0], self[1], x, train, self.fused, update)


class BasicBlock(nn.Module):
    """2x 3x3: the ResNet-18/34 block."""

    expansion = 1

    def __init__(self, cin, filters, stride, *, fused=False, norm=BatchNorm,
                 dtype=torch.float32, device=None):
        super().__init__()
        if fused:
            raise ValueError("bn='fused' targets the Bottleneck 1x1 convs; "
                             "BasicBlock models have no 1x1 compute convs")
        kw = dict(dtype=dtype, device=device)
        self.conv1 = Conv(cin, filters, 3, stride, **kw)
        self.bn1 = norm(filters, **kw)
        self.conv2 = Conv(filters, filters, 3, **kw)
        self.bn2 = norm(filters, zero_init=True, **kw)
        self.downsample = (Downsample(cin, filters, stride, False, norm,
                                      dtype, device)
                           if stride != 1 or cin != filters else None)

    def forward(self, x, train: bool, update: bool = True):
        y = F.relu(self.bn1(self.conv1(x), train, update))
        y = self.bn2(self.conv2(y), train, update)
        res = (x if self.downsample is None
               else self.downsample(x, train, update))
        return F.relu(res + y)


class Bottleneck(nn.Module):
    """1x1 → 3x3 (stride) → 1x1 (4x): the ResNet-50/101/152 block (v1.5).
    With ``fused`` the three 1x1 conv + BN pairs run the fused op."""

    expansion = 4

    def __init__(self, cin, filters, stride, *, fused=False, norm=BatchNorm,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        out = filters * 4
        self.fused = fused
        self.conv1 = Conv(cin, filters, 1, **kw)
        self.bn1 = norm(filters, **kw)
        self.conv2 = Conv(filters, filters, 3, stride, **kw)
        self.bn2 = norm(filters, **kw)
        self.conv3 = Conv(filters, out, 1, **kw)
        self.bn3 = norm(out, zero_init=True, **kw)
        self.downsample = (Downsample(cin, out, stride, fused, norm, dtype,
                                      device)
                           if stride != 1 or cin != out else None)

    def forward(self, x, train: bool, update: bool = True):
        y = F.relu(conv_bn(self.conv1, self.bn1, x, train, self.fused,
                           update))
        y = F.relu(self.bn2(self.conv2(y), train, update))
        y = conv_bn(self.conv3, self.bn3, y, train, self.fused, update)
        res = (x if self.downsample is None
               else self.downsample(x, train, update))
        return F.relu(res + y)


def space_to_depth(x, block: int = 2):
    """``[B, H, W, C]`` → ``[B, H/b, W/b, b*b*C]``, channels in (row
    offset, column offset, C) order, as :func:`s2d_stem_kernel` expects."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block,
                                               block * block * c)


def s2d_stem_kernel(w7):
    """A 7x7 stride-2 stem weight ``[O, C, 7, 7]`` → the equivalent
    ``[O, 4C, 4, 4]`` weight of the space-to-depth stem: padded to 8x8 at
    the end, even and odd taps split into the depth axis.  The 4x4
    stride-1 conv's SAME padding (1, 2) on ``H/2`` then reads the inputs
    the 7x7 one's (2, 3) on ``H`` does, with the eighth tap zero."""
    o, c = w7.shape[:2]
    w8 = F.pad(w7, (0, 1, 0, 1))
    # [O, C, 8, 8] → [O, C, 4, p=2, 4, q=2] → [O, (p, q, C), 4, 4]
    w8 = w8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return w8.reshape(o, 4 * c, 4, 4)


def _remat_block(block, x):
    """A training forward of ``block`` whose activations are recomputed in
    the backward.  The recomputation runs the block a second time with
    ``update=False``, so the running statistics move once, as under
    flax's ``nn.remat``.  The block draws no random numbers, so the RNG
    state need not be kept for the recomputation."""
    calls = []

    def run(x):
        calls.append(None)
        return block(x, True, len(calls) == 1)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class ResNet(nn.Module):
    """``tpuframe.models.resnet.ResNet``: images ``[B, H, W, C]`` → f32
    logits ``[B, num_classes]``.  ``forward(x, train=True)`` normalises
    with batch statistics and updates the running ones."""

    def __init__(self, stage_sizes, block_cls, *, num_classes: int = 1000,
                 width: int = 64, cifar_stem: bool = False,
                 dtype="float32", stem: str = "conv", remat: bool = False,
                 bn: str = "flax", device="cuda", seed: int = 0):
        super().__init__()
        if bn == "folded":
            from tpuframe_torch.models.folded_bn import FoldedBatchNorm

            norm = FoldedBatchNorm
        elif bn in ("flax", "fused"):
            norm = BatchNorm
        else:
            raise ValueError(f"unknown bn {bn!r}; expected 'flax', 'folded'"
                             f" or 'fused'")
        if stem not in ("conv", "space_to_depth"):
            raise ValueError(f"unknown stem {stem!r}; expected 'conv' or "
                             f"'space_to_depth'")
        device = _device.resolve(device)
        dt = getattr(torch, str(dtype).replace("torch.", ""))
        self.dtype, self.cifar_stem, self.remat = dt, cifar_stem, remat
        # the CIFAR stem wins over stem=, as in flax
        self.s2d = stem == "space_to_depth" and not cifar_stem
        fused = bn == "fused"
        if cifar_stem:
            self.conv1 = Conv(3, width, 3, dtype=dt, device=device)
        elif self.s2d:
            # flax pads this conv ((1, 2), (1, 2)): its SAME padding
            self.conv1 = Conv(12, width, 4, dtype=dt, device=device)
        else:
            self.conv1 = Conv(3, width, 7, 2, dtype=dt, device=device)
        self.bn1 = norm(width, dtype=dt, device=device)
        cin = width
        for i, n_blocks in enumerate(stage_sizes):
            blocks = []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                blocks.append(block_cls(cin, width * 2 ** i, stride,
                                        fused=fused, norm=norm, dtype=dt,
                                        device=device))
                cin = width * 2 ** i * block_cls.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.n_stages = len(stage_sizes)
        self.fc = nn.Linear(cin, num_classes, device=device)
        self._init_weights(seed)

    @torch.no_grad()
    def _init_weights(self, seed: int) -> None:
        gen = torch.Generator(device=self.fc.weight.device)
        gen.manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, Conv):
                # variance_scaling(2.0, "fan_out", "normal"): truncated at
                # 2 sigma, std rescaled so the variance is 2 / fan_out.
                o, _, kh, kw = mod.weight.shape
                std = math.sqrt(2.0 / (o * kh * kw)) / .87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
        self.fc.weight.normal_(0.0, 0.01, generator=gen)
        self.fc.bias.zero_()

    def forward(self, x, *, train: bool = False):
        x = x.to(self.dtype)
        if self.s2d:
            x = space_to_depth(x, 2)
        x = F.relu(self.bn1(self.conv1(x), train))
        if not self.cifar_stem:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1)
            x = x.permute(0, 2, 3, 1)
        remat = self.remat and train and torch.is_grad_enabled()
        for i in range(self.n_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = _remat_block(block, x) if remat else block(x, train)
        x = x.mean(dim=(1, 2))                  # global average pool
        x = F.linear(x, full(self.fc.weight).to(self.dtype),
                     full(self.fc.bias).to(self.dtype))
        return x.float()


def ResNet18(num_classes: int = 10, *, cifar_stem: bool = True,
             dtype="float32", remat: bool = False, bn: str = "flax",
             device="cuda", seed: int = 0) -> ResNet:
    """Config 2's default: ResNet-18 with the CIFAR stem."""
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes=num_classes,
                  cifar_stem=cifar_stem, dtype=dtype, remat=remat, bn=bn,
                  device=device, seed=seed)


def ResNet34(num_classes: int = 1000, *, cifar_stem: bool = False,
             dtype="float32", remat: bool = False, bn: str = "flax",
             device="cuda", seed: int = 0) -> ResNet:
    return ResNet((3, 4, 6, 3), BasicBlock, num_classes=num_classes,
                  cifar_stem=cifar_stem, dtype=dtype, remat=remat, bn=bn,
                  device=device, seed=seed)


def _bottleneck_resnet(stage_sizes):
    def build(num_classes: int = 1000, *, cifar_stem: bool = False,
              dtype="float32", stem: str = "conv", remat: bool = False,
              bn: str = "flax", device="cuda", seed: int = 0) -> ResNet:
        return ResNet(stage_sizes, Bottleneck, num_classes=num_classes,
                      cifar_stem=cifar_stem, dtype=dtype, stem=stem,
                      remat=remat, bn=bn, device=device, seed=seed)

    return build


ResNet50 = _bottleneck_resnet((3, 4, 6, 3))      # configs 3 and 5
ResNet101 = _bottleneck_resnet((3, 4, 23, 3))
ResNet152 = _bottleneck_resnet((3, 8, 36, 3))
