"""On-device training augmentation (counterpart of
``tpuframe/data/augment.py``; ``TrainConfig.augment``).

The ops run on the device batch ``[B, H, W, C]`` (any dtype) before
normalisation, inside the train step.  Their randomness comes from an
explicit ``torch.Generator`` that the step seeds per step, so a run is
reproducible.  It does not give the JAX PRNG's bits, so the draws are
apart from their use: :func:`draw` makes the flip bits and crop offsets,
:func:`apply_draws` applies given ones, and the tests hold the latter to
the JAX package's ``apply`` on the bits and offsets JAX drew.

Modes: ``"none"``; ``"flip"`` (per-image horizontal flip, p = 0.5);
``"pad_crop_flip"`` (zero-pad 4 px, random crop back to the stored size,
flip: the CIFAR recipe); ``"crop_flip"`` (random ``crop`` from larger
stored images, flip).  Eval batches are never randomly augmented; their
one companion is :func:`center_crop`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

MODES = ("none", "flip", "pad_crop_flip", "crop_flip")


def flip(images, bits):
    """Horizontal flip of the images whose ``bits [B]`` (bool) are set."""
    return torch.where(bits[:, None, None, None], images.flip(2), images)


def crop(images, oy, ox, crop_h: int, crop_w: int):
    """Per-image crop ``images[i, oy[i]:oy[i]+crop_h, ox[i]:ox[i]+crop_w]``
    (``oy``, ``ox`` int ``[B]``), as one gather."""
    b = images.shape[0]
    dev = images.device
    rows = oy.to(dev)[:, None] + torch.arange(crop_h, device=dev)
    cols = ox.to(dev)[:, None] + torch.arange(crop_w, device=dev)
    idx = torch.arange(b, device=dev)[:, None, None]
    return images[idx, rows[:, :, None], cols[:, None, :]]


def _check(mode, h, w, crop_size):
    if mode not in MODES:
        raise ValueError(f"unknown augment mode {mode!r}; expected none | "
                         f"flip | pad_crop_flip | crop_flip")
    if mode == "crop_flip":
        if crop_size is None:
            raise ValueError("crop_flip needs the model input size")
        if h < crop_size or w < crop_size:
            raise ValueError(
                f"crop_flip: stored images {(h, w)} smaller than crop "
                f"{crop_size} — prepare shards with a larger --image-size")


def draw(mode: str, shape, gen: torch.Generator, *,
         crop_size: int | None = None, device=None) -> dict:
    """The random draws of one batch of ``shape [B, H, W, C]``: ``flip``
    bits ``[B]`` and, for the crop modes, offsets ``oy``, ``ox`` ``[B]``
    (uniform over the valid range)."""
    b, h, w, _ = shape
    _check(mode, h, w, crop_size)
    out = {}
    if mode in ("pad_crop_flip", "crop_flip"):
        dy, dx = (8, 8) if mode == "pad_crop_flip" else (h - crop_size,
                                                          w - crop_size)
        out["oy"] = torch.randint(0, dy + 1, (b,), generator=gen,
                                  device=device)
        out["ox"] = torch.randint(0, dx + 1, (b,), generator=gen,
                                  device=device)
    out["flip"] = torch.rand((b,), generator=gen, device=device) < 0.5
    return out


def apply_draws(mode: str, images, draws: dict, *,
                crop_size: int | None = None):
    """``mode`` on ``images`` with the given draws (see :func:`draw`)."""
    _, h, w, _ = images.shape
    _check(mode, h, w, crop_size)
    if mode == "none":
        return images
    if mode == "pad_crop_flip":
        images = crop(F.pad(images, (0, 0, 4, 4, 4, 4)), draws["oy"],
                      draws["ox"], h, w)
    elif mode == "crop_flip":
        images = crop(images, draws["oy"], draws["ox"], crop_size,
                      crop_size)
    return flip(images, draws["flip"].to(images.device))


def apply(mode: str, images, gen: torch.Generator, *,
          crop_size: int | None = None):
    """Dispatch on the config's ``augment`` mode (train path only), with
    draws from ``gen`` (a generator on the images' device)."""
    if mode == "none":
        return images
    return apply_draws(mode, images,
                       draw(mode, images.shape, gen, crop_size=crop_size,
                            device=images.device),
                       crop_size=crop_size)


def center_crop(images, crop_size: int):
    """The deterministic eval-side companion of ``crop_flip``."""
    h, w = images.shape[1], images.shape[2]
    if h == crop_size and w == crop_size:
        return images
    if h < crop_size or w < crop_size:
        raise ValueError(
            f"center_crop: stored images {(h, w)} smaller than crop "
            f"{crop_size} — prepare shards with a larger --image-size")
    oy, ox = (h - crop_size) // 2, (w - crop_size) // 2
    return images[:, oy:oy + crop_size, ox:ox + crop_size, :]
