"""Loss and metric functions (counterpart of ``tpuframe/models/losses.py``).

``reduce`` takes the place of the JAX package's ``reduce_axis``: a
``torch.distributed`` group over which the valid-token mean's numerator
and denominator are summed before dividing (None: this rank alone).
"""

from __future__ import annotations

import torch

from tpuframe_torch.parallel import collectives


def masked_mean(x, labels, ignore_index: int, reduce=None):
    """Mean of ``x`` over positions whose label is not ``ignore_index``.

    With ``reduce`` the numerator and the denominator are summed over the
    group first: per-rank masked means averaged uniformly are biased when
    ranks hold unequal valid counts.  The numerator's sum is
    differentiable, so each rank's gradient is ``world / den`` times its
    own tokens' and the step's gradient mean is the global one."""
    valid = (labels != ignore_index).float()
    num = (x.float() * valid).sum()
    den = valid.sum()
    if reduce is not None:
        num = collectives.all_reduce_sum(num, reduce)
        den = collectives.all_reduce_sum(den.detach(), reduce)
    return num / torch.clamp(den, min=1.0)


def softmax_cross_entropy(logits, labels, label_smoothing: float = 0.0,
                          ignore_index: int | None = None, reduce=None):
    """Mean CE over integer labels (optax's ``softmax_cross_entropy`` with
    one-hot or smoothed targets).  ``ignore_index`` positions contribute
    neither loss nor gradient, and the mean divides by the valid count."""
    num_classes = logits.shape[-1]
    safe = labels.long()
    if ignore_index is not None:
        safe = torch.where(labels == ignore_index, 0, safe)
    logp = torch.log_softmax(logits.float(), dim=-1)
    if label_smoothing > 0.0:
        on = 1.0 - label_smoothing
        off = label_smoothing / (num_classes - 1)
        soft = torch.nn.functional.one_hot(safe, num_classes) * (on - off) \
            + off
        loss = -(soft * logp).sum(dim=-1)
    else:
        loss = -logp.gather(-1, safe[..., None])[..., 0]
    if ignore_index is None:
        return loss.mean()
    return masked_mean(loss, labels, ignore_index, reduce)


def accuracy(logits, labels, ignore_index: int | None = None, reduce=None):
    hit = (logits.argmax(dim=-1) == labels).float()
    if ignore_index is None:
        return hit.mean()
    return masked_mean(hit, labels, ignore_index, reduce)


def topk_accuracy(logits, labels, k: int = 5):
    """Share of rows whose label is among the ``k`` largest logits."""
    topk = logits.topk(k, dim=-1).indices
    return (topk == labels[:, None]).any(dim=-1).float().mean()
