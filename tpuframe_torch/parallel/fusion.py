"""Gradient-fusion buffers: Horovod's tensor fusion on ``torch.distributed``
(counterpart of ``tpuframe/parallel/fusion.py``).

Horovod packs many small gradients into one buffer per cycle so that each
collective pays its latency once, and starts each buffer's allreduce from
a gradient hook while the backward still runs.  Both halves are here:

  tensors are greedily packed, in order, into same-dtype buckets of up to
  ``threshold_bytes`` (a tensor larger than the threshold gets a bucket of
  its own), each bucket is flattened into one 1-D buffer, ONE
  ``all_reduce`` runs per bucket, and the results are copied back.

:func:`fused_sum_` / :func:`fused_mean_` — the synchronous reference
  (the JAX package's ``fused_psum``): pack, reduce, unpack one bucket at a
  time, in place on a list of tensors.

:class:`StagedReducer` — the overlapped pass (``staged_psum``), in
  PyTorch's idiom: a ``register_post_accumulate_grad_hook`` on every
  parameter packs a bucket once its last gradient has accumulated and
  starts its ``all_reduce`` with ``async_op=True``; :meth:`finish`, after
  ``backward()``, starts what is left, waits for every bucket in plan
  order and unpacks into ``.grad``.

``threshold_bytes <= 0`` gives every tensor a bucket of its own (one
collective per tensor, the ``HOROVOD_FUSION_THRESHOLD=0`` semantics).  The
values do not change with the threshold: the reduction is elementwise, so
over two ranks the bucketed sums are bit-equal to the per-tensor ones.

Where this module and the JAX one differ:

  - the bucket key is the dtype alone (PyTorch has no varying manual
    axes; it is the JAX code's own fallback);
  - the staged pass's plan order is the reverse of
    ``model.parameters()``, the order in which the backward produces
    gradients (as DDP and Horovod do), where JAX buckets in
    ``jax.tree.flatten`` order and leaves the overlap to XLA's scheduler.
    It changes which tensors share a bucket, never a value;
  - :func:`resolve` is env > ``default``: the port has no tuning DB, so a
    ``program`` or ``family`` argument changes nothing (on an H100 the JAX
    chain's DB leg is gated off too, naming no TPU generation);
  - :func:`check_static` holds the env and census legs; the JAX module's
    seeded HLO positive and the ``shard_map`` leg of its ``check`` are XLA
    artefacts and have no counterpart in an eager step.

:func:`pack_for_scatter`, :func:`split_scattered` and
:func:`split_gathered` are the shard-aligned packing of the ZeRO-1 seam
(``parallel/zero1.py``): one reduce-scatter and one all-gather a bucket of
padded flat gradients.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch import nn

from tpuframe_torch.parallel import collectives

ENV_VAR = "TPUFRAME_FUSION_THRESHOLD"


def _leaf_kind(leaf) -> torch.dtype:
    """Bucket compatibility key: the dtype (``torch.cat`` needs one)."""
    return leaf.dtype


def _nbytes(leaf) -> int:
    return leaf.numel() * leaf.element_size()


def _bucketize(leaves: Sequence, threshold_bytes: int) -> list[list[int]]:
    """Greedy same-kind packing in leaf order; returns index buckets."""
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    cur_kind = None
    for i, leaf in enumerate(leaves):
        nbytes = _nbytes(leaf)
        if cur and (_leaf_kind(leaf) != cur_kind
                    or cur_bytes + nbytes > threshold_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_kind = _leaf_kind(leaf)
    if cur:
        buckets.append(cur)
    return buckets


def plan(leaves: Sequence, threshold_bytes: int) -> list[list[int]]:
    """The index buckets of ``leaves``: one a leaf when
    ``threshold_bytes <= 0``, else :func:`_bucketize`'s."""
    if threshold_bytes <= 0:
        return [[i] for i in range(len(leaves))]
    return _bucketize(leaves, threshold_bytes)


def _dtype_name(dtype: torch.dtype) -> str:
    """``"float32"`` for ``torch.float32``: numpy's name, as the JAX
    census writes it."""
    return str(dtype).removeprefix("torch.")


def bucket_census(leaves: Sequence, threshold_bytes: int) -> dict:
    """Bucketing accounting for a tensor list: per-bucket ``{leaves,
    bytes, dtype}`` rows and totals, in the JAX census's shape.  Shape
    math only (``meta`` tensors do)."""
    rows = [{"leaves": len(b),
             "bytes": int(sum(_nbytes(leaves[i]) for i in b)),
             "dtype": _dtype_name(leaves[b[0]].dtype)}
            for b in plan(leaves, threshold_bytes)]
    return {
        "threshold_bytes": int(threshold_bytes),
        "n_leaves": len(leaves),
        "n_buckets": len(rows),
        "buckets": rows,
        "total_bytes": int(sum(r["bytes"] for r in rows)),
    }


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One fresh contiguous 1-D buffer holding ``tensors`` in order."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _unpack_(flat: torch.Tensor, tensors: Sequence) -> None:
    """Copy ``flat``'s consecutive slices back into ``tensors`` (a None
    entry skips its slice, given as its element count)."""
    off = 0
    for t in tensors:
        n = t if isinstance(t, int) else t.numel()
        if not isinstance(t, int):
            t.copy_(flat[off:off + n].view_as(t))
        off += n


@torch.no_grad()
def fused_sum_(tensors: Sequence[torch.Tensor], grp, *, threshold_bytes: int,
               mean: bool = False) -> None:
    """Sum (or mean) of each tensor over ``grp``, in place, with one
    ``all_reduce`` a bucket of :func:`plan`.  A ``None`` group is the
    identity, as in ``collectives.mean_``."""
    if grp is None or not tensors:
        return
    n = dist.get_world_size(grp)
    for bucket in plan(tensors, threshold_bytes):
        members = [tensors[i] for i in bucket]
        flat = _pack(members)
        collectives.allreduce_start_(flat, grp).wait()
        if mean:
            flat.div_(n)
        _unpack_(flat, members)


def fused_mean_(tensors: Sequence[torch.Tensor], grp, *,
                threshold_bytes: int) -> None:
    fused_sum_(tensors, grp, threshold_bytes=threshold_bytes, mean=True)


def pack_for_scatter(flats: Sequence[torch.Tensor], n: int) -> torch.Tensor:
    """Pack padded flat leaves (each a multiple of ``n`` long) so that a
    reduce-scatter of the result hands rank ``k`` the concatenation of its
    own per-leaf shards: each leaf as ``(n, len / n)``, joined along dim 1
    (a plain concatenation would give rank ``k`` a chunk straddling leaf
    boundaries)."""
    return torch.cat([f.reshape(n, -1) for f in flats], dim=1).reshape(-1)


def split_scattered(shard: torch.Tensor,
                    chunk_sizes: Sequence[int]) -> list[torch.Tensor]:
    """Undo :func:`pack_for_scatter` on the scattered side: a rank's shard
    back into its per-leaf ``[padded / n]`` shards (views)."""
    return list(torch.split(shard, [int(c) for c in chunk_sizes]))


def split_gathered(full: torch.Tensor, n: int,
                   chunk_sizes: Sequence[int]) -> list[torch.Tensor]:
    """Undo :func:`pack_for_scatter` after an all-gather of the packed
    shards: the full vector back into per-leaf ``[padded]`` flats."""
    rows = full.reshape(n, -1)
    return [part.reshape(-1) for part in
            torch.split(rows, [int(c) for c in chunk_sizes], dim=1)]


def plan_params(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """The parameters that take a gradient, named, in the staged pass's
    plan order: the reverse of ``model.named_parameters()``."""
    return [(name, p) for name, p in model.named_parameters()
            if p.requires_grad][::-1]


class StagedReducer:
    """The overlapped bucketed mean of a model's gradients.

    Built once per model: the parameters of :func:`plan_params` in
    buckets of :func:`plan`, with a post-accumulate-grad hook on each.
    :meth:`arm` before the backward whose gradients are reduced (the
    last microbatch's); the hooks of any other backward do nothing.
    Armed, a hook marks its parameter ready; bucket ``k`` is packed and
    its ``all_reduce`` started (``async_op=True``) once it is full and
    buckets ``0..k-1`` have started, so every rank issues the buckets in
    plan order.  :meth:`finish` starts the buckets left (a parameter that
    got no gradient goes as zeros, and keeps ``.grad`` None), waits for
    each in plan order, divides and unpacks into ``.grad``.  ``early``
    counts the buckets started before :meth:`finish` was called."""

    def __init__(self, model: nn.Module, grp, *, threshold_bytes: int):
        self.model = model
        self.grp = grp
        self.threshold_bytes = int(threshold_bytes)
        self.params = [p for _, p in plan_params(model)]
        self.buckets = plan(self.params, self.threshold_bytes)
        self._where = {id(self.params[i]): b
                       for b, bucket in enumerate(self.buckets)
                       for i in bucket}
        self._handles = [p.register_post_accumulate_grad_hook(self._hook)
                         for p in self.params]
        self.armed = False
        self.early = 0
        self._reset()

    def _reset(self) -> None:
        self._ready = [0] * len(self.buckets)
        self._works: list = [None] * len(self.buckets)
        self._flats: list = [None] * len(self.buckets)
        self._next = 0

    def arm(self) -> None:
        self._reset()
        self.armed = True

    def _hook(self, p: torch.Tensor) -> None:
        if not self.armed:
            return
        self._ready[self._where[id(p)]] += 1
        while (self._next < len(self.buckets)
               and self._ready[self._next] == len(self.buckets[self._next])):
            self._start(self._next)

    @torch.no_grad()
    def _start(self, b: int) -> None:
        members = [self.params[i] for i in self.buckets[b]]
        flat = _pack([p.grad if p.grad is not None
                      else torch.zeros_like(p) for p in members])
        self._flats[b] = flat
        self._works[b] = collectives.allreduce_start_(flat, self.grp)
        self._next = b + 1

    @torch.no_grad()
    def finish(self) -> None:
        if not self.armed:
            raise RuntimeError("StagedReducer.finish() without arm()")
        self.armed = False
        self.early = self._next
        for b in range(self._next, len(self.buckets)):
            self._start(b)
        n = dist.get_world_size(self.grp)
        for b, bucket in enumerate(self.buckets):
            self._works[b].wait()
            flat = self._flats[b].div_(n)
            _unpack_(flat, [self.params[i].grad
                            if self.params[i].grad is not None
                            else self.params[i].numel() for i in bucket])
        self._reset()

    def census(self) -> dict:
        return bucket_census(self.params, self.threshold_bytes)

    def remove(self) -> None:
        """Take the hooks off the parameters."""
        for h in self._handles:
            h.remove()
        self._handles = []


def validate_threshold(raw) -> int:
    """Parse a threshold value.  Any int is legal (<= 0 means packing
    off, per the ``HOROVOD_FUSION_THRESHOLD=0`` convention)."""
    try:
        return int(raw)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"invalid fusion threshold {raw!r}; expected an integer byte "
            f"count ({ENV_VAR})") from e


def threshold_from_env(env=os.environ) -> int | None:
    """The explicit ``TPUFRAME_FUSION_THRESHOLD``, or None."""
    raw = env.get(ENV_VAR, "").strip()
    return validate_threshold(raw) if raw else None


def resolve(program: str | None = None, family: str | None = None,
            default: int | None = None) -> tuple:
    """``(threshold_bytes | None, source)``: the env knob, else
    ``default``; ``source`` is ``"env"`` or ``"default"``.  ``program``
    and ``family`` name the tuning-DB row in the JAX package; the port has
    no DB, so they change nothing.  None means fusion off."""
    del program, family
    env_val = threshold_from_env()
    if env_val is not None:
        return env_val, "env"
    return default, "default"


def _census_problems() -> list[str]:
    """Bucket-census arithmetic over a mixed-dtype tensor list."""
    problems: list[str] = []
    leaves = [torch.empty(n, dtype=dt, device="meta") for n, dt in
              ((100, torch.float32), (100, torch.float32),
               (7, torch.float32), (64, torch.int8), (300, torch.float32),
               (1, torch.float32))]
    threshold = 512
    buckets = _bucketize(leaves, threshold)
    if [i for b in buckets for i in b] != list(range(len(leaves))):
        problems.append(
            f"bucketize broke leaf order: {buckets!r} is not an ordered "
            f"partition of {len(leaves)} leaves")
    for b in buckets:
        kinds = {_leaf_kind(leaves[i]) for i in b}
        if len(kinds) != 1:
            problems.append(f"bucket {b!r} mixes leaf kinds {kinds!r}")
        nbytes = sum(_nbytes(leaves[i]) for i in b)
        if len(b) > 1 and nbytes > threshold:
            problems.append(
                f"bucket {b!r} holds {nbytes} B > threshold {threshold}")
    census = bucket_census(leaves, threshold)
    if census["n_buckets"] != len(buckets):
        problems.append("bucket_census disagrees with _bucketize on count")
    if census["total_bytes"] != sum(_nbytes(l) for l in leaves):
        problems.append("bucket_census lost bytes")
    if bucket_census(leaves, 0)["n_buckets"] != len(leaves):
        problems.append("threshold<=0 must census one bucket per leaf")
    return problems


def check_static() -> list[str]:
    """Env parsing and bucket-census arithmetic; [] means healthy."""
    problems: list[str] = []
    try:
        threshold_from_env()
    except ValueError as e:
        problems.append(f"{ENV_VAR} is set to an invalid value: {e}")
    problems.extend(_census_problems())
    return problems
