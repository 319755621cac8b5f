"""``tpuframe_torch.parallel.hvd``: the Horovod API on ``torch.distributed``
(counterpart of ``tpuframe/parallel/hvd.py``).

The reference's whole distributed surface is a handful of
``horovod.torch`` calls (SURVEY.md §3a "Distributed glue"):

    hvd.init(); hvd.size(); hvd.rank(); hvd.local_rank()
    hvd.allreduce(t, average=True)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    opt = hvd.DistributedOptimizer(opt)

Here they keep Horovod's own model, one process a card, so a reference
``train.py`` ports verb for verb.  That is where this module and the JAX
package's differ: there ``size()`` counts chips while ``rank()`` is the
host (one process drives every chip of its host); here ``size()`` counts
processes, which are cards, and ``rank()`` is this process's rank among
them.  ``size()`` is the learning-rate scaling denominator in both.

Whenever a process group exists, of any size, the verbs go through
``torch.distributed`` (a world of one on the card runs NCCL's kernels);
with no group each verb is the identity, as the JAX package's verbs are
outside a mapped step.  Tensor verbs take one tensor, as
``horovod.torch``'s do, and return a new one; ``broadcast_parameters``,
``broadcast_optimizer_state`` and ``allreduce_async_`` work in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tpuframe_torch.parallel import bootstrap, collectives, fusion, quantwire
from tpuframe_torch.utils.optim import Optimizer


def init(config: bootstrap.DistConfig | None = None, device="cuda") -> None:
    """``hvd.init()``: join the world the launcher's environment names
    (:func:`tpuframe_torch.parallel.bootstrap.initialize`)."""
    bootstrap.initialize(config, device)


def size() -> int:
    """The number of processes, one a card: the learning-rate scaling
    denominator (``scale LR by hvd.size()``)."""
    return bootstrap.process_count()


def rank() -> int:
    """This process's rank."""
    return bootstrap.process_index()


def local_rank() -> int:
    """This process's index among the ranks on its host: its card."""
    return bootstrap.local_rank()


def local_size() -> int:
    return bootstrap.local_size()


def is_primary() -> bool:
    return bootstrap.is_primary()


class _ReduceOp:
    """Reduction-op sentinel, mirroring ``horovod.torch``'s op
    constants."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"hvd.{self.name}"


Average = _ReduceOp("Average")
Sum = _ReduceOp("Sum")
Adasum = _ReduceOp("Adasum")
Min = _ReduceOp("Min")
Max = _ReduceOp("Max")
Product = _ReduceOp("Product")


class ProcessSet:
    """A subgroup for collectives (Horovod ``hvd.ProcessSet``): a static
    list of ranks.  A collective over it runs over the whole world with
    non-members contributing nothing, and non-members keep their input
    (Horovod's "the op never runs outside the set")."""

    def __init__(self, ranks):
        ranks = tuple(sorted(set(int(r) for r in ranks)))
        if not ranks:
            raise ValueError("ProcessSet needs at least one rank")
        if any(r < 0 for r in ranks):
            raise ValueError(f"negative rank in ProcessSet: {ranks}")
        self.ranks = ranks

    def size(self) -> int:
        return len(self.ranks)

    def __repr__(self):
        return f"ProcessSet(ranks={list(self.ranks)})"


def _resolve_op(average: bool | None, op: _ReduceOp | None) -> _ReduceOp:
    if average is not None and op is not None:
        raise ValueError("specify either average= or op=, not both "
                         "(Horovod raises here too)")
    if op is None:
        op = Sum if average is False else Average
    return op


_ELEMENTWISE = {Average: "mean", Sum: "sum", Min: "min", Max: "max"}


def allreduce(tensor: torch.Tensor, average: bool | None = None,
              name: str | None = None, op: _ReduceOp | None = None,
              process_set: ProcessSet | None = None) -> torch.Tensor:
    """``hvd.allreduce``: ``tensor`` reduced over the world by ``op``
    (``hvd.Average``, the default, ``Sum``, ``Adasum``, ``Min``, ``Max``
    or ``Product``); the legacy ``average=`` may not be combined with
    ``op``.  ``process_set`` restricts Average and Sum to a subgroup:
    members get the subgroup's result, the others keep their input."""
    del name    # Horovod names tensors for its fusion table
    op = _resolve_op(average, op)
    grp = collectives.process_group()
    if process_set is not None:
        if op is Average or op is Sum:
            return collectives.masked_allreduce(
                tensor, grp, process_set.ranks, average=op is Average)
        raise NotImplementedError(
            f"process_set is supported for Average/Sum, not {op!r}")
    if op in _ELEMENTWISE:
        return collectives.allreduce(tensor, grp, _ELEMENTWISE[op])
    if op is Adasum:
        out = tensor.clone()
        collectives.adasum_([out], grp)
        return out
    if op is Product:
        return collectives.reduce_prod(tensor, grp)
    raise ValueError(f"unknown reduction op {op!r}")


def _named_tensors(params) -> list[torch.Tensor]:
    """The tensors of a ``state_dict``, a dict of tensors, or named
    ``(name, tensor)`` pairs (``model.named_parameters()``)."""
    items = params.items() if hasattr(params, "items") else params
    return [t for _, t in items]


@torch.no_grad()
def broadcast_parameters(params, root_rank: int = 0,
                         process_set: ProcessSet | None = None) -> None:
    """``hvd.broadcast_parameters``: every rank (of ``process_set``)
    copies ``root_rank``'s tensors into its own, in place.  ``params`` is
    a ``state_dict`` (parameters and buffers, BatchNorm statistics among
    them) or named tensors."""
    grp = collectives.process_group()
    for t in _named_tensors(params):
        if process_set is not None:
            got = collectives.masked_broadcast(t, grp, process_set.ranks,
                                               root=root_rank)
        else:
            got = collectives.broadcast(t, grp, root_rank)
        if got is not t:
            t.copy_(got)


def _unwrap(opt):
    return opt.inner if isinstance(opt, _DistributedOptimizer) else opt


@torch.no_grad()
def broadcast_optimizer_state(opt: Optimizer, root_rank: int = 0) -> None:
    """``hvd.broadcast_optimizer_state``: ``root_rank``'s update count and
    every moment of the port's :class:`Optimizer` (or a
    :func:`DistributedOptimizer` around one), in place on every rank.  An
    optimizer in the ZeRO-1 layout is refused: each rank holds its own
    chunk of every moment, which a broadcast would overwrite."""
    opt = _unwrap(opt)
    if opt.shards is not None:
        raise ValueError("broadcast_optimizer_state on an optimizer in the "
                         "ZeRO-1 layout: each rank's moments are its own "
                         "chunks, not replicas")
    opt.count = bootstrap.broadcast_object(opt.count, root_rank)
    for moments in opt.moments.values():
        broadcast_parameters(enumerate(moments), root_rank)


class Compression:
    """Horovod's ``hvd.Compression`` namespace, for
    ``DistributedOptimizer``'s ``compression``: ``fp16`` puts bf16 on the
    wire (the card's half precision for gradients, as in the JAX package)
    and gives the original dtype back."""

    none = None
    fp16 = "bf16"


class _DistributedOptimizer:
    """See :func:`DistributedOptimizer`."""

    def __init__(self, inner: Optimizer, op: _ReduceOp,
                 compression: str | None):
        self.inner = inner
        self.op = op
        self.compression = compression

    def __getattr__(self, name):
        # the inner optimizer's state (params, count, moments, ...)
        return getattr(self.__dict__["inner"], name)

    def state_dict(self) -> dict:
        return self.inner.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.inner.load_state_dict(sd)

    @torch.no_grad()
    def reduce_gradients(self) -> None:
        """Each parameter's ``.grad`` reduced over the world in place."""
        grp = collectives.process_group()
        grads = [p.grad for p in self.inner.params if p.grad is not None]
        if self.op is Adasum:
            collectives.adasum_(grads, grp)
            return
        if self.compression == "int8":
            # the quantized wire replaces the reduction outright, with no
            # size floor: an explicit per-optimizer ask
            for g, m in zip(grads, quantwire.all_reduce_mean(grads, grp,
                                                            min_elems=0)):
                g.copy_(m)
            return
        # the bf16 wire copies are what is reduced (and packed), as the
        # JAX package compresses, then averages; with the fusion knob
        # unset or <= 0, one bucket (one all_reduce) a tensor
        wires = [g.to(torch.bfloat16) if self.compression == "bf16"
                 and g.dtype == torch.float32 else g for g in grads]
        threshold = max(fusion.threshold_from_env() or 0, 0)
        fusion.fused_sum_(wires, grp, threshold_bytes=threshold,
                          mean=self.op is Average)
        for g, wire in zip(grads, wires):
            if wire is not g:
                g.copy_(wire)

    def step(self) -> torch.Tensor:
        """Reduce the gradients, then the inner optimizer's step; returns
        its gradient norm."""
        self.reduce_gradients()
        return self.inner.step()


def DistributedOptimizer(opt: Optimizer, *, average: bool | None = None,
                         compression: str | None = None,
                         op: _ReduceOp | None = None):
    """Wrap the port's :class:`Optimizer` so that ``step()`` first reduces
    every parameter's ``.grad`` over the world: by Average (the default),
    Sum or Adasum (``op=hvd.Adasum``, the scale-insensitive large-batch
    reduction).  ``state_dict``/``load_state_dict`` pass through, so
    checkpoints are the inner optimizer's.

    ``compression``: ``None`` or ``Compression.fp16`` (``"bf16"``): f32
    gradients go over the wire in bf16 and come back in f32.  ``"int8"``:
    the block-quantized wire, ``quantwire.all_reduce_mean`` with no size
    floor (``min_elems=0``), a quantized mean, so it needs Average, as in
    the JAX package.  Adasum's norm-based combine takes no compression,
    as in Horovod.

    The reduction runs in ``step()``: one collective a tensor, or, with
    ``TPUFRAME_FUSION_THRESHOLD`` set above 0, one a fusion bucket
    (``parallel/fusion.py``), as in the JAX package.  The trainer's step
    overlaps its buckets with the backward (``fusion.StagedReducer``);
    this wrapper sees the gradients only once the backward is done."""
    op = _resolve_op(average, op)
    if op not in (Average, Sum, Adasum):
        raise ValueError(f"DistributedOptimizer supports Average/Sum/Adasum, "
                         f"got {op!r}")
    if op is Adasum and compression is not None:
        raise ValueError("Adasum's norm-based combine does not compose with "
                         "wire compression")
    if compression == "int8" and op is not Average:
        raise ValueError("compression='int8' implements a quantized mean; "
                         "use average=True")
    if compression not in (None, "bf16", "int8"):
        raise ValueError(f"unknown compression {compression!r}")
    return _DistributedOptimizer(opt, op, compression)


def allgather(tensor: torch.Tensor, name: str | None = None) -> torch.Tensor:
    """``hvd.allgather``: every rank's tensor concatenated along dim 0."""
    del name
    return collectives.allgather(tensor, collectives.process_group())


def alltoall(tensor: torch.Tensor, splits=None,
             name: str | None = None) -> torch.Tensor:
    """``hvd.alltoall`` with equal splits (dim 0 scattered, gathered
    back).  Ragged ``splits`` are refused, as in the JAX package, whose
    collectives have static shapes: pad to equal splits instead."""
    del name
    if splits is not None:
        splits = [int(x) for x in splits]
        if (len(set(splits)) != 1 or sum(splits) != tensor.shape[0]
                or len(splits) != size()):
            raise NotImplementedError(
                f"alltoall with splits {splits} is ragged; only equal "
                f"splits, one a rank, are supported — pad to equal splits")
    return collectives.alltoall(tensor, collectives.process_group())


def grouped_allreduce(tensors, average: bool = True,
                      name: str | None = None) -> list[torch.Tensor]:
    """``hvd.grouped_allreduce``: :func:`allreduce` of each tensor of a
    list."""
    del name
    return [allreduce(t, average=average) for t in tensors]


def barrier() -> None:
    """``hvd.barrier``: a process barrier."""
    bootstrap.host_barrier("tpuframe_hvd_barrier")


def join() -> int:
    """``hvd.join``: Horovod's straggler drain.  Ranks leave together (a
    failed rank fails the job, which restarts from a checkpoint), so this
    is a barrier; returns -1, as Horovod does when no rank is joining."""
    barrier()
    return -1


def shutdown() -> None:
    """``hvd.shutdown``; a later ``hvd.init()`` starts afresh."""
    bootstrap.shutdown()


class _Handle:
    """What :func:`allreduce_async_` returns: ``work``, the ``Work`` of
    ``async_op=True`` (None when the op ran synchronously), and the
    tensor the result lands in."""

    def __init__(self, work, tensor: torch.Tensor, divisor: int = 1):
        self.work = work
        self.tensor = tensor
        self.divisor = divisor


def allreduce_async_(tensor: torch.Tensor, average: bool | None = None,
                     name: str | None = None, op: _ReduceOp | None = None,
                     process_set: ProcessSet | None = None) -> _Handle:
    """``hvd.allreduce_async_``: start an in-place allreduce of
    ``tensor`` and return a handle for :func:`synchronize`.  Average, Sum,
    Min and Max are one ``all_reduce(async_op=True)``; the other ops and
    process sets run at once and the handle holds their result."""
    op = _resolve_op(average, op)
    grp = collectives.process_group()
    if (grp is None or process_set is not None
            or op not in _ELEMENTWISE):
        out = allreduce(tensor, name=name, op=op, process_set=process_set)
        if out is not tensor:
            tensor.copy_(out)
        return _Handle(None, tensor)
    work = collectives.allreduce_start_(tensor, grp, _ELEMENTWISE[op])
    return _Handle(work, tensor,
                   dist.get_world_size(grp) if op is Average else 1)


def synchronize(handle: _Handle) -> torch.Tensor:
    """``hvd.synchronize``: wait for an :func:`allreduce_async_` and
    return its result (where a failed collective raises)."""
    if handle.work is not None:
        handle.work.wait()
        handle.work = None
        if handle.divisor != 1:
            handle.tensor.div_(handle.divisor)
    return handle.tensor


def mpi_built() -> bool:
    """Horovod's build introspection, answered from ``torch.distributed``."""
    return dist.is_available() and dist.is_mpi_available()


def nccl_built() -> bool:
    return dist.is_available() and dist.is_nccl_available()


def gloo_built() -> bool:
    return dist.is_available() and dist.is_gloo_available()


def cuda_built() -> bool:
    return torch.version.cuda is not None


def rocm_built() -> bool:
    return getattr(torch.version, "hip", None) is not None


def mpi_enabled() -> bool:
    """True when the world runs over MPI."""
    return (collectives.process_group() is not None
            and dist.get_backend() == "mpi")


def broadcast_object(obj, root_rank: int = 0, name: str | None = None):
    """``hvd.broadcast_object``: ``root_rank``'s picklable object on every
    process (collective; :func:`bootstrap.broadcast_object`)."""
    del name
    return bootstrap.broadcast_object(obj, root=root_rank)


def allgather_object(obj, name: str | None = None) -> list:
    """``hvd.allgather_object``: one picklable object per process, in
    process order everywhere."""
    del name
    return bootstrap.allgather_object(obj)
