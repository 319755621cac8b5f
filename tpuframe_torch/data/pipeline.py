"""Host-to-device input pipeline with per-rank sharding and prefetch
(counterpart of ``tpuframe/data/pipeline.py``).

Each rank of the data-parallel world takes its contiguous shard of the
dataset (unless the builder already loaded only this rank's files and
marked it ``host_presharded``) and iterates it in an epoch-shuffled order
drawn from ``default_rng(SeedSequence([seed, epoch]))``, the JAX package's
per-host split with one host per rank.  Batches are assembled, float
image columns cast to the compute dtype on the host (``cast_floats``, as
the JAX loader does: half the bytes over the link, the same rounding the
model's first cast would do), and copied to the device one step ahead of
the consumer on a background thread, through pinned host memory when the
device is a GPU.

The trainer passes the batch degree and index as ``world`` and ``rank``
(``parallel/mesh.py``: data x fsdp, the JAX ``BATCH_AXES``), so the rows
go over the ranks that take other rows, and ranks that differ only in
their pipe, expert, model or seq coordinate take the same ones (a
pipeline's stages all take their data index's rows: stage 0 embeds
them, the last stage's loss reads their labels).  A
sequence-parallel run (``seq``: the seq ring's size and this rank's
index) takes the JAX layout ``P(('data', 'fsdp'), 'seq')``: each seq
rank keeps its ``[i*S/n, (i+1)*S/n)`` columns of
every column with a sequence dimension (the LM's labels are shifted on
the host, so no shift crosses ranks).  One-dimensional columns stay
whole.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from tpuframe_torch.data.datasets import ArrayDataset
from tpuframe_torch.parallel import collectives

PREFETCH = 2  # batches assembled ahead of the consumer


class ShardedLoader:
    """Iterates epoch-shuffled, rank-sharded batches as device tensors.

    ``dataset`` is the whole dataset (every rank passes the same one and
    takes its shard); ``global_batch`` is across all ranks, each feeding
    ``global_batch / world`` rows.  ``world`` and ``rank`` default to the
    ``torch.distributed`` group.  The remainder partial batch of an epoch
    is dropped.  ``cast_floats`` (a torch dtype) casts the float model
    inputs (the ``image`` column) on the host.  ``seq`` ``(n, i)``: keep
    the ``i``-th of ``n`` equal column blocks of the sequence columns
    (module docstring)."""

    def __init__(self, dataset: ArrayDataset, global_batch: int, *,
                 device="cpu", shuffle: bool = True, seed: int = 0,
                 world: int | None = None, rank: int | None = None,
                 cast_floats: torch.dtype | None = None,
                 seq: tuple[int, int] = (1, 0)):
        if world is None:
            world, rank = collectives.world()
        self.seq = seq
        self.global_batch = global_batch
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        if global_batch % world:
            raise ValueError(f"global batch {global_batch} not divisible by "
                             f"{world} ranks")
        self.host_batch = global_batch // world
        self.cast_floats = cast_floats
        presharded = getattr(dataset, "host_presharded", False)
        self.dataset = (dataset.shard(world, rank)
                        if world > 1 and not presharded else dataset)
        if len(self.dataset) < self.host_batch:
            raise ValueError(f"rank shard has {len(self.dataset)} examples "
                             f"< per-rank batch {self.host_batch}")

    def steps_per_epoch(self) -> int:
        return len(self.dataset) // self.host_batch

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if not self.shuffle:
            return np.arange(n)
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, epoch]))
        return rng.permutation(n)

    def epoch(self, epoch: int, *, skip: int = 0) -> Iterator[dict]:
        """Batches of one epoch, assembled ``PREFETCH`` steps ahead on a
        background thread; ``skip`` drops the first batches (resume)."""
        order = self._epoch_order(epoch)
        starts = list(range(0, len(order) - self.host_batch + 1,
                            self.host_batch))[skip:]
        q: queue.Queue = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()
        sentinel = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for lo in starts:
                    idx = order[lo:lo + self.host_batch]
                    if not put(self._to_device(self.dataset[idx])):
                        return  # consumer gone
                put(sentinel)
            except Exception as e:  # noqa: BLE001 — raised to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True,
                             name="tpuframe-torch-prefetch")
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()

    def from_step(self, step: int) -> Iterator[dict]:
        """Infinite stream positioned as if ``step`` batches were already
        consumed: a resumed run sees the same remaining data order."""
        epoch, offset = divmod(step, self.steps_per_epoch())
        while True:
            yield from self.epoch(epoch, skip=offset)
            offset = 0
            epoch += 1

    def __iter__(self):
        return self.from_step(0)

    def _seq_block(self, v: np.ndarray) -> np.ndarray:
        n, i = self.seq
        if n == 1 or v.ndim < 2:
            return v
        if v.shape[1] % n:
            raise ValueError(f"sequence length {v.shape[1]} does not split "
                             f"over {n} seq ranks")
        c = v.shape[1] // n
        return v[:, i * c:(i + 1) * c]

    def _to_device(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            v = self._seq_block(v)
            t = torch.from_numpy(np.ascontiguousarray(v))
            if (self.cast_floats is not None and k == "image"
                    and t.is_floating_point()):
                t = t.to(self.cast_floats)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out
